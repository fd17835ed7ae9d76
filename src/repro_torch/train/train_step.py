"""The training step: next-token cross-entropy, its gradients, the optimizer.

The port of the reference's ``train/train_step.py`` for every family: the
next-token cross-entropy, plus the MoE auxiliary loss, plus for a model
with an MTP head ``mtp_coef`` times the cross-entropy of its predictions
two positions ahead.  ``make_train_step(cfg, optimizer)`` returns
``(train_step, init_state)``; ``train_step(state, batch)`` updates
``state``'s parameters and optimizer state in place and returns the next
`TrainState` with its metrics (0-d tensors on the device: ``ce``,
``moe_aux``, ``mtp_ce`` with an MTP head, ``loss``, ``grad_norm``).

Gradients: the backward writes every parameter's gradient into a buffer
shaped like the parameter tree.  Each layer of a stacked tree is a leaf of
its own (a view of the stack that takes gradients; each layer of each
group for the hybrid's ``(groups, attn_every, ...)`` stack), so the
backward of one layer never builds a gradient the size of the whole stack;
each layer's gradient lands in its slice of the buffer.  Leaves that are
not stacked (``shared_attn``, ``mtp``, ``patch_proj``, ``enc_ln_f``, the
embedding) stay whole: a block used several times sums its gradients.  With ``grad_microbatches > 1``
the batch is split along its rows and the per-microbatch gradients are
summed in ``grad_accum_dtype`` and averaged in float32, as the reference's
scan does.
"""
from __future__ import annotations

import functools
from typing import Mapping, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..checkpoint.checkpoint import tree_leaves, tree_map
from ..configs.base import ModelConfig
from ..core.util import fp32_reciprocal
from ..models import layers
from ..models import model as model_lib
from ..optim.adam import Optimizer


class TrainState(NamedTuple):
    params: dict
    opt_state: object
    step: torch.Tensor


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token CE in fp32.  logits (B, T, V); targets (B, T) already
    aligned (target[t] is the label for position t)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -lp.gather(-1, targets[..., None].long())[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.sum() * fp32_reciprocal(nll.numel())


def _chunk_nll(h, t, emb_params, softcap: float) -> torch.Tensor:
    logits = layers.unembed(emb_params, h, softcap)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -lp.gather(-1, t[..., None].long())[..., 0].sum()


def chunked_xent(hidden: torch.Tensor, emb_params, targets: torch.Tensor,
                 softcap: float, chunk: int = 512) -> torch.Tensor:
    """CE computed per sequence chunk, each chunk rematerialised in the
    backward: the (B, S, V) fp32 logits never exist at full size.  The
    chunk is ``chunk`` shrunk to a divisor of S."""
    B, S, _ = hidden.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    nll = functools.partial(_chunk_nll, emb_params=emb_params, softcap=softcap)
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // c):
        h, t = hidden[:, i * c:(i + 1) * c], targets[:, i * c:(i + 1) * c]
        total = total + (checkpoint(nll, h, t, use_reentrant=False)
                         if remat else nll(h, t))
    return total * fp32_reciprocal(B * S)


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """``(loss, metrics)`` of ``batch["tokens"]`` predicting itself one
    position ahead (and, with an MTP head, two positions ahead)."""
    hidden, aux = model_lib.forward(params, cfg, batch, return_hidden=True)
    tokens = batch["tokens"]
    emb = params["embedding"]
    loss = chunked_xent(hidden[:, :-1], emb, tokens[:, 1:], cfg.final_softcap)
    total = loss + aux["moe_aux"]
    metrics = {"ce": loss, "moe_aux": aux["moe_aux"]}
    if "mtp_hidden" in aux and cfg.mtp_depth:
        # depth-1 MTP predicts token t+2 from position t
        mtp = chunked_xent(aux["mtp_hidden"][:, :-2], emb, tokens[:, 2:],
                           cfg.final_softcap)
        total = total + cfg.mtp_coef * mtp
        metrics["mtp_ce"] = mtp
    metrics["loss"] = total
    return total, metrics


# the stacked trees of every family and their number of stacked axes
STACKED = {"blocks": 1, "dense_blocks": 1, "moe_blocks": 1, "mamba_blocks": 2,
           "mlstm_blocks": 1, "slstm_blocks": 1, "enc_blocks": 1,
           "dec_blocks": 1}


def _grad_leaves(params, grads) -> dict:
    """A tree like ``params`` whose leaves share the parameters' storage and
    take gradients into the matching tensors of ``grads``; each stacked
    tree (`STACKED`) is a list of per-layer trees (``mamba_blocks`` a list
    of groups, each a list of layers)."""
    def leaf(p, g):
        t = p.detach().requires_grad_()
        t.grad = g
        return t

    def pair(a, b):
        return {k: pair(a[k], b[k]) if isinstance(a[k], Mapping)
                else leaf(a[k], b[k]) for k in a}

    def split(a, b, axes: int):
        if not axes:
            return pair(a, b)
        n = tree_leaves(a)[0].shape[0]
        return [split(model_lib.layer_params(a, i),
                      model_lib.layer_params(b, i), axes - 1)
                for i in range(n)]

    return {k: split(v, grads[k], STACKED[k]) if k in STACKED
            else pair(v, grads[k]) if isinstance(v, Mapping)
            else leaf(v, grads[k]) for k, v in params.items()}


def grads_and_metrics(params, cfg: ModelConfig, batch: dict):
    """``(grads, metrics)`` of one batch: grads a tree like ``params`` in
    the parameters' dtypes, metrics detached 0-d tensors."""
    grads = tree_map(torch.zeros_like, params)
    leaves = _grad_leaves(params, grads)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, cfg, batch)
        torch.autograd.backward(loss, inputs=tree_leaves(leaves))
    return grads, {k: v.detach() for k, v in metrics.items()}


_NORM_PIECE = 2 ** 27      # elements a float32 temporary of `grad_norm` holds


def grad_norm(grads) -> torch.Tensor:
    """Global L2 norm of a gradient tree: float32 squares summed piece by
    piece (``sum``'s tree reduction on the card, cascade on the CPU)."""
    sq = [(piece.float() ** 2).sum() for g in tree_leaves(grads)
          for piece in g.reshape(-1).split(_NORM_PIECE)]
    return torch.sqrt(torch.stack(sq).sum())


def make_train_step(cfg: ModelConfig, optimizer: Optimizer):
    n_micro = max(1, cfg.grad_microbatches)
    acc_dt = torch.bfloat16 if cfg.grad_accum_dtype == "bfloat16" \
        else torch.float32

    def init_state(gen: torch.Generator, device="cuda") -> TrainState:
        params = model_lib.init_params(cfg, gen, device)
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=step)

    def accumulate(params, batch):
        if n_micro == 1:
            return grads_and_metrics(params, cfg, batch)
        if batch["tokens"].shape[0] % n_micro:
            raise ValueError(f"batch of {batch['tokens'].shape[0]} rows does "
                             f"not split into {n_micro} microbatches")
        rows = batch["tokens"].shape[0] // n_micro
        g_acc = m_acc = None
        for i in range(n_micro):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            g, m = grads_and_metrics(params, cfg, mb)
            g = tree_map(lambda x: x.to(acc_dt), g)
            if g_acc is None:
                g_acc, m_acc = g, m
            else:
                for a, b in zip(tree_leaves(g_acc), tree_leaves(g)):
                    a.add_(b)
                m_acc = {k: m_acc[k] + m[k] for k in m_acc}
        inv = fp32_reciprocal(n_micro)
        return (tree_map(lambda x: x.float() * inv, g_acc),
                {k: v * inv for k, v in m_acc.items()})

    def train_step(state: TrainState, batch: dict):
        grads, metrics = accumulate(state.params, batch)
        metrics["grad_norm"] = grad_norm(grads)
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params)
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1), metrics

    return train_step, init_state
