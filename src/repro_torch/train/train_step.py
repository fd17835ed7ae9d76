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

On a ``(data, model)`` mesh (``make_train_step(cfg, optimizer, mesh)``) the
state's parameters and optimizer state are trees of
`parallel.sharding.Sharded` leaves placed by `parallel.param_specs`, and
every input of the batch splits its rows over the data axes
(`param_specs.batch_shardings`); every family trains there.  The whole
sharded step is one autograd graph: the backward of each layer's FSDP
gather delivers every block its gradient summed over the ranks that read
it, and a leaf's equal copies (the ranks its spec does not split over)
then add their gradients, in rank order, so every copy holds the whole
gradient.  The loss (and the MTP head's) is each data shard's token sum
(computed on its rank at model index 0) added over the shards and divided
by the global token count.  ``grad_norm`` counts one copy of each block.
Microbatches are the global batch's consecutive row blocks, as the
reference's are, each then split over the data axes.
"""
from __future__ import annotations

import functools
from typing import Mapping, NamedTuple, Optional

import torch

from ..checkpoint.checkpoint import tree_leaves, tree_map
from ..configs.base import ModelConfig
from ..core.util import fp32_reciprocal
from ..models import layers
from ..models import model as model_lib
from ..models.remat import remat_call
from ..optim.adam import Optimizer, init_on_mesh
from ..parallel import param_specs
from ..parallel.sharding import NULL_CTX, Sharded, ShardingCtx, make_ctx


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
    return _xent_sum(hidden, emb_params, targets, softcap, chunk) \
        * fp32_reciprocal(B * S)


def _xent_sum(hidden: torch.Tensor, emb_params, targets: torch.Tensor,
              softcap: float, chunk: int = 512) -> torch.Tensor:
    """`chunked_xent`'s sum of the tokens' negative log-likelihoods."""
    B, S, _ = hidden.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    nll = functools.partial(_chunk_nll, emb_params=emb_params, softcap=softcap)
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // c):
        h, t = hidden[:, i * c:(i + 1) * c], targets[:, i * c:(i + 1) * c]
        total = total + (remat_call(nll, h, t) if remat else nll(h, t))
    return total


def _loss_mesh(params, cfg: ModelConfig, batch: dict, ctx: ShardingCtx):
    """`loss_fn` on a mesh: the forward on each rank's rows, then each data
    shard's cross-entropy sums (and the MTP head's, two positions ahead) on
    its rank at model index 0, the shards' sums added in order on the
    mesh's first device, over the global token counts."""
    mesh = ctx.mesh
    batch = model_lib.shard_batch(batch, mesh)
    tokens = batch["tokens"]
    xs, aux = model_lib.forward_ranks(
        params, cfg, {k: v.shards for k, v in batch.items()}, mesh)
    emb = layers.unembed_weights(params["embedding"])
    dp = param_specs.batch_axes(mesh)
    first = mesh.devices[0]
    mtp = aux.get("mtp_hidden") if cfg.mtp_depth else None
    total = mtp_total = None
    for r, x in enumerate(xs):
        c = mesh.coords(r)
        if any(ci for a, ci in zip(mesh.axis_names, c) if a not in dp):
            continue            # a copy of this data shard's hidden states
        t = tokens.shards[r]
        part = _xent_sum(x[:, :-1], emb[r], t[:, 1:],
                         cfg.final_softcap).to(first)
        total = part if total is None else total + part
        if mtp is not None:
            part = _xent_sum(mtp[r][:, :-2], emb[r], t[:, 2:],
                             cfg.final_softcap).to(first)
            mtp_total = part if mtp_total is None else mtp_total + part
    B, S = tokens.shape
    loss = total * fp32_reciprocal(B * (S - 1))
    moe_aux = aux["moe_aux"]
    if moe_aux is None:
        moe_aux = torch.zeros((), dtype=torch.float32, device=first)
    metrics = {"ce": loss, "moe_aux": moe_aux}
    total_loss = loss + moe_aux
    if mtp is not None:
        # depth-1 MTP predicts token t+2 from position t
        metrics["mtp_ce"] = mtp_loss = mtp_total * fp32_reciprocal(B * (S - 2))
        total_loss = total_loss + cfg.mtp_coef * mtp_loss
    metrics["loss"] = total_loss
    return total_loss, metrics


def loss_fn(params, cfg: ModelConfig, batch: dict, ctx: ShardingCtx = NULL_CTX):
    """``(loss, metrics)`` of ``batch["tokens"]`` predicting itself one
    position ahead (and, with an MTP head, two positions ahead)."""
    if ctx.mesh is not None:
        return _loss_mesh(params, cfg, batch, ctx)
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
        if isinstance(p, Sharded):
            return Sharded([leaf(a, b) for a, b in zip(p.shards, g.shards)],
                           p.spec, p.mesh, p.shape)
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


def _map_blocks(fn, tree):
    """``fn`` on every tensor of a tree, block by block in a `Sharded`."""
    return tree_map(lambda x: Sharded([fn(s) for s in x.shards], x.spec,
                                      x.mesh, x.shape)
                    if isinstance(x, Sharded) else fn(x), tree)


def _blocks(tree) -> list:
    """A tree's tensors, a `Sharded` leaf's blocks in rank order."""
    return [t for x in tree_leaves(tree)
            for t in (x.shards if isinstance(x, Sharded) else (x,))]


def _sum_replicas(g: Sharded) -> None:
    """Every group of equal copies of a block: the copies' gradients added
    in rank order (once a device) and written into each copy."""
    for group in g.replica_groups():
        if len(group) == 1:
            continue
        sums = {}
        for q in group:
            dev = g.shards[q].device
            if dev not in sums:
                acc = g.shards[group[0]].to(dev, copy=True)
                for o in group[1:]:
                    acc += g.shards[o].to(dev)
                sums[dev] = acc
        for q in group:
            g.shards[q].copy_(sums[g.shards[q].device])


def grads_and_metrics(params, cfg: ModelConfig, batch: dict,
                      ctx: ShardingCtx = NULL_CTX):
    """``(grads, metrics)`` of one batch: grads a tree like ``params`` in
    the parameters' dtypes, metrics detached 0-d tensors."""
    grads = _map_blocks(torch.zeros_like, params)
    leaves = _grad_leaves(params, grads)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, cfg, batch, ctx)
        torch.autograd.backward(loss, inputs=_blocks(leaves))
    for g in tree_leaves(grads):
        if isinstance(g, Sharded):
            _sum_replicas(g)
    return grads, {k: v.detach() for k, v in metrics.items()}


_NORM_PIECE = 2 ** 27      # elements a float32 temporary of `grad_norm` holds


def grad_norm(grads) -> torch.Tensor:
    """Global L2 norm of a gradient tree: float32 squares summed piece by
    piece (``sum``'s tree reduction on the card, cascade on the CPU); one
    copy of each block of a `Sharded` leaf, the blocks' sums added on the
    first block's device."""
    blocks = [t for g in tree_leaves(grads)
              for t in ([s for _, s in g.distinct()] if isinstance(g, Sharded)
                        else (g,))]
    first = blocks[0].device
    sq = [(piece.float() ** 2).sum().to(first) for g in blocks
          for piece in g.reshape(-1).split(_NORM_PIECE)]
    return torch.sqrt(torch.stack(sq).sum())


def shard_state(state: TrainState, mesh,
                like: Optional[TrainState] = None) -> TrainState:
    """A single-device `TrainState` (on any device, the host's included)
    placed onto ``mesh``: the parameters by `param_specs.param_shardings`
    (or ``like``'s specs), the optimizer state by
    `param_specs.opt_state_shardings`; the 0-d step counters on the mesh's
    first device."""
    first = mesh.devices[0]
    if like is None:
        p_specs = param_specs.param_shardings(state.params, mesh)
        o_specs = param_specs.opt_state_shardings(state.opt_state, p_specs,
                                                  mesh)
    else:
        p_specs = param_specs.specs_of(like.params)
        o_specs = param_specs.specs_of(like.opt_state)
    params = param_specs.shard_params(state.params, mesh, p_specs)
    opt = param_specs.shard_params(state.opt_state, mesh, o_specs)
    return TrainState(params=params, opt_state=opt,
                      step=state.step.to(first))


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, mesh=None):
    """``(train_step, init_state)``.  With a ``mesh`` the state lives on it
    (`init_state` draws the parameters on ``device`` and places them) and
    ``train_step`` takes a global batch (on any device) or one already
    split over the batch axes."""
    n_micro = max(1, cfg.grad_microbatches)
    acc_dt = torch.bfloat16 if cfg.grad_accum_dtype == "bfloat16" \
        else torch.float32
    ctx = make_ctx(mesh)

    def init_state(gen: torch.Generator, device="cuda") -> TrainState:
        params = model_lib.init_params(cfg, gen, device)
        if mesh is not None:
            params = param_specs.shard_params(
                params, mesh, fsdp_over_pod=cfg.fsdp_over_pod)
            return TrainState(params=params,
                              opt_state=init_on_mesh(optimizer, params),
                              step=torch.zeros((), dtype=torch.int32,
                                               device=mesh.devices[0]))
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=step)

    def accumulate(params, batch):
        if n_micro == 1:
            return grads_and_metrics(params, cfg, batch, ctx)
        if batch["tokens"].shape[0] % n_micro:
            raise ValueError(f"batch of {batch['tokens'].shape[0]} rows does "
                             f"not split into {n_micro} microbatches")
        rows = batch["tokens"].shape[0] // n_micro
        # microbatch i is rows [i * rows, (i + 1) * rows) of the global
        # batch (assembled on the mesh's first device when it is split)
        batch = {k: v.full() if isinstance(v, Sharded) else v
                 for k, v in batch.items()}
        g_acc = m_acc = None
        for i in range(n_micro):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            g, m = grads_and_metrics(params, cfg, mb, ctx)
            g = _map_blocks(lambda x: x.to(acc_dt), g)
            if g_acc is None:
                g_acc, m_acc = g, m
            else:
                for a, b in zip(_blocks(g_acc), _blocks(g)):
                    a.add_(b)
                m_acc = {k: m_acc[k] + m[k] for k in m_acc}
        inv = fp32_reciprocal(n_micro)
        return (_map_blocks(lambda x: x.float() * inv, g_acc),
                {k: v * inv for k, v in m_acc.items()})

    def train_step(state: TrainState, batch: dict):
        grads, metrics = accumulate(state.params, batch)
        metrics["grad_norm"] = grad_norm(grads)
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params)
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1), metrics

    return train_step, init_state
