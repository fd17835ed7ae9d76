"""Mixture-of-Experts layers (deepseek-moe-16b, deepseek-v3-671b).

Counterpart of the reference's ``models/moe.py``: ``n_shared`` always-on
experts plus ``n_experts`` routed experts with top-k softmax gating, a
Switch-style load-balance aux loss, and the capacity dispatch
``C = ceil(T * topk / n_experts * capacity_factor)`` that drops a token for
an expert once C tokens ahead of it (token-major order) took that expert.

Two routes give the reference's values; `_dispatch_compute_combine` picks
by size.  The capacity-buffer route is the reference's ``moe_dense``: the
kept (token, slot) pairs are scattered into an ``(E * C + 1, d)`` buffer
whose last row is the dump row of dropped pairs, every expert runs over its
C rows as one batched product over the stacked ``(E, d, f)`` weights, and
the dump row reads 0.  The gathered-pair route computes only the kept
pairs, each on its expert's weights gathered (three ``d x d_ff_expert``
slices a pair); it reads fewer bytes where ``T * topk < n_experts`` (the
decode), the buffer route everywhere else (training).

``moe_ep`` is expert parallelism on a ``(data, model)`` mesh: the experts
split over ``model``; each rank routes its data shard's tokens, gathers its
local experts' weights over the FSDP axis inside the layer, runs the
capacity dispatch for its experts only (C from its local token count), and
one bf16 sum over ``model`` combines the ranks' outputs, as the
reference's ``shard_map`` body does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.util import fp32_reciprocal
from ..parallel import sharding
from ..parallel.param_specs import batch_axes
from ..parallel.sharding import NULL_CTX, ShardingCtx
from . import layers


def init_moe(gen, d_model: int, n_experts: int, n_shared: int,
             d_ff_expert: int, dtype, device, lead: tuple = ()) -> dict:
    """MoE weights; ``lead`` prepends axes (a stack of layers).  The router
    stays float32, as in the reference."""
    sc_in = 1.0 / math.sqrt(d_model)
    sc_out = 1.0 / math.sqrt(d_ff_expert)
    E, d, f = n_experts, d_model, d_ff_expert
    p = {
        "router": layers._normal(gen, lead + (d, E), sc_in, torch.float32, device),
        "w_gate": layers._normal(gen, lead + (E, d, f), sc_in, dtype, device),
        "w_up": layers._normal(gen, lead + (E, d, f), sc_in, dtype, device),
        "w_down": layers._normal(gen, lead + (E, f, d), sc_out, dtype, device),
    }
    if n_shared:
        p["shared"] = layers.init_mlp(gen, d, n_shared * f, dtype, device,
                                      lead=lead)
    return p


def _route(router_w, x_flat, topk: int):
    """Returns (weights (T, k) fp32, expert ids (T, k) int64, aux loss).

    The top k are taken by a stable descending sort, so that equal
    probabilities go to the lower expert id first, as ``lax.top_k`` orders
    them (``torch.topk`` promises no order among ties)."""
    logits = x_flat.float() @ router_w                     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :topk], idx[:, :topk]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load balance: E * sum_e f_e * p_e
    E = router_w.shape[1]
    f = torch.zeros((E,), dtype=torch.float32, device=x_flat.device)
    f = f.index_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1),
                                                         dtype=torch.float32))
    f = f * fp32_reciprocal(max(idx.numel(), 1))
    pbar = probs.sum(0) * fp32_reciprocal(probs.shape[0])
    aux = E * torch.sum(f * pbar)
    return w, idx, aux


def _expert_ffn(p, xs, experts=None):
    """xs (n, C, d) → (n, C, d), SwiGLU per expert: row i of ``xs`` runs
    expert ``experts[i]`` (n,), its weights gathered, or with ``experts``
    None expert i of the stacked weights (n = E)."""
    if experts is None:
        wu, wg, wd = p["w_up"], p["w_gate"], p["w_down"]
    else:
        wu, wg, wd = (p["w_up"][experts], p["w_gate"][experts],
                      p["w_down"][experts])
    h = torch.bmm(xs, wu)
    g = F.silu(torch.bmm(xs, wg))
    return torch.bmm(h * g, wd)


def _capacity_slots(idx, e_lo: int, E_local: int, C: int):
    """Each (token, slot) pair's expert in the range (``le``, clamped) and
    its buffer row ``le * C + rank``, or ``E_local * C`` (the dump row)
    where the pair is dropped: routed outside ``[e_lo, e_lo + E_local)``,
    or of rank >= C within its expert.  Ranks come from a stable sort of
    the token-major expert ids, as the reference's.  idx (T, k) → (le, pos,
    ok), each (T * k,)."""
    a_e = idx.reshape(-1)
    local = (a_e >= e_lo) & (a_e < e_lo + E_local)
    le = torch.clamp(a_e - e_lo, 0, E_local - 1)
    key = torch.where(local, le, torch.full_like(le, E_local))
    order = torch.argsort(key, stable=True)
    counts = torch.zeros((E_local + 1,), dtype=key.dtype, device=key.device)
    counts = counts.index_add_(0, key, torch.ones_like(key))   # no host wait
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(a_e.numel(), device=key.device) - starts[key[order]]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    ok = local & (rank < C)
    pos = torch.where(ok, le * C + rank, torch.full_like(le, E_local * C))
    return le, pos, ok


def _gathered_pairs(p_local, x_flat, w, le, ok):
    """Every pair runs its expert on its token's row with that expert's
    weights gathered; a dropped pair's weight is 0, so its (finite) output
    adds a zero and takes no gradient.  → y (T, d) fp32."""
    T, d = x_flat.shape
    k = w.shape[1]
    rows = x_flat.repeat_interleave(k, dim=0)[:, None, :]  # (T*k, 1, d)
    ys = _expert_ffn(p_local, rows, le).reshape(T, k, d)
    contrib = ys.float() * (w * ok.reshape(T, k))[..., None]
    y = torch.zeros((T, d), dtype=torch.float32, device=x_flat.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y


def _capacity_buffer(p_local, x_flat, w, pos, E_local: int, C: int):
    """The kept pairs scattered slot by slot into an ``(E_local * C + 1,
    d)`` buffer (each kept row lands alone on a zero row; the dump row is
    never read), every expert over its C rows on the stacked weights, the
    dump row reading 0.  → y (T, d) fp32."""
    T, d = x_flat.shape
    k = w.shape[1]
    pos_k = pos.reshape(T, k)
    buf = torch.zeros((E_local * C + 1, d), dtype=x_flat.dtype,
                      device=x_flat.device)
    for j in range(k):
        buf = buf.index_add(0, pos_k[:, j], x_flat)
    ys = _expert_ffn(p_local, buf[:-1].reshape(E_local, C, d))
    ys = torch.cat([ys.reshape(E_local * C, d), ys.new_zeros((1, d))])
    y = torch.zeros((T, d), dtype=torch.float32, device=x_flat.device)
    for j in range(k):
        y = y + ys[pos_k[:, j]].float() * w[:, j, None]
    return y


def _dispatch_compute_combine(p_local, x_flat, w, idx, e_lo: int,
                              E_local: int, C: int):
    """Capacity dispatch for experts in ``[e_lo, e_lo + E_local)``.  x_flat
    (T, d); w / idx (T, k) → y (T, d) fp32: the k slots' weighted expert
    outputs added into one fp32 accumulator in order 0..k-1.  The gathered
    pairs where their ``T * k`` weight slices are fewer than the
    ``E_local`` stacked experts (the decode), else the capacity buffer."""
    le, pos, ok = _capacity_slots(idx, e_lo, E_local, C)
    if idx.numel() < E_local:
        return _gathered_pairs(p_local, x_flat, w, le, ok)
    return _capacity_buffer(p_local, x_flat, w, pos, E_local, C)


def moe_dense(params, x, *, topk: int, capacity_factor: float):
    """Single-device path: x (B, S, d) → (y (B, S, d), aux loss)."""
    B, S, d = x.shape
    E = params["router"].shape[1]
    x_flat = x.reshape(B * S, d)
    w, idx, aux = _route(params["router"], x_flat, topk)
    C = max(1, math.ceil(B * S * topk / E * capacity_factor))
    y = _dispatch_compute_combine(params, x_flat, w, idx, 0, E, C)
    y = y.to(x.dtype).reshape(B, S, d)
    if "shared" in params:
        y = y + layers.mlp(params["shared"], x)
    return y, aux


def moe_ep(params, xs: list, mesh, topk: int, capacity_factor: float,
           sum_dtype=None):
    """Expert parallelism, one tensor a rank: ``xs[r]`` rank r's data shard's
    tokens (equal over ``model``) → (one output a rank, the aux on the
    mesh's first device).  The expert weights split their experts over
    ``model``; whatever FSDP axes their specs name (``data``, or ``data``
    and ``pod`` with the reference's ``fsdp_over_pod``) are gathered.  The
    ranks' outputs are summed over ``model`` in bfloat16, as the reference
    sums them (halving a training step's all-reduce); with ``sum_dtype``
    (the decode's float32: a few tokens) in that dtype, and the shared
    experts' row-parallel products too (`layers.mlp_ranks`), each sum
    rounded once as one device rounds it."""
    E = params["router"].shape[-1]
    M = mesh.shape["model"]
    if E % M:
        raise ValueError(f"moe_ep: {E} experts over a {M}-wide model axis")
    E_local = E // M
    for k in ("w_gate", "w_up", "w_down"):
        if params[k].spec[0] != "model":
            raise ValueError(f"moe_ep: {k} of spec {params[k].spec} does not "
                             "split its experts over 'model'")
    routers = params["router"].gathered()
    # this layer's local experts, gathered over the FSDP axis (ZeRO)
    wg, wu, wd = (params[k].gathered(keep=("model",))
                  for k in ("w_gate", "w_up", "w_down"))
    ys, auxes = [], []
    for r, x in enumerate(xs):
        Bl, Sl, d = x.shape
        x_flat = x.reshape(Bl * Sl, d)
        w, idx, aux = _route(routers[r], x_flat, topk)
        C = max(1, math.ceil(Bl * Sl * topk / E * capacity_factor))
        m = sharding.axis_index(mesh, r, "model")
        p_local = {"w_gate": wg[r], "w_up": wu[r], "w_down": wd[r]}
        ys.append(_dispatch_compute_combine(p_local, x_flat, w, idx,
                                            m * E_local, E_local, C)
                  .to(sum_dtype or torch.bfloat16))
        auxes.append(aux)
    # the combine sum over "model" (per-token sums have <= topk + 1 terms);
    # the per-shard load-balance estimate averaged over the mesh
    ys = sharding.psum(ys, mesh, "model")
    aux = sharding.pmean(auxes, mesh, ("model",) + batch_axes(mesh))[0]
    ys = [y.float().reshape(x.shape).to(x.dtype) for y, x in zip(ys, xs)]
    if "shared" in params:
        shared = layers.mlp_ranks(params["shared"], xs, mesh,
                                  sum_dtype=sum_dtype)
        ys = [y + s for y, s in zip(ys, shared)]
    return ys, aux


def _dense_ranks(params, xs: list, mesh, topk: int, capacity_factor: float):
    """`moe_dense` over the whole batch on every rank (a mesh whose
    ``model`` axis does not split the experts): each rank gathers the
    batch and every weight, and keeps its own rows."""
    dp = batch_axes(mesh)
    full = sharding.all_gather(xs, mesh, dp, dim=0)
    tree = layers.gathered_tree(params)
    ys, auxes = [], []
    for r, x in enumerate(xs):
        y, aux = moe_dense(tree[r], full[r], topk=topk,
                           capacity_factor=capacity_factor)
        i = sharding.axis_index(mesh, r, dp)
        ys.append(y[i * x.shape[0]:(i + 1) * x.shape[0]])
        auxes.append(aux)
    return ys, auxes[0]


def moe_ranks(params, xs: list, mesh, *, topk: int, capacity_factor: float,
              sum_dtype=None):
    """`moe` on one tensor a rank (the mesh forward's activations); with no
    ``mesh``, `moe_dense` of ``xs``' one tensor on one device.
    ``sum_dtype`` is `moe_ep`'s."""
    if mesh is None:
        y, aux = moe_dense(params, xs[0], topk=topk,
                           capacity_factor=capacity_factor)
        return [y], aux
    if _use_ep(params, mesh):
        return moe_ep(params, xs, mesh, topk, capacity_factor, sum_dtype)
    return _dense_ranks(params, xs, mesh, topk, capacity_factor)


def _use_ep(params, mesh) -> bool:
    return ("model" in mesh.axis_names and mesh.shape["model"] > 1
            and params["router"].shape[-1] % mesh.shape["model"] == 0)


def moe(params, x, *, topk: int, capacity_factor: float,
        ctx: ShardingCtx = NULL_CTX):
    """Dispatching entry point: expert parallelism (`moe_ep`) when the mesh
    has a ``model`` axis wider than 1 that divides the experts, else
    `moe_dense` (on a mesh: over the whole batch, as the reference's
    auto-sharded dense path computes it).  On a mesh ``params`` is a tree
    of `Sharded` leaves and ``x`` a `Sharded` split over the batch axes."""
    if ctx.mesh is None:
        return moe_dense(params, x, topk=topk, capacity_factor=capacity_factor)
    ys, aux = moe_ranks(params, x.shards, ctx.mesh, topk=topk,
                        capacity_factor=capacity_factor)
    return sharding.sharded_like(x, ys), aux
