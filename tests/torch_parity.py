"""Helpers shared by the parity tests of the PyTorch port (tests/test_torch_*.py).

Reference objects cross to the port as dicts of numpy arrays
(`repro_torch.convert`); the comparisons here state the tolerances once.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import gemma3_4b as jgemma
from repro.configs import qwen3_4b as jqwen
from repro.core import lsh as jlsh
from repro.train import train_step as jts

# batch_score_topk: fp32 sums in another order than the reference's.
RTOL, ATOL = 1e-5, 1e-6


def _mix(rng, L, k):
    """Odd uint32 multipliers, as the reference's init draws them."""
    return ((rng.integers(1, 2**31 - 1, size=(L, k)).astype(np.uint32) << 1)
            | np.uint32(1))


def ref_srp(seed, dim, L, k, n_buckets):
    """Reference SRP params drawn with numpy (no JAX random compile)."""
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(dim, L * k)).astype(np.float32)
    return jlsh.SRPParams(proj=jnp.asarray(proj), mix=jnp.asarray(_mix(rng, L, k)),
                          L=L, k=k, n_buckets=n_buckets)


def ref_pstable(seed, dim, L, k, w, n_buckets):
    """Reference p-stable params drawn with numpy."""
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(dim, L * k)).astype(np.float32)
    bias = rng.uniform(0.0, w, size=L * k).astype(np.float32)
    return jlsh.PStableParams(proj=jnp.asarray(proj), bias=jnp.asarray(bias),
                              mix=jnp.asarray(_mix(rng, L, k)), w=w, L=L, k=k,
                              n_buckets=n_buckets)


def fields(obj) -> dict:
    """A reference params dataclass or state NamedTuple → dict of numpy
    arrays (static fields stay Python scalars)."""
    if hasattr(obj, "_asdict"):
        items = obj._asdict().items()
    else:
        items = ((f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in items}


def np_(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_state_equal(port_state, ref_state, names=None):
    """Every (or each named) leaf bit-identical, dtype and shape included."""
    names = names or port_state._fields
    for name in names:
        a, b = np_(getattr(port_state, name)), np_(getattr(ref_state, name))
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


def assert_topk_match(d2_p, idx_p, d2_r, idx_r, exact_d2):
    """Top-k outputs agree: d2 within (RTOL, ATOL); ids equal except at a
    detected near-tie, where the two candidates' exact distances
    (``exact_d2 (B, M)``, float64, inf where masked) differ by less than the
    tolerance."""
    d2_p, idx_p, d2_r, idx_r = map(np_, (d2_p, idx_p, d2_r, idx_r))
    np.testing.assert_allclose(d2_p, d2_r, rtol=RTOL, atol=ATOL)
    rows, cols = np.nonzero(idx_p != idx_r)
    for b, j in zip(rows, cols):
        dp, dr = exact_d2[b, idx_p[b, j]], exact_d2[b, idx_r[b, j]]
        tie = (dp == dr) or abs(dp - dr) <= ATOL + RTOL * abs(dr)
        assert tie, f"id mismatch at ({b}, {j}) without a near-tie: {dp} vs {dr}"


def grid_data(n, d, seed=0, scale=1.0):
    """Rows on a 1/16 grid: every product with `exact_params`' 1/8-grid
    parameters is exact in fp32, so both packages hash alike whatever their
    summation order."""
    rng = np.random.default_rng(seed)
    return (np.round(rng.normal(size=(n, d)) * scale * 16) / 16).astype(
        np.float32)


def exact_params(family, seed, dim, L, k, n_buckets, w=None):
    """Reference SRP or p-stable params on a 1/8 grid (see `grid_data`)."""
    rng = np.random.default_rng(seed)
    proj = (np.round(rng.normal(size=(dim, L * k)) * 8) / 8).astype(np.float32)
    mix = jnp.asarray(_mix(rng, L, k))
    if family == "srp":
        return jlsh.SRPParams(proj=jnp.asarray(proj), mix=mix, L=L, k=k,
                              n_buckets=n_buckets)
    bias = (np.floor(rng.uniform(0, w, L * k) * 8) / 8).astype(np.float32)
    return jlsh.PStableParams(proj=jnp.asarray(proj), bias=jnp.asarray(bias),
                              mix=mix, w=w, L=L, k=k, n_buckets=n_buckets)


def port_params(ref_params, device="cpu"):
    """The reference's params as the port's, on ``device``."""
    from repro_torch import convert
    return convert.params_from_numpy(fields(ref_params), device)


# ---------------------------------------------------------------------------
# The language model's training path (tests/test_torch_{flash,model,train}.py)
# ---------------------------------------------------------------------------

# The reference's functions compile at XLA's lowest backend optimisation
# level and with its older loop emitters, which compile a train step in
# 40% of the time (the shapes are tiny, so compiling dominates); XLA keeps
# IEEE semantics there, but does not contract ``a * x + y`` into one
# multiply-add as it does at its default level, so optimizer updates
# compile by default.
XLA_FAST = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True,
            "xla_cpu_use_fusion_emitters": False,
            # one LLVM module, not several compiled in parallel (the tests
            # run a process a core), and copy insertion without its region
            # analysis: ~15% of a smoke model's loss-gradient compile, and
            # neither changes what the program computes
            "xla_cpu_parallel_codegen_split_count": 1,
            "xla_cpu_copy_insertion_use_region_analysis": False}
GEMMA_2L = dataclasses.replace(jgemma.smoke(), n_layers=2,
                               param_dtype="float32")
QWEN = dataclasses.replace(jqwen.smoke(), param_dtype="float32")
LM_B, LM_S = 2, 64


def fast_jit(fn):
    """``jax.jit(fn)`` compiled once per input signature with `XLA_FAST`."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(x), jnp.result_type(x)) for x in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(compiler_options=XLA_FAST)
        return compiled[key](*args)

    return call


def port_model_cfg(cfg):
    """The port's `ModelConfig` with a reference config's fields."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**dataclasses.asdict(cfg))


def f32(x) -> np.ndarray:
    """A tensor (bfloat16 included) or array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
    return np.asarray(np_(x), np.float32)


def assert_rel(got, want, tol):
    """Every element within ``tol`` times the largest ``|want|``."""
    got, want = f32(got), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


def lm_tree_np(cfg, seed: int) -> dict:
    """The reference's parameter tree as numpy: the port's `init_params`
    shapes and dtypes (the reference's names and layout, any family) with
    values drawn at the reference's distributions, norm weights 0.1 *
    normal (the reference starts them at 0) so their ``1 + w`` scale
    matters, and the recurrent families' special leaves near their
    meaning: Mamba2's decay ``A_log``, step bias ``dt_bias`` (steps in
    [0.01, 0.5]) and skip ``D``, the conv biases, the xLSTM gate biases
    (forget gates near 3), all float32 where the reference keeps them so.
    (The reference's own ``init_model`` compiles for seconds.)"""
    from repro_torch.models import model as tmodel
    like = tmodel.init_params(port_model_cfg(cfg),
                              torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(seed)
    dt = jnp.bfloat16 if cfg.param_dtype == "bfloat16" else np.float32

    def draw(name, t):
        norm = (name.startswith("ln") or name.endswith("_norm")
                or name in ("norm_w", "enc_ln_f"))
        if norm:
            x = 0.1 * rng.normal(size=t.shape)
        elif name == "embed":
            x = 0.02 * rng.normal(size=t.shape)
        elif name == "A_log":
            x = rng.uniform(-1.0, 1.0, size=t.shape)
        elif name == "dt_bias":
            x = np.log(np.expm1(rng.uniform(0.01, 0.5, size=t.shape)))
        elif name == "D":
            x = 1.0 + 0.1 * rng.normal(size=t.shape)
        elif name in ("conv_w", "conv_b"):
            x = 0.1 * rng.normal(size=t.shape)
        elif name in ("b_if", "b"):
            x = 0.5 * rng.normal(size=t.shape)
            forget = x[..., t.shape[-1] // 2:] if name == "b_if" else x[..., 1, :]
            forget += 3.0
        else:
            x = rng.normal(size=t.shape) / np.sqrt(t.shape[-2])
        leaf_dt = np.float32 if t.dtype == torch.float32 else dt
        return np.asarray(x.astype(np.float32), leaf_dt)

    def walk(d):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v)
                for k, v in d.items()}

    return walk(like)


def flat(tree) -> dict:
    """``{"a/b/c": float32 numpy}`` of a nested dict (tensors or numpy)."""
    from repro_torch.checkpoint import checkpoint as tckpt
    return {k: f32(v) for k, v in tckpt._flatten(tree)}


def lm_tokens(cfg, seed, b=LM_B, s=LM_S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


_JLOSS_GRAD: dict = {}


def jloss_grad(cfg):
    """The reference's ``(metrics, grads)`` of ``loss_fn``, compiled once a
    config."""
    if cfg not in _JLOSS_GRAD:
        ctx = jts.make_ctx(None)

        def f(params, tokens):
            (_, m), g = jax.value_and_grad(
                lambda p: jts.loss_fn(p, cfg, {"tokens": tokens}, ctx),
                has_aux=True)(params)
            return m, g
        _JLOSS_GRAD[cfg] = fast_jit(f)
    return _JLOSS_GRAD[cfg]
