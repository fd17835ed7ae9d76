"""Flash attention and the attention layer of the port against the
reference's, on the CPU.

`models.flash.flash_attention` (a ``torch.autograd.Function`` in plain
PyTorch; the reference's is a ``lax.scan`` with a custom VJP) over five
cases — causal with GQA (G = 4), a sliding window with the tanh softcap
and ``dv != dqk``, a positive ``q_offset`` (chunked prefill), a negative
one whose first queries see no key (o = 0 and zero gradients), and a
non-causal cross case — with blocks of 16 so that block pairs are
skipped, partly masked and fully visible; the reference's five cases
compile once.  Then `layers.attention` with qk-norm, RoPE, a window, the
softcap and ``cross_kv``.

Tolerances (float32): the two frameworks sum matrix products and softmax
rows in other orders: the output and the q, k and v gradients within 5e-6
of the largest value (seen: 6e-7); `layers.attention` within 5e-6.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import flash as jflash
from repro.models import layers as jlayers
from repro_torch.models import flash as tflash
from repro_torch.models import layers as tlayers

from torch_parity import LM_B, assert_rel, fast_jit


FLASH_CASES = {
    "causal_gqa": dict(B=1, Sq=64, Sk=64, H=8, Hkv=2, dh=16, dv=16),
    "window_softcap_dv": dict(B=2, Sq=64, Sk=64, H=4, Hkv=2, dh=16, dv=8,
                              window=24, softcap=5.0),
    "q_offset": dict(B=2, Sq=32, Sk=64, H=4, Hkv=2, dh=16, dv=16, q_offset=32),
    # queries at positions -16..-1 see no key: o = 0, zero gradients
    "dead_rows": dict(B=2, Sq=48, Sk=32, H=4, Hkv=2, dh=16, dv=16,
                      q_offset=-16),
    "cross": dict(B=2, Sq=32, Sk=48, H=4, Hkv=2, dh=16, dv=16, causal=False),
}
_FLASH_OUT: dict = {}


def _flash_kw(c):
    return dict(causal=c.get("causal", True), window=c.get("window", 0),
                softcap=c.get("softcap", 0.0), q_offset=c.get("q_offset", 0),
                block_q=16, block_k=16)


def _flash_inputs(c, seed):
    rng = np.random.default_rng(seed)
    shapes = ((c["B"], c["Sq"], c["H"], c["dh"]), (c["B"], c["Sk"], c["Hkv"], c["dh"]),
              (c["B"], c["Sk"], c["Hkv"], c["dv"]), (c["B"], c["Sq"], c["H"], c["dv"]))
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _flash_reference():
    """Every case's reference output and gradients, from one compile."""
    if not _FLASH_OUT:
        names = list(FLASH_CASES)

        def all_cases(args):
            out = []
            for name, (q, k, v, w) in zip(names, args):
                kw = _flash_kw(FLASH_CASES[name])

                def f(q, k, v):
                    o = jflash.flash_attention(q, k, v, **kw)
                    return (o * w).sum(), o

                (_, o), g = jax.value_and_grad(f, argnums=(0, 1, 2),
                                               has_aux=True)(q, k, v)
                out.append((o, *g))
            return out

        args = [_flash_inputs(FLASH_CASES[n], i) for i, n in enumerate(names)]
        res = fast_jit(all_cases)(args)
        _FLASH_OUT.update({n: (a, r) for n, a, r in zip(names, args, res)})
    return _FLASH_OUT


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_and_grads_match_reference(case):
    (q, k, v, w), want = _flash_reference()[case]
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tflash.flash_attention(qt, kt, vt, **_flash_kw(FLASH_CASES[case]))
    (o * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((o, qt.grad, kt.grad, vt.grad), want):
        assert_rel(got.detach(), ref, 5e-6)
    if case == "dead_rows":
        assert not o.detach()[:, :16].any() and not qt.grad[:, :16].any()


def test_attention_layer_matches_reference():
    rng = np.random.default_rng(3)
    d, H, Hkv, dh = 32, 4, 2, 8
    p = {"wq": rng.normal(size=(d, H * dh)), "wk": rng.normal(size=(d, Hkv * dh)),
         "wv": rng.normal(size=(d, Hkv * dh)), "wo": rng.normal(size=(H * dh, d)),
         "q_norm": 0.1 * rng.normal(size=dh), "k_norm": 0.1 * rng.normal(size=dh)}
    p = {n: (x / np.sqrt(x.shape[0]) if x.ndim == 2 else x).astype(np.float32)
         for n, x in p.items()}
    x = rng.normal(size=(LM_B, 48, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(48, dtype=np.int32) + 100, (LM_B, 48)).copy()
    kv = [rng.normal(size=(LM_B, 40, Hkv, dh)).astype(np.float32) for _ in range(2)]
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=dh, rope_theta=10_000.0,
              qk_norm=True, window=16, softcap=20.0)

    def ref(p, x, pos, kv):
        own = jlayers.attention(p, x, pos, **kw)
        cross = jlayers.attention(p, x, pos, **kw, cross_kv=tuple(kv))
        return own, cross

    (o, (k, v)), (oc, _) = fast_jit(ref)(p, x, pos, kv)
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    got, (gk, gv) = tlayers.attention(tp, torch.from_numpy(x),
                                      torch.from_numpy(pos), **kw)
    for a, b in ((got, o), (gk, k), (gv, v)):
        assert_rel(a, b, 5e-6)
    got_c, _ = tlayers.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                                 **kw, cross_kv=tuple(map(torch.from_numpy, kv)))
    assert_rel(got_c, oc, 5e-6)
