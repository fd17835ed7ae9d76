"""Counter-based random keys, bit-identical to JAX's default threefry keys.

The reference draws every S-ANN keep decision from a threefry-2x32 key
(``jax.random.fold_in`` + ``jax.random.bernoulli``, with
``jax_threefry_partitionable`` on).  This module reproduces those bits in
integer tensor arithmetic, so the same seed keeps the same points in both
packages and the keep schedule stays prefix-stable across chunk lengths.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words,
as ``jax.random.PRNGKey`` holds them.  Every word stays in [0, 2^32): each
add and rotate is masked, in the style of `kernels.ref.mul32`, so the
arithmetic is exact on every device.  The recipes, for partitionable threefry:

* ``fold_in(key, i) == threefry2x32(key, (0, i))``;
* ``split(key, n)[i] == fold_in(key, i)``;
* ``bits32(key) == x0 ^ x1`` with ``(x0, x1) = threefry2x32(key, (0, 0))``;
* ``bernoulli(key, p)``: the 23 high bits of ``bits32`` as a float in
  [1, 2), minus 1, compared with ``float32(p)``.
"""
from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """The key ``jax.random.PRNGKey(seed)`` gives for a seed in [0, 2^32)
    (JAX's default 32-bit mode): ``(0, seed)`` as a ``(2,)`` int64 tensor."""
    seed = int(seed)
    if not 0 <= seed <= _MASK32:
        raise ValueError("PRNGKey: seed must lie in [0, 2^32)")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(key: torch.Tensor, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``key (..., 2)``; every argument broadcasts against the others.
    Returns the two output words as int64 tensors in [0, 2^32).  A counter
    word may be a Python int: it stays a scalar operand, so the card gets
    no host-to-device copy."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (ks[0] + x0) & _MASK32
    x1 = (ks[1] + x1) & _MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``; ``data`` (an int or an integer
    tensor of uint32 values) broadcasts against the key's batch shape."""
    x0, x1 = threefry2x32(key, 0, data)
    return torch.stack([x0, x1], dim=-1)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(key, n)`` for a single key → ``(n, 2)`` keys."""
    return fold_in(key, torch.arange(n, dtype=torch.int64, device=key.device))


def bits32(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.bits(key, (), uint32)`` per key of ``key (..., 2)`` →
    ``(...)`` int64 holding uint32 values."""
    x0, x1 = threefry2x32(key, 0, 0)
    return x0 ^ x1


def bernoulli(key: torch.Tensor, p: float) -> torch.Tensor:
    """``jax.random.bernoulli(key, p)`` per key of ``key (..., 2)`` →
    ``(...)`` bool: a uniform float32 in [0, 1) from the key's 23 high
    bits, below ``float32(p)``."""
    mant = (bits32(key) >> 9) | 0x3F800000              # float32 bits in [1, 2)
    u = mant.to(torch.int32).view(torch.float32) - 1.0
    return u < float(torch.tensor(p, dtype=torch.float32))   # exact in fp32
