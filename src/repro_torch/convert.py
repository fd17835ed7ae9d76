"""Carry parameters and sketch states between the reference and the port.

The reference's objects travel as plain dicts of numpy arrays (and ints or
floats for static fields), so this module needs neither JAX nor the
reference package: a caller builds the dict from the reference object
(``{f: np.asarray(getattr(p, f)) ...}``), and `*_from_numpy` places the
values on ``device`` as the port's tensors.  `to_numpy` goes back.

The reference's uint32 ``mix`` multipliers and threefry keys become int64
tensors holding the same values; every other leaf keeps its dtype (int32,
float32, bool).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.eh import EHState
from .core.jl import JLState
from .core.lsh import PStableParams, SRPParams
from .core.race import RACEState
from .core.sann import SANNState
from .core.swakde import BatchSWAKDEState, SWAKDEState
from .core.util import resolve_device


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _mix(x, device) -> torch.Tensor:
    return _tensor(np.asarray(x, dtype=np.uint32).astype(np.int64), device)


def params_from_numpy(d: Mapping[str, Any], device="cuda"):
    """``PStableParams`` (when ``d`` has a ``bias``) or ``SRPParams``."""
    device = resolve_device(device)
    common = dict(proj=_tensor(d["proj"], device), mix=_mix(d["mix"], device),
                  L=int(d["L"]), k=int(d["k"]), n_buckets=int(d["n_buckets"]))
    if "bias" in d:
        return PStableParams(bias=_tensor(d["bias"], device), w=float(d["w"]),
                             **common)
    return SRPParams(**common)


def _state(cls, d: Mapping[str, Any], device):
    device = resolve_device(device)
    return cls(**{f: _tensor(d[f], device) for f in cls._fields})


def sann_state_from_numpy(d: Mapping[str, Any], device="cuda") -> SANNState:
    return _state(SANNState, d, device)


def race_state_from_numpy(d: Mapping[str, Any], device="cuda") -> RACEState:
    return _state(RACEState, d, device)


def swakde_state_from_numpy(d: Mapping[str, Any], device="cuda") -> SWAKDEState:
    return _state(SWAKDEState, d, device)


def eh_state_from_numpy(d: Mapping[str, Any], device="cuda") -> EHState:
    """An ``EHState`` (or ``SumEHState``, the same layout)."""
    return _state(EHState, d, device)


def batch_swakde_state_from_numpy(d: Mapping[str, Any],
                                  device="cuda") -> BatchSWAKDEState:
    return _state(BatchSWAKDEState, d, device)


def jl_state_from_numpy(d: Mapping[str, Any], device="cuda") -> JLState:
    return _state(JLState, d, device)


def key_from_numpy(key, device="cuda") -> torch.Tensor:
    """A reference threefry key (uint32 ``(..., 2)``) → int64 tensor."""
    device = resolve_device(device)
    return _mix(key, device)


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """A port key → the reference's uint32 ``(..., 2)`` array."""
    return key.detach().cpu().numpy().astype(np.uint32)


def to_numpy(obj) -> dict:
    """A port params or state object → dict of numpy arrays (and the static
    ints and floats), ``mix`` back as uint32."""
    out = {}
    for name, value in obj._asdict().items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
            if name == "mix":
                value = value.astype(np.uint32)
        out[name] = value
    return out
