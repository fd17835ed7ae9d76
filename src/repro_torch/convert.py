"""Carry parameters and sketch states between the reference and the port.

The reference's objects travel as plain dicts of numpy arrays (and ints or
floats for static fields), so this module needs neither JAX nor the
reference package: a caller builds the dict from the reference object
(``{f: np.asarray(getattr(p, f)) ...}``), and `*_from_numpy` places the
values on ``device`` as the port's tensors.  `to_numpy` goes back.

The reference's uint32 ``mix`` multipliers and threefry keys become int64
tensors holding the same values; every other leaf keeps its dtype (int32,
float32, bfloat16, bool).

The language model's parameters and KV cache travel as the reference's
nested dicts (``jax.tree.map(np.asarray, params)``): `lm_params_from_numpy`
builds the port's `models.model.ParamTree`, `lm_cache_from_numpy` and
`lm_cache_to_numpy` carry a cache both ways.  A training state (the
reference's ``TrainState`` with any of its optimizers' states, as numpy)
crosses with `train_state_from_numpy` and `train_state_to_numpy`; with a
``mesh`` the first places the tree on it (through
`parallel.param_specs.shard_params`) and the second gathers a sharded tree
(`parallel.param_specs.gather_params`, assembled on the host).
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
from .models.model import ParamTree


def _tensor(x, device) -> torch.Tensor:
    x = np.array(x, copy=True)
    if x.dtype.name == "bfloat16":   # numpy's bfloat16 extension type
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


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


def _tree(d: Mapping[str, Any], device) -> dict:
    return {k: _tree(v, device) if isinstance(v, Mapping) else _tensor(v, device)
            for k, v in d.items()}


def lm_params_from_numpy(tree: Mapping[str, Any], device="cuda") -> ParamTree:
    """The reference's ``init_model`` pytree of any family (nested dicts of
    numpy arrays) → the port's parameter tree on ``device``, leaf for leaf,
    each leaf in its own dtype (the float32 router, ``A_log``, ``D``,
    ``dt_bias``, ``b_if`` and ``b`` stay float32)."""
    return ParamTree(_tree(tree, resolve_device(device)))


def lm_cache_from_numpy(cache: Mapping[str, Any], device="cuda", mesh=None,
                        cfg=None) -> dict:
    """A reference decode cache of any family (``k``/``v``, ``dk``/``dv``,
    ``c``/``kr``, ``ssm_state``/``conv_buf``, the xLSTM states with their
    -inf stabilisers, ``xk``/``xv``, ``block_sigs``, and a 0-d ``length``)
    → the port's cache: every leaf in its own dtype and values, ``length``
    a Python int.  With a ``mesh`` (and the model's ``cfg``) each leaf is
    placed on it per `serve.kv_cache.cache_specs` (from the host)."""
    if mesh is not None:
        from .serve import kv_cache
        return kv_cache.shard_cache(lm_cache_from_numpy(cache, "cpu"), cfg,
                                    mesh)
    device = resolve_device(device)
    return {k: int(v) if k == "length" else _tensor(v, device)
            for k, v in cache.items()}


def lm_cache_to_numpy(cache: Mapping[str, Any]) -> dict:
    """A port cache (on a mesh too: each leaf gathered) → dict of numpy
    arrays (bfloat16 leaves as float32, which holds them exactly) and
    ``length`` as an int."""
    from .parallel.sharding import Sharded
    out = {}
    for k, v in cache.items():
        if isinstance(v, Sharded):
            v = v.full("cpu")
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        out[k] = v
    return out


def _fields_of(obj) -> dict:
    return dict(obj._asdict()) if hasattr(obj, "_asdict") else dict(obj)


def train_params_from_numpy(tree: Mapping[str, Any], device="cuda",
                            mesh=None) -> dict:
    """A reference parameter pytree as numpy → nested dicts of tensors on
    ``device`` (the training layout; `lm_params_from_numpy` builds the
    decode's `ParamTree`), or with a ``mesh`` placed on it per
    `param_specs.param_shardings` (from the host)."""
    if mesh is not None:
        from .parallel import param_specs
        return param_specs.shard_params(_tree(tree, torch.device("cpu")), mesh)
    return _tree(tree, resolve_device(device))


def train_state_from_numpy(state, device="cuda", mesh=None):
    """A reference ``TrainState`` whose leaves are numpy (``params``,
    ``opt_state`` of AdamW, Adam8bit or Adafactor, ``step``) → the port's
    `train.train_step.TrainState` on ``device``, or with a ``mesh`` placed
    on it by the reference's parameter and optimizer-state specs (from the
    host).  The optimizer state's class follows its field names."""
    from .optim import adam
    from .train.train_step import TrainState, shard_state
    if mesh is not None:
        return shard_state(train_state_from_numpy(state, "cpu"), mesh)
    device = resolve_device(device)
    d = _fields_of(state)
    opt = _fields_of(d["opt_state"])
    cls = next(c for c in (adam.AdamState, adam.Adam8bitState,
                           adam.AdafactorState)
               if set(c._fields) == set(opt))
    opt_state = cls(**{f: (_tensor(v, device) if f == "step" else _tree(v, device))
                       for f, v in opt.items()})
    return TrainState(params=_tree(d["params"], device), opt_state=opt_state,
                      step=_tensor(d["step"], device))


def train_state_to_numpy(state) -> dict:
    """A port ``TrainState`` (on a mesh too) → nested dicts of numpy arrays
    (bfloat16 leaves as float32, which holds them exactly)."""
    from .parallel.sharding import Sharded

    def host(x):
        if isinstance(x, Sharded):
            x = x.full("cpu")
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        if isinstance(x, Mapping) or hasattr(x, "_asdict"):
            return {k: host(v) for k, v in _fields_of(x).items()}
        return x
    return host(state)
