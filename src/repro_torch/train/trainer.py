"""Resumable trainer: checkpoint/restart, straggler monitor, drift hooks.

The port of the reference's ``train/trainer.py``.  Contract:

  * checkpoints every ``ckpt_every`` steps and at the last step through the
    async writer (`checkpoint.AsyncCheckpointer`, the reference's format:
    either package restores the other's), which copies the state to the
    host, on the card or on the host alike, before the next step updates
    it in place;
  * ``Trainer.run`` resumes bit-exact from the latest checkpoint
    (parameters, optimizer state, step counter and data-stream position);
  * per-step wall times feed a robust straggler detector (median absolute
    deviation);
  * with ``monitor_drift`` every batch passes the SW-AKDE drift monitor
    (`data.pipeline.DriftMonitor`) before its step.

The starting state is drawn from the port's generator (``seed``), or handed
over as the reference's parameter tree in numpy (the optimizer state then
starts empty, as the reference's ``init_state`` starts it).

With a ``mesh`` (`parallel.sharding.Mesh` with ``data`` and ``model`` axes)
the state lives on the mesh (`train_step.make_train_step`), each batch is
split over its data axes from the host, and a checkpoint holds the
gathered tree in the reference's format (assembled on the host); a resume
restores it on the host and places it by the running state's specs.

The token stream feeds tokens alone, so the families whose batches also
hold a frontend's outputs (encdec's ``frames``, vlm's ``patches``) are
refused: they train through `train_step.make_train_step` on
`launch.inputs.make_batch`'s batches, on one device or a mesh.
``ckpt_every <= 0`` writes no checkpoint at all (the port's addition: a
state too large to gather on the host, as a model trained across cards
is).
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import convert
from ..checkpoint import checkpoint as ckpt_lib
from ..configs.base import ModelConfig
from ..core.util import resolve_device
from ..data.pipeline import DataConfig, DriftMonitor, TokenStream
from ..optim.adam import OPTIMIZERS, init_on_mesh
from ..parallel import param_specs
from .train_step import TrainState, make_train_step, shard_state


class StragglerMonitor:
    """Flags steps (hosts, on a real cluster) whose duration exceeds
    median + k * MAD — robust to the heavy-tailed step-time distribution."""

    def __init__(self, k: float = 6.0, min_history: int = 16):
        self.k = k
        self.min_history = min_history
        self.times: list[float] = []

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        h = np.asarray(self.times[-256:])
        if len(h) < self.min_history:
            return False
        med = np.median(h)
        mad = np.median(np.abs(h - med)) + 1e-9
        return bool(dt > med + self.k * mad)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    optimizer: str = "adamw"
    lr: float = 3e-4
    log_every: int = 10
    monitor_drift: bool = True


class Trainer:
    """``device`` holds the model, the optimizer state and the drift
    monitor (the card by default; raises without one); with a ``mesh`` the
    model and the optimizer state live on the mesh, the monitor and the
    step counter on its first device."""

    def __init__(self, model_cfg: ModelConfig, data_cfg: DataConfig,
                 cfg: TrainerConfig, device="cuda",
                 log_fn: Callable[[str], None] = print, mesh=None):
        if model_cfg.family in ("encdec", "vlm"):
            raise ValueError(
                f"{model_cfg.arch_id}: the Trainer feeds tokens only, and a "
                f"{model_cfg.family} batch also needs its frontend's "
                "outputs; train it through train_step.make_train_step with "
                "launch.inputs.make_batch")
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None \
            else resolve_device(device)
        self.log = log_fn
        opt = OPTIMIZERS[cfg.optimizer](lr=cfg.lr)
        self.optimizer = opt
        self._step_fn, self._init_fn = make_train_step(model_cfg, opt, mesh)
        self.ckpt = ckpt_lib.AsyncCheckpointer()
        self.straggler = StragglerMonitor()
        self.monitor = (DriftMonitor(data_cfg, self.device)
                        if cfg.monitor_drift else None)
        self.history: list[dict] = []

    def _ckpt_path(self, step: int) -> pathlib.Path:
        return pathlib.Path(self.cfg.ckpt_dir) / f"step_{step}"

    def _start_state(self, seed: int, init) -> TrainState:
        if init is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return self._init_fn(gen, self.device)
        step = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.mesh is not None:
            params = param_specs.shard_params(
                convert.train_params_from_numpy(init, "cpu"), self.mesh,
                fsdp_over_pod=self.model_cfg.fsdp_over_pod)
            return TrainState(params=params,
                              opt_state=init_on_mesh(self.optimizer, params),
                              step=step)
        params = convert.train_params_from_numpy(init, self.device)
        return TrainState(params=params,
                          opt_state=self.optimizer.init(params), step=step)

    def _restore(self, path, state: TrainState, stream):
        """The checkpoint at ``path`` into ``state``'s structure (on the
        mesh: restored on the host, placed by ``state``'s specs)."""
        if self.mesh is None:
            payload = {"state": state, "stream": stream.state()}
            return ckpt_lib.restore(path, payload, self.device)
        like = param_specs.meta_like(state)
        payload, step = ckpt_lib.restore(
            path, {"state": like, "stream": stream.state()}, "cpu")
        restored = shard_state(payload["state"], self.mesh, like=state)
        return {"state": restored, "stream": payload["stream"]}, step

    def _saved(self, state: TrainState):
        """What a checkpoint holds: the state, gathered on the host on a
        mesh."""
        if self.mesh is None:
            return state
        return param_specs.gather_params(state, device="cpu")

    def run(self, seed: int = 0, init=None) -> dict:
        stream = TokenStream(self.data_cfg)
        state = self._start_state(seed, init)
        start = 0
        latest = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if latest is not None:
            payload, step = self._restore(self._ckpt_path(latest), state,
                                          stream)
            state, start = payload["state"], step
            stream.restore(payload["stream"])
            self.log(f"[trainer] resumed from step {start}")

        metrics = {}
        for step in range(start, self.cfg.steps):
            tokens = stream.next_batch()
            drift = self.monitor.observe(tokens) if self.monitor else None
            batch = {"tokens": torch.from_numpy(tokens)}
            if self.mesh is None:
                batch["tokens"] = batch["tokens"].to(self.device)
            t0 = time.time()
            state, metrics = self._step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            slow = self.straggler.observe(dt)
            rec = {"step": step + 1, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "dt": dt, "straggler": slow}
            if drift:
                rec["drift"] = drift
            self.history.append(rec)
            if (step + 1) % self.cfg.log_every == 0:
                self.log(f"[trainer] step {step+1} loss {rec['loss']:.4f} "
                         f"({dt*1e3:.0f} ms{' STRAGGLER' if slow else ''})")
            if self.cfg.ckpt_every > 0 and (
                    (step + 1) % self.cfg.ckpt_every == 0
                    or step + 1 == self.cfg.steps):
                self.ckpt.save(self._ckpt_path(step + 1),
                               {"state": self._saved(state),
                                "stream": stream.state()},
                               step + 1)
        self.ckpt.wait()
        return {"state": state, "metrics": metrics, "history": self.history}
