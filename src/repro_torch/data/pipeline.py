"""Streaming data pipeline with the paper's SW-AKDE drift monitor.

The port of the reference's ``data/pipeline.py``.  `TokenStream` yields
fixed-shape token batches from a synthetic, seeded document stream; its
host numpy draws are the reference's, so the batches are bit-identical.
Every batch's examples are embedded on the host (a hashed bag of tokens,
numpy, as the reference computes it) and fed to a **sliding-window A-KDE**
(paper §4) on the monitor's device: the density of the batch mean under the
recent window flags distribution shift (the density collapses) and
near-duplicate floods (it spikes).

Where the reference feeds a batch's examples one by one through
``swakde_update``, the monitor feeds them as one chunk
(`core.swakde.swakde_update_chunk`'s prepare and commit), which is
bit-identical to the per-example path.  The batch mean is hashed in the
same call as the examples, so on the card a batch costs one ``srp_hash``
launch and one ``swakde_segment_pass`` launch; the density is read from the
state before the update, as ``swakde_query`` reads it.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..core import lsh, swakde
from ..core.util import mean_last, resolve_device


@dataclasses.dataclass
class DataConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    n_shards: int = 1          # simulated hosts
    shard_id: int = 0
    drift_window: int = 256    # SW-AKDE window (batches are the stream unit)
    drift_rows: int = 8
    drift_width: int = 128
    drift_dim: int = 32        # hashed token-histogram embedding dim
    prefetch: int = 2


class DriftMonitor:
    """SW-AKDE over per-example embeddings; z-scored density flags drift.

    ``params`` (optional) are SRP params for ``drift_dim`` on ``device``
    (a parity test carries the reference's across); by default they are
    drawn from a generator seeded with ``seed + 7``."""

    def __init__(self, cfg: DataConfig, device="cuda", params=None):
        self.device = resolve_device(device)
        self.cfg = swakde.SWAKDEConfig(
            L=cfg.drift_rows, W=cfg.drift_width, window=cfg.drift_window,
            eh_eps=0.2)
        if params is None:
            params = lsh.init_srp(
                torch.Generator().manual_seed(cfg.seed + 7), cfg.drift_dim,
                L=cfg.drift_rows, k=4, n_buckets=cfg.drift_width,
                device=self.device)
        self.params = params
        self.state = swakde.swakde_init(self.cfg, self.device)
        self._proj = np.random.default_rng(cfg.seed + 13).standard_normal(
            (cfg.vocab, cfg.drift_dim)).astype(np.float32) / np.sqrt(cfg.drift_dim)
        self._hist: list[float] = []

    def embed(self, tokens: np.ndarray) -> np.ndarray:
        """Hashed bag-of-tokens embedding (B, drift_dim)."""
        out = self._proj[tokens.reshape(tokens.shape[0], -1)].mean(axis=1)
        return out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-6)

    def observe(self, tokens) -> dict:
        """Density of the batch mean under the window, then the batch's
        examples enter the window (one chunk, one step per example)."""
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.cpu().numpy()
        emb = self.embed(np.asarray(tokens))
        # float64 under NumPy 2's promotion (the table is divided by a
        # float64 scalar); the reference's jnp.asarray rounds it to float32
        rows = np.concatenate([emb, emb.mean(axis=0)[None]]).astype(np.float32)
        x = torch.from_numpy(rows).to(self.device)
        codes = lsh.hash_points(self.params, x)                 # (B + 1, L)
        est = swakde.swakde_row_estimates_from_codes(self.state, codes[-1],
                                                     self.cfg)
        density_t = mean_last(est)
        prep = swakde.swakde_prepare_from_codes(codes[:-1], self.cfg)
        self.state = swakde.swakde_commit_chunk(self.state, prep, self.cfg)
        density = float(density_t)
        warm = len(self._hist) >= 8
        recent = float(np.median(self._hist[-16:])) if warm else density
        self._hist.append(density)
        hist = np.asarray(self._hist[-64:])
        mu, sd = float(hist.mean()), float(hist.std() + 1e-6)
        return {"density": density, "z": (density - mu) / sd,
                # relative drop/spike vs the recent plateau — robust to the
                # warmup ramp of the sliding window
                "drift": bool(warm and density < 0.4 * max(recent, 1e-6)),
                "dup_flood": bool(warm and density > 2.5 * max(recent, 1e-6))}


class TokenStream:
    """Deterministic synthetic document stream, shardable by host."""

    def __init__(self, cfg: DataConfig, drift_at: Optional[int] = None):
        self.cfg = cfg
        self.drift_at = drift_at
        self._i = 0

    def next_batch(self) -> np.ndarray:
        c = self.cfg
        rng = np.random.default_rng(
            hash((c.seed, c.shard_id, self._i)) % 2**32)
        # zipf-ish unigram stream; optional distribution shift for tests
        alpha = 1.3 if (self.drift_at is None or self._i < self.drift_at) else 2.5
        toks = rng.zipf(alpha, size=(c.batch, c.seq)).astype(np.int64)
        offset = 0 if (self.drift_at is None or self._i < self.drift_at) \
            else c.vocab // 2
        toks = (toks + offset) % c.vocab
        self._i += 1
        return toks.astype(np.int32)

    def state(self) -> dict:
        return {"i": self._i}

    def restore(self, state: dict) -> None:
        self._i = int(state["i"])  # may arrive as a restored 0-d tensor


def batches(cfg: DataConfig, monitor: Optional[DriftMonitor] = None,
            drift_at: Optional[int] = None,
            device="cuda") -> Iterator[dict]:
    """Prefetching iterator of {'tokens': (B, S) int32 on ``device``,
    'drift': metrics}.  A daemon thread draws the batches ahead."""
    device = resolve_device(device)
    stream = TokenStream(cfg, drift_at=drift_at)
    q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)

    def producer():
        while True:
            q.put(stream.next_batch())

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        toks = q.get()
        out = {"tokens": torch.from_numpy(toks).to(device)}
        if monitor is not None:
            out["drift"] = monitor.observe(toks)
        yield out
