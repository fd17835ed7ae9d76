"""Model inputs: the shapes of one train or prefill step and concrete random
batches.

The port of the reference's ``launch/inputs.py``: ``batch_shapes`` and
``make_batch``.  Its ``input_specs`` (shape stand-ins for the multi-pod
dry-run) waits for the port of ``launch/dryrun.py``.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models.model import VIT_DIM


def batch_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """``{name: (shape, dtype)}`` of one step's inputs: ``tokens``, and the
    stub frontends' ``patches`` (vlm: ``seq`` counts them) or ``frames``
    (encdec)."""
    shapes = {}
    if cfg.family == "vlm":
        text = seq - cfg.n_patches
        if text <= 0:
            raise ValueError(f"vlm: seq {seq} leaves no text after "
                             f"{cfg.n_patches} patches")
        shapes["tokens"] = ((batch, text), torch.int32)
        shapes["patches"] = ((batch, cfg.n_patches, VIT_DIM), torch.bfloat16)
    elif cfg.family == "encdec":
        shapes["tokens"] = ((batch, seq), torch.int32)
        shapes["frames"] = ((batch, cfg.enc_frames, cfg.d_model),
                            torch.bfloat16)
    else:
        shapes["tokens"] = ((batch, seq), torch.int32)
    return shapes


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               gen: torch.Generator) -> dict:
    """A random batch drawn from ``gen`` on its device: tokens uniform in
    ``[0, vocab)``, frontend embeddings ``0.02 * normal``."""
    out = {}
    for name, (shape, dt) in batch_shapes(cfg, batch, seq).items():
        if dt == torch.int32:
            out[name] = torch.randint(0, cfg.vocab, shape, generator=gen,
                                      dtype=dt, device=gen.device)
        else:
            out[name] = (0.02 * torch.randn(shape, generator=gen,
                                            device=gen.device)).to(dt)
    return out
