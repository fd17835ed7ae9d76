"""Architecture registry: ``arch_id`` → ``ModelConfig``.

Lists only the configurations the port runs (the dense family's decode,
``serve/serve_step.py``).  The reference's other architectures are still
to be ported (``ROADMAP.md``, queue 1); asking for one raises.
"""
from __future__ import annotations

from . import gemma2_27b, gemma3_4b, qwen3_4b
from .base import ModelConfig

_MODULES = {
    "qwen3-4b": qwen3_4b,
    "gemma2-27b": gemma2_27b,
    "gemma3-4b": gemma3_4b,
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise ValueError(
            f"{arch_id!r} is not ported yet (the port runs {ARCH_IDS}; "
            "see ROADMAP.md, queue 1)")
    return _MODULES[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()
