"""Architecture registry: ``arch_id`` → ``ModelConfig``.

Lists the reference's ten architectures.  Every family decodes
(``serve/serve_step.py``) and trains (``models.model.forward``,
``train/train_step.py``), on one device and on a ``(data, model)`` mesh.
"""
from __future__ import annotations

from . import (deepseek_moe_16b, deepseek_v3_671b, gemma2_27b, gemma3_4b,
               granite_8b, internvl2_76b, qwen3_4b, whisper_large_v3,
               xlstm_125m, zamba2_2p7b)
from .base import ModelConfig

_MODULES = {
    "zamba2-2.7b": zamba2_2p7b,
    "qwen3-4b": qwen3_4b,
    "granite-8b": granite_8b,
    "gemma2-27b": gemma2_27b,
    "gemma3-4b": gemma3_4b,
    "whisper-large-v3": whisper_large_v3,
    "deepseek-moe-16b": deepseek_moe_16b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "xlstm-125m": xlstm_125m,
    "internvl2-76b": internvl2_76b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].smoke()
