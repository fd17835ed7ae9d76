"""qwen3-4b — dense GQA with qk-norm [hf:Qwen/Qwen3-8B; hf].

36L d_model=2560 32H (kv=8) d_ff=9728 vocab=151936.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
    seq_parallel=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256)
