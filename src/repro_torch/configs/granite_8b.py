"""granite-8b — llama-arch dense GQA, code model [arXiv:2405.04324; hf].

36L d_model=4096 32H (kv=8) d_ff=14336 vocab=49152.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152, head_dim=128,
    seq_parallel=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256)
