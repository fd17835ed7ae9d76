"""gemma3-4b — 5:1 local:global, 128k context [hf:google/gemma-3-1b-pt; unverified].

34L d_model=2560 8H (kv=4) d_ff=10240 vocab=262144; window 1024 locals,
qk-norm, sandwich norms, no softcap (gemma3 replaced it with qk-norm).
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab=262144, head_dim=256,
    qk_norm=True, local_window=1024, local_global_period=6,
    rope_theta=1_000_000.0,
    sandwich_norm=True, scale_embeddings=True, mlp_act="gelu",
    seq_parallel=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, local_window=32, local_global_period=3)
