"""gemma2-27b — local+global alternating, logit softcap [arXiv:2408.00118; hf].

46L d_model=4608 32H (kv=16) d_ff=36864 vocab=256000; 1:1 local:global with
4096-token sliding window; attn softcap 50, final softcap 30; sandwich norms.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
    d_ff=36864, vocab=256000, head_dim=128,
    attn_softcap=50.0, final_softcap=30.0,
    local_window=4096, local_global_period=2,
    sandwich_norm=True, scale_embeddings=True, mlp_act="gelu",
    seq_parallel=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, local_window=32)
