"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf].

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000 ssm_state=64; a single
shared transformer block is applied every 6 mamba layers (weights shared).
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_chunk=64,
    attn_every=6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, ssm_state=8, ssm_head_dim=16, ssm_chunk=16,
        attn_every=2)
