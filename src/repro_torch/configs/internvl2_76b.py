"""internvl2-76b — InternViT (stub) + InternLM2-style 70B-class backbone
[arXiv:2404.16821; unverified].

80L d_model=8192 64H (kv=8) d_ff=28672 vocab=128256; the vision frontend is
a stub: input_specs() provides 256 precomputed patch embeddings per example,
projected and prepended to the token sequence.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    n_patches=256,
    seq_parallel=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, n_patches=8)
