"""whisper-large-v3 — audio enc-dec backbone, conv frontend stubbed
[arXiv:2212.04356; unverified].

32 encoder + 32 decoder layers, d_model=1280 20H (kv=20 = MHA) d_ff=5120
vocab=51866; the mel/conv frontend is a stub: input_specs() provides
precomputed frame embeddings (B, 1500, d_model).
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-large-v3", family="encdec",
    n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64,
    rope_theta=0.0,  # sinusoidal absolute positions
    enc_frames=1500, mlp_act="gelu",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=256, enc_frames=32)
