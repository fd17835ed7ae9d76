"""xlstm-125m — alternating sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H vocab=50304; d_ff=0 in the assignment (blocks carry their
own projections; the sLSTM block has a 4/3-factor post-FFN).
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=192,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
        vocab=256)
