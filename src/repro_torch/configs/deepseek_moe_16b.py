"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066; hf].

28L d_model=2048 16H (kv=16) expert_d_ff=1408 vocab=102400; first layer is
dense (d_ff=10944).
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab=102400, head_dim=128,
    n_experts=64, n_shared_experts=2, moe_topk=6, d_ff_expert=1408,
    n_dense_layers=1,
    seq_parallel=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, n_experts=8, n_shared_experts=1, moe_topk=2,
        d_ff_expert=32, n_dense_layers=1)
