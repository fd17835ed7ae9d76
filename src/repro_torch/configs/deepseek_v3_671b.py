"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf].

61L d_model=7168 128H expert_d_ff=2048 vocab=129280; first 3 layers dense
(d_ff=18432); MLA latent d_c=512, q latent 1536, decoupled rope dim 64;
depth-1 multi-token prediction head.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab=129280, head_dim=128,
    n_experts=256, n_shared_experts=1, moe_topk=8, d_ff_expert=2048,
    n_dense_layers=3,
    use_mla=True, mla_d_c=512, mla_d_cq=1536, mla_rope_dim=64,
    mtp_depth=1,
    seq_parallel=True,
    grad_microbatches=8, grad_accum_dtype="bfloat16", fsdp_over_pod=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, n_experts=8, n_shared_experts=1, moe_topk=2,
        d_ff_expert=32, n_dense_layers=1,
        mla_d_c=32, mla_d_cq=48, mla_rope_dim=8)
