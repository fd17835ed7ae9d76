"""Model configuration schema, a copy of the reference's ``configs/base.py``.

One flat dataclass covers the reference's whole zoo; family-specific fields
default off.  The port keeps its own copy so that it never imports the
reference package.  Every ``configs/<arch>.py`` exports ``CONFIG`` (the
exact published shape) and ``smoke()`` (a reduced same-family config for
CPU tests).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 → d_model // n_heads

    # attention variants
    qk_norm: bool = False
    attn_softcap: float = 0.0            # gemma2 logit softcapping
    final_softcap: float = 0.0
    local_window: int = 0                # sliding-window size for local layers
    local_global_period: int = 0         # every Nth layer is global (0 = all global)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    sandwich_norm: bool = False          # gemma pre+post block norms
    scale_embeddings: bool = False       # gemma sqrt(d_model) embedding scale
    mlp_act: str = "silu"                # "silu" (gated) | "gelu"

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_topk: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0              # leading dense layers before MoE
    moe_aux_coef: float = 0.01
    capacity_factor: float = 1.25

    # MLA (deepseek-v3)
    use_mla: bool = False
    mla_d_c: int = 0                     # kv latent dim
    mla_d_cq: int = 0                    # q latent dim (0 = no q compression)
    mla_rope_dim: int = 0

    # MTP (deepseek-v3)
    mtp_depth: int = 0
    mtp_coef: float = 0.1

    # SSM / hybrid (zamba2-style mamba2 backbone)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0                  # hybrid: shared attn block period

    # xLSTM
    xlstm_pattern: Tuple[str, ...] = ()  # e.g. ("m", "s") repeated

    # encoder-decoder (whisper)
    n_enc_layers: int = 0                # >0 → enc-dec; n_layers = decoder layers
    enc_frames: int = 1500               # stub audio frontend sequence length

    # VLM (internvl2)
    n_patches: int = 0                   # stub vision frontend patch count

    # numerics
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    # distribution hints
    remat: bool = True
    scan_layers: bool = True
    seq_parallel: bool = False   # Megatron-SP residual stream (d_model>=4096)
    grad_microbatches: int = 1   # gradient accumulation (peak-memory / overlap)
    grad_accum_dtype: str = "float32"   # bf16 halves the accumulator for 100B+
    fsdp_over_pod: bool = False  # ZeRO params across pods too (100B+ models)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def has_decode(self) -> bool:
        """Encoder-only archs have no decode step; everything here decodes."""
        return True

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic structure → runs the long_500k shape (DESIGN.md §3)."""
        return self.family in ("ssm", "hybrid") or self.local_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline MODEL_FLOPS)."""
        d, V = self.d_model, self.vocab
        dh = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        n = emb
        if self.family == "ssm":       # xlstm
            d_in = self.ssm_expand * d
            per = 2 * d * d_in + d_in * d + 4 * d_in  # proj + gates (approx)
            return n + self.n_layers * per
        att = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) \
            + (self.n_heads * dh) * d
        if self.use_mla:
            att = d * self.mla_d_c + self.mla_d_c * self.n_heads * dh * 2 \
                + d * (self.mla_d_cq or d) // 1 + self.n_heads * dh * d
        mlp_dense = 3 * d * self.d_ff
        if self.n_experts:
            moe = self.n_experts * 3 * d * self.d_ff_expert \
                + self.n_shared_experts * 3 * d * self.d_ff_expert + d * self.n_experts
            n_moe_layers = self.n_layers - self.n_dense_layers
            n += self.n_dense_layers * (att + mlp_dense) \
                + n_moe_layers * (att + moe)
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            mamba = d * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim) \
                + d_in * d
            n_attn = max(1, self.n_layers // max(self.attn_every, 1)) if self.attn_every else 0
            n += self.n_layers * (mamba + 2 * d * d) + (att + mlp_dense)  # shared blk once
        else:
            n += self.n_layers * (att + mlp_dense)
        if self.is_encdec:
            n += self.n_enc_layers * (att + mlp_dense) + self.n_layers * att  # cross-attn
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        all_experts = (self.n_layers - self.n_dense_layers) * self.n_experts \
            * 3 * self.d_model * self.d_ff_expert
        active_experts = (self.n_layers - self.n_dense_layers) * self.moe_topk \
            * 3 * self.d_model * self.d_ff_expert
        return full - all_experts + active_experts


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str      # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
