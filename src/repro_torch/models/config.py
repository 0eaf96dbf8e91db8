"""Model configuration for all assigned architectures — a copy of
``repro.models.config`` (the port imports nothing of ``repro``).

One dataclass covers every family; family-specific fields are ignored by the
others. Exact per-arch values live in repro_torch/configs/<arch>.py.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Family

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None        # default d_model // n_heads

    ffn_kind: Literal["swiglu", "geglu"] = "swiglu"
    attn_window: int | None = None     # sliding-window attention (mixtral)
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0                 # routed experts (0 = dense FFN)
    n_shared_experts: int = 0          # deepseek shared expert(s)
    top_k: int = 2
    moe_d_ff: int = 0                  # routed-expert hidden dim
    n_dense_layers: int = 0            # leading layers that keep dense FFN
    capacity_factor: float = 1.25

    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- hybrid / ssm ---
    ssm_state: int = 0                 # Mamba2 state size N (0 = no ssm)
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0                # zamba2: shared attn block every k layers
    rwkv: bool = False                 # RWKV6 time/channel mix blocks

    # --- vlm ---
    cross_attn_every: int = 0          # cross-attn to vision every k layers
    n_vision_tokens: int = 1601        # stub frontend output length

    # --- audio (enc-dec) ---
    enc_dec: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500         # stub conv frontend output length

    # --- numerics / compile ---
    dtype: str = "bfloat16"
    remat: bool = True                 # activation checkpointing per layer
    moe_groups: int = 1                # dispatch groups (= data shards)
    # attention implementation for train/prefill self-attention:
    #   "einsum" — materialized-score SDPA (paper-faithful baseline)
    #   "flash"  — the flash-attention kernel (in the port: K5, the CUDA
    #              kernel in repro_torch/kernels/csrc/flash_attention.cu)
    attn_impl: str = "einsum"
    # expert-parallel dispatch axes for MoE all-to-all re-sharding
    # (§Perf: deepseek-v3); None disables the constraint.
    ep_axes: tuple | None = None

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        D, V, L = self.d_model, self.vocab, self.n_layers
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.rwkv:
            att = L * (4 * D * D + 6 * D)        # r,k,v,g,o + mixes/decay
            ffn = L * 2 * D * self.d_ff          # rwkv channel mix (r,k,v ~ 2x)
            return emb + att + ffn
        hd = self.hd
        if self.use_mla:
            att_l = (D * self.q_lora_rank
                     + self.q_lora_rank * self.n_heads
                     * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                     + D * (self.kv_lora_rank + self.qk_rope_head_dim)
                     + self.kv_lora_rank * self.n_heads
                     * (self.qk_nope_head_dim + self.v_head_dim)
                     + self.n_heads * self.v_head_dim * D)
        else:
            att_l = (D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd
                     + self.n_heads * hd * D)
        n_ff = 3 * D * self.d_ff
        moe_l = 0
        if self.is_moe:
            moe_l = (self.n_experts * 3 * D * self.moe_d_ff
                     + self.n_shared_experts * 3 * D * self.moe_d_ff
                     + D * self.n_experts)
            n_moe_layers = L - self.n_dense_layers
            ffn_total = self.n_dense_layers * n_ff + n_moe_layers * moe_l
        else:
            ffn_total = L * n_ff
        ssm_l = 0
        if self.ssm_state:
            d_in = self.ssm_expand * D
            ssm_l = L * (D * 2 * d_in + d_in * D + D * d_in // 2)
        layers = L * att_l if not self.ssm_state else 0
        if self.attn_every:   # zamba2: ONE shared attn block (attn + its FFN)
            layers = att_l
            ffn_total = n_ff
        if self.enc_dec:
            layers = (self.n_encoder_layers + L) * att_l + L * att_l  # + cross
            ffn_total = (self.n_encoder_layers + L) * n_ff
        if self.cross_attn_every:
            layers += (L // self.cross_attn_every) * att_l
        return emb + layers + ffn_total + ssm_l

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        n_moe_layers = self.n_layers - self.n_dense_layers
        all_experts = n_moe_layers * self.n_experts * 3 * self.d_model * self.moe_d_ff
        active = n_moe_layers * (self.top_k + self.n_shared_experts) \
            * 3 * self.d_model * self.moe_d_ff
        return full - all_experts + active
