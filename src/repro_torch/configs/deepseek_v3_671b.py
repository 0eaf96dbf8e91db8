"""deepseek-v3-671b [arXiv:2412.19437; hf]: 61L d7168 128H MLA ff2048(routed)
vocab 129280, 1 shared + 256 routed experts top-8. MTP head omitted
(DESIGN.md §Arch-applicability)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,                   # dense-layer FFN width
    vocab=129280,
    n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    n_dense_layers=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    arch_id="deepseek-v3-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab=256,
    n_experts=8, n_shared_experts=1, top_k=2, moe_d_ff=48,
    n_dense_layers=1,
    use_mla=True, q_lora_rank=32, kv_lora_rank=16,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    dtype="float32",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")  # full (latent) attention
