"""mixtral-8x7b [arXiv:2401.04088; hf]: 32L d4096 32H GQA(kv=8) ff14336
vocab 32000, MoE 8 experts top-2, sliding-window attention."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    n_experts=8, top_k=2, moe_d_ff=14336,
    attn_window=4096, rope_theta=1e6,
)

SMOKE = ModelConfig(
    arch_id="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    n_experts=4, top_k=2, moe_d_ff=128,
    attn_window=16,
    dtype="float32",
)

# full attention over 32k context (SWA bounds the window but the published
# config uses 32k context); long_500k skipped per assignment rule.
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
