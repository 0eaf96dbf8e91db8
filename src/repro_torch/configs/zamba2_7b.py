"""zamba2-7b [arXiv:2411.15242]: hybrid — 81 Mamba2 layers with a SHARED
full-attention block applied every 6 layers; d3584 32H ff14336 vocab 32000,
ssm_state 64."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
)

SMOKE = ModelConfig(
    arch_id="zamba2-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, attn_every=2,
    dtype="float32",
)

# sub-quadratic (SSM core): long_500k applies.
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
