"""llama-3.2-vision-90b [hf]: 100L d8192 64H GQA(kv=8) ff28672 vocab 128256;
gated cross-attention to vision tokens every 5th layer; vision tower is a
STUB (input_specs provides patch embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, rope_theta=5e5,
    cross_attn_every=5, n_vision_tokens=1601,
)

SMOKE = ModelConfig(
    arch_id="llama32v-smoke", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    cross_attn_every=2, n_vision_tokens=16,
    dtype="float32",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
