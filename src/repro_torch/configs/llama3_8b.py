"""llama3-8b [arXiv:2407.21783]: 32L d4096 32H GQA(kv=8) ff14336 vocab 128256."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, rope_theta=5e5,
)

SMOKE = ModelConfig(
    arch_id="llama3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab=256,
    dtype="float32",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
