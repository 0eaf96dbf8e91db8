"""minitron-8b [arXiv:2407.14679; hf]: pruned nemotron, dense,
32L d4096 32H GQA(kv=8) ff16384 vocab 256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256000,
)

SMOKE = ModelConfig(
    arch_id="minitron-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab=512,
    dtype="float32",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
