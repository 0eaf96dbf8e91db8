"""deepseek-coder-33b [arXiv:2401.14196; hf]: llama-arch dense,
62L d7168 56H GQA(kv=8) ff19200 vocab 32256."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256, rope_theta=1e5,
)

SMOKE = ModelConfig(
    arch_id="deepseek-coder-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab=256,
    dtype="float32",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
