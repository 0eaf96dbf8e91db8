"""gemma-7b [arXiv:2403.08295; hf]: 28L d3072 16H (kv=16) ff24576
vocab 256000, GeGLU, head_dim 256, tied embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    d_ff=24576, vocab=256000, head_dim=256,
    ffn_kind="geglu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch_id="gemma-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=192, vocab=512, head_dim=32,
    ffn_kind="geglu", tie_embeddings=True,
    dtype="float32",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
