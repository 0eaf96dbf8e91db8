"""rwkv6-1.6b 'Finch' [arXiv:2404.05892]: attention-free, 24L d2048 ff7168
vocab 65536, data-dependent decay."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,  # heads = D/64
    d_ff=7168, vocab=65536, rwkv=True,
)

SMOKE = ModelConfig(
    arch_id="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
    d_ff=256, vocab=256, rwkv=True,
    dtype="float32",
)

# attention-free: long_500k applies (state is O(1)).
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
