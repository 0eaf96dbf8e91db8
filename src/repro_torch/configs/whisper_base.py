"""whisper-base [arXiv:2212.04356]: enc-dec, 6+6L d512 8H ff2048 vocab 51865;
conv audio frontend is a STUB (input_specs provides frame embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865,
    enc_dec=True, n_encoder_layers=6, n_audio_frames=1500,
)

SMOKE = ModelConfig(
    arch_id="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
    enc_dec=True, n_encoder_layers=2, n_audio_frames=32,
    dtype="float32",
)

# enc-dec: decoder KV-cache decode applies; long_500k (full attention) skipped.
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
