"""seamless-m4t-medium [arXiv:2308.11596] — enc-dec; audio frontend stubbed."""

from .base import ModelConfig, register


@register("seamless-m4t-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec", n_layers=12, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=256206,
        n_enc_layers=12, enc_frames_decode=4096)
