"""tinyllama-1.1b [arXiv:2401.02385]."""

from .base import ModelConfig, register


@register("tinyllama-1.1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=5632, vocab_size=32000)
