"""granite-3-8b [hf:ibm-granite/granite-3.0-8b-base family]."""

from .base import ModelConfig, register


@register("granite-3-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b", family="dense", n_layers=40, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=12800, vocab_size=49155)
