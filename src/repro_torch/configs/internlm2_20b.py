"""internlm2-20b [arXiv:2403.17297]."""

from .base import ModelConfig, register


@register("internlm2-20b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=16384, vocab_size=92544)
