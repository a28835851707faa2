"""internvl2-2b [arXiv:2404.16821] — InternViT frontend stubbed; InternLM2 backbone."""

from .base import ModelConfig, register


@register("internvl2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
        n_heads=16, n_kv_heads=8, d_ff=8192, vocab_size=92553,
        n_patches=256)
