"""recurrentgemma-2b [arXiv:2402.19427] — RG-LRU + local attention, 1 attn : 2 rec."""

from .base import ModelConfig, register


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
        n_heads=10, n_kv_heads=1, d_ff=7680, vocab_size=256000,
        attn_window=2048, block_pattern=("rglru", "rglru", "attn"),
        rglru_dim=2560)
