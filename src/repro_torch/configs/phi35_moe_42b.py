"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]."""

from .base import ModelConfig, register


@register("phi3.5-moe-42b-a6.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=6400, vocab_size=32064,
        n_experts=16, top_k=2)
