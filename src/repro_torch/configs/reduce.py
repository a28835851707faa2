"""Reduced configs for CPU smoke tests (same family, tiny dimensions)."""

import dataclasses

from .base import ModelConfig


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Shrink every axis while keeping the family's structure intact."""
    pat = cfg.block_pattern
    n_layers = max(2, len(pat)) if pat else 2
    if pat:
        n_layers = len(pat) + min(2, len(pat))  # one scanned group + a tail
    n_heads = 4
    n_kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else n_heads
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        vocab_round=64,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        attn_window=min(cfg.attn_window, 16) if cfg.attn_window else 0,
        rglru_dim=32 if cfg.rglru_dim else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_frames_decode=16,
        n_patches=8 if cfg.n_patches else 0,
        remat_policy="none",
    )
