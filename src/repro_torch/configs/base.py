"""Config system: model + shape descriptors and the --arch registry."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "register", "get_config",
           "list_archs", "shapes_for"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (exact values from the assignment table)."""

    name: str
    family: str            # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0      # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid (RG-LRU + local attention) / ssm
    attn_window: int = 0           # 0 -> full attention
    block_pattern: tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "attn")
    rglru_dim: int = 0             # recurrence width (defaults to d_model)
    # enc-dec
    n_enc_layers: int = 0
    enc_frames_decode: int = 4096  # encoder memory length for decode shapes
    # vlm
    n_patches: int = 0             # vision-prefix length (stubbed embeddings)
    # common
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    vocab_round: int = 256         # pad vocab to a shardable multiple
    tie_embeddings: bool = False
    remat_policy: str = "nothing"  # nothing | dots | none

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        r = self.vocab_round
        return (self.vocab_size + r - 1) // r * r

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md shape-skip table)."""
        return self.family in ("hybrid", "ssm")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def shapes_for(cfg: ModelConfig) -> list[ShapeSpec]:
    """The assigned shape set, with the documented long_500k skip rule."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_subquadratic:
        names.append("long_500k")
    return [SHAPES[n] for n in names]
