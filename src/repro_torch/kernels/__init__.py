"""Hand-written CUDA kernels of the matching hot path and the serving stack,
with their plain PyTorch versions (``ref``) and the padding/dispatch
wrappers (``ops``).
Nothing is built at import: kernels compile on first launch."""

from . import dfa_match, flash_attn, lvec_compose, ops, ref, token_mask
from .ops import spec_compose_lanes, spec_match_merge, spec_match_merge_lanes

__all__ = ["dfa_match", "flash_attn", "lvec_compose", "ops", "ref",
           "token_mask", "spec_match_merge", "spec_match_merge_lanes",
           "spec_compose_lanes"]
