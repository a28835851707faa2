"""Hand-written CUDA kernels of the matching hot path and the serving stack,
with their plain PyTorch versions (``ref``) and the padding/dispatch
wrappers (``ops``).  ``lvec_compose`` names the module of the compose
kernels; the full-map compose op is ``ops.lvec_compose``.
Nothing is built at import: kernels compile on first launch."""

from . import (dfa_match, flash_attn, lvec_compose, onehot_match, ops, ref,
               token_mask)
from .ops import (mxu_profitable, onehot_block_maps, spec_compose_lanes,
                  spec_match, spec_match_merge, spec_match_merge_lanes)

__all__ = ["dfa_match", "flash_attn", "lvec_compose", "onehot_match", "ops",
           "ref", "token_mask", "spec_match", "spec_match_merge",
           "spec_match_merge_lanes", "spec_compose_lanes",
           "onehot_block_maps", "mxu_profitable"]
