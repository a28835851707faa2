"""Config registry: one module per assigned architecture (+ shape specs)."""

from .base import (SHAPES, ModelConfig, ShapeSpec, get_config, list_archs,
                   register, shapes_for)
from . import (granite_3_8b, granite_moe_1b, internlm2_20b, internvl2_2b,
               llama3_8b, phi35_moe_42b, recurrentgemma_2b,
               seamless_m4t_medium, tinyllama_1b, xlstm_1b)
from .reduce import reduce_for_smoke

__all__ = ["SHAPES", "ModelConfig", "ShapeSpec", "get_config", "list_archs",
           "register", "shapes_for", "reduce_for_smoke"]
