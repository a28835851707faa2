"""Model substrate of the port: the dense, MoE and vision-prefixed
transformers, the RG-LRU hybrid, xLSTM and the encoder-decoder (layers,
blockwise attention, the phase API) and the converter of the JAX package's
parameters."""

from . import (api, attention_core, convert, encdec, layers, moe, recurrent,
               transformer, xlstm)
from .api import (decode, init, input_specs, lm_loss, make_inputs, prefill,
                  train_logits)

__all__ = ["api", "attention_core", "convert", "encdec", "layers", "moe",
           "recurrent", "transformer", "xlstm", "init", "train_logits",
           "prefill", "decode", "make_inputs", "input_specs", "lm_loss"]
