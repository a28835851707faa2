"""Model substrate of the port: the dense decoder-only LM (layers,
blockwise attention, transformer, the phase API) and the converter of the
JAX package's parameters.  The other families wait for ROADMAP A15."""

from . import api, attention_core, convert, layers, transformer

__all__ = ["api", "attention_core", "convert", "layers", "transformer"]
