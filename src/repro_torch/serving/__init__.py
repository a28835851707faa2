"""Serving: batched prefill/decode engine + grammar-constrained decoding."""

from .constrained import DecodeStream, GrammarConstraint
from .engine import ServeConfig, ServingEngine

__all__ = ["DecodeStream", "GrammarConstraint", "ServeConfig", "ServingEngine"]
