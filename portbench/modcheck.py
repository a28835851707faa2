"""The benchmark measures the PyTorch port and never the JAX package."""

from __future__ import annotations

import sys
from typing import Iterable, Optional

# compared with each loaded module's top-level name (before the first dot),
# whole: "repro_torch" passes, "repro" and "repro.core" do not
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names: Optional[Iterable[str]] = None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: every module
    this process has loaded)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
