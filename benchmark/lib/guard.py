"""The modules a run may not load: JAX and the JAX package."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "bridged_gnn_tpu")


def forbidden(modules: Iterable[str] = None,
              names=FORBIDDEN) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``names``, compared whole: ``bridged_gnn_tpu_torch`` is not
    ``bridged_gnn_tpu``."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in names)
