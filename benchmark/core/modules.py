"""The rule that nothing of JAX runs in a benchmark process.

The port's package name begins with the JAX package's, so names are
compared whole, by their top-level part (before the first dot).
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "vbt_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
