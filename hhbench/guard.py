"""The check that no JAX module is loaded in the benchmark's process.

Module names are compared by their top-level name, the part before the
first dot, whole: ``hedgehog_tpu_torch`` (the program) begins with
``hedgehog_tpu`` (the JAX package) and is not a hit.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hedgehog_tpu"})


def forbidden_modules(names=None) -> list[str]:
    """The loaded module names (``sys.modules`` by default) whose top-level
    name is forbidden, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
