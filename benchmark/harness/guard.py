"""The check that nothing of JAX or of the JAX package is loaded."""

from __future__ import annotations

import sys

#: top-level module names that no run may load: JAX, its libraries, and the
#: JAX package this port was made from (compared whole: the port's own
#: name begins with it)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "rt_depth_map_tpu"})


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(names)} & FORBIDDEN)
