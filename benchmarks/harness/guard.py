"""Which loaded modules the benchmark refuses to run beside.

Top-level names are compared whole (the part before the first dot), since
the port's name, `tpu_device_plugin_torch`, begins with the JAX package's.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_device_plugin")


def loaded(tops: Iterable[str], modules=None) -> List[str]:
    """Names in `modules` (default `sys.modules`) whose top-level name is
    one of `tops`, sorted."""
    wanted = set(tops)
    names = sys.modules if modules is None else modules
    return sorted(name for name in list(names)
                  if name.split(".", 1)[0] in wanted)


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules of JAX, jaxlib, flax or the JAX package."""
    return loaded(FORBIDDEN, modules)
