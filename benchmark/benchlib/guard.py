"""The check that nothing the benchmark ran loaded JAX or the JAX package.

Names are compared by their whole top-level part (before the first dot):
``video_spike_torch`` begins with ``video_spike_t`` but is not
``video_spike_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "video_spike_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
