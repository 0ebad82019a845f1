"""The check that a run loaded neither JAX nor the JAX package.

Module names are compared by their top-level part (before the first
dot), whole: `guard_tpu_torch` is the port and does not match
`guard_tpu`.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "guard_tpu"})


def forbidden(names) -> list:
    """The forbidden top-level names among module names."""
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


def loaded_here() -> list:
    return forbidden(list(sys.modules))


def loaded_in_worker(_args=None) -> list:
    """loaded_here, as a pool job."""
    return loaded_here()
