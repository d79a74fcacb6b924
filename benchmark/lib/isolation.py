"""The check that a run loaded neither JAX nor the JAX package.

Names are compared by their top-level part, whole: the port's package
``microwakeword_tpu_torch`` begins with the JAX package's name
``microwakeword_tpu`` and must not trip the check, while any module under
``microwakeword_tpu`` must.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "microwakeword_tpu"})


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules (default ``sys.modules``) whose top-level name is
    one of FORBIDDEN, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
