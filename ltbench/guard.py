"""What the benchmark's process may not hold: JAX, its libraries, and the
JAX package this repository ports. Modules are compared by their top-level
name (before the first dot) as a whole, so ``livetalking_tpu_torch``, the
program under test, passes while ``livetalking_tpu`` does not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "livetalking_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """Sorted top-level names among ``names`` (default ``sys.modules``) that
    are forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
