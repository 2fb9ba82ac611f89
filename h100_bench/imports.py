"""The check that a run loads neither JAX nor the JAX package: top-level
module names compared whole (the port's name begins with the JAX
package's)."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "closerlook3d_tpu")


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
