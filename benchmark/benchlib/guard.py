"""The guard that nothing the benchmark ran loaded JAX or the JAX package.

Names are compared by their whole top-level part (before the first dot):
``floodgan_tpu_torch`` is the program and passes; ``floodgan_tpu`` and
``floodgan_tpu.ops`` are the JAX package and fail.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "floodgan_tpu"})


def offending(module_names: Iterable[str]) -> List[str]:
    return sorted(n for n in module_names if n.split(".", 1)[0] in FORBIDDEN)


def check() -> None:
    """Exit with code 3, naming what it found on standard error, if this
    process holds any forbidden module."""
    found = offending(list(sys.modules))
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}; the benchmark measures the "
              "PyTorch port alone", file=sys.stderr)
        sys.exit(3)
