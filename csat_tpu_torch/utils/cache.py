"""The port's persistent cache root, under the JAX package's two knobs.

The JAX package's ``utils/cache.py`` points XLA's compilation cache at a
directory; the port compiles nothing but its CUDA kernel libraries, so its
cache root holds the warm-start store of those libraries
(``serve/warmstart.py``).  The root is resolved by the same rule, so one
setting governs both packages: ``CSAT_TPU_NO_CACHE`` (any value but ``0`` or
empty) turns every persistent cache off, else ``CSAT_TPU_CACHE_DIR``, else
the caller's directory, else :data:`DEFAULT_DIR` at the repository root (in
``.gitignore``).  A root that cannot be created degrades to uncached and
never raises: a cache is an optimisation, not a dependency.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

__all__ = ["DEFAULT_DIR", "cache_disabled", "cache_root"]

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".torch_cache",
)


def cache_disabled() -> bool:
    """The kill switch: ``CSAT_TPU_NO_CACHE`` set to anything but 0 / ""."""
    return os.environ.get("CSAT_TPU_NO_CACHE", "0") not in ("", "0")


def cache_root(cache_dir: Optional[str] = None,
               log: Callable[[str], None] = print) -> Optional[str]:
    """The cache directory to use (created), or None when caching is off.

    Precedence: ``CSAT_TPU_NO_CACHE`` > ``CSAT_TPU_CACHE_DIR`` > ``cache_dir``
    > :data:`DEFAULT_DIR`.  An unwritable location logs one line and returns
    None (run uncached)."""
    if cache_disabled():
        return None
    root = os.environ.get("CSAT_TPU_CACHE_DIR") or cache_dir or DEFAULT_DIR
    try:
        os.makedirs(root, exist_ok=True)
    except OSError as e:
        log(f"# cache disabled ({root}: {e})")
        return None
    return root
