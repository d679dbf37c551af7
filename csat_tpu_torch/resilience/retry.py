"""Bounded retry with exponential backoff (the JAX package's
``resilience/retry.py:retry``), used around checkpoint saves."""

from __future__ import annotations

import time
from typing import Callable, Tuple, Type

__all__ = ["retry"]


def retry(fn: Callable, *args, attempts: int = 3, backoff_s: float = 0.5,
          retry_on: Tuple[Type[BaseException], ...] = (Exception,),
          desc: str = "operation", log: Callable[[str], None] = print,
          sleep: Callable[[float], None] = time.sleep, **kwargs):
    """Call ``fn(*args, **kwargs)`` with up to ``attempts`` tries.  Backoff
    doubles per failure starting at ``backoff_s``; the final failure
    re-raises the original exception."""
    assert attempts >= 1, attempts
    for attempt in range(1, attempts + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt == attempts:
                raise
            delay = backoff_s * (2 ** (attempt - 1))
            log(f"# retry: {desc} failed (attempt {attempt}/{attempts}: "
                f"{type(e).__name__}: {e}); retrying in {delay:.2f}s")
            sleep(delay)
