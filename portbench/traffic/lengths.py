"""Length histograms and the fixed multisets drawn from them.

A mix names a histogram file under ``portbench/data/`` (``{"nodes":
[[value, count], ...], "words": [...]}``).  :func:`quantiles` takes ``k``
values at the histogram's quantiles ``(i + ½) / k``: the same multiset for
every seed, so two seeds give the same amount of work and only its order
and contents differ — the seed then changes the arrangement, not the load.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["load_histogram", "quantiles", "exp_gaps"]

DATA = Path(__file__).resolve().parents[1] / "data"


def load_histogram(name: str) -> Dict[str, List[Tuple[int, int]]]:
    doc = json.loads((DATA / f"{name}.json").read_text())
    return {k: [(int(v), int(c)) for v, c in doc[k]] for k in ("nodes", "words")}


def quantiles(hist: List[Tuple[int, int]], k: int, lo: int = 0, hi: int = 1 << 30) -> np.ndarray:
    """``k`` values of the histogram (restricted to ``[lo, hi]``) at the
    quantiles ``(i + ½) / k``, ascending."""
    vals = np.array([v for v, _ in hist if lo <= v <= hi], np.int64)
    cnts = np.array([c for v, c in hist if lo <= v <= hi], np.float64)
    if not len(vals):
        raise ValueError(f"no histogram mass in [{lo}, {hi}]")
    cdf = np.cumsum(cnts) / cnts.sum()
    q = (np.arange(k) + 0.5) / k
    return vals[np.minimum(np.searchsorted(cdf, q, side="left"), len(vals) - 1)]


def exp_gaps(k: int, rate: float) -> np.ndarray:
    """``k`` exponential inter-arrival gaps of mean ``1 / rate`` at the
    quantiles ``(i + ½) / k`` (a Poisson process's gaps as a fixed
    multiset), rescaled so that they sum to ``k / rate``."""
    q = (np.arange(k) + 0.5) / k
    g = -np.log1p(-q)
    return g * (k / rate) / g.sum()
