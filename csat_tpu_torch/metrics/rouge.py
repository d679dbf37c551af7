"""ROUGE-L (longest-common-subsequence F-measure, β = 1.2).

Capability parity with the reference's ``valid_metrices/rouge/rouge.py``:
per-sample score is the LCS-based F with ``beta=1.2`` against the (single)
reference; ``compute_score`` averages over the corpus and returns
``(mean, per_sample_array)``.

The port's own copy of the JAX package's ``metrics/rouge.py`` (host-only code, no JAX
in it); ``tests/test_torch_metrics.py`` holds the two together.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["Rouge"]


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        hyp = candidate[0].split()
        prec, rec = [], []
        for ref in refs:
            r = ref.split()
            lcs = _lcs_len(hyp, r)
            prec.append(lcs / len(hyp) if hyp else 0.0)
            rec.append(lcs / len(r) if r else 0.0)
        p, r = max(prec), max(rec)
        if p != 0 and r != 0:
            return ((1 + self.beta**2) * p * r) / (r + self.beta**2 * p)
        return 0.0

    def compute_score(
        self, gts: Dict[int, List[str]], res: Dict[int, List[str]]
    ) -> Tuple[float, np.ndarray]:
        assert sorted(gts) == sorted(res)
        scores = [self.calc_score(res[i], gts[i]) for i in gts]
        return float(np.mean(scores)) if scores else 0.0, np.array(scores)

    @staticmethod
    def method() -> str:
        return "Rouge"
