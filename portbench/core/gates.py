"""The numbers ``correct`` compares, and the limits they are held to.

Training (the checked steps of the timed path, one at each bucket width,
against the reference's):

* ``loss_gap``: the largest relative gap between the program's and the
  reference's NLL over the steps;
* ``grad_gap``: the worst leaf's gap between the norm of the program's first
  gradient, as its optimizer holds it after one step (``m / (1 − b1)``), and
  the norm of the reference's first gradient;
* ``change_gap``: the worst leaf's gap between the norms of the parameters'
  change over the steps; ``grad_median`` / ``change_median``, the median
  leaf's gaps.

A cell's limits file names the ones it compares.  A leaf's gap is
``|‖prog‖ − ‖ref‖|`` over the larger of ``‖ref‖`` and the median leaf's
``‖ref‖``.  Leaves whose reference gradient is under a thousandth of the
median leaf's (the attention key biases, which the softmax makes constant)
move by round-off alone and are left out.

Serving (every request that finished inside the window, teacher-forced
through the reference): ``logit_gap``, the widest gap by which a served
token's logit lies below the reference's largest logit at its position.

Each cell's limits sit in ``portbench/limits/<cell>.json``.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["leaf_gaps", "worst_leaf", "median", "limits", "judge", "served_gaps", "ZERO_GRAD"]

ZERO_GRAD = 1e-3  # a leaf whose gradient norm is under this share of the median is left out
LIMITS = Path(__file__).resolve().parents[1] / "limits"


def median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1] + s[len(s) // 2])


def kept_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    med = median(list(ref_grad_norms.values()))
    return [k for k, v in ref_grad_norms.items() if v >= ZERO_GRAD * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep: Sequence[str]) -> Dict[str, float]:
    med = median([ref[k] for k in keep])
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def worst_leaf(gaps: Dict[str, float]) -> float:
    return max(gaps.values()) if gaps else float("inf")


def limits(cell: str) -> Dict[str, float]:
    path = LIMITS / f"{cell}.json"
    return {k: float(v) for k, v in json.loads(path.read_text())["limits"].items()}


def judge(cell: str, values: Dict[str, float], lim: Optional[Dict[str, float]] = None) -> Dict:
    """``{name: {"value", "limit"}}`` and whether every value is within its
    limit (a value that is not a finite number is not)."""
    lim = limits(cell) if lim is None else lim
    vals = {k: float(values[k]) for k in lim}
    ok = all(math.isfinite(v) and v <= lim[k] for k, v in vals.items())
    # JSON has no infinity or NaN: a value past every float prints as the
    # largest one, a NaN as null; either fails
    checks = {k: {"value": (v if math.isfinite(v) else None if v != v else sys.float_info.max),
                  "limit": lim[k]} for k, v in vals.items()}
    return {"checks": checks, "ok": ok}


def served_gaps(logits: torch.Tensor, tokens: torch.Tensor, lengths: Sequence[int],
                chosen: Optional[torch.Tensor] = None) -> List[float]:
    """Per request, the widest gap ``max(logits) − logits[token]`` over its
    served positions.  ``logits`` (R, T, V) from the reference, ``tokens``
    (R, T) the served tokens; ``chosen`` (R, T), when given, replaces the
    served tokens (the control's own first choices)."""
    pick = tokens if chosen is None else chosen
    best = logits.max(dim=-1).values
    got = torch.gather(logits, -1, pick.long()[..., None])[..., 0]
    gap = (best - got).double().cpu()
    return [float(gap[i, :k].max()) for i, k in enumerate(lengths)]
