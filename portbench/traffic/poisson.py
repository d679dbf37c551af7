"""Open-loop serving traffic in wall time.

``generate(mix, model, seed, seconds)`` → :class:`Traffic`: the requests due
in a window of ``seconds`` at ``mix["rate_per_s"]``, each with its due time
(seconds after the window opens), its AST and its token budget, plus the
requests that warm the engine up before the window.

* Arrivals are a Poisson process: ``round(rate · seconds)`` exponential gaps
  at fixed quantiles (:func:`~portbench.traffic.lengths.exp_gaps`), in an
  order drawn from the seed, so every seed offers the same number of
  requests over the same span and only the bursts move.
* AST node counts and token budgets (``max_new_tokens``) at the quantiles of
  the mix's histograms (``nodes``; ``words``, whose 4–30 range is the corpus
  tool's filter), paired by the seed; trees and ids as
  :mod:`portbench.traffic.corpus` draws them.
* With ``repeat_share`` > 0, that share of the requests (positions drawn
  from the seed) repeats an AST of a pool of ``pool_size`` earlier ones,
  exactly (the same arrays and budget), at Zipf(``zipf_s``) ranks taken at
  fixed quantiles; each rank's AST size and budget are the same for every
  seed (only its tree and ids are drawn).  The pool is asked once during
  warm-up, so the window opens with it in the prefix cache.  Without
  repeats every AST is new.
* Warm-up: ``warmup_per_bucket`` fresh ASTs at each prefill width of
  ``ladder`` (the engine's own, which the driver hands over: 37, 75, 150
  nodes for N 150) with a short budget, asked together, then the pool.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from portbench.traffic.corpus import sample_arrays
from portbench.traffic.lengths import exp_gaps, load_histogram, quantiles

__all__ = ["Traffic", "generate", "zipf_ranks"]


@dataclasses.dataclass
class Traffic:
    arrays: Dict[str, np.ndarray]   # the distinct samples, flagship width
    due: np.ndarray                 # (R,) seconds after the window opens
    sample: np.ndarray              # (R,) index into arrays
    max_new: np.ndarray             # (R,) token budget
    repeat: np.ndarray              # (R,) bool: a pool AST asked again
    warmup: List[List[int]]         # groups of sample indices asked before the window
    warmup_max_new: np.ndarray      # budget of each sample index in warm-up

    def request_sample(self, idx: int) -> Dict[str, np.ndarray]:
        a = self.arrays
        return {"src_seq": a["src_seq"][idx], "L_raw": a["L_raw"][idx], "T_raw": a["T_raw"][idx],
                "num_node": a["num_node"][idx], "tree_pos": a["tree_pos"][idx],
                "triplet": a["triplet"][idx]}


def zipf_ranks(k: int, pool: int, s: float) -> np.ndarray:
    """``k`` ranks in ``[0, pool)`` at the quantiles ``(i + ½) / k`` of
    Zipf(``s``) over ``pool`` items."""
    w = 1.0 / np.arange(1, pool + 1) ** s
    cdf = np.cumsum(w) / w.sum()
    return np.minimum(np.searchsorted(cdf, (np.arange(k) + 0.5) / k), pool - 1)


def generate(mix: Dict, model: Dict, seed: int, seconds: float, ladder: Sequence[int],
             stream: int = 2) -> Traffic:
    """``ladder``: the engine's prefill widths, ascending.  ``stream`` picks
    an independent draw from the same seed (the traced segment after the
    window asks for another)."""
    hist = load_histogram(mix["lengths"])
    rng = np.random.default_rng([int(seed), int(stream)])
    n_max = model["max_src_len"]
    count = max(1, int(round(float(mix["rate_per_s"]) * seconds)))
    n_rep = int(round(float(mix["repeat_share"]) * count))
    pool = int(mix["pool_size"]) if n_rep else 0
    n_fresh = count - n_rep
    lo_w, hi_w = 1, model["max_tgt_len"] - 1

    # distinct samples: the fresh requests, then the pool, then warm-up
    nodes = [rng.permutation(np.minimum(quantiles(hist["nodes"], n_fresh), n_max))]
    budget = [rng.permutation(quantiles(hist["words"], n_fresh, lo_w, hi_w))]
    if pool:
        # the pool's sizes by Zipf rank are the same for every seed, so a
        # seed does not change the work its repeats carry
        fixed = np.random.default_rng(0)
        nodes.append(fixed.permutation(np.minimum(quantiles(hist["nodes"], pool), n_max)))
        budget.append(fixed.permutation(quantiles(hist["words"], pool, lo_w, hi_w)))
    ladder = sorted(ladder)
    per = int(mix["warmup_per_bucket"])
    lows = [1] + [w + 1 for w in ladder[:-1]]
    warm_nodes = np.concatenate([rng.integers(lo, hi + 1, per) for lo, hi in zip(lows, ladder)])
    nodes.append(np.maximum(warm_nodes, 2))
    budget.append(np.full(len(warm_nodes), int(mix["warmup_max_new"])))
    all_nodes, all_budget = np.concatenate(nodes), np.concatenate(budget)
    arrays = sample_arrays(model, all_nodes, np.zeros(0, np.int64), rng)

    sample = np.empty(count, np.int64)
    repeat = np.zeros(count, bool)
    rep_pos = rng.permutation(count)[:n_rep]
    repeat[rep_pos] = True
    sample[~repeat] = np.arange(n_fresh)
    if n_rep:
        ranks = rng.permutation(zipf_ranks(n_rep, pool, float(mix["zipf_s"])))
        sample[np.sort(rep_pos)] = n_fresh + ranks  # pool AST k holds rank k
    due = np.cumsum(rng.permutation(exp_gaps(count, float(mix["rate_per_s"]))))
    due = due - due[0] * rng.random()  # the first arrival somewhere in its gap
    warm_first = n_fresh + pool
    warmup = [list(range(warm_first, warm_first + len(warm_nodes)))]
    if pool:
        warmup.append(list(range(n_fresh, n_fresh + pool)))
    return Traffic(arrays=arrays, due=due, sample=sample, max_new=all_budget[sample].astype(np.int64),
                   repeat=repeat, warmup=warmup, warmup_max_new=all_budget.astype(np.int64))
