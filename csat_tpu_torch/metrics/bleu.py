"""Smoothed BLEU (Lin & Och 2004 "ORANGE" smoothing), plus corpus helpers.

Capability parity with the reference's ``valid_metrices/google_bleu.py``:
``compute_bleu`` returns the same 6-tuple (bleu, precisions, bp, ratio,
translation_length, reference_length); ``corpus_bleu`` returns
(corpus_bleu, avg_sentence_bleu, per_id_scores). Implemented from the
published algorithm: clipped modified n-gram precision up to order 4 with
add-one smoothing, geometric mean, brevity penalty ``exp(1 - 1/ratio)``.

The port's own copy of the JAX package's ``metrics/bleu.py`` (host-only code, no JAX
in it); ``tests/test_torch_metrics.py`` holds the two together.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

__all__ = ["compute_bleu", "corpus_bleu", "sentence_bleu"]


def _ngrams(tokens: Sequence[str], max_order: int) -> Counter:
    counts: Counter = Counter()
    for order in range(1, max_order + 1):
        for i in range(len(tokens) - order + 1):
            counts[tuple(tokens[i : i + order])] += 1
    return counts


def compute_bleu(
    reference_corpus: Sequence[Sequence[Sequence[str]]],
    translation_corpus: Sequence[Sequence[str]],
    max_order: int = 4,
    smooth: bool = False,
):
    matches = [0] * max_order
    possible = [0] * max_order
    ref_len = 0
    hyp_len = 0
    for refs, hyp in zip(reference_corpus, translation_corpus):
        ref_len += min(len(r) for r in refs)
        hyp_len += len(hyp)
        merged_ref: Counter = Counter()
        for ref in refs:
            ref_counts = _ngrams(ref, max_order)
            for g, c in ref_counts.items():
                merged_ref[g] = max(merged_ref[g], c)
        hyp_counts = _ngrams(hyp, max_order)
        for g, c in hyp_counts.items():
            m = min(c, merged_ref.get(g, 0))
            if m:
                matches[len(g) - 1] += m
        for order in range(1, max_order + 1):
            pm = len(hyp) - order + 1
            if pm > 0:
                possible[order - 1] += pm

    precisions = [0.0] * max_order
    for i in range(max_order):
        if smooth:
            precisions[i] = (matches[i] + 1.0) / (possible[i] + 1.0)
        elif possible[i] > 0:
            precisions[i] = matches[i] / possible[i]

    if min(precisions) > 0:
        geo_mean = math.exp(sum(math.log(p) for p in precisions) / max_order)
    else:
        geo_mean = 0.0

    ratio = hyp_len / ref_len if ref_len else 0.0
    bp = 1.0 if ratio > 1.0 else (math.exp(1.0 - 1.0 / ratio) if ratio > 0 else 0.0)
    return geo_mean * bp, precisions, bp, ratio, hyp_len, ref_len


def sentence_bleu(reference: Sequence[str], hypothesis: Sequence[str]) -> float:
    return compute_bleu([[reference]], [hypothesis], smooth=True)[0]


def corpus_bleu(
    hypotheses: Dict[int, List[str]], references: Dict[int, List[str]]
) -> Tuple[float, float, Dict[int, float]]:
    assert sorted(hypotheses) == sorted(references)
    refs, hyps = [], []
    ind_score: Dict[int, float] = {}
    total = 0.0
    for idx in hypotheses:
        hyp = hypotheses[idx][0].split()
        ref = [r.split() for r in references[idx]]
        hyps.append(hyp)
        refs.append(ref)
        score = compute_bleu([ref], [hyp], smooth=True)[0]
        ind_score[idx] = score
        total += score
    avg = total / len(hypotheses) if hypotheses else 0.0
    corpus = compute_bleu(refs, hyps, smooth=True)[0]
    return corpus, avg, ind_score
