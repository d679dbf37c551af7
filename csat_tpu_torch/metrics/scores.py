"""Aggregate evaluation + id→token output transform.

Capability parity with the reference's ``valid_metrices/compute_scores.py``
(``eval_accuracies`` → (bleu, rouge_l, meteor, ind_bleu, ind_rouge), ×100)
and ``valid_metrices/bleu_metrice.py:14-33`` (``bleu_output_transform``:
truncate hyp/ref at ``</s>``, drop empty references, substitute ``<???>``
for empty hypotheses).

The port's own copy of the JAX package's ``metrics/scores.py`` (host-only code, no JAX
in it); ``tests/test_torch_metrics.py`` holds the two together.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from csat_tpu_torch.metrics.bleu import corpus_bleu, sentence_bleu
from csat_tpu_torch.metrics.meteor import Meteor
from csat_tpu_torch.metrics.rouge import Rouge
from csat_tpu_torch.utils import EOS_WORD

__all__ = ["eval_accuracies", "bleu_output_transform", "batch_bleu"]


def bleu_output_transform(
    y_pred: np.ndarray,  # (B, T) generated ids
    y: np.ndarray,  # (B, T) reference ids
    i2w: Dict[int, str],
) -> Tuple[List[List[str]], List[List[str]]]:
    hypothesises, references = [], []
    for pred_row, ref_row in zip(y_pred, y):
        reference = [i2w[int(c)] for c in ref_row]
        if EOS_WORD in reference:
            reference = reference[: reference.index(EOS_WORD)]
        hypothesis = [i2w[int(c)] for c in pred_row]
        if EOS_WORD in hypothesis:
            hypothesis = hypothesis[: hypothesis.index(EOS_WORD)]
        if not hypothesis:
            hypothesis = ["<???>"]
        if not reference:
            continue
        references.append(reference)
        hypothesises.append(hypothesis)
    return hypothesises, references


def batch_bleu(predicts: Sequence[Sequence[str]], trues: Sequence[Sequence[str]]) -> List[float]:
    """Per-sentence smoothed BLEU (ref ``BLEU4.batch_bleu``)."""
    return [sentence_bleu(t, p) for p, t in zip(predicts, trues)]


def eval_accuracies(
    hypotheses: Dict[int, List[str]], references: Dict[int, List[str]]
):
    assert sorted(references.keys()) == sorted(hypotheses.keys())
    bleu, _, ind_bleu = corpus_bleu(hypotheses, references)
    rouge_calculator = Rouge()
    rouge_l, rouge_scores = rouge_calculator.compute_score(references, hypotheses)
    ind_rouge = {i: rouge_scores[n] for n, i in enumerate(references)}
    meteor, _ = Meteor().compute_score(references, hypotheses)
    return bleu * 100, rouge_l * 100, meteor * 100, ind_bleu, ind_rouge
