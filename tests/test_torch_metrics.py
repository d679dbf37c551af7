"""The port's host-side metrics against the JAX package's on fixed hypotheses.

BLEU (sentence, corpus, the batch transform), ROUGE-L, METEOR (1.5 and 2005)
and ``eval_accuracies`` are the port's copies of jax-free modules; the same
hypothesis/reference pairs go through both and must give equal numbers
(exactly; METEOR within 1e-12 of the JAX package's default scorer, which may
run a native library with the same semantics).
"""

import numpy as np
import pytest

PAIRS = [
    ("get the node using tree", "get the node using tree"),
    ("get the node", "get the node using tree"),
    ("set the value using config index", "set the value using index"),
    ("parse parses parsed the trees", "parse the tree"),
    ("find", "update the cache using path"),
    ("build the graph , using tokens .", "Build the graph using token"),
    ("make make make make", "make the batch"),
    ("", "load the path"),
    ("check the index using value value value", "check the index"),
    ("loads configuration quickly", "load config fast"),
]
HYPS = [h.split() for h, _ in PAIRS]
REFS = [r.split() for _, r in PAIRS]


@pytest.mark.parametrize("i", range(len(PAIRS)))
def test_sentence_bleu_equal(i):
    from csat_tpu.metrics.bleu import compute_bleu as jc, sentence_bleu as js
    from csat_tpu_torch.metrics.bleu import compute_bleu as tc, sentence_bleu as ts

    assert js(HYPS[i], REFS[i]) == ts(HYPS[i], REFS[i])
    for smooth in (False, True):
        assert jc([[REFS[i]]], [HYPS[i]], smooth=smooth) == tc([[REFS[i]]], [HYPS[i]],
                                                             smooth=smooth)


def test_corpus_bleu_and_rouge_equal():
    from csat_tpu.metrics.bleu import corpus_bleu as jb
    from csat_tpu.metrics.rouge import Rouge as JR
    from csat_tpu_torch.metrics.bleu import corpus_bleu as tb
    from csat_tpu_torch.metrics.rouge import Rouge as TR

    hyp = {i: [h] for i, (h, _) in enumerate(PAIRS)}
    ref = {i: [r] for i, (_, r) in enumerate(PAIRS)}
    jres, tres = jb(hyp, ref), tb(hyp, ref)
    assert jres[0] == tres[0] and jres[1] == tres[1] and tres[0] > 0
    keep = {i: v for i, v in hyp.items() if v[0]}
    (jm, js), (tm, ts) = (JR().compute_score({i: ref[i] for i in keep}, keep),
                          TR().compute_score({i: ref[i] for i in keep}, keep))
    assert jm == tm and tm > 0
    np.testing.assert_array_equal(np.asarray(js), np.asarray(ts))


@pytest.mark.parametrize("version", ["1.5", "2005"])
@pytest.mark.parametrize("i", range(len(PAIRS)))
def test_meteor_equal(version, i):
    from csat_tpu.metrics.meteor import meteor_score as jm
    from csat_tpu_torch.metrics.meteor import meteor_score as tm

    got = tm(HYPS[i], REFS[i], version=version)
    assert got == jm(HYPS[i], REFS[i], use_native=False, version=version)
    assert abs(got - jm(HYPS[i], REFS[i], version=version)) <= 1e-12
    assert 0.0 <= got <= 1.0


def test_eval_accuracies_and_transform_equal():
    from csat_tpu.metrics import (batch_bleu as jbb, bleu_output_transform as jt,
                                  eval_accuracies as je)
    from csat_tpu_torch.metrics import (batch_bleu as tbb, bleu_output_transform as tt,
                                        eval_accuracies as te)

    hyp = {i: [h or "x"] for i, (h, _) in enumerate(PAIRS)}
    ref = {i: [r] for i, (_, r) in enumerate(PAIRS)}
    jres, tres = je(hyp, ref), te(hyp, ref)
    assert jres[:3] == tres[:3] and all(x > 0 for x in tres[:3])
    assert jres[3] == tres[3]
    np.testing.assert_array_equal(np.asarray(jres[4]), np.asarray(tres[4]))

    i2w = {0: "<pad>", 1: "<unk>", 2: "<s>", 3: "</s>", 4: "get", 5: "the", 6: "node", 7: "tree"}
    y_pred = np.asarray([[4, 5, 6, 3, 7, 7], [4, 4, 0, 5, 3, 0], [3, 0, 0, 0, 0, 0]])
    target = np.asarray([[4, 5, 7, 3, 0, 0], [4, 5, 6, 7, 3, 0], [6, 3, 0, 0, 0, 0]])
    (jh, jr), (th, tr) = jt(y_pred, target, i2w), tt(y_pred, target, i2w)
    assert jh == th and jr == tr and th[0] == ["get", "the", "node"]
    assert list(jbb(jh, jr)) == list(tbb(th, tr))


def test_match_accuracy_equal():
    from csat_tpu.metrics.acc import MatchAccMetric as JM, match_accuracy as ja
    from csat_tpu_torch.metrics.acc import MatchAccMetric as TM, match_accuracy as ta

    rng = np.random.default_rng(0)
    y = rng.integers(0, 6, (5, 9))
    y_pred = np.where(rng.random(y.shape) < 0.6, y, rng.integers(0, 6, y.shape))
    assert ja(y_pred, y) == ta(y_pred, y)
    jm, tm = JM(), TM()
    for m in (jm, tm):
        m.update(y_pred, y)
        m.update(y_pred[:2], y[:2])
    assert jm.compute() == tm.compute() > 0
