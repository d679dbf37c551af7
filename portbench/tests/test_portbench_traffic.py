"""The generators: histogram draws, trees, wall-time Poisson arrivals, Zipf repeats."""

import json

import numpy as np
import pytest

from portbench.traffic import corpus, lengths, poisson, trees

MODEL = json.loads(open(__import__("conftest").ROOT / "portbench/configs/csat-python.json").read())
LADDER = [37, 75, 150]   # the port's prefill widths at N 150


def test_quantiles_follow_the_histogram():
    hist = [(1, 1), (2, 2), (3, 1)]
    assert lengths.quantiles(hist, 4).tolist() == [1, 2, 2, 3]
    assert lengths.quantiles(hist, 4, lo=2).tolist() == [2, 2, 2, 3]
    h = lengths.load_histogram("stdlib_lengths")
    q = lengths.quantiles(h["nodes"], 2000)
    assert q.min() >= 1 and q.max() == 150
    assert 35 <= np.median(q) <= 50          # the stdlib's median function is 43 nodes
    w = lengths.quantiles(h["words"], 2000)
    assert w.min() == 4 and w.max() == 30    # the corpus tool's filter


def test_exponential_gaps_are_a_fixed_multiset_with_the_rate_s_mean():
    g = lengths.exp_gaps(1000, 50.0)
    assert g.sum() == pytest.approx(20.0)
    assert np.median(g) == pytest.approx(np.log(2) / 50.0, rel=0.02)


@pytest.mark.parametrize("n", [1, 2, 7, 60, 150])
def test_distance_planes_match_the_port_s_derivation(n):
    from csat_tpu_torch.data.ast_tools import ast_json_to_tree, build_matrices, truncate_preorder

    rng = np.random.default_rng(n)
    parent = trees.draw_parents(rng, n)
    kids = [[] for _ in range(n)]
    for c in range(1, n):
        kids[parent[c]].append(c)
    js = [dict(label=f"nont:x:0:0:{i + 1}", **({"children": [f"ref:{c + 1}" for c in kids[i]]}
                                               if kids[i] else {})) for i in range(n)]
    L, T = build_matrices(truncate_preorder(ast_json_to_tree(js), 150), 150)
    L2, T2 = trees.distance_planes(parent, 150)
    assert (L == L2).all() and (T == T2).all()


def test_corpus_sizes_are_the_same_multiset_for_every_seed():
    mix = {"lengths": "stdlib_lengths", "corpus_size": 64}
    a = corpus.generate(mix, MODEL, 2**31 + 5, 20)
    b = corpus.generate(mix, MODEL, 2**33 + 11, 20)
    assert sorted(a["num_node"]) == sorted(b["num_node"])
    assert not (a["num_node"] == b["num_node"]).all()
    assert not (a["src_seq"] == b["src_seq"]).all()
    n = a["num_node"]
    assert ((a["src_seq"] > 3).sum(1) == n).all()     # real ids on the real nodes only
    assert (a["tgt_seq"][:, 0] == corpus.BOS).all()
    ends = (a["target"] == corpus.EOS).argmax(1)
    assert ((a["tgt_seq"] != 0).sum(1) == ends + 2).all()   # BOS, the words, EOS


def test_poisson_arrivals_are_in_wall_time_inside_the_window():
    mix = {"lengths": "stdlib_lengths", "rate_per_s": 40.0, "repeat_share": 0.0,
           "warmup_per_bucket": 2, "warmup_max_new": 4}
    t = poisson.generate(mix, MODEL, 2**31 + 9, 10, LADDER)
    assert len(t.due) == 400
    assert (np.diff(t.due) >= 0).all() and t.due[0] >= 0 and t.due[-1] <= 10.0
    assert not t.repeat.any() and len(set(t.sample.tolist())) == 400
    assert t.max_new.min() >= 4 and t.max_new.max() <= 30
    u = poisson.generate(mix, MODEL, 2**32 + 1, 10, LADDER)
    assert not np.allclose(t.due, u.due)             # the order, and so the bursts, move
    assert sorted(t.max_new.tolist()) == sorted(u.max_new.tolist())
    warm = t.warmup[0]
    got = {min(w for w in LADDER if w >= t.arrays["num_node"][i]) for i in warm}
    assert got == set(LADDER)                         # every prefill width warmed
    assert (t.warmup_max_new[warm] == 4).all()


def test_repeats_are_exact_and_zipf_ranked():
    mix = {"lengths": "stdlib_lengths", "rate_per_s": 50.0, "repeat_share": 0.5,
           "pool_size": 32, "zipf_s": 1.1, "warmup_per_bucket": 2, "warmup_max_new": 4}
    t = poisson.generate(mix, MODEL, 2**31 + 3, 20, LADDER)
    assert t.repeat.sum() == 500
    pool = set(t.sample[t.repeat].tolist())
    assert len(pool) <= 32 and pool.isdisjoint(t.sample[~t.repeat].tolist())
    assert pool <= set(t.warmup[1])                   # asked once before the window
    counts = np.bincount(poisson.zipf_ranks(500, 32, 1.1), minlength=32)
    assert counts[0] > counts[1] > counts[4] > counts[31]
    assert counts[0] == pytest.approx(500 / sum(1 / r ** 1.1 for r in range(1, 33)), abs=2)
