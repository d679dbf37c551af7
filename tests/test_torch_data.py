"""The port's host-side data pipeline against the JAX package's, exactly.

Both packages generate the synthetic corpus from the same seed into their own
directories and must agree:

* the text artifacts (``ast.original``, ``nl.original``, ``split_pot.seq``)
  byte for byte, the vocabularies entry for entry, and the tree records and
  L/T matrices of ``split_matrices.npz`` array for array (an ``.npz`` carries
  zip timestamps and the pickled record class's module path, so those files
  are compared by content);
* every array of ``ASTDataset`` for every split;
* ``plan_buckets`` / ``plan_signature`` / ``assign_buckets`` for several
  bucket configurations;
* the batch sequence — every field of every batch, two epochs — of
  ``iterate_batches`` and ``iterate_bucketed_batches`` (train and eval
  modes), and ``pad_batch`` / ``slice_batch``.
"""

import os

import numpy as np
import pytest

from torch_parity import MICRO

SPLITS = ("train", "dev", "test")
N_SAMPLES = {"train": 96, "dev": 24, "test": 24}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    from csat_tpu.data.synthetic import make_corpus as jmake
    from csat_tpu_torch.data.synthetic import make_corpus as tmake

    jdir = str(tmp_path_factory.mktemp("jax_corpus"))
    tdir = str(tmp_path_factory.mktemp("torch_corpus"))
    jmake(jdir, n_train=96, n_dev=24, n_test=24, seed=5, max_ast_len=48)
    tmake(tdir, n_train=96, n_dev=24, n_test=24, seed=5, max_ast_len=48)
    return jdir, tdir


def _cfgs(jdir, tdir, **kw):
    from csat_tpu.configs import get_config as jcfg
    from csat_tpu_torch.configs import get_config as tcfg

    over = {**MICRO, "batch_size": 8, **kw}
    return jcfg("python", data_dir=jdir, **over), tcfg("python", data_dir=tdir, **over)


def _datasets(corpora, split="train", **kw):
    from csat_tpu.data.dataset import ASTDataset as JDS
    from csat_tpu.data.vocab import load_vocab as jload
    from csat_tpu_torch.data.dataset import ASTDataset as TDS
    from csat_tpu_torch.data.vocab import load_vocab as tload

    jc, tc = _cfgs(*corpora, **kw)
    return (jc, JDS(jc, split, *jload(jc.data_dir), use_cache=False),
            tc, TDS(tc, split, *tload(tc.data_dir), use_cache=False))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", ["ast.original", "nl.original", "split_pot.seq"])
def test_corpus_text_files_are_byte_identical(corpora, split, name):
    jdir, tdir = corpora
    a = open(os.path.join(jdir, split, name), "rb").read()
    b = open(os.path.join(tdir, split, name), "rb").read()
    assert a == b and len(a) > 0


@pytest.mark.parametrize("split", SPLITS)
def test_corpus_matrices_equal(corpora, split):
    jdir, tdir = corpora
    jm = np.load(os.path.join(jdir, split, "split_matrices.npz"), allow_pickle=True)
    tm = np.load(os.path.join(tdir, split, "split_matrices.npz"), allow_pickle=True)
    assert sorted(jm.files) == sorted(tm.files)
    assert len(jm["L"]) == len(tm["L"]) == N_SAMPLES[split]
    for key in ("L", "T", "root_first_level"):
        for a, b in zip(jm[key], tm[key]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for ra, rb in zip(jm["root_first_seq"], tm["root_first_seq"]):
        assert list(ra.labels) == list(rb.labels)
        for field in ("parent_idx", "child_idx", "levels"):
            np.testing.assert_array_equal(getattr(ra, field), getattr(rb, field))


def test_vocabularies_equal(corpora):
    from csat_tpu.data.vocab import Vocab as JV, load_vocab as jload
    from csat_tpu_torch.data.vocab import Vocab as TV, load_vocab as tload

    jdir, tdir = corpora
    for jv, tv in zip(jload(jdir), tload(tdir)):
        assert jv.w2i == tv.w2i and jv.i2w == tv.i2w and jv.size() == tv.size() > 4
    name = "node_triplet_dictionary_python.pt"
    jt = JV(need_bos=False, file_path=os.path.join(jdir, name)).load()
    tt = TV(need_bos=False, file_path=os.path.join(tdir, name)).load()
    assert jt.w2i == tt.w2i and tt.size() > 1


@pytest.mark.parametrize("split", SPLITS)
def test_dataset_arrays_equal(corpora, split):
    _, jds, _, tds = _datasets(corpora, split)
    assert len(jds) == len(tds) == N_SAMPLES[split]
    assert sorted(jds.arrays) == sorted(tds.arrays)
    for key in jds.arrays:
        assert jds.arrays[key].dtype == tds.arrays[key].dtype, key
        np.testing.assert_array_equal(jds.arrays[key], tds.arrays[key], err_msg=key)


def test_dataset_cache_round_trip(corpora):
    from csat_tpu_torch.data.dataset import ASTDataset
    from csat_tpu_torch.data.vocab import load_vocab

    _, tc = _cfgs(*corpora)
    vocabs = load_vocab(tc.data_dir)
    first = ASTDataset(tc, "dev", *vocabs)            # builds and writes the cache
    cache = [f for f in os.listdir(os.path.join(tc.data_dir, "dev"))
             if f.startswith("processed_data_N48_T10_tp4x8_python_v2")]
    assert cache
    again = ASTDataset(tc, "dev", *vocabs)            # reads it
    for key in first.arrays:
        np.testing.assert_array_equal(first.arrays[key], again.arrays[key])


BUCKET_CASES = [
    dict(),
    dict(bucket_src_lens=(16, 24, 48), bucket_tgt_lens=(6, 10)),
    dict(bucket_src_lens=(18, 26), bucket_token_budget=200),
]


@pytest.mark.parametrize("case", BUCKET_CASES, ids=["default", "grid", "budget"])
def test_bucket_plan_and_assignment_equal(corpora, case):
    from csat_tpu.data import bucketing as jb
    from csat_tpu_torch.data import bucketing as tb

    jc, jds, tc, tds = _datasets(corpora, bucketing=True, **case)
    jspecs, tspecs = jb.plan_buckets(jc), tb.plan_buckets(tc)
    assert [tuple(s) for s in jspecs] == [tuple(s) for s in tspecs]
    assert jb.plan_signature(jc) == tb.plan_signature(tc)
    assert jb.plan_signature(jc.replace(bucketing=False)) == \
        tb.plan_signature(tc.replace(bucketing=False))
    assert jb.src_bucket_ladder(jc) == tb.src_bucket_ladder(tc)
    jl, tl = jb.sample_lengths(jds.arrays), tb.sample_lengths(tds.arrays)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)
    ja, ta = jb.assign_buckets(jspecs, *jl), tb.assign_buckets(tspecs, *tl)
    np.testing.assert_array_equal(ja, ta)
    assert len(set(ta.tolist())) >= 2  # the corpus really spreads over buckets
    jh, th = jb.bucket_histogram(jc, jds.arrays), tb.bucket_histogram(tc, tds.arrays)
    assert jh == th


def _assert_batches_equal(jbatches, tbatches):
    jbatches, tbatches = list(jbatches), list(tbatches)
    assert len(jbatches) == len(tbatches) > 0
    for jbt, tbt in zip(jbatches, tbatches):
        if isinstance(jbt, tuple) and not hasattr(jbt, "_fields"):
            assert tuple(jbt[0]) == tuple(tbt[0])
            jbt, tbt = jbt[1], tbt[1]
        assert jbt._fields == tbt._fields
        for field, a, b in zip(jbt._fields, jbt, tbt):
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
    return len(tbatches)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_iterate_batches_sequence_equal(corpora, shuffle, drop_last):
    from csat_tpu.data.dataset import iterate_batches as jit_
    from csat_tpu_torch.data.dataset import iterate_batches as tit

    jc, jds, tc, tds = _datasets(corpora)
    for epoch in (1, 2):
        kw = dict(shuffle=shuffle, seed=jc.seed + epoch, drop_last=drop_last)
        n = _assert_batches_equal(jit_(jds, 8, **kw), tit(tds, 8, **kw))
        assert n == 12
    first = [b.src_seq for b in tit(tds, 8, shuffle=True, seed=1)]
    second = [b.src_seq for b in tit(tds, 8, shuffle=True, seed=2)]
    assert any((a != b).any() for a, b in zip(first, second))


@pytest.mark.parametrize("case", BUCKET_CASES, ids=["default", "grid", "budget"])
@pytest.mark.parametrize("mode", ["train", "eval", "sharded"])
def test_iterate_bucketed_batches_sequence_equal(corpora, case, mode):
    from csat_tpu.data.bucketing import iterate_bucketed_batches as jit_
    from csat_tpu_torch.data.bucketing import iterate_bucketed_batches as tit

    jc, jds, tc, tds = _datasets(corpora, bucketing=True, **case)
    kw = {"train": dict(shuffle=True, drop_last=True),
          "eval": dict(shuffle=False, drop_last=False, with_spec=True),
          "sharded": dict(shuffle=True, drop_last=True, num_shards=2, shard_index=1)}[mode]
    shapes = set()
    for epoch in (1, 2):
        tb = list(tit(tds, tc, seed=tc.seed + epoch, **kw))
        _assert_batches_equal(jit_(jds, jc, seed=jc.seed + epoch, **kw), tb)
        shapes |= {(b[1] if mode == "eval" else b).src_seq.shape for b in tb}
    assert len(shapes) >= 2


def test_pad_and_slice_batch_equal(corpora):
    from csat_tpu.data import bucketing as jb
    from csat_tpu.data.dataset import iterate_batches as jit_
    from csat_tpu_torch.data import bucketing as tb
    from csat_tpu_torch.data.dataset import iterate_batches as tit

    jc, jds, tc, tds = _datasets(corpora, "dev")
    jbt = next(jit_(jds, 5, shuffle=False))
    tbt = next(tit(tds, 5, shuffle=False))
    js, ts = jb.slice_batch(jbt, 30, 7), tb.slice_batch(tbt, 30, 7)
    _assert_batches_equal([js], [ts])
    (jp, jr), (tp, tr) = (jb.pad_batch(js, rows=8, n=48, t=10, max_src_len=48),
                          tb.pad_batch(ts, rows=8, n=48, t=10, max_src_len=48))
    assert jr == tr == 5 and tp.src_seq.shape == (8, 48) and tp.tgt_seq.shape == (8, 9)
    _assert_batches_equal([jp], [tp])
    same, real = tb.pad_batch(tbt)
    assert same is tbt and real == 5
