"""The port's native host modules (``csat_tpu_torch/native``) against the JAX
package's and against their own plain versions, on the CPU at small sizes:
the fused collate bit for bit with JAX's ``collate_indexed`` (which runs
JAX's library) and with the NumPy ``collate``, at N 150 and N 512, and on
JAX's guard cases; the C++ METEOR within 1e-9 of the port's Python scorer
and of JAX's ``meteor_score`` on 200 seeded pairs of each version; a broken
source raising; the library built once under ``build/native/`` and reused;
the ``.cpp`` copies equal to JAX's with comments left out."""

import random
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

from csat_tpu_torch import native
from csat_tpu_torch.data import dataset as port_data

REPO = Path(__file__).resolve().parents[1]


class _Counted:
    """A library whose ``collate_rel_c`` counts its calls."""

    def __init__(self, lib):
        self.lib, self.calls = lib, 0

    def collate_rel_c(self, *args):
        self.calls += 1
        return self.lib.collate_rel_c(*args)


@pytest.fixture
def counted(monkeypatch):
    """The port's native collate library with its calls counted."""
    monkeypatch.delenv("CSAT_TPU_NO_NATIVE_COLLATE", raising=False)
    lib = _Counted(native.load_collate())
    monkeypatch.setitem(native._LIBS, "collate", lib)
    return lib


def _arrays(s: int, n: int, t: int = 7, seed: int = 0) -> dict:
    """Dataset-resident arrays with raw distances far beyond the clip range
    in both directions, and the mask (0) and adjacency (±1) cases present."""
    rng = np.random.default_rng(seed)
    arrays = {
        "src_seq": rng.integers(0, 50, (s, n)).astype(np.int32),
        "tgt_seq": rng.integers(0, 50, (s, t)).astype(np.int32),
        "target": rng.integers(0, 50, (s, t)).astype(np.int32),
        "L_raw": rng.integers(-2 * n, 2 * n, (s, n, n)).astype(np.int16),
        "T_raw": rng.integers(-2 * n, 2 * n, (s, n, n)).astype(np.int16),
        "num_node": rng.integers(1, n, (s,)).astype(np.int32),
        "tree_pos": (rng.random((s, n, 32)) < 0.3).astype(np.uint8),
        "triplet": rng.integers(0, 30, (s, n)).astype(np.int32),
    }
    arrays["L_raw"][:, 0, :3] = [0, 1, -1]
    arrays["T_raw"][:, 0, :3] = [0, 1, -1]
    return arrays


def _equal(a, b) -> None:
    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("n,idx", [(150, [3, 0, 5, 5, 1]), (512, [2, 0, 2])])
def test_native_collate_matches_jax_and_numpy(counted, n, idx):
    from csat_tpu.data.dataset import collate_indexed as jax_collate_indexed
    from csat_tpu.native import load_collate as jax_load_collate

    assert jax_load_collate() is not None, "the JAX package's native collate did not build"
    arrays, idx = _arrays(6, n), np.asarray(idx)
    out = port_data.collate_indexed(arrays, idx, n)
    assert counted.calls == 1
    _equal(out, port_data.collate({k: v[idx] for k, v in arrays.items()}, n))
    _equal(out, jax_collate_indexed(arrays, idx, n))
    # a max_src_len below N clips the offset distances at both table ends
    _equal(port_data.collate_indexed(arrays, idx, n // 3),
           port_data.collate({k: v[idx] for k, v in arrays.items()}, n // 3))


def _guard_cases():
    base = _arrays(6, 8, seed=2)
    wide = {**base, "L_raw": base["L_raw"].astype(np.int32), "T_raw": base["T_raw"].astype(np.int32)}
    view = {**base, "L_raw": base["L_raw"][:, :6, :6], "T_raw": base["T_raw"][:, :6, :6]}
    return [("int32", wide, [1, 4], 8), ("view", view, [1, 4], 6),
            ("empty", base, [], 8), ("negative", base, [-1, 0], 8)]


def test_mismatched_relation_shapes_take_numpy(counted):
    """L and T of different sample counts: the kernel would read T past its
    end for an index valid in L (the JAX package has no such guard); the
    port collates with NumPy."""
    base = _arrays(6, 8, seed=4)
    arrays, idx = {**base, "T_raw": base["T_raw"][:4].copy()}, np.asarray([1, 3])
    _equal(port_data.collate_indexed(arrays, idx, 8),
           port_data.collate({k: v[idx] for k, v in arrays.items()}, 8))
    assert counted.calls == 0


@pytest.mark.parametrize("case", _guard_cases(), ids=lambda c: c[0])
def test_guarded_batches_take_numpy(counted, case):
    """JAX's routes to NumPy (``csat_tpu/data/dataset.py:300-314``): a non-int16
    array, a non-contiguous view (every bucketed batch), an empty index, a
    negative index (NumPy's wraparound) — the same results in both packages,
    the native kernel never called."""
    from csat_tpu.data.dataset import collate_indexed as jax_collate_indexed

    _, arrays, idx, n = case
    idx = np.asarray(idx, dtype=np.int64)
    out = port_data.collate_indexed(arrays, idx, n)
    _equal(out, jax_collate_indexed(arrays, idx, n))
    _equal(out, port_data.collate({k: v[idx] for k, v in arrays.items()}, n))
    assert counted.calls == 0


def test_out_of_range_index_raises_like_numpy(counted):
    from csat_tpu.data.dataset import collate_indexed as jax_collate_indexed

    arrays = _arrays(6, 8, seed=2)
    for collate_indexed in (port_data.collate_indexed, jax_collate_indexed):
        with pytest.raises(IndexError):
            collate_indexed(arrays, np.asarray([6]), 8)
    assert counted.calls == 0


def test_opt_out_takes_numpy(monkeypatch):
    monkeypatch.setenv("CSAT_TPU_NO_NATIVE_COLLATE", "1")
    assert native.load_collate() is None
    arrays, idx = _arrays(6, 8, seed=3), np.asarray([1, 2])
    _equal(port_data.collate_indexed(arrays, idx, 8),
           port_data.collate({k: v[idx] for k, v in arrays.items()}, 8))


VOCAB = [
    "the", "cat", "sat", "on", "mat", "a", "dog", "ran", "fast", "very",
    "running", "runs", "sorted", "sorting", "items", "lists", "list", "Returns", "value.",
    # synonym-table members (and inflections): the stage-3 module and its
    # stem-indexed lookup
    "creates", "makes", "built", "removes", "deletes", "large", "big",
    "error", "mistake", "quickly", "fetches", "retrieves", "obtain", "verify", "checks",
]


@pytest.mark.parametrize("version", ["1.5", "2005"])
def test_native_meteor_matches_python_and_jax(monkeypatch, version):
    from csat_tpu.metrics.meteor import meteor_score as jax_meteor_score
    from csat_tpu.native import load_meteor as jax_load_meteor
    from csat_tpu_torch.metrics.meteor import meteor_score

    assert jax_load_meteor() is not None, "the JAX package's native METEOR did not build"
    calls = []
    inner = native.native_meteor_score
    monkeypatch.setattr(native, "native_meteor_score",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    rng = random.Random(0)
    spaced = 0
    for i in range(200):
        hyp = [rng.choice(VOCAB) for _ in range(rng.randint(1, 12))]
        ref = [rng.choice(VOCAB) for _ in range(rng.randint(1, 14))]
        if i % 10 == 0:  # a token holding whitespace: the C ABI cannot carry it
            hyp[0] = "sorted  list"
            spaced += 1
        ours = meteor_score(hyp, ref, version=version)
        plain = meteor_score(hyp, ref, use_native=False, version=version)
        jax = jax_meteor_score(hyp, ref, use_native=True, version=version)
        assert abs(ours - plain) < 1e-9 and abs(ours - jax) < 1e-9, (hyp, ref, ours, plain, jax)
    # every pair went through the C++ scorer but those with a whitespace token
    assert spaced == 20 and len(calls) == 200 - spaced


def test_broken_source_raises(tmp_path, monkeypatch):
    bad = tmp_path / "collate.cpp"
    bad.write_text(native.SOURCES["collate"].read_text().replace("int64_t b = 0", "int64_t b = "))
    build = tmp_path / "build"
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build_library(bad, "-O3", build)
    assert "error" in str(e.value)
    assert not list(build.iterdir())  # no library, no temporary file left
    # the loader and the collate raise too: no quiet fall back to NumPy
    monkeypatch.setitem(native.SOURCES, "collate", bad)
    monkeypatch.delitem(native._LIBS, "collate", raising=False)
    monkeypatch.delenv("CSAT_TPU_NO_NATIVE_COLLATE", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        port_data.collate_indexed(_arrays(6, 8), np.asarray([1, 2]), 8)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build_library(native.SOURCES["collate"], "-O3", tmp_path / "other")


def test_built_once_under_build_native_and_reused(monkeypatch, tmp_path):
    fresh = native.build_library(native.SOURCES["collate"], "-O3", tmp_path)
    assert native.BUILT[fresh.name] > 0 and [p.name for p in tmp_path.iterdir()] == [fresh.name]
    native.load_collate()
    native.load_meteor()
    for name, src in native.SOURCES.items():
        path = native.library_path(src, native.OPT[name])
        assert path.parent == REPO / "build" / "native" and path.exists()
        stat = path.stat()

        def no_compiler(*a, **kw):
            raise AssertionError("rebuilt an existing library")

        monkeypatch.setattr(native.subprocess, "run", no_compiler)
        assert native.build_library(src, native.OPT[name]) == path
        assert path.stat().st_mtime_ns == stat.st_mtime_ns


def _code(path: Path) -> list:
    """The C++ source's tokens with ``//`` and ``/* */`` comments left out."""
    text = re.sub(r"/\*.*?\*/", " ", path.read_text(), flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return text.split()


@pytest.mark.parametrize("name", ["collate", "meteor"])
def test_sources_are_the_jax_packages(name):
    assert _code(native.SOURCES[name]) == _code(REPO / "csat_tpu" / "native" / f"{name}.cpp")
