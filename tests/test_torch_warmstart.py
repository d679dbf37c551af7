"""Warm start on the port: the kernel library store, on the CPU.

* the store: the JAX package's store drills (``tests/test_warmstart.py``) on
  the port's ``WarmStartStore`` — root precedence (``CSAT_TPU_NO_CACHE`` >
  explicit directory > ``CSAT_TPU_CACHE_DIR`` > the default), the key's
  sensitivity to every field, the round trip, every structured miss
  (``toolchain_mismatch`` where JAX has ``jaxlib_mismatch``), disabled and
  unwritable stores that never raise; the cache root's precedence;
* the ``ops/build.py`` hook with a stub compiler and loader (no ``nvcc`` here):
  a cold load is an ``absent`` miss that builds once and saves; a fresh
  process on that store is a hit that builds nothing and loads the stored
  bytes; a corrupt or truncated entry is a ``digest_mismatch`` that never
  reaches the loader and rebuilds; a hand-copied entry of another toolchain
  is refused; the kill switch gives ``disabled`` and saves nothing;
* the engine books each library's provenance (hits, misses, events).
"""

import hashlib
import json
import os
import types

import pytest

from csat_tpu_torch.serve.warmstart import WarmStartStore, store_root


def test_store_root_precedence(monkeypatch, tmp_path):
    monkeypatch.setenv("CSAT_TPU_NO_CACHE", "1")
    assert store_root(None) is None
    assert store_root(types.SimpleNamespace(serve_warmstart_dir="/x")) is None
    monkeypatch.setenv("CSAT_TPU_NO_CACHE", "0")
    cfg = types.SimpleNamespace(serve_warmstart_dir=str(tmp_path / "explicit"))
    assert store_root(cfg) == str(tmp_path / "explicit")
    monkeypatch.setenv("CSAT_TPU_CACHE_DIR", str(tmp_path / "cache"))
    assert store_root(types.SimpleNamespace(serve_warmstart_dir="")) == str(
        tmp_path / "cache" / "warmstart")
    (tmp_path / "file").write_text("x")  # a cache root that cannot be created
    monkeypatch.setenv("CSAT_TPU_CACHE_DIR", str(tmp_path / "file" / "cache"))
    assert store_root(None) is None


def test_cache_root_precedence_and_unwritable(monkeypatch, tmp_path):
    from csat_tpu_torch.utils.cache import cache_root

    monkeypatch.delenv("CSAT_TPU_CACHE_DIR", raising=False)
    monkeypatch.setenv("CSAT_TPU_NO_CACHE", "yes")
    assert cache_root(str(tmp_path / "a")) is None
    monkeypatch.setenv("CSAT_TPU_NO_CACHE", "")
    assert cache_root(str(tmp_path / "a")) == str(tmp_path / "a")
    monkeypatch.setenv("CSAT_TPU_CACHE_DIR", str(tmp_path / "env"))
    assert cache_root(str(tmp_path / "a")) == str(tmp_path / "env")
    (tmp_path / "file").write_text("x")
    logs = []
    monkeypatch.setenv("CSAT_TPU_CACHE_DIR", str(tmp_path / "file" / "sub"))
    assert cache_root(None, log=logs.append) is None and logs


def test_key_is_sensitive_to_every_field():
    fields = {"source": "s0", "flags": "-O3", "git": "abc", "toolchain": "nvcc 12"}
    k0 = WarmStartStore.key("paged_decode", fields)
    assert k0 == WarmStartStore.key("paged_decode", dict(fields))
    assert k0 != WarmStartStore.key("flex_fwd_tc", fields)
    for name in fields:
        assert k0 != WarmStartStore.key("paged_decode", dict(fields, **{name: "CHANGED"})), name


def test_roundtrip_and_structured_miss_reasons(tmp_path):
    store = WarmStartStore(str(tmp_path))
    fields = {"source": "s0", "toolchain": "nvcc 12"}
    assert store.load("lib", fields) == (None, "absent")
    assert store.save("lib", fields, b"\x7fELFpayload") is True
    assert store.load("lib", fields) == (b"\x7fELFpayload", "hit")
    assert store.entries() == [store.path("lib", fields)]
    with open(store.path("lib", fields), "rb") as f:
        header = json.loads(f.readline())
    assert header["magic"] == "csat-warmstart-v1" and header["fields"]["toolchain"] == "nvcc 12"
    assert store.corrupt_entries() == 1
    assert store.load("lib", fields) == (None, "digest_mismatch")
    with open(store.path("lib", fields), "wb") as f:
        f.write(b"not json at all\n\x00\x00")
    assert store.load("lib", fields) == (None, "corrupt_header")
    # a hand-copied entry of another toolchain, its digest intact
    other = json.dumps({"magic": "csat-warmstart-v1", "program": "lib",
                        "payload_sha256": hashlib.sha256(b"pp").hexdigest(),
                        "fields": {"source": "s0", "toolchain": "nvcc 11"}}).encode()
    with open(store.path("lib", fields), "wb") as f:
        f.write(other + b"\n" + b"pp")
    assert store.load("lib", fields) == (None, "toolchain_mismatch")
    os.remove(store.path("lib", fields))
    os.mkdir(store.path("lib", fields))  # exists, but cannot be read
    assert store.load("lib", fields) == (None, "io_error")


def test_disabled_and_unwritable_stores_never_raise(tmp_path):
    off = WarmStartStore(None)
    assert not off.enabled
    assert off.load("lib", {}) == (None, "disabled")
    assert off.save("lib", {}, b"x") is False
    assert off.entries() == [] and off.corrupt_entries() == 0 and off.path("lib", {}) is None
    (tmp_path / "file").write_text("x")
    logs = []
    bad = WarmStartStore(str(tmp_path / "file" / "ws"), log=logs.append)
    assert not bad.enabled and logs and bad.load("lib", {}) == (None, "disabled")


# ---------------------------------------------------------------------------
# the ops/build.py hook, with a stub compiler and loader
# ---------------------------------------------------------------------------

@pytest.fixture
def stub_build(monkeypatch, tmp_path):
    """``ops/build.py`` with an empty process (no library loaded), its build
    directory in ``tmp_path``, a stub ``nvcc`` (``built``: one entry per
    library compiled) and a stub loader (``loaded``: the bytes each load
    read)."""
    from csat_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "PROVENANCE", {})
    built, loaded = [], []

    def nvcc_build(todo):
        for n in todo:
            build.build_dir().mkdir(parents=True, exist_ok=True)
            build.library_path(n).write_bytes(b"\x7fELF built " + n.encode())
            built.append(n)

    def open_lib(path):
        loaded.append(path.read_bytes())
        return types.SimpleNamespace(**{fn: types.SimpleNamespace() for fn in build.KERNELS})

    monkeypatch.setattr(build, "_nvcc_build", nvcc_build)
    monkeypatch.setattr(build, "_open", open_lib)

    def fresh_process():
        """A new process on the same store: nothing loaded, no build dir."""
        build._LIBS.clear()
        build.PROVENANCE.clear()
        for f in build.build_dir().glob("*.so"):
            f.unlink()

    return build, built, loaded, fresh_process


def test_cold_then_warm_builds_once(stub_build, tmp_path):
    build, built, loaded, fresh = stub_build
    store = WarmStartStore(str(tmp_path / "ws"))
    build.load_library("paged_decode", store)
    assert build.PROVENANCE["paged_decode"] == "absent" and built == ["paged_decode"]
    assert len(store.entries()) == 1
    build.load_library("paged_decode", store)  # loaded once per process
    assert built == ["paged_decode"] and len(loaded) == 1
    fresh()
    build.load_library("paged_decode", store)
    assert build.PROVENANCE["paged_decode"] == "hit"
    assert built == ["paged_decode"], "a hit must not run the compiler"
    assert loaded[-1] == b"\x7fELF built paged_decode"
    assert build.library_path("paged_decode").read_bytes() == loaded[-1]


@pytest.mark.parametrize("damage", ["corrupt", "truncate"])
def test_damaged_entry_never_reaches_the_loader(stub_build, tmp_path, damage):
    build, built, loaded, fresh = stub_build
    store = WarmStartStore(str(tmp_path / "ws"))
    build.load_library("flex_fwd_tc", store)
    fresh()
    (path,) = store.entries()
    if damage == "corrupt":
        assert store.corrupt_entries() == 1
    else:
        data = open(path, "rb").read()
        open(path, "wb").write(data[:-5])
    build.load_library("flex_fwd_tc", store)
    assert build.PROVENANCE["flex_fwd_tc"] == "digest_mismatch"
    assert built == ["flex_fwd_tc"] * 2
    assert all(b == b"\x7fELF built flex_fwd_tc" for b in loaded)
    fresh()
    build.load_library("flex_fwd_tc", store)  # the rebuild re-seeded the store
    assert build.PROVENANCE["flex_fwd_tc"] == "hit" and len(built) == 2


def test_other_toolchain_and_kill_switch(stub_build, tmp_path, monkeypatch):
    import shutil

    build, built, loaded, fresh = stub_build
    store = WarmStartStore(str(tmp_path / "ws"))
    build.load_library("paged_decode", store)
    fresh()
    fields = build.store_fields("paged_decode")
    skewed = dict(fields, toolchain="nvcc 0.0 / torch 0 / cuda 0 / sm 0.0")
    monkeypatch.setattr(build, "store_fields", lambda name: skewed)
    shutil.copy(store.path("paged_decode", fields), store.path("paged_decode", skewed))
    build.load_library("paged_decode", store)
    assert build.PROVENANCE["paged_decode"] == "toolchain_mismatch" and len(built) == 2
    fresh()
    monkeypatch.setenv("CSAT_TPU_NO_CACHE", "1")
    off = WarmStartStore(store_root(None))
    build.load_library("paged_decode", off)
    assert build.PROVENANCE["paged_decode"] == "disabled" and len(built) == 3
    fresh()
    build.load_library("paged_decode")  # no store asked
    assert build.PROVENANCE["paged_decode"] == "off"


def test_store_fields_cover_source_flags_toolchain_and_rev():
    from csat_tpu_torch.ops import build

    f = build.store_fields("paged_decode")
    assert set(f) == {"source", "flags", "git", "toolchain"}
    assert f["source"] != build.store_fields("flex_fwd_tc")["source"]
    assert "sm_90a" in f["flags"] and f["toolchain"].startswith("nvcc ")


def test_engine_books_library_provenance(stub_build, tmp_path, monkeypatch):
    """The engine's warm-up through the store: a cold engine books absent
    misses, a warm one hits; each library once, with its event; the CPU
    engine itself loads nothing."""
    from torch_parity import configs
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.serve import ServeEngine

    build, built, _, fresh = stub_build
    _, cfg = configs(serve_warmstart=True, serve_warmstart_dir=str(tmp_path / "ws"))
    model = CSATrans(cfg, 200, 300, device="cpu", triplet_vocab_size=50)
    for want in ("absent", "hit"):
        eng = ServeEngine(model, cfg, device="cpu")
        assert eng.warmstart.enabled and eng.warmstart_provenance == {}
        eng._warm_libraries()
        assert eng.warmstart_provenance == {lib: want for lib in build.SERVE_LIBRARIES}
        hits, misses = (2, 0) if want == "hit" else (0, 2)
        assert (eng.stats.warmstart_hits, eng.stats.warmstart_misses) == (hits, misses)
        names = [n for _, n, _, _ in eng.obs.events()]
        assert names.count("warmstart.hit" if want == "hit" else "warmstart_miss") == 2
        fresh()
    assert built == list(build.SERVE_LIBRARIES)
