"""KV tiering on the port, on the CPU, against the JAX package.

* the store: the JAX package's store drills (``tests/test_tiering.py``) run
  on both packages' ``TieredPageStore``, and one random sequence of ``put`` /
  ``get`` / ``drop`` / ``corrupt_entries`` gives both the same results, the
  same events and byte-identical disk files;
* the snapshot: the port's ``tier_gather`` = JAX's ``build_tier_gather`` on
  the same pool contents (shape, layer order past ten layers, values), and
  ``tier_restore`` writes exactly the gathered bytes, dropping sentinel lanes;
* the engine: the JAX drills on the port's ``tier_pair`` (JAX's micro config,
  converted weights, a pool of half the slots' worst case): a spilled and
  restored chain serves the never-spilled tokens bit for bit at f32 and int8
  pages, events and gauges reach the stats, a chain with live sharers never
  spills, a corrupted snapshot degrades to a re-prefill, a rebuild drops the
  tiers, int8 snapshots refuse an f32 pool (``dtype_mismatch``), the config's
  refusals are JAX's, and the tier faults act only on a tiered engine;
* the port's tiered tokens = JAX's tiered engine's, and a ``(1, 2)`` serve
  mesh's payloads = the solo engine's byte for byte.
"""

import os

import numpy as np
import pytest
import torch

from torch_parity import configs, jax_model_and_params, request_samples, torch_model
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TIER_OVER = dict(full_att=True, dropout=0.0, attention_dropout=0.0, cse_empty_rows="zero",
                 serve_slots=4, bucket_src_lens=(48,), serve_page_size=4, serve_tiering=True,
                 serve_tier_host_pages=8)


class _Recorder:
    def __init__(self):
        self.events = []

    def emit(self, name, **fields):
        self.events.append((name, fields))

    def named(self, name):
        return [f for n, f in self.events if n == name]


def _store_cls(pkg):
    if pkg == "jax":
        from csat_tpu.serve.tiering import MISS_REASONS, TieredPageStore
    else:
        from csat_tpu_torch.serve.tiering import MISS_REASONS, TieredPageStore
    return TieredPageStore, MISS_REASONS


def _put(store, key, payload, pages):
    store.put(key, payload, {"pages": pages})


PKGS = pytest.mark.parametrize("pkg", ["jax", "torch"])


@PKGS
def test_store_roundtrip_demotion_and_disk_format(pkg, tmp_path):
    import json

    Store, _ = _store_cls(pkg)
    rec = _Recorder()
    store = Store(host_pages=4, root=str(tmp_path), obs=rec)
    pa, pb = b"a" * 64, b"b" * 96
    _put(store, b"A" * 16, pa, 3)
    _put(store, b"B" * 16, pb, 3)  # host 6 > budget 4: A demotes to disk
    assert store.host_pages_in_use == 3 and store.disk_pages_in_use == 3
    path = os.path.join(str(tmp_path), (b"A" * 16).hex() + ".kvp")
    with open(path, "rb") as f:
        header = json.loads(f.readline())
        assert f.read() == pa
    assert header["magic"] == "csat-kvtier-v1" and header["meta"]["nbytes"] == 64
    assert store.get(b"A" * 16)[::2] == (pa, "disk")
    assert store.get(b"B" * 16)[::2] == (pb, "host")
    assert [n for n, _ in rec.events].count("tier.demote") == 1
    assert store.restores == 2 and store.accounting_errors() == 0
    store.clear()
    assert len(store) == 0 and not os.path.exists(path)


@PKGS
def test_store_disk_budget_evicts_lru_files(pkg, tmp_path):
    Store, _ = _store_cls(pkg)
    store = Store(host_pages=1, disk_pages=2, root=str(tmp_path))
    for i, key in enumerate((b"A" * 16, b"B" * 16, b"C" * 16, b"D" * 16)):
        _put(store, key, bytes([i]) * 32, 1)
    assert not store.has(b"A" * 16) and store.has(b"B" * 16) and store.has(b"C" * 16)
    assert store.disk_pages_in_use == 2
    assert len([f for f in os.listdir(str(tmp_path)) if f.endswith(".kvp")]) == 2


@PKGS
def test_store_unwritable_root_degrades_to_host_only(pkg, tmp_path):
    Store, _ = _store_cls(pkg)
    blocker = tmp_path / "file"
    blocker.write_text("x")
    logs = []
    store = Store(host_pages=1, root=str(blocker / "tiers"), log=logs.append)
    assert store.root is None and logs
    _put(store, b"A" * 16, b"a" * 8, 1)
    _put(store, b"B" * 16, b"b" * 8, 1)
    assert not store.has(b"A" * 16) and store.has(b"B" * 16)
    assert store.get(b"A" * 16) == (None, None, "absent")


@PKGS
def test_store_every_miss_reason_is_structured(pkg, tmp_path):
    Store, reasons = _store_cls(pkg)
    rec = _Recorder()
    store = Store(root=str(tmp_path), obs=rec)

    def miss(key, expect):
        assert store.get(key) == (None, None, expect)
        assert not store.has(key)

    miss(b"Z" * 16, "absent")
    _put(store, b"T" * 16, b"t" * 32, 1)
    store._host[b"T" * 16].payload = b"t" * 16
    miss(b"T" * 16, "truncated")
    _put(store, b"D" * 16, b"d" * 32, 1)
    store._host[b"D" * 16].payload = b"X" * 32
    miss(b"D" * 16, "digest_mismatch")

    def demote(key, payload):
        _put(store, key, payload, 1)
        store.host_budget = 1
        _put(store, b"\xee" * 16, b"e" * 8, 1)
        store.host_budget = 0
        store.drop(b"\xee" * 16)
        return os.path.join(str(tmp_path), key.hex() + ".kvp")

    path = demote(b"H" * 16, b"h" * 32)
    with open(path, "wb") as f:
        f.write(b"not a header\n" + b"h" * 32)
    miss(b"H" * 16, "corrupt_header")
    os.remove(demote(b"I" * 16, b"i" * 32))
    miss(b"I" * 16, "io_error")
    path = demote(b"U" * 16, b"u" * 32)
    with open(path, "rb") as f:
        header = f.readline()
    with open(path, "wb") as f:
        f.write(header + b"u" * 8)
    miss(b"U" * 16, "truncated")
    demote(b"C" * 16, b"c" * 32)
    assert store.corrupt_entries() == 1
    miss(b"C" * 16, "digest_mismatch")
    _put(store, b"S" * 16, b"s" * 32, 1)
    store.invalidate(b"S" * 16, "dtype_mismatch")
    events = rec.named("tier.restore_miss")
    assert len(events) == store.restore_misses == 8
    assert {e["reason"] for e in events} == set(reasons)
    assert store.accounting_errors() == 0


def test_store_sequences_equal_across_packages(tmp_path):
    """One random sequence of put / get / drop / invalidate / corrupt on both
    stores: the same results, events, counters and disk files, byte for
    byte."""
    from csat_tpu.serve.tiering import TieredPageStore as JStore
    from csat_tpu_torch.serve.tiering import TieredPageStore as TStore

    rng = np.random.default_rng(3)
    stores, recs = [], []
    for name, cls in (("jax", JStore), ("torch", TStore)):
        recs.append(_Recorder())
        stores.append(cls(host_pages=5, disk_pages=7, root=str(tmp_path / name), obs=recs[-1]))
    keys = [bytes([i]) * 16 for i in range(6)]
    outs = ([], [])
    files_seen = 0
    for _ in range(120):
        op = rng.choice(["put", "put", "get", "get", "drop", "invalidate", "corrupt"],
                        p=[0.25, 0.15, 0.25, 0.15, 0.1, 0.05, 0.05])
        key = keys[int(rng.integers(len(keys)))]
        pages = int(rng.integers(1, 4))
        payload = rng.bytes(int(rng.integers(4, 64)))
        for store, out in zip(stores, outs):
            if op == "put":
                store.put(key, payload, {"pages": pages, "kv_dtype": "int8"})
            elif op == "get":
                out.append(store.get(key))
            elif op == "drop":
                store.drop(key)
            elif op == "invalidate":
                store.invalidate(key, "dtype_mismatch")
            else:
                out.append(store.corrupt_entries())
            out.append((store.host_pages_in_use, store.disk_pages_in_use, store.spills,
                        store.demotions, store.restores, store.restore_misses, store.keys()))
        # the disk tiers after every operation: the same files, byte for byte
        files = [sorted(os.listdir(tmp_path / name)) for name in ("jax", "torch")]
        assert files[0] == files[1]
        for f in files[0]:
            assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "torch" / f).read_bytes()
        files_seen += len(files[0])
    assert outs[0] == outs[1] and files_seen > 0
    assert recs[0].events == recs[1].events
    assert {n for n, _ in recs[0].events} >= {"tier.spill", "tier.demote", "tier.restore",
                                              "tier.restore_miss", "tier.evict"}


# ---------------------------------------------------------------------------
# the snapshot programs
# ---------------------------------------------------------------------------

def _random_pools(n_layers=11, num_pages=9, heads=4, page=4, dh=8, dtype="int8", seed=0):
    """The same random page contents as a JAX ``PagedPool`` (``layer_{i}``
    keys) and the port's (a list by layer)."""
    import jax.numpy as jnp

    from csat_tpu.serve.pages import PagedPool as JPool
    from csat_tpu_torch.serve.pages import PagedPool as TPool

    rng = np.random.default_rng(seed)
    shape = (num_pages, heads, page, dh)
    layers = []
    for _ in range(n_layers):
        if dtype == "int8":
            k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        else:
            k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        ks, vs = (rng.random(shape[:-1] + (1,)).astype(np.float32) for _ in range(2))
        layers.append(dict(k=k, v=v, k_scale=ks, v_scale=vs))
    jpool = JPool(pages={f"layer_{i}": {n: jnp.asarray(a) for n, a in e.items()}
                         for i, e in enumerate(layers)},
                  self_pt=None, cross_pt=None, src_mask=None, tok=None, pos=None, limit=None,
                  done=None, prev_pad=None, toks=None)
    z = torch.zeros(1, dtype=torch.int32)
    tpool = TPool(pages=[{n: torch.from_numpy(a.copy()) for n, a in e.items()} for e in layers],
                  self_pt=z, cross_pt=z, src_mask=z, tok=z, pos=z, limit=z, done=z, prev_pad=z,
                  toks=z)
    return jpool, tpool


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_tier_gather_equals_jax_past_ten_layers(dtype):
    """Eleven layers: JAX stacks ``layer_10`` second (sorted names); the
    port's snapshot must stack the same layers in the same order."""
    from csat_tpu.serve.pages import build_tier_gather
    from csat_tpu_torch.serve.pages import tier_gather, tier_layer_order

    assert tier_layer_order(11) == [0, 1, 10, 2, 3, 4, 5, 6, 7, 8, 9]
    jpool, tpool = _random_pools(dtype=dtype)
    row = np.asarray([3, 7, 1, 0, 0], np.int32)  # a chain padded with the null page
    jvals, jscales = build_tier_gather()(jpool, row)
    tvals, tscales = tier_gather(tpool, row)
    assert tuple(tvals.shape) == jvals.shape == (11, 2, 5, 4, 4, 8)
    assert tuple(tscales.shape) == jscales.shape == (11, 2, 5, 4, 4, 1)
    assert str(tvals.dtype).endswith(str(jvals.dtype))
    np.testing.assert_allclose(tvals.numpy().astype(np.float64),
                               np.asarray(jvals).astype(np.float64), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tscales.numpy(), np.asarray(jscales), rtol=0, atol=1e-6)


def test_tier_restore_writes_the_gathered_bytes_and_drops_sentinels():
    from csat_tpu_torch.serve.pages import tier_gather, tier_restore

    _, src = _random_pools(seed=1)
    _, dst = _random_pools(seed=2)
    before = [{k: t.clone() for k, t in e.items()} for e in dst.pages]
    vals, scales = tier_gather(src, [3, 7, 1, 5])
    row = [6, 2, 9, 9]  # 9 = num_pages: the sentinel lanes are dropped
    tier_restore(dst, row, vals, scales)
    got_v, got_s = tier_gather(dst, [6, 2])
    assert torch.equal(got_v, vals[:, :, :2]) and torch.equal(got_s, scales[:, :, :2])
    for e, b in zip(dst.pages, before):
        for key in e:
            for p in (0, 1, 3, 4, 5, 7, 8):  # every page but the two written
                assert torch.equal(e[key][p], b[key][p]), (key, p)


# ---------------------------------------------------------------------------
# the engine drills
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tier_pair(tmp_path_factory):
    """(jcfg, params, make_pair): ``make_pair(page_dtype)`` gives (cfg,
    tiered, plain) — port engines over one converted model on the same pool
    of half the slots' worst case; the plain engine never spills."""
    from csat_tpu_torch.serve import ServeEngine
    from csat_tpu_torch.serve.pages import page_geometry

    jcfg, _ = configs(**TIER_OVER)
    jmodel, params = jax_model_and_params(jcfg, seed=1)
    made = {}

    def make_pair(page_dtype="float32"):
        if page_dtype not in made:
            _, cfg = configs(**TIER_OVER, serve_kv_page_dtype=page_dtype,
                             serve_tier_dir=str(tmp_path_factory.mktemp("kv_tiers")),
                             obs_postmortem_dir="")
            geo = page_geometry(cfg)
            tight = cfg.replace(serve_num_pages=1 + cfg.serve_slots * geo.rect_pages_per_slot // 2)
            model = torch_model(tight, params)
            made[page_dtype] = (tight, ServeEngine(model, tight, device="cpu"),
                                ServeEngine(model, tight.replace(serve_tiering=False),
                                            device="cpu"))
        return made[page_dtype]

    make_pair.jmodel = jmodel
    yield jcfg, params, make_pair
    for _, tiered, plain in made.values():
        tiered.close()
        plain.close()


def _reset(eng):
    assert eng.occupancy == 0 and eng.queue_depth == 0
    for _, chain in eng._prefix.evict_for(1 << 30):
        eng._allocator.free(chain)
    if eng._tiers is not None:
        eng._tiers.clear()


def _no_leaks(eng):
    assert eng.occupancy == 0 and eng.queue_depth == 0
    assert eng.page_leaks() == 0 and eng.chain_leaks() == 0


def _tokens(results):
    return [np.asarray(r.tokens) for r in results]


@pytest.mark.parametrize("page_dtype", ["float32", "int8"])
def test_spill_restore_bit_identity(tier_pair, page_dtype):
    """Warm both engines, spill the tiered one's whole warm set, replay: the
    replay restores from both tiers and its tokens are the never-spilled
    engine's bit for bit; a restored admission is a prefix hit."""
    jcfg, _, make_pair = tier_pair
    cfg, tiered, plain = make_pair(page_dtype)
    _reset(tiered)
    _reset(plain)
    samples = request_samples(jcfg, 6, seed=1, lo=5)
    ref = _tokens(plain.generate(samples, max_new_tokens=4))
    assert all(r.ok for r in tiered.generate(samples, max_new_tokens=4))
    spilled = tiered.spill_all()
    assert spilled > 0 and len(tiered._prefix) == 0 and len(tiered._tiers) >= spilled
    assert tiered._tiers.demotions > 0 and tiered._tiers.disk_pages_in_use > 0
    r0, hits0 = tiered._tiers.restores, tiered.stats.prefix_hits
    got = _tokens(tiered.generate(samples, max_new_tokens=4))
    assert tiered._tiers.restores - r0 == len(samples) and tiered._tiers.restore_misses == 0
    assert all(np.array_equal(a, b) for a, b in zip(ref, got))
    assert tiered.stats.prefix_hits - hits0 >= len(samples)
    _no_leaks(tiered)


def test_restored_pages_gather_the_spilled_bytes(tier_pair):
    """A chain's payload, restored into fresh pages and gathered again, is
    the spilled payload byte for byte (values and scales)."""
    from csat_tpu_torch.serve.engine import _host_array
    from csat_tpu_torch.serve.pages import tier_gather

    jcfg, _, make_pair = tier_pair
    _, tiered, _ = make_pair("int8")
    _reset(tiered)
    s = request_samples(jcfg, 1, seed=9, lo=20)[0]
    tiered.generate([s], max_new_tokens=2)
    h, entry = next(iter(tiered._prefix._entries.items()))
    vals, scales = tier_gather(tiered._pool, entry.chain)
    spilled = _host_array(vals).tobytes() + scales.numpy().tobytes()
    tiered.spill_all()
    payload, meta, _ = tiered._tiers.get(h)
    assert payload == spilled and meta["dtype"] == "|i1" and meta["kv_dtype"] == "int8"
    tiered.generate([s], max_new_tokens=2)  # restores
    chain = tiered._prefix._entries[h].chain
    vals, scales = tier_gather(tiered._pool, chain)
    assert _host_array(vals).tobytes() + scales.numpy().tobytes() == spilled
    _no_leaks(tiered)


def test_restore_events_and_gauges_flow_to_stats(tier_pair):
    jcfg, _, make_pair = tier_pair
    _, tiered, _ = make_pair()
    _reset(tiered)
    samples = request_samples(jcfg, 4, seed=2, lo=5)
    tiered.generate(samples, max_new_tokens=3)
    tiered.spill_all()
    tiered.generate(samples, max_new_tokens=3)
    s = tiered.stats.summary()
    assert s["tier_spills"] > 0 and s["tier_restores"] > 0 and s["restore_miss_total"] == 0
    assert s["tier_restore_p95_s"] >= 0.0
    assert s["tier_host_pages"] == tiered._tiers.host_pages_in_use
    assert s["tier_disk_pages"] == tiered._tiers.disk_pages_in_use
    names = [n for _, n, _, _ in tiered.obs.events()]
    assert {"tier.spill", "tier.restore", "tier.spill_all"} <= set(names)
    _no_leaks(tiered)


def test_live_sharers_pin_chain_against_spill(tier_pair):
    from csat_tpu_torch.serve.prefix import sample_hash

    jcfg, _, make_pair = tier_pair
    _, tiered, _ = make_pair()
    _reset(tiered)
    dup = request_samples(jcfg, 1, seed=55, lo=11)[0]
    h = sample_hash(dup)
    ids = [tiered.submit(dup, max_new_tokens=6)]
    for _ in range(30):
        if h in tiered._prefix._entries:
            break
        tiered.tick()
    ids.append(tiered.submit(dup, max_new_tokens=6))
    tiered.tick()  # the hit attaches
    assert tiered._prefix._entries[h].refs > 0
    tiered.spill_all()
    assert h in tiered._prefix._entries and not tiered._tiers.has(h)
    tiered.drain()
    assert all(tiered.pop_result(i).ok for i in ids)
    assert tiered.spill_all() >= 1 and tiered._tiers.has(h)
    _no_leaks(tiered)


def test_corrupted_restore_degrades_to_reprefill(tier_pair):
    from csat_tpu_torch.serve.tiering import MISS_REASONS

    jcfg, _, make_pair = tier_pair
    _, tiered, plain = make_pair()
    _reset(tiered)
    _reset(plain)
    samples = request_samples(jcfg, 5, seed=3, lo=5)
    ref = _tokens(plain.generate(samples, max_new_tokens=4))
    tiered.generate(samples, max_new_tokens=4)
    tiered.spill_all()
    assert tiered.corrupt_tiers() > 0
    m0, p0 = tiered._tiers.restore_misses, tiered.prefills
    got = _tokens(tiered.generate(samples, max_new_tokens=4))
    assert tiered._tiers.restore_misses - m0 == len(samples)
    assert tiered.stats.tier_restore_misses == tiered._tiers.restore_misses
    assert tiered.prefills > p0  # the misses re-ran the encoder
    assert all(np.array_equal(a, b) for a, b in zip(ref, got))
    missed = [f for _, n, _, f in tiered.obs.events() if n == "tier.restore_miss"]
    assert missed and {f["reason"] for f in missed} <= set(MISS_REASONS)
    assert any(f["reason"] == "digest_mismatch" for f in missed)
    _no_leaks(tiered)


def test_rebuild_drops_all_tiers_no_leak_storm(tier_pair):
    from csat_tpu_torch.resilience.faults import FaultInjector

    jcfg, _, make_pair = tier_pair
    cfg, tiered, _ = make_pair()
    _reset(tiered)
    rng = np.random.default_rng(7)
    ids = []
    for round_ in range(4):
        for s in request_samples(jcfg, int(rng.integers(2, 5)), seed=40 + round_, lo=5):
            ids.append(tiered.submit(s, max_new_tokens=int(rng.integers(0, 6))))
        for _ in range(int(rng.integers(1, 4))):
            tiered.tick()
        tiered.spill_all()
    tiered.fault_injector = FaultInjector(serve_decode_fail_ticks=[tiered.ticks + 1])
    try:
        for _ in range(50):
            if tiered.stats.rebuilds:
                break
            tiered.tick()
        assert tiered.stats.rebuilds == 1
        assert tiered._allocator.used_pages == 0 and len(tiered._prefix) == 0
        assert len(tiered._tiers) == 0
        assert tiered._tiers.host_pages_in_use == tiered._tiers.disk_pages_in_use == 0
        assert not [f for f in os.listdir(cfg.serve_tier_dir) if f.endswith(".kvp")]
        tiered.drain()
    finally:
        tiered.fault_injector = None
        tiered._rebuilds = 0
    assert all(tiered.pop_result(i).ok for i in ids)
    _no_leaks(tiered)


def test_int8_snapshot_refuses_an_f32_pool(tier_pair, tmp_path):
    """Spilled from an int8 engine, restored by an f32 engine over the same
    tier directory: a structured ``dtype_mismatch``, a re-prefill, no leak."""
    from csat_tpu_torch.serve import ServeEngine

    jcfg, params, make_pair = tier_pair
    cfg8, _, _ = make_pair("int8")
    cfg8 = cfg8.replace(serve_tier_dir=str(tmp_path), serve_tier_host_pages=1)
    model = torch_model(cfg8, params)
    samples = request_samples(jcfg, 3, seed=4, lo=5)
    spill = ServeEngine(model, cfg8, device="cpu")
    spill.generate(samples, max_new_tokens=2)
    spill.spill_all()
    assert spill._tiers.disk_pages_in_use > 0
    f32 = ServeEngine(model, cfg8.replace(serve_kv_page_dtype="float32"), device="cpu")
    f32._tiers._disk.update(spill._tiers._disk)  # adopt the int8 engine's disk index
    f32._tiers.disk_pages_in_use = spill._tiers.disk_pages_in_use
    res = f32.generate(samples, max_new_tokens=2)
    assert all(r.ok for r in res)
    missed = [f["reason"] for _, n, _, f in f32.obs.events() if n == "tier.restore_miss"]
    assert missed and set(missed) == {"dtype_mismatch"}
    assert f32.page_leaks() == 0 and f32.chain_leaks() == 0


@pytest.mark.parametrize("over", [dict(serve_tiering=True, serve_kv_layout="rect"),
                                  dict(serve_tiering=True, serve_prefix_cache=0),
                                  dict(serve_tier_host_pages=-1),
                                  dict(serve_tier_disk_pages=-1),
                                  dict(serve_tiering=True, serve_tier_host_pages=3)])
def test_tiering_config_rules_are_jax(over):
    from csat_tpu.configs import get_config as jax_config
    from csat_tpu_torch.configs import get_config as torch_config

    outcome = []
    for get in (jax_config, torch_config):
        try:
            get("python", **over)
            outcome.append("ok")
        except AssertionError:
            outcome.append("refused")
    assert outcome[0] == outcome[1]


def test_tier_faults_act_only_on_a_tiered_engine(tier_pair):
    """The injector's spill_storm / corrupt_tier ticks: on the tiered engine
    the warm set spills and the snapshots corrupt (noted as
    ``fault.injected.spill_storm`` / ``corrupt_tier_restore``); on an engine
    without tiers the same plan changes nothing."""
    from csat_tpu_torch.resilience.faults import FaultInjector

    jcfg, _, make_pair = tier_pair
    _, tiered, plain = make_pair()
    samples = request_samples(jcfg, 3, seed=6, lo=5)
    for eng in (tiered, plain):
        _reset(eng)
        eng.generate(samples, max_new_tokens=2)
        cached = len(eng._prefix)
        t = eng.ticks
        eng.fault_injector = FaultInjector(serve_spill_storm_ticks=[t],
                                           serve_corrupt_tier_ticks=[t + 1])
        try:
            eng.tick()
            eng.tick()
        finally:
            eng.fault_injector = None
        names = [n for _, n, _, _ in eng.obs.events()]
        assert {"fault.injected.spill_storm", "fault.injected.corrupt_tier_restore"} <= set(names)
        if eng is tiered:
            assert len(eng._prefix) == 0 and len(eng._tiers) >= cached
        else:
            assert len(eng._prefix) == cached and eng.chain_leaks() == 0
        eng.generate(samples, max_new_tokens=2)
        _no_leaks(eng)


@pytest.mark.parametrize("prefix_cache", [None, 2])
def test_tiered_tokens_equal_jax_tiered_engine(tier_pair, prefix_cache):
    """The JAX tiered engine (interpret mode) and the port's on the same
    converted weights, trace and spill: the same tokens, spills, restores,
    misses, prefix hits and prefill calls.  At a prefix cache of 2 entries
    over a pool with room to spare, the publishing insert (not pool
    pressure) evicts, and what it evicts must spill too."""
    from csat_tpu.serve.engine import ServeEngine as JServeEngine
    from csat_tpu_torch.serve import ServeEngine

    jcfg, params, make_pair = tier_pair
    cfg, _, _ = make_pair()
    over = {"serve_num_pages": cfg.serve_num_pages}
    if prefix_cache is not None:
        over = {"serve_prefix_cache": prefix_cache, "serve_num_pages": 8 * cfg.serve_num_pages}
    tag = f"_pc{prefix_cache}"
    samples = request_samples(jcfg, 5, seed=8, lo=5)
    jeng = JServeEngine(make_pair.jmodel, params,
                        jcfg.replace(backend="pallas",
                                     serve_tier_dir=cfg.serve_tier_dir + "_jax" + tag, **over),
                        sample_seed=0)
    teng = ServeEngine(torch_model(cfg, params),
                       cfg.replace(serve_tier_dir=cfg.serve_tier_dir + "_port" + tag, **over),
                       device="cpu")
    try:
        runs = []
        for eng in (jeng, teng):
            first = _tokens(eng.generate(samples, max_new_tokens=4))
            by_spill_all = eng.spill_all()
            again = _tokens(eng.generate(samples, max_new_tokens=4))
            t, st = eng._tiers, eng.stats
            runs.append((first + again, (t.spills, t.restores, t.restore_misses, t.demotions,
                                         st.prefix_hits, st.prefill_calls, by_spill_all)))
            assert eng.page_leaks() == 0 and eng.chain_leaks() == 0
    finally:
        jeng.close()
        teng.close()
    (jtok, jcount), (ttok, tcount) = runs
    assert jcount == tcount
    spills, restores, misses = jcount[:3]
    assert misses == 0 and restores > 0
    if prefix_cache is None:
        assert restores >= len(samples)
    else:
        # the publishing inserts spilled the entries past the capacity
        # before spill_all took the rest
        assert spills > jcount[-1]
    for a, b in zip(jtok, ttok):
        np.testing.assert_array_equal(a, b)


def test_mesh_payload_equals_solo(tier_pair):
    """A ``(1, 2)`` serve mesh (both head shards on the CPU) spills the same
    bytes as the solo engine for each chain, and its replay serves the same
    tokens."""
    from csat_tpu_torch.serve import ServeEngine

    jcfg, params, make_pair = tier_pair
    cfg, _, _ = make_pair()
    model = torch_model(cfg, params)
    samples = request_samples(jcfg, 4, seed=10, lo=5)
    payloads, tokens = [], []
    for i, c in enumerate((cfg, cfg.replace(serve_mesh_shape=(1, 2)))):
        eng = ServeEngine(model, c.replace(serve_tier_dir=cfg.serve_tier_dir + f"_m{i}",
                                           serve_tier_host_pages=0), device="cpu")
        first = _tokens(eng.generate(samples, max_new_tokens=3))
        eng.spill_all()
        payloads.append({k: eng._tiers.get(k)[0] for k in eng._tiers.keys()})
        eng._tiers.clear()
        tokens.append(first)
        eng.close()
    assert payloads[0].keys() == payloads[1].keys() and payloads[0]
    assert all(payloads[0][k] == payloads[1][k] for k in payloads[0])
    assert all(np.array_equal(a, b) for a, b in zip(*tokens))
