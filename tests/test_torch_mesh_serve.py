"""One serving engine across head shards (``serve_mesh_shape``) on the CPU:
the JAX package's ``tests/test_mesh_serve.py`` drills that need no KV
tiering, on the port.

* a ``(1, 2)`` engine — both shards' pages on the CPU, each ``(NP, H/2,
  page, dh)`` — serves a mixed-length trace cold, then as a prefix-hit
  replay, with tokens and terminal statuses equal to the solo engine's bit
  for bit (f32 pages and int8 pages), 0 page and chain leaks;
* it is engine-shaped: ``mesh_devices`` 2, ``kv_pages_worst_chip`` the
  pool's pages in use;
* a NaN drill fails the same request on both engines and the rest stay
  equal;
* ``mesh_descriptor`` distinguishes solo from ``(1, 2)`` on one host;
* the config's asserts are JAX's for every shape tried, and the engine
  refuses a head count the shards do not divide.

JAX's spill→restore leg waits for KV tiering, which the port does not
carry yet.
"""

import numpy as np
import pytest

from torch_parity import configs, request_samples  # noqa: F401
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SRC_V, TGT_V, TRIP_V = 200, 300, 50
OVER = dict(full_att=True, dropout=0.0, attention_dropout=0.0, cse_empty_rows="zero",
            serve_slots=4, bucket_src_lens=(24, 48), serve_page_size=4, serve_num_pages=160)


def _engines(page_dtype="float32"):
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.serve.engine import ServeEngine

    _, cfg = configs(**OVER, serve_kv_page_dtype=page_dtype)
    model = CSATrans(cfg, SRC_V, TGT_V, device="cpu", seed=4, triplet_vocab_size=TRIP_V)
    solo = ServeEngine(model, cfg, device="cpu")
    mesh = ServeEngine(model, cfg.replace(serve_mesh_shape=(1, 2)), device="cpu")
    return cfg, solo, mesh


def _run(eng, samples, limit=4):
    res = eng.generate(samples, max_new_tokens=limit)
    return [np.asarray(r.tokens) for r in res], [r.status for r in res]


@pytest.mark.parametrize("page_dtype", ["float32", "int8"])
def test_sharded_bit_identity_cold_and_prefix_hits(page_dtype):
    jcfg, _ = configs(**OVER)
    cfg, solo, mesh = _engines(page_dtype)
    samples = request_samples(jcfg, 6, seed=1, lo=5)
    for leg in ("cold", "prefix replay"):
        hits = mesh.stats.prefix_hits
        ref, ref_st = _run(solo, samples)
        got, got_st = _run(mesh, samples)
        assert got_st == ref_st and all(s == "OK" for s in got_st), leg
        for a, b in zip(ref, got):
            assert np.array_equal(a, b), leg
        if leg == "prefix replay":
            assert mesh.stats.prefix_hits - hits >= len(samples)
    assert mesh.page_leaks() == 0 and mesh.chain_leaks() == 0
    assert solo.page_leaks() == 0 and solo.chain_leaks() == 0


def test_mesh_engine_is_engine_shaped():
    jcfg, _ = configs(**OVER)
    cfg, solo, mesh = _engines()
    assert solo.mesh is None and mesh.mesh.shape == {"data": 1, "model": 2}
    pool = mesh._pool
    assert pool.pages is None and [(h0, h1) for h0, h1, _ in pool.shards] == [(0, 2), (2, 4)]
    k = pool.shards[1][2][0]["k"]
    assert k.shape == (mesh.geo.num_pages, cfg.num_heads // 2, cfg.serve_page_size,
                       cfg.hidden_size // cfg.num_heads)
    samples = request_samples(jcfg, 4, seed=2, lo=5)
    for s in samples:
        mesh.submit(s, max_new_tokens=6)
    mesh.tick()
    mesh.tick()
    s_solo, s_mesh = solo.stats.summary(), mesh.stats.summary()
    assert s_solo["mesh_devices"] == 1 and s_mesh["mesh_devices"] == 2
    assert int(mesh.stats.pages_in_use) > 0
    assert s_mesh["kv_pages_worst_chip"] == int(mesh.stats.pages_in_use)
    mesh.drain()
    assert mesh.page_leaks() == 0 and mesh.chain_leaks() == 0


def test_nan_drill_fails_the_same_request_on_both_engines():
    jcfg, _ = configs(**OVER)
    cfg, solo, mesh = _engines()
    samples = request_samples(jcfg, 4, seed=3, lo=5)
    out = []
    for eng in (solo, mesh):
        ids = [eng.submit(s, max_new_tokens=6) for s in samples]
        eng.tick()
        eng._inject_nan(eng._results[ids[1]].slot if ids[1] in eng._results
                        else next(i for i, r in enumerate(eng._slots)
                                  if r is not None and r.id == ids[1]))
        res = eng.drain()
        out.append([(res[i].status, np.asarray(res[i].tokens) if res[i].tokens is not None
                     else None) for i in ids])
        assert eng.page_leaks() == 0 and eng.chain_leaks() == 0
    (s_solo, s_mesh) = out
    assert [s for s, _ in s_solo] == [s for s, _ in s_mesh]
    assert s_solo[1][0] == "FAILED" and [s for s, _ in s_solo].count("OK") == 3
    for (_, a), (_, b) in zip(s_solo, s_mesh):
        assert (a is None and b is None) or np.array_equal(a, b)


def test_mesh_descriptor_distinguishes_topologies():
    import torch

    from csat_tpu_torch.parallel.mesh import build_serve_mesh, mesh_descriptor

    solo = mesh_descriptor(None)
    sharded = mesh_descriptor(build_serve_mesh((1, 2), [torch.device("cpu")] * 2))
    assert solo.startswith("solo/") and sharded.startswith("mesh[data=1,model=2]/")
    assert solo.split("/", 1)[1] == sharded.split("/", 1)[1]  # the same kinds
    assert mesh_descriptor(build_serve_mesh((2,), ["cpu", "cpu"])).startswith("mesh[model=2]/")
    with pytest.raises(ValueError, match="needs 4 devices"):
        build_serve_mesh((1, 4), ["cpu", "cpu"])


@pytest.mark.parametrize("shape", [(), (1,), (2,), (1, 2), (1, 4), (2, 2), (2, 1), (1, 1, 2),
                                   (0,)])
def test_serve_mesh_shape_asserts_are_jax(shape):
    """What JAX's ``validate`` accepts the port accepts, and what it refuses
    the port refuses."""
    from csat_tpu.configs import get_config as jax_config
    from csat_tpu_torch.configs import get_config as torch_config

    outcome = []
    for get in (jax_config, torch_config):
        try:
            get("python", serve_mesh_shape=shape)
            outcome.append("ok")
        except AssertionError:
            outcome.append("refused")
    assert outcome[0] == outcome[1], (shape, outcome)


def test_engine_refuses_heads_the_shards_do_not_divide():
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.serve.engine import ServeEngine

    _, cfg = configs(**OVER)
    model = CSATrans(cfg, SRC_V, TGT_V, device="cpu", seed=4, triplet_vocab_size=TRIP_V)
    with pytest.raises(ValueError, match="num_heads=4 must divide evenly over 8"):
        ServeEngine(model, cfg.replace(serve_mesh_shape=(8,)), device="cpu")
