"""The rectangle layout (``serve_kv_layout="rect"``) on the port, on the CPU.

The JAX package pins its paged and rect engines bit for bit
(``tests/test_pages.py``); here the same A/B on the port — one
duplicate-laden trace through a paged engine on a pool of half the slots'
worst case (prefix hits included) and through a rect engine, token for token
— and the rect engine against JAX's rect engine on converted weights.  The
rect engine has no allocator and no prefix cache (0 page and chain leaks),
fails a NaN-poisoned slot alone, and rebuilds after a decode fault to the
same tokens; the config refuses rect under a serve mesh, with tiering and
with quantized pages, as JAX's does.
"""

import numpy as np
import pytest
import torch

from torch_parity import configs, jax_model_and_params, request_samples, torch_model
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OVER = dict(full_att=True, dropout=0.0, attention_dropout=0.0, cse_empty_rows="zero",
            serve_slots=4, bucket_src_lens=(24, 48), serve_page_size=4, obs_postmortem_dir="")


@pytest.fixture(scope="module")
def pair():
    """(jcfg, jmodel, params, paged, rect): port engines over one converted
    model; the paged one on a pool of half the slots' worst case."""
    from csat_tpu_torch.serve import ServeEngine
    from csat_tpu_torch.serve.pages import page_geometry

    jcfg, cfg = configs(**OVER)
    jmodel, params = jax_model_and_params(jcfg, seed=3)
    model = torch_model(cfg, params)
    geo = page_geometry(cfg)
    paged = ServeEngine(model, cfg.replace(
        serve_num_pages=1 + cfg.serve_slots * geo.rect_pages_per_slot // 2), device="cpu")
    rect = ServeEngine(model, cfg.replace(serve_kv_layout="rect", serve_prefix_cache=0),
                       device="cpu")
    yield jcfg, jmodel, params, paged, rect
    paged.close()
    rect.close()


def _trace(jcfg, n, seed, dup_every=3):
    rng = np.random.default_rng(seed)
    samples = request_samples(jcfg, n, seed=seed, lo=5)
    for i in range(dup_every - 1, n, dup_every):
        samples[i] = samples[int(rng.integers(0, i))]
    return samples


def test_paged_bit_identical_to_rect_including_prefix_hits(pair):
    jcfg, _, _, paged, rect = pair
    samples = _trace(jcfg, 12, seed=2)
    budgets = [0, 3, 5] * 4
    a = [paged.submit(s, max_new_tokens=b) for s, b in zip(samples, budgets)]
    b = [rect.submit(s, max_new_tokens=bb) for s, bb in zip(samples, budgets)]
    paged.drain()
    rect.drain()
    assert paged.stats.prefix_hits > 0
    for ia, ib in zip(a, b):
        ra, rb = paged.pop_result(ia), rect.pop_result(ib)
        assert ra.status == rb.status == "OK"
        np.testing.assert_array_equal(ra.tokens, rb.tokens)
    assert paged.page_leaks() == 0 and rect.page_leaks() == 0 and rect.chain_leaks() == 0


def test_rect_engine_is_rect_shaped(pair):
    jcfg, _, _, _, rect = pair
    cfg = rect.cfg
    assert not rect.paged and rect.geo is None and rect._prefix is None
    c = rect._pool.cache[0]
    dh = cfg.hidden_size // cfg.num_heads
    assert tuple(c["k"].shape) == (cfg.serve_slots, cfg.num_heads, cfg.max_tgt_len - 1, dh)
    assert tuple(c["cross_k"].shape) == (cfg.serve_slots, cfg.num_heads, cfg.max_src_len, dh)
    s = rect.stats.summary()
    assert s["kv_pages"] == 0 and s["prefix_hit_rate"] == 0
    assert rect.spill_all() == 0 and rect.corrupt_tiers() == 0


def test_rect_tokens_equal_jax_rect_engine(pair):
    from csat_tpu.serve.engine import ServeEngine as JServeEngine

    jcfg, jmodel, params, _, rect = pair
    samples = request_samples(jcfg, 5, seed=4, lo=3)
    budgets = [9, 2, 6, 9, 4]

    def run(eng):
        ids = [eng.submit(s, b) for s, b in zip(samples, budgets)]
        eng.drain()
        return [eng.poll(i) for i in ids]

    jeng = JServeEngine(jmodel, params, jcfg.replace(
        backend="pallas", serve_kv_layout="rect", serve_prefix_cache=0))
    try:
        j = run(jeng)
    finally:
        jeng.close()
    t = run(rect)
    for a, b in zip(j, t):
        assert a.status == b.status == "OK"
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)


def test_rect_nan_drill_fails_one_request_others_exact(pair):
    jcfg, _, _, _, rect = pair
    samples = request_samples(jcfg, 4, seed=5, lo=5)
    clean = [r.tokens for r in rect.generate(samples, max_new_tokens=6)]
    ids = [rect.submit(s, max_new_tokens=6) for s in samples]
    rect.tick()
    slot = next(i for i, r in enumerate(rect._slots) if r is not None and r.id == ids[1])
    rect._inject_nan(slot)
    rect.drain()
    res = [rect.pop_result(i) for i in ids]
    assert res[1].status == "FAILED" and "non-finite" in res[1].error
    for k in (0, 2, 3):
        assert res[k].ok
        np.testing.assert_array_equal(res[k].tokens, clean[k])
    # the poisoned rows are zeroed at the next prefill: a request served in
    # the same slot afterwards is exact
    again = rect.generate(samples, max_new_tokens=6)
    assert all(np.array_equal(r.tokens, c) for r, c in zip(again, clean))


def test_rect_rebuild_after_decode_fault_same_tokens(pair):
    from csat_tpu_torch.resilience.faults import FaultInjector

    jcfg, _, _, _, rect = pair
    samples = request_samples(jcfg, 6, seed=31, lo=5)
    clean = [r.tokens for r in rect.generate(samples)]
    rect.fault_injector = FaultInjector(serve_decode_fail_ticks=[rect.ticks + 2])
    try:
        ids = [rect.submit(s) for s in samples]
        rect.drain()
        assert rect.stats.rebuilds == 1
    finally:
        rect.fault_injector = None
        rect._rebuilds = 0
    for i, c in zip(ids, clean):
        r = rect.pop_result(i)
        assert r.ok
        np.testing.assert_array_equal(r.tokens, c)
    assert rect.page_leaks() == 0 and rect.chain_leaks() == 0


@pytest.mark.parametrize("over", [dict(serve_kv_layout="rect", serve_mesh_shape=(1, 2)),
                                  dict(serve_kv_layout="rect", serve_mesh_shape=(2,)),
                                  dict(serve_kv_layout="rect", serve_tiering=True),
                                  dict(serve_kv_layout="rect", serve_kv_page_dtype="int8"),
                                  dict(serve_kv_layout="rect", serve_kv_page_dtype="bfloat16"),
                                  dict(serve_kv_layout="slots"),
                                  dict(serve_kv_layout="rect", serve_prefix_cache=0)])
def test_rect_config_rules_are_jax(over):
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
    assert outcome[0] == ("ok" if over == dict(serve_kv_layout="rect", serve_prefix_cache=0)
                          else "refused")


def test_rect_prefill_drops_sentinel_rows(pair):
    """A row whose slot id is the sentinel ``num_slots`` is encoded and
    dropped: the other row lands as if it were admitted alone."""
    from csat_tpu_torch.serve.prefill import rect_prefill
    from csat_tpu_torch.serve.slots import init_pool

    jcfg, _, _, _, rect = pair
    cfg, model = rect.cfg, rect.model
    a, b = request_samples(jcfg, 2, seed=12, lo=5)
    n = rect.specs[-1].n
    alone = init_pool(model, cfg.serve_slots, rect.steps, cfg.max_src_len)
    rect_prefill(model, cfg, alone, n, [a], [1], [3])
    both = init_pool(model, cfg.serve_slots, rect.steps, cfg.max_src_len)
    rect_prefill(model, cfg, both, n, [a, b], [1, cfg.serve_slots], [3, 5])
    assert both.limit.tolist() == [0, 3, 0, 0] == alone.limit.tolist()
    for x, y in zip(alone.cache, both.cache):
        for key in ("cross_k", "cross_v"):
            assert torch.allclose(x[key], y[key], atol=1e-6, rtol=0)
    assert torch.equal(alone.src_mask, both.src_mask)
