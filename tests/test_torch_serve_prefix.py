"""The prefix cache against the JAX package's: the content hash byte for byte,
the cache's state machine on a seeded random op sequence, and both engines at
the default ``serve_prefix_cache`` on a duplicate storm under page pressure
(micro configuration, converted weights, ``eval_graph="expected"``; the JAX
engine runs its Pallas kernels in interpret mode, as its own tests do)."""

import numpy as np
import pytest

from torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    configs, jax_model_and_params, request_samples, torch_model, one_torch_thread)

# one intra-op thread: the suite's workers share the host's cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_sample_hash_gives_jax_bytes():
    from csat_tpu.serve.prefix import sample_hash as jhash
    from csat_tpu_torch.serve.prefix import sample_hash as thash

    jcfg, _ = configs()
    samples = request_samples(jcfg, 6, seed=3)
    for s in samples:
        assert thash(s) == jhash(s) and len(thash(s)) == 16
    # dtype and shape are hashed too: int64 ids are another input
    wide = dict(samples[0], src_seq=samples[0]["src_seq"].astype(np.int64))
    assert thash(wide) == jhash(wide) != thash(samples[0])
    assert thash(dict(samples[0])) == thash(samples[0])  # content, not identity
    assert len({thash(s) for s in samples}) == len(samples)


def _state(cache):
    return ([(h, list(e.chain), e.refs, e.hits) for h, e in cache._entries.items()],
            cache.hits, cache.misses, cache.pinned_pages, cache.referenced, len(cache))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_equals_jax_on_random_ops(seed):
    from csat_tpu.serve.prefix import PrefixCache as JCache
    from csat_tpu_torch.serve.prefix import PrefixCache as TCache

    rng = np.random.default_rng(seed)
    jc, tc = JCache(4), TCache(4)
    keys = [bytes([k]) * 16 for k in range(7)]
    next_page = 1
    for _ in range(300):
        op = rng.choice(["acquire", "release", "insert", "evict_for", "hit", "miss", "clear"],
                        p=[0.25, 0.2, 0.25, 0.1, 0.1, 0.08, 0.02])
        h = keys[int(rng.integers(len(keys)))]
        if op == "acquire":
            a, b = jc.acquire(h), tc.acquire(h)
            assert (a is None) == (b is None)
        elif op == "release":
            if (jc._entries.get(h) is None) or jc._entries[h].refs > 0:
                jc.release(h)
                tc.release(h)
        elif op == "insert":
            chain = list(range(next_page, next_page + int(rng.integers(1, 4))))
            next_page += len(chain)
            assert jc.insert(h, chain) == tc.insert(h, chain)
        elif op == "evict_for":
            n = int(rng.integers(1, 6))
            assert jc.evict_for(n) == tc.evict_for(n)
        elif op == "hit":
            jc.count_hit(h)
            tc.count_hit(h)
        elif op == "miss":
            jc.count_miss()
            tc.count_miss()
        else:
            jc.clear()
            tc.clear()
        assert _state(jc) == _state(tc)
        assert jc.keys() == tc.keys()


def test_prefix_cache_never_evicts_a_live_sharer():
    from csat_tpu_torch.serve.prefix import PrefixCache

    cache = PrefixCache(2)
    assert cache.insert(b"a" * 16, [1, 2]) == []  # refs 1: the inserting request
    assert cache.insert(b"b" * 16, [3]) == []
    assert cache.insert(b"c" * 16, [4]) is None   # declined: both referenced
    assert cache.evict_for(10) == []
    cache.release(b"a" * 16)
    assert cache.evict_for(1) == [(b"a" * 16, [1, 2])]
    assert cache.insert(b"b" * 16, [5]) is None   # duplicate hash: declined
    cache.clear()
    assert len(cache) == 0 and cache.pinned_pages == 0
    cache.release(b"b" * 16)                      # tolerated after a clear


# ---------------------------------------------------------------------------
# both engines, default prefix cache, duplicate storm under page pressure
# ---------------------------------------------------------------------------

# 4 distinct requests, each submitted 3-4 times with its own budget; the pool
# funds about two worst-case requests, so cached chains are evicted on demand
STORM = [0, 1, 0, 2, 1, 0, 3, 2, 3, 1, 0, 2, 3, 1]
BUDGETS = [9, 4, 2, 9, 6, 9, 3, 1, 9, 5, 7, 2, 8, 9]
TIMING = ("wall_s", "gen_tokens_per_sec", "gen_tokens_per_sec_per_chip",
          "gen_tokens_per_sec_per_slot")


@pytest.fixture(scope="module")
def storm(tmp_path_factory):
    from csat_tpu.serve.engine import ServeEngine as JServeEngine
    from csat_tpu_torch.serve import ServeEngine

    over = dict(serve_page_size=8, serve_num_pages=17,
                obs_postmortem_dir=str(tmp_path_factory.mktemp("pm")))
    jcfg, tcfg = configs(**over)
    assert jcfg.serve_prefix_cache == tcfg.serve_prefix_cache == 64
    jmodel, params = jax_model_and_params(jcfg, seed=1)
    distinct = request_samples(jcfg, 4, seed=8, lo=2)
    samples = [distinct[i] for i in STORM]

    def run(engine):
        clock = engine.clock
        ids = []
        for k, (s, b) in enumerate(zip(samples, BUDGETS)):
            ids.append(engine.submit(s, b))
            if k % 3 == 2:  # arrivals between ticks, not one burst
                clock.advance(1.0)
                engine.tick()
        engine.drain()
        return [engine.poll(i) for i in ids]

    jeng = JServeEngine(jmodel, params, jcfg.replace(backend="pallas"), clock=FakeClock())
    try:
        j_res = run(jeng)
        j_out = dict(leaks=jeng.page_leaks(), summary=jeng.stats.summary(),
                     cache=jeng._prefix.hits, misses=jeng._prefix.misses)
    finally:
        jeng.close()
    teng = ServeEngine(torch_model(tcfg, params), tcfg, device="cpu", clock=FakeClock())
    t_res = run(teng)
    t_out = dict(leaks=teng.page_leaks(), summary=teng.stats.summary(),
                 cache=teng._prefix.hits, misses=teng._prefix.misses)
    teng.close()
    return j_res, j_out, t_res, t_out, teng


def test_duplicate_storm_tokens_and_hits_equal_jax(storm):
    j_res, j_out, t_res, t_out, teng = storm
    assert t_out["leaks"] == j_out["leaks"] == 0
    assert teng.chain_leaks() == 0 and teng.occupancy == 0
    # more misses than distinct requests: cached chains were evicted on demand
    assert t_out["cache"] == j_out["cache"] > 0
    assert t_out["misses"] == j_out["misses"] > len(set(STORM))
    for t, j in zip(t_res, j_res):
        assert t.status == j.status == "OK"
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
    # a hit's tokens are its original's, to the shorter budget
    first = {}
    for k, (i, r) in enumerate(zip(STORM, t_res)):
        if i in first:
            a, b = first[i].tokens, r.tokens
            n = min(len(a), len(b))
            np.testing.assert_array_equal(a[:n], b[:n])
        else:
            first[i] = r


def test_duplicate_storm_stats_summary_equals_jax(storm):
    _, j_out, _, t_out, _ = storm
    js, ts = j_out["summary"], t_out["summary"]
    assert list(ts) == list(js)  # key for key, in order
    for key in js:
        if key not in TIMING:
            assert ts[key] == js[key], key
    assert ts["prefix_hit_rate"] > 0 and ts["rebuilds"] == 0 and ts["failed"] == 0
    assert ts["kv_pages"] == 16 and 0 < ts["kv_page_peak"] <= 1
