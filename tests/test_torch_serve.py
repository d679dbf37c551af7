"""The whole slice: the port's ServeEngine on the CPU against the JAX one.

Both engines carry the same converted weights (micro configuration,
``eval_graph="expected"``, f32 pages) and serve the same six requests of
mixed node counts (both prefill buckets) and token budgets, plus one
malformed sample.  Tokens and statuses must be identical, no page may leak,
and the malformed sample resolves ``FAILED`` on both.  The JAX engine runs
its Pallas kernels in interpret mode, as its own tests do.
"""

import numpy as np
import pytest
import torch

from torch_parity import configs, jax_model_and_params, request_samples, torch_model
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

# one intra-op thread: the suite's workers share the host's cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

BUDGETS = [9, 3, 6, 9, 1, 5]


@pytest.fixture(scope="module")
def served():
    jcfg, tcfg = configs()
    jmodel, params = jax_model_and_params(jcfg, seed=1)
    samples = request_samples(jcfg, len(BUDGETS), seed=5, lo=2)
    assert {int(s["num_node"]) <= 24 for s in samples} == {True, False}
    bad = dict(samples[0], src_seq=np.zeros((7,), np.int32))  # wrong width
    return jcfg, tcfg, jmodel, params, samples, bad


def _run(engine, samples, bad):
    ids = [engine.submit(s, b) for s, b in zip(samples, BUDGETS)]
    bad_id = engine.submit(bad, 4)
    engine.drain()
    return [engine.poll(i) for i in ids], engine.poll(bad_id)


def test_port_engine_serves_same_tokens_as_jax(served):
    from csat_tpu.serve.engine import ServeEngine as JServeEngine
    from csat_tpu_torch.serve import RequestStatus, ServeEngine

    jcfg, tcfg, jmodel, params, samples, bad = served
    jeng = JServeEngine(jmodel, params, jcfg.replace(backend="pallas"))
    try:
        j_res, j_bad = _run(jeng, samples, bad)
        assert jeng.page_leaks() == 0
    finally:
        jeng.close()

    teng = ServeEngine(torch_model(tcfg, params), tcfg, device="cpu")
    t_res, t_bad = _run(teng, samples, bad)
    assert teng.page_leaks() == 0
    assert teng.occupancy == 0 and teng.prefills >= 2

    assert t_bad.status == j_bad.status == RequestStatus.FAILED == "FAILED"
    assert "poison" in t_bad.error
    for t, j, budget in zip(t_res, j_res, BUDGETS):
        assert t.status == j.status == RequestStatus.OK
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        assert 1 <= len(t.tokens) <= budget


def test_generate_returns_in_submission_order(served):
    from csat_tpu_torch.serve import ServeEngine

    _, tcfg, _, params, samples, _ = served
    eng = ServeEngine(torch_model(tcfg, params), tcfg.replace(serve_slots=2), device="cpu")
    res = eng.generate(samples[:3], max_new_tokens=2)
    assert [r.id for r in res] == [0, 1, 2]
    assert all(r.ok and len(r.tokens) <= 2 for r in res)
    assert eng.page_leaks() == 0


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(served, monkeypatch):
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.serve import ServeEngine

    _, tcfg, _, params, _, _ = served
    model = torch_model(tcfg, params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CSATrans(tcfg, 200, 300)


def test_page_allocator_invariants():
    from csat_tpu_torch.serve.pages import PageAllocator, page_geometry

    alloc = PageAllocator(6)
    chain = alloc.alloc(3)
    assert chain == [1, 2, 3] and alloc.alloc(3) is None and alloc.free_pages == 2
    alloc.free(chain)
    with pytest.raises(AssertionError, match="double-free"):
        alloc.free([2])
    with pytest.raises(AssertionError, match="null page"):
        alloc.free([0])
    _, tcfg = configs()
    with pytest.raises(ValueError, match="worst-case"):
        page_geometry(tcfg.replace(serve_num_pages=4))
