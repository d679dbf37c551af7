"""``chip_smoke.py``'s ``tensor`` phase, rehearsed on the CPU at narrow
widths: (b) python over a model axis (two gloo ranks) and (c) python_long
over model × seq (four), each in fresh interpreters against the one-process
step, with their equalities (the step, the gathered parameters on every
rank and against one process, ΣA of each layer, the same-graph gate on the
ranks' own K7 inputs, the decodes up to a near tie); (d) the serve mesh's
trace at f32 and at bf16 compute with int8 pages, both shards on the CPU,
tokens and statuses equal to the solo engine's; and the head-shard slicing
of phase 3's checks.  What needs the card — the kernels launched on each
path at shapes phase 3 checked, K5 per shard — is left to the card (the CPU
runs the plain path, which launches nothing)."""

import pytest
import torch

import chip_smoke

from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NARROW = dict(pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=4,
              num_layers=1, sbm_layers=4, clusters=(4, 4, 4, 4), dim_feed_forward=64,
              decoder_layers=2, max_src_len=32, max_tgt_len=10)


def _quiet(monkeypatch):
    for check in ("_check_launched", "_check_rates", "_check_shapes"):
        monkeypatch.setattr(chip_smoke, check, lambda *a, **kw: None)
    monkeypatch.setattr(chip_smoke, "emit", lambda *a, **kw: None)


@pytest.mark.parametrize("kind", ["tp", "tp_seq"])
def test_tensor_gate_on_the_cpu(kind, tmp_path, monkeypatch):
    _quiet(monkeypatch)
    rec = chip_smoke.tensor_gate(kind, str(tmp_path), device="cpu", overrides=NARROW)
    want = {"data": 1, "model": 2} if kind == "tp" else {"data": 1, "model": 2, "seq": 2}
    assert rec["mesh"] == want and rec["ranks"] == (2 if kind == "tp" else 4)
    assert rec["loss_rel"] <= 1e-6 and rec["grad_norm_rel"] <= 1e-5
    assert rec["params_equal_on_ranks"] and rec["metrics_equal"]
    assert rec["params_rel_l2_vs_one_process"] <= chip_smoke.TP_PARAMS_RTOL
    assert not rec["launches"]  # the plain path launches no kernel
    assert all(d["rows_apart"] == 0 for d in rec["decode"])
    assert len(rec["graph_sum_entries_apart_by_layer"]) == 4
    if kind == "tp":
        assert len(rec["losses"]) == chip_smoke.TP_STEPS
        gated = sorted({g["layer"] for g in rec["same_graph"]})
        assert gated == list(chip_smoke.TP_GATE_LAYERS)
        assert all(g["edges_apart"] == 0 and g["heads"] == 2 for g in rec["same_graph"])
    else:  # the ring on each model member's heads against K6's plain path
        gated = sorted({(g["model_index"], g["layer"]) for g in rec["same_graph"]})
        assert gated == [(m, layer) for m in (0, 1) for layer in chip_smoke.TP_GATE_LAYERS]
        assert all(g["graph_sum_equal"] and g["heads"] == 2 for g in rec["same_graph"])
        # on the CPU the CSE's row-parallel sums happen to round as one process's
        assert rec["graph_sum_entries_apart_by_layer"][0] == 0


@pytest.mark.parametrize("compute,pages", [("float32", "float32"), ("bfloat16", "int8")])
def test_tensor_serve_on_the_cpu(compute, pages, monkeypatch):
    _quiet(monkeypatch)
    from csat_tpu_torch.ops import build

    # the CPU launches no K5: count the plain path's calls as the card counts launches
    from csat_tpu_torch.ops import paged_decode

    inner = paged_decode._attend_reference

    def counted(*a):
        build._LAUNCHES["paged_decode"] += 1
        return inner(*a)

    monkeypatch.setattr(paged_decode, "_attend_reference", counted)
    rec = chip_smoke.tensor_serve(pages, compute, device="cpu",
                                  overrides=dict(NARROW, max_src_len=48, serve_slots=4))
    assert rec["tokens_and_statuses_equal"] and rec["hits"] > 0
    assert rec["mesh_devices"] == 2 and rec["shard_pages_shape"][1] == 2
    assert rec["k5_launches_mesh"] == 2 * rec["k5_launches_solo"] > 0


@pytest.mark.parametrize("mod", ["cse", "sbm_expected", "sbm_sampled", "sbm_graph"])
def test_head_shard_inputs_are_the_full_launchs_slice(mod):
    """``_shard_of`` gives a head shard the launch's own slice: on the plain
    path its output and ΣA are the full launch's heads 4-7 (K1 on the T
    plane alone)."""
    from csat_tpu_torch.ops import flex_core

    gen = torch.Generator().manual_seed(3)
    q, k, v, spec, aux = chip_smoke._flex_inputs(mod, 3, 37, gen, "cpu")
    h0, h, h_total = chip_smoke.TP_HEADS
    sq, sk, sv, s_spec, s_aux = chip_smoke._shard_of(mod, q, k, v, spec, aux, h0, h)
    rate = 0.0 if mod == "cse" else chip_smoke.RATE
    dseed = torch.tensor([7], dtype=torch.int32)
    full, fex = flex_core.flex_reference(q, k, v, spec, aux, rate, dseed)
    part, pex = flex_core.flex_reference(sq, sk, sv, s_spec, s_aux, rate, dseed)
    assert torch.allclose(part, full[:, h0:h0 + h], atol=1e-6, rtol=0)
    assert torch.equal(pex["graph_sum"], fex["graph_sum"][:, h0:h0 + h])
    if mod != "cse":
        assert (s_spec.bh0, s_spec.h_total, s_spec.heads) == (h0, h_total, h)
    else:
        assert s_spec.planes == 1 and s_spec.group == h
