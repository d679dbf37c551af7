"""``chip_smoke.py``'s ``parallel`` phase, rehearsed on the CPU at narrow
widths: both gates — python_pp over a pipe axis and python_long over a seq
axis, two gloo ranks in fresh interpreters against the one-process step —
with their equalities (the step, the parameters on both ranks, ΣA of each
layer under the ring, the decodes up to a near tie) and the near-tie rule
of the token comparison.  What needs the card — the kernels launched on
each path at shapes phase 3 checked — is left to the card (the CPU runs the
plain path, which launches nothing)."""

import numpy as np
import pytest

import chip_smoke

from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NARROW = dict(pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=4,
              num_layers=1, sbm_layers=4, clusters=(4, 4, 4, 4), dim_feed_forward=64,
              decoder_layers=2, max_src_len=32, max_tgt_len=10)


@pytest.mark.parametrize("kind", ["pp", "seq"])
def test_parallel_gate_on_the_cpu(kind, tmp_path, monkeypatch):
    for check in ("_check_launched", "_check_rates", "_check_shapes"):
        monkeypatch.setattr(chip_smoke, check, lambda *a, **kw: None)
    monkeypatch.setattr(chip_smoke, "emit", lambda *a, **kw: None)
    rec = chip_smoke.parallel_gate(kind, str(tmp_path), device="cpu", overrides=NARROW)
    assert rec["mesh"] == ({"data": 1, "pipe": 2} if kind == "pp" else {"data": 1, "seq": 2})
    assert rec["loss_rel"] <= 1e-6 and rec["grad_norm_rel"] <= 1e-5
    assert rec["params_bitwise_equal"] and rec["metrics_equal"]
    assert not rec["launches"]  # the plain path launches no kernel
    for got in rec["decode"].values():
        assert [d["rows_apart"] for d in got] == [0, 0]
    if kind == "pp":
        assert len(rec["losses"]) == chip_smoke.PAR_STEPS and set(rec["decode"]) == {
            "sampled", "expected"}
    else:  # on the CPU the ranks' GEMMs round as one process's: ΣA equal at the step too
        assert rec["graph_sums_equal"] and rec["net_edges_apart"] == [0.0, 0.0]
        layers = rec["same_graph"]["layers"]
        assert [r["layer"] for r in layers] == list(chip_smoke.RING_GATE_LAYERS)
        assert all(r["graph_sum_equal"] for r in layers)
        assert layers[0]["inputs_max_abs_vs_one_process"] == {"q": 0.0, "r": 0.0}


def test_tokens_up_to_tie():
    ref = np.array([[5, 6, 7], [5, 6, 7]])
    gaps = np.array([[1.0, 1.0, 1.0], [1.0, 1e-6, 1.0]])
    same = chip_smoke.tokens_up_to_tie(ref.copy(), ref, gaps, "x")
    assert same["rows_apart"] == 0 and same["tokens"] == 6
    tie = chip_smoke.tokens_up_to_tie(np.array([[5, 6, 7], [5, 9, 9]]), ref, gaps, "x")
    assert tie["rows_apart"] == tie["near_ties"] == 1
    with pytest.raises(AssertionError, match="first differs at step 2"):
        chip_smoke.tokens_up_to_tie(np.array([[5, 6, 8], [5, 6, 7]]), ref, gaps, "x")
