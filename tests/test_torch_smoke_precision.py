"""``chip_smoke.py``'s precision-phase pieces and java's expected-graph gate,
driven on the CPU at a narrow width (nodes up to 64) through the plain
paths: the step gate in bf16 compute at its bf16 limits, the same-graph
gates in both noise modes reading f32 island inputs, the expected-graph
gradient gate at java's width ratio, the decode captures of bf16 and int8
page pools, and steps of two models timed in turns.  On the card the same
helpers feed the kernels."""

import numpy as np
import pytest
import torch

import chip_smoke
from csat_tpu_torch.configs import get_config
from csat_tpu_torch.data.dataset import batch_to_device, collate
from csat_tpu_torch.data.synthetic import random_ast, request_sample, train_sample
from csat_tpu_torch.ops import paged_decode as pd
from csat_tpu_torch.serve.pages import KV_PAGE_DTYPES
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

# one intra-op thread: the suite's workers share the host's cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

NARROW = dict(hidden_size=32, sbm_enc_dim=32, pegen_dim=16, pe_dim=8, num_heads=2,
              dim_feed_forward=64, max_src_len=64)


@pytest.fixture
def small_vocab(monkeypatch):
    monkeypatch.setattr(chip_smoke, "SRC_VOCAB", 300)
    monkeypatch.setattr(chip_smoke, "TGT_VOCAB", 400)


def _train_batch(cfg, sizes, seed):
    rng = np.random.default_rng(seed)
    samples = [train_sample(random_ast(rng, n), cfg, 300, 400, rng) for n in sizes]
    arrs = {key: np.stack([s[key] for s in samples]) for key in samples[0]}
    return batch_to_device(collate(arrs, cfg.max_src_len), torch.device("cpu"))


def test_bf16_step_gate_passes_on_the_plain_path(small_vocab):
    cfg = get_config("python", compute_dtype="bfloat16", **NARROW)
    batch = _train_batch(cfg, (30, 64), seed=4)
    model, state, _, metrics, launches, rec = chip_smoke.step_gate(
        cfg, batch, device="cpu", loss_rtol=chip_smoke.BF16_LOSS_RTOL,
        gnorm_rtol=chip_smoke.BF16_GNORM_RTOL)
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert np.isfinite(float(metrics["loss"])) and not any(launches.values())
    assert rec["loss_rel"] == 0.0 and rec["grad_norm_rel"] == 0.0
    assert (rec["loss_rtol"], rec["grad_norm_rtol"]) == (1e-3, 1e-2)


@pytest.mark.parametrize("mode", ["shared", "counter"])
def test_bf16_same_graph_gate_reads_f32_island_inputs(small_vocab, mode):
    cfg = get_config("python", compute_dtype="bfloat16", noise_mode=mode, **NARROW)
    batch = _train_batch(cfg, (30, 64), seed=2)
    caps = chip_smoke.capture_sbm_inputs(cfg, batch, "cpu", layers=cfg.sbm_layers)
    assert all(rec[key].dtype == torch.float32 for rec in caps for key in ("q", "k", "v", "go"))
    res = chip_smoke.same_graph_gate(cfg, batch, device="cpu")
    assert len(res["layers"]) == cfg.sbm_layers
    for rec in res["layers"]:
        assert rec["edges"] > 0 and rec["edges_apart"] == 0
        assert rec["out_rel"] == 0.0 and max(rec["grad_rel"].values()) == 0.0


def test_expected_grad_gate_passes_on_the_plain_path(small_vocab, monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    cfg = get_config("java", eval_graph="expected", **{**NARROW, "sbm_enc_dim": 48})
    batch = _train_batch(cfg, (30, 64), seed=5)
    model, grad_pass, counts, rec = chip_smoke.expected_grad_gate(cfg, batch, "err.json",
                                                                  device="cpu")
    assert not any(counts.values())
    assert rec["loss_rel"] == 0.0 and rec["grad_norm_rel"] == 0.0
    assert (tmp_path / "err.json").exists()
    assert model.encoder.blocks[0].attn.clusters.grad.abs().sum() > 0


@pytest.mark.parametrize("compute,pages", [("bfloat16", "bfloat16"), ("float32", "int8")])
def test_capture_decode_inputs_of_quantized_pools(small_vocab, compute, pages):
    cfg = get_config("python", eval_graph="expected", serve_slots=4, max_tgt_len=12,
                     compute_dtype=compute, serve_kv_page_dtype=pages, **NARROW)
    rng = np.random.default_rng(0)
    samples = [request_sample(random_ast(rng, n), cfg, 300) for n in (20, 60, 64, 40, 33)]
    got = chip_smoke.capture_decode_inputs(cfg, samples, [0, 3, 5, 0, 2], device="cpu")
    for side in ("self", "cross"):
        inputs, merge = got[side]["inputs"], got[side]["merge"]
        assert inputs[1].dtype == KV_PAGE_DTYPES[pages] and inputs[0].dtype == torch.float32
        assert inputs[3].dtype == torch.float32 and (inputs[3] != 1.0).any() == (pages == "int8")
        out, _ = pd.paged_attend(*inputs, **merge)
        live = ~inputs[6].all(dim=1)
        assert torch.isfinite(out[live]).all()


def test_alternating_step_times_take_the_runs_in_turns(small_vocab):
    cfg = get_config("python", **NARROW)
    batch = _train_batch(cfg, (30, 40), seed=1)
    runs = {}
    for name, dtype in (("float32", "float32"), ("bfloat16", "bfloat16")):
        _, state, step = chip_smoke.trainer(cfg.replace(compute_dtype=dtype), device="cpu")
        runs[name] = (step, state)
    times = chip_smoke.alternating_step_times(runs, batch, rounds=2)
    assert set(times) == {"float32", "bfloat16"}
    assert all(len(t["step_s"]) == 2 and t["median_s"] > 0 for t in times.values())
    assert all(state.step == 2 for _, state in runs.values())
