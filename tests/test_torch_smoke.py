"""``chip_smoke.py``'s input captures, its same-graph gates and its step
gate, driven on the CPU at a narrow width through the plain paths: the
serving drain's decode launches are recorded from its middle and replay to
the output the drain computed, and each SBM layer's recorded inputs carry
the real cotangents, in the counter noise mode and in the config's default
shared mode (whose graph is an input), and in the expected-graph
gradient's deterministic forward; K1's serve-path capture (the largest
prefill group's first CSE layer) replays to that layer's output; the
backward work count the bounds read and the build's register and spill
reading.
On the card the same helpers feed the kernels.  Also ``Trainer.fit`` in the
config's defaults (shared noise, sampled eval graph) repeats from its seed."""

import numpy as np
import pytest
import torch

import chip_smoke
from csat_tpu_torch.configs import get_config
from csat_tpu_torch.data.dataset import batch_to_device, collate
from csat_tpu_torch.data.synthetic import random_ast, request_sample, train_sample
from csat_tpu_torch.models import CSATrans
from csat_tpu_torch.ops import paged_decode as pd
from csat_tpu_torch.serve import ServeEngine
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

# one intra-op thread: the suite's workers share the host's cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

NARROW = dict(hidden_size=32, sbm_enc_dim=32, pegen_dim=16, pe_dim=8, num_heads=2,
              dim_feed_forward=64)


@pytest.fixture
def small_vocab(monkeypatch):
    monkeypatch.setattr(chip_smoke, "SRC_VOCAB", 300)
    monkeypatch.setattr(chip_smoke, "TGT_VOCAB", 400)


def _train_batch(cfg, sizes, seed):
    rng = np.random.default_rng(seed)
    samples = [train_sample(random_ast(rng, n), cfg, 300, 400, rng) for n in sizes]
    arrs = {key: np.stack([s[key] for s in samples]) for key in samples[0]}
    return batch_to_device(collate(arrs, cfg.max_src_len), torch.device("cpu"))


def test_capture_decode_inputs_keeps_the_middle_launch_of_each_side(small_vocab, monkeypatch):
    from csat_tpu_torch.models import components

    cfg = get_config("python", eval_graph="expected", serve_slots=4, max_tgt_len=12, **NARROW)
    rng = np.random.default_rng(0)
    samples = [request_sample(random_ast(rng, n), cfg, 300) for n in (20, 60, 150, 90, 33)]
    budgets = [0, 3, 5, 0, 2]
    got = chip_smoke.capture_decode_inputs(cfg, samples, budgets, device="cpu")
    assert set(got) == {"self", "cross"}
    # the drain is deterministic: a third drain's launch at the same index
    # gets the same arguments and gives the output the capture replays to
    outs = {}
    inner = components.paged_attend
    calls = {"self": 0, "cross": 0}

    def recorder(*args, idx=None, k_tok=None, v_tok=None):
        side = "cross" if idx is None else "self"
        out = inner(*args, idx=idx, k_tok=k_tok, v_tok=v_tok)
        if calls[side] == got[side]["call"]:
            outs[side] = out[0].clone()
        calls[side] += 1
        return out

    monkeypatch.setattr(components, "paged_attend", recorder)
    model = CSATrans(cfg, 300, 400, device="cpu", seed=chip_smoke.SEED)
    engine = ServeEngine(model, cfg, device="cpu")
    for sample, budget in zip(samples, budgets):
        engine.submit(sample, budget)
    engine.drain()
    for side, rec in got.items():
        assert rec["call"] == rec["of"] // 2 and calls[side] in (rec["of"], rec["of"] + 1)
        q, pk, pv, sk, sv, table, mask, width = rec["inputs"]
        assert width == (cfg.max_src_len if side == "cross" else cfg.max_tgt_len - 1)
        assert mask.shape == (cfg.serve_slots, width) and (~mask).any()
        assert (rec["merge"] != {}) == (side == "self")
        out, skipped = pd.paged_attend(*rec["inputs"], **rec["merge"])
        torch.testing.assert_close(out, outs[side], atol=0, rtol=0)
        assert torch.equal(skipped, pd.reference_page_skip(table, q.shape[1]))


def test_capture_cse_inputs_keeps_the_largest_prefill_group(small_vocab, monkeypatch):
    """The serve-path K1 capture records the first CSE layer of the drain's
    largest prefill group: its q, k, v, tables and the group's own distances
    and masks, which give that layer's attention output again."""
    from csat_tpu_torch.models import cse
    from csat_tpu_torch.ops import flex_core

    cfg = get_config("python", eval_graph="expected", serve_slots=4, max_tgt_len=12, **NARROW)
    rng = np.random.default_rng(0)
    samples = [request_sample(random_ast(rng, n), cfg, 300) for n in (20, 60, 150, 90, 33)]
    budgets = [0, 3, 5, 0, 2]
    got = chip_smoke.capture_prefill_inputs(cfg, samples, budgets, device="cpu")
    shapes, outs = [], {}
    inner = cse.flex_attention

    def recorder(q, k, v, spec, aux):
        out = inner(q, k, v, spec, aux)
        shapes.append((q.shape[2], q.shape[0]))
        outs.setdefault(shapes[-1], out[0].clone())
        return out

    monkeypatch.setattr(cse, "flex_attention", recorder)
    model = CSATrans(cfg, 300, 400, device="cpu", seed=chip_smoke.SEED)
    engine = ServeEngine(model, cfg, device="cpu")
    for sample, budget in zip(samples, budgets):
        engine.submit(sample, budget)
    engine.drain()
    q, spec, (lq, lk, rel, mask) = got["q"], got["spec"], got["aux"]
    assert (q.shape[2], q.shape[0]) == max(shapes) and len(shapes) % cfg.num_layers == 0
    assert rel.shape == mask.shape == (q.shape[0], 2, q.shape[2], q.shape[2])
    assert mask.any() and (~mask).any() and got["rate"] == 0.0 and got["dseed"] is None
    out, _ = flex_core.flex_attention(got["q"], got["k"], got["v"], spec, got["aux"])
    torch.testing.assert_close(out, outs[max(shapes)], atol=0, rtol=0)


@pytest.mark.parametrize("name", ["python_treepos", "java"])
def test_capture_prefill_inputs_of_the_sbm_layer(small_vocab, monkeypatch, name):
    """The serve-path K2 capture (java's, at dh 96 on the card) records the
    first SBM layer of the drain's largest prefill group, which gives that
    layer's output again; a PE variant's requests carry real tree positions
    and more than one triplet id."""
    from csat_tpu_torch.models import sbm
    from csat_tpu_torch.ops import flex_core

    cfg = get_config(name, eval_graph="expected", serve_slots=4, max_tgt_len=12,
                     **dict(NARROW, pegen_dim=128 if name.endswith("treepos") else 16))
    samples, budgets = chip_smoke.make_requests(cfg, 5)
    inputs = chip_smoke._check_nonblank(name, [s["tree_pos"] for s in samples],
                                        [s["triplet"] for s in samples],
                                        [s["num_node"] for s in samples])
    assert inputs["tree_pos_ones"] > 0 and inputs["triplet_ids"] > 1
    got = chip_smoke.capture_prefill_inputs(cfg, samples, budgets, device="cpu", layer="sbm")
    shapes, outs = [], {}
    inner = sbm.flex_attention

    def recorder(q, k, v, spec, aux, *args):
        out = inner(q, k, v, spec, aux, *args)
        shapes.append((q.shape[2], q.shape[0]))
        outs.setdefault(shapes[-1], out[0].clone())
        return out

    monkeypatch.setattr(sbm, "flex_attention", recorder)
    engine = ServeEngine(CSATrans(cfg, 300, 400, device="cpu", seed=chip_smoke.SEED), cfg,
                         device="cpu")
    for sample, budget in zip(samples, budgets):
        engine.submit(sample, budget)
    engine.drain()
    assert (got["q"].shape[2], got["q"].shape[0]) == max(shapes)
    assert got["spec"].name == "sbm_expected" and got["inputs"].startswith(f"{name} serve")
    out, _ = flex_core.flex_attention(got["q"], got["k"], got["v"], got["spec"], got["aux"])
    torch.testing.assert_close(out, outs[max(shapes)], atol=0, rtol=0)


def test_blank_pe_inputs_fail_the_check():
    """Zero tree positions, or one triplet id on every real node, fail."""
    pos = np.zeros((2, 5, 8), np.uint8)
    trip = np.full((2, 5), 7, np.int32)
    with pytest.raises(AssertionError, match="blank"):
        chip_smoke._check_nonblank("t", pos, trip, [5, 3])
    pos[0, 1, 2] = 1
    with pytest.raises(AssertionError, match="blank"):
        chip_smoke._check_nonblank("t", pos, trip, [5, 3])
    trip[1, 4] = 9  # a pad node's id does not count
    with pytest.raises(AssertionError, match="blank"):
        chip_smoke._check_nonblank("t", pos, trip, [5, 3])
    trip[1, 2] = 9
    assert chip_smoke._check_nonblank("t", pos, trip, [5, 3]) == dict(
        tree_pos_ones=1, triplet_ids=2)


def test_serve_shapes_cover_every_prefill_group():
    """Every (B, N) an admission can give the encoder: each bucket of the
    prefill ladder from one request to its batch size."""
    from csat_tpu_torch.serve.prefill import prefill_plan

    cfg = chip_smoke.flagship()
    shapes = chip_smoke.serve_shapes(cfg)
    assert {n for _, n in shapes} == {spec.n for spec in prefill_plan(cfg)} == {37, 75, 150}
    assert len(shapes) == sum(spec.batch_size for spec in prefill_plan(cfg)) == 20
    assert (8, 37) in shapes and (4, 150) in shapes and (5, 150) not in shapes


def test_ptxas_usage_reads_registers_and_spills_per_function():
    """The build phase's register and spill reading, on an ``-Xptxas -v``
    report of the form nvcc prints (one kernel that spills, one that does
    not)."""
    log = """ptxas info    : Compiling entry function '_Z1aILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z1aILi64EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z1bILi96EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z1bILi96EEvv
    296 bytes stack frame, 348 bytes spill stores, 360 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 296 bytes cumulative stack size
"""
    assert chip_smoke.ptxas_usage(log) == {
        "_Z1aILi64EEvv": {"registers": 254, "spill_stores": 0},
        "_Z1bILi96EEvv": {"registers": 255, "spill_stores": 348}}


def test_capture_sbm_inputs_records_every_layer_with_its_cotangents(small_vocab):
    cfg = get_config("python", noise_mode="counter", **NARROW)
    batch = _train_batch(cfg, (20, 80, 150), seed=1)
    layers = chip_smoke.capture_sbm_inputs(cfg, batch, "cpu", layers=cfg.sbm_layers)
    assert len(layers) == cfg.sbm_layers
    seeds = set()
    for rec in layers:
        b, h, n, dh = rec["q"].shape
        assert (b, h, n) == (3, cfg.num_heads, cfg.max_src_len)
        assert rec["rate"] == cfg.attention_dropout and rec["dseed"].shape == (1,)
        assert rec["go"].abs().sum() > 0 and rec["gs"].abs().sum() > 0
        seeds.add(int(rec["aux"][3]))
    assert len(seeds) == cfg.sbm_layers  # every layer draws its graph under its own seed


def test_same_graph_gate_passes_on_the_plain_path(small_vocab):
    cfg = get_config("python", noise_mode="counter", **NARROW)
    batch = _train_batch(cfg, (30, 150), seed=2)
    res = chip_smoke.same_graph_gate(cfg, batch, device="cpu")
    assert [rec["layer"] for rec in res["layers"]] == list(range(cfg.sbm_layers))
    for rec in res["layers"]:
        assert rec["edges"] > 0 and rec["edges_apart"] == 0
        assert rec["out_rel"] == 0.0 and max(rec["grad_rel"].values()) == 0.0


# ---------------------------------------------------------------------------
# the expected-graph gradient: eval_graph="expected", the deterministic forward
# ---------------------------------------------------------------------------

def test_capture_sbm_inputs_records_the_expected_graph_forward(small_vocab):
    from csat_tpu_torch.ops.mods import SBMExpectedSpec

    cfg = get_config("python", eval_graph="expected", **NARROW)
    batch = _train_batch(cfg, (20, 80, 150), seed=5)
    layers = chip_smoke.capture_sbm_inputs(cfg, batch, "cpu", layers=cfg.sbm_layers,
                                           deterministic=True)
    assert len(layers) == cfg.sbm_layers
    for rec in layers:
        b, h, n, _ = rec["q"].shape
        assert isinstance(rec["spec"], SBMExpectedSpec) and rec["spec"].floor == cfg.sbm_floor
        r, kh, pad = rec["aux"]
        assert r.shape == kh.shape == (b, h, n, rec["spec"].kk) and pad.shape == (b, n)
        assert rec["rate"] == 0.0 and rec["dseed"] is None
        assert rec["inputs"] == "expected_grad batch"
        assert rec["go"].abs().sum() > 0 and rec["gs"].abs().sum() > 0


def test_expected_same_layer_gate_passes_on_the_plain_path(small_vocab):
    cfg = get_config("python", eval_graph="expected", **NARROW)
    batch = _train_batch(cfg, (30, 150), seed=6)
    res = chip_smoke.same_graph_gate(cfg, batch, device="cpu", deterministic=True)
    assert [rec["layer"] for rec in res["layers"]] == list(range(cfg.sbm_layers))
    assert res["graph_sum_rtol"] == chip_smoke.SAME_GRAPH_GSUM_RTOL
    for rec in res["layers"]:
        assert rec["mod"] == "sbm_expected" and set(rec["grad_rel"]) == set(chip_smoke.GRAD_NAMES)
        assert rec["graph_sum"] > 0 and rec["graph_sum_rel"] == 0.0
        assert rec["out_rel"] == 0.0 and max(rec["grad_rel"].values()) == 0.0


@pytest.mark.parametrize("mod", ["sbm_sampled", "sbm_expected"])
def test_backward_work_counts_the_products_as_tensor_core_work(mod):
    """B 1, H 1, N 3, kk 2, dh 4 by hand: 4 live entries (a_eff > 0) of 5
    edges (a_raw > 0) of 9."""
    from csat_tpu_torch.ops.mods import SBMExpectedSpec, SBMSampledSpec

    spec = (SBMSampledSpec if mod == "sbm_sampled" else SBMExpectedSpec)(n=3, heads=1, kk=2,
                                                                        floor=0.01)
    a_raw = torch.tensor([[[[1.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 1.0, 0.0]]]])
    a_eff = a_raw * torch.tensor([1.0, 1.0, 0.0])  # key 2 padded: one edge loses its weight
    work = chip_smoke.backward_work(spec, a_raw, a_eff, 4)
    assert (work["live_entries"], work["edges"], work["entries"]) == (4, 5, 9)
    cluster = (5 if mod == "sbm_sampled" else 9) * 2 * 2  # d_exp·K̂ per edge | per entry
    rkt = 9 * 2 * 2                                       # R·K̂ᵀ per entry, f32
    assert work["q"] == dict(flops=4 * 6 * 4 + cluster + rkt,
                             tensor_core_flops=4 * 6 * 4 + cluster)
    assert work["k"] == dict(flops=4 * 8 * 4 + cluster + rkt,
                             tensor_core_flops=4 * 8 * 4 + cluster)


# ---------------------------------------------------------------------------
# the config's default training path: noise_mode="shared", eval_graph="sample"
# ---------------------------------------------------------------------------

def test_capture_sbm_inputs_records_the_shared_graph_and_its_cotangents(small_vocab):
    cfg = get_config("python", **NARROW)
    assert cfg.noise_mode == "shared"
    batch = _train_batch(cfg, (20, 80, 150), seed=3)
    layers = chip_smoke.capture_sbm_inputs(cfg, batch, "cpu", layers=cfg.sbm_layers)
    assert len(layers) == cfg.sbm_layers
    for rec in layers:
        b, h, n, _ = rec["q"].shape
        assert rec["spec"].name == "sbm_graph"
        graph, pad = rec["aux"]
        assert graph.shape == (b, h, n, n) and pad.shape == (b, n)
        assert torch.all((graph == 0) | (graph == 1)) and graph.sum() > 0
        assert torch.all((pad == 0) | (pad == 1)) and pad[2].sum() == 0 < pad[0].sum()
        assert rec["rate"] == cfg.attention_dropout and rec["dseed"].shape == (1,)
        assert rec["go"].abs().sum() > 0 and rec["gs"].abs().sum() > 0


def test_shared_same_graph_gate_passes_on_the_plain_path(small_vocab):
    cfg = get_config("python", **NARROW)
    batch = _train_batch(cfg, (30, 150), seed=2)
    res = chip_smoke.same_graph_gate(cfg, batch, device="cpu")
    assert [rec["layer"] for rec in res["layers"]] == list(range(cfg.sbm_layers))
    for rec in res["layers"]:
        assert rec["mod"] == "sbm_graph" and set(rec["grad_rel"]) == {"dq", "dk", "dv", "dgraph"}
        assert rec["edges"] > 0 and rec["edges_apart"] == 0
        assert rec["out_rel"] == 0.0 and max(rec["grad_rel"].values()) == 0.0


def test_shared_step_gate_passes_on_the_plain_path(small_vocab):
    cfg = get_config("python", **NARROW)
    batch = _train_batch(cfg, (30, 150), seed=4)
    *_, metrics, launches, rec = chip_smoke.step_gate(cfg, batch, device="cpu")
    assert np.isfinite(float(metrics["loss"])) and not any(launches.values())
    assert rec["loss_rel"] == 0.0 and rec["grad_norm_rel"] == 0.0
    assert rec["net_graph_edges_apart"] == 0.0 and rec["kernel_sparsity"] > 0


def test_default_fit_repeats_from_its_seed(tmp_path):
    from csat_tpu_torch.data.dataset import ASTDataset
    from csat_tpu_torch.data.synthetic import make_corpus
    from csat_tpu_torch.train import Trainer
    from csat_tpu_torch.train.loop import _decode_dataset

    data_dir = make_corpus(str(tmp_path / "corpus"), 48, 16, 16, seed=0, max_ast_len=48)
    runs = []
    for run in ("a", "b"):
        cfg = get_config("python", data_dir=data_dir, output_dir=str(tmp_path / run),
                         num_epochs=1, val_interval=1, bucketing=True, max_src_len=48,
                         max_tgt_len=10, batch_size=8, num_layers=1, sbm_layers=2,
                         clusters=(4, 3), decoder_layers=2, tree_pos_width=4,
                         tree_pos_height=8, **NARROW)
        assert (cfg.noise_mode, cfg.eval_graph) == ("shared", "sample")
        tr = Trainer(cfg, log=lambda msg: None, device="cpu")
        train, dev = (ASTDataset(cfg, split, tr.src_vocab, tr.tgt_vocab)
                      for split in ("train", "dev"))
        _, hist = tr.fit(train, dev)
        gen = torch.Generator().manual_seed(cfg.seed + 777)
        runs.append((hist, [y for y, _ in _decode_dataset(tr.model, dev, cfg, gen)]))
    (hist_a, tokens_a), (hist_b, tokens_b) = runs
    assert hist_a["steps"] and np.isfinite(hist_a["loss"]).all()
    assert [r["loss"] for r in hist_a["steps"]] == [r["loss"] for r in hist_b["steps"]]
    assert hist_a["loss"] == hist_b["loss"] and hist_a["val_bleu"] == hist_b["val_bleu"]
    assert len(tokens_a) == len(tokens_b) > 0
    assert all(np.array_equal(a, b) for a, b in zip(tokens_a, tokens_b))
