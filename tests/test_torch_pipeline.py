"""The port's GPipe wavefront over a ``pipe`` axis (``csat_tpu_torch/parallel/pipeline.py``)
on the CPU, against a sequential microbatched loop and JAX's ``gpipe_blocks``.

Ranks run as spawned processes in one gloo group (``tests/torch_dist.py``).
The counterparts of ``tests/test_pipeline.py:38-176``:

* ``gpipe_blocks`` over 4 SBM blocks at (pipe, microbatches, data) = (2, 4,
  1), (2, 2, 2) with remat and (4, 2, 1), with the (layer, microbatch) seeds
  handed over, against a sequential loop over the microbatches with JAX's
  keying written out here (microbatches per data shard, key (l, m) shared by
  the shards, each microbatch hashed from row 0): the output within 1e-5,
  the per-head sparsity within 1e-6, every block parameter's and the
  input's gradient within 1e-4 relative; and against JAX's ``gpipe_blocks``
  on a CPU mesh of the same shape with the same seeds handed to its blocks
  (forward, the JAX test's limits);
* in training mode (model dropout 0.3 from the streams, attention dropout
  0.2) the wavefront equals the sequential loop;
* a whole train step of a tiny python_pp at ``pipe`` 2 and at ``data`` 2 ×
  ``pipe`` 2 equals one process running the sequential microbatched loop
  with JAX's keying on the global batch (``pipeline_reference_mesh``):
  loss and sparsity within 1e-6, grad-norm within 1e-5, every parameter's
  gradient within 1e-4 (of the larger of its own and 1 % of the largest),
  the gradients the same bits on every rank and no parameter without
  gradient; the expected-graph greedy decode through the wavefront equals
  the one-process decode;
* a 2-rank ``Trainer.fit`` of python_pp: only rank 0 checkpoints, the ranks'
  losses and parameters are the same bits;
* python_pp through the train command line under ``torchrun`` (two CPU
  processes) and its checkpoint through ``summarize``;
* the validation refusals of the JAX package's pipeline and ring rules, and
  the dry run over 2 gloo ranks at ``pipe`` 2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from torch_parity import configs, jax_model_and_params, torch_model
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WAVE = {"p2m4d1": (2, 4, 1, False), "p2m2d2-remat": (2, 2, 2, True), "p4m2d1": (4, 2, 1, False)}
B, N, L = 8, 16, 4


_PARAMS = {}


def _setup(pipe, micro, data, **over):
    """(JAX config, port config, JAX layer params, port blocks' state dict,
    inputs) for 4 SBM blocks of 3 clusters at micro widths (one JAX init
    serves every shape: the parameters do not depend on the mesh)."""
    jcfg, tcfg = configs("python_pp", **{**dict(
        sbm_layers=L, clusters=(3,) * L, max_src_len=N, batch_size=B, dropout=0.0,
        attention_dropout=0.0, pipeline_stages=pipe, pipeline_microbatches=micro,
        mesh_shape=(("data", data), ("pipe", pipe))), **over})
    if not _PARAMS:
        _PARAMS["params"] = jax_model_and_params(jcfg, seed=4)[1]
        _PARAMS["blocks"] = torch_model(tcfg, _PARAMS["params"]).encoder.blocks.state_dict()
    params = _PARAMS["params"]
    rng = np.random.default_rng(0)
    inputs = dict(
        x=rng.standard_normal((B, N, tcfg.sbm_enc_dim)).astype(np.float32),
        pad=rng.random((B, N)) < 0.2,
        seeds=rng.integers(0, 2**31 - 1, (2, L, micro)).astype(np.int32),
        go=rng.standard_normal((B, N, tcfg.sbm_enc_dim)).astype(np.float32),
        gsp=rng.standard_normal((L, tcfg.num_heads)).astype(np.float32))
    layer_params = [params["encoder"][f"transformer_{i}"] for i in range(L)]
    return jcfg, tcfg, layer_params, _PARAMS["blocks"], inputs


def _sequential(tcfg, state_dict, inp, micro, data, deterministic, remat=False):
    """The blocks over every microbatch in turn with JAX's keying → output,
    sparsity (L, H), the block parameters' and the input's gradients of
    ``Σ out·go + Σ sparsity·gsp``."""
    from csat_tpu_torch.models import sbm as tsbm
    from csat_tpu_torch.models.components import remat as remat_fn
    from csat_tpu_torch.ops.hashrng import KeyedStream
    from csat_tpu_torch.parallel.mesh import DataShard

    blocks = torch.nn.ModuleList(tsbm.SBMBlock(tcfg, i) for i in range(L))
    blocks.load_state_dict(state_dict)
    x = torch.tensor(inp["x"]).requires_grad_()
    pad = torch.tensor(inp["pad"])
    seeds = inp["seeds"]
    mb = B // (data * micro)
    outs, sps = [], []
    for s in range(data):
        for m in range(micro):
            rows = slice((s * micro + m) * mb, (s * micro + m + 1) * mb)
            y, sp_m = x[rows], []
            for l in range(L):
                stream = KeyedStream(torch.tensor(seeds[0, l, m]), torch.tensor(seeds[1, l, m]))
                args = (y, pad[rows], deterministic, stream, DataShard(row0=0, rows=mb))
                y, sp = (remat_fn(blocks[l], (stream,), *args) if remat else blocks[l](*args))
                sp_m.append(sp)
            outs.append(y)
            sps.append(torch.stack(sp_m))
    out, sp = torch.cat(outs), torch.mean(torch.stack(sps), dim=0)
    (torch.sum(out * torch.tensor(inp["go"])) + torch.sum(sp * torch.tensor(inp["gsp"]))).backward()
    return (out.detach().numpy(), sp.detach().numpy(),
            {n: p.grad.numpy() for n, p in blocks.named_parameters()}, x.grad.numpy())


def _wave_ranks(tmp_path, tcfg, state_dict, inp, deterministic, remat):
    pipe = dict(tcfg.mesh_shape)["pipe"]
    world = pipe * dict(tcfg.mesh_shape)["data"]
    return torch_dist.run_ranks(torch_dist.gpipe_rank, world, tmp_path, dict(
        cfg=tcfg, state_dict=state_dict, deterministic=deterministic, remat=remat, **inp),
        timeout=180)


def _assemble(ranks):
    """Output rows by data shard, the sparsity summed over the data shards,
    gradients summed over every rank."""
    out = np.zeros((B, N, ranks[0]["out"].shape[-1]), np.float32)
    sp, seen = 0.0, set()
    x_grad = np.zeros_like(out)
    grads = {n: 0.0 for n in ranks[0]["grads"]}
    for r in ranks:
        r0, b = r["rows"]
        out[r0:r0 + b] = r["out"]
        x_grad[r0:r0 + b] += r["x_grad"]
        if r0 not in seen:
            seen.add(r0)
            sp = sp + r["sparsity"]
        for n, g in r["grads"].items():
            grads[n] = grads[n] + g
    return out, sp, grads, x_grad


def _rel(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12)


@pytest.fixture(scope="module")
def waves(tmp_path_factory):
    import csat_tpu_torch.models.sbm as tsbm

    runs = {}

    def get(name):
        if name not in runs:
            pipe, micro, data, remat = WAVE[name]
            setup = _setup(pipe, micro, data, remat=remat)
            _, tcfg, _, sd, inp = setup
            before = tsbm.ClusterProj.dropout
            tsbm.ClusterProj.dropout = 0.0  # as the ranks set it
            try:
                seq = _sequential(tcfg, sd, inp, micro, data, True, remat)
            finally:
                tsbm.ClusterProj.dropout = before
            ranks = _wave_ranks(tmp_path_factory.mktemp(name), tcfg, sd, inp, True, remat)
            runs[name] = (setup, seq, ranks)
        return runs[name]
    return get


@pytest.mark.parametrize("name", list(WAVE))
def test_wavefront_equals_sequential_loop(waves, name):
    _, (ref_out, ref_sp, ref_grads, ref_xg), ranks = waves(name)
    out, sp, grads, x_grad = _assemble(ranks)
    np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sp, ref_sp, rtol=1e-5, atol=1e-6)
    for n, g in ref_grads.items():
        assert _rel(grads[n], g) <= 1e-4, (n, _rel(grads[n], g))
    assert _rel(x_grad, ref_xg) <= 1e-4
    for r in ranks[1:]:  # every stage holds the outputs and the sparsity
        if r["rows"] == ranks[0]["rows"]:
            np.testing.assert_array_equal(r["out"], ranks[0]["out"])
            np.testing.assert_array_equal(r["sparsity"], ranks[0]["sparsity"])


@pytest.mark.parametrize("name", list(WAVE))
def test_wavefront_equals_jax_gpipe(waves, name, monkeypatch):
    """JAX's ``gpipe_blocks`` on a CPU mesh of the same shape, the same
    (layer, microbatch) sample seeds handed to its blocks' counter streams."""
    from csat_tpu.models import sbm as jsbm
    from csat_tpu.parallel.mesh import build_mesh
    from csat_tpu.parallel.pipeline import gpipe_blocks, stack_layer_params
    from csat_tpu.utils.compat import use_mesh

    (jcfg, _, layer_params, _, inp), _, ranks = waves(name)
    pipe, micro, data, remat = WAVE[name]

    class ClusterProj(jsbm.ClusterProj):  # JAX fixes 0.2; disabled here only
        dropout: float = 0.0

    handed = {}
    monkeypatch.setattr(jsbm, "ClusterProj", ClusterProj)
    monkeypatch.setattr(jsbm, "draw_counter_seed", lambda module, seed_name: handed[seed_name])
    block = jsbm.SBMBlock(jcfg, 0, jnp.float32)

    def block_apply(p, xm, padm, sk, dk):
        handed["sample"] = sk
        y, sp, _, _ = block.apply({"params": p}, xm, padm, True, False,
                                  rngs={"sample": jax.random.key(0)})
        return y, sp

    if remat:
        block_apply = jax.checkpoint(block_apply)
    stacked = stack_layer_params([jax.tree.map(jnp.asarray, p) for p in layer_params])
    with use_mesh(build_mesh((("data", data), ("pipe", pipe)))):
        jout, jsp = jax.jit(lambda s, xx, pp: gpipe_blocks(
            block_apply, s, xx, pp, jnp.asarray(inp["seeds"][0]), None, micro, pipe))(
            stacked, jnp.asarray(inp["x"]), jnp.asarray(inp["pad"]))
    out, sp, _, _ = _assemble(ranks)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sp, np.asarray(jsp), rtol=1e-5, atol=1e-6)


def test_wavefront_with_dropout_equals_sequential(tmp_path):
    """Training mode: every (layer, microbatch) stream drives the model
    dropout (0.3) and the attention dropout (0.2) alike in both."""
    import csat_tpu_torch.models.sbm as tsbm

    _, tcfg, _, sd, inp = _setup(2, 2, 2, dropout=0.3, attention_dropout=0.2)
    before = tsbm.ClusterProj.dropout
    tsbm.ClusterProj.dropout = 0.0
    try:
        ref_out, ref_sp, ref_grads, ref_xg = _sequential(tcfg, sd, inp, 2, 2, False)
    finally:
        tsbm.ClusterProj.dropout = before
    out, sp, grads, x_grad = _assemble(_wave_ranks(tmp_path, tcfg, sd, inp, False, False))
    np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sp, ref_sp, rtol=1e-5, atol=1e-6)
    for n, g in ref_grads.items():
        assert _rel(grads[n], g) <= 1e-4, n
    assert _rel(x_grad, ref_xg) <= 1e-4


# ---------------------------------------------------------------------------
# python_pp: a whole train step, decode, fit and the command lines
# ---------------------------------------------------------------------------

STEP = dict(pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=4,
            num_layers=1, sbm_layers=4, clusters=(3, 3, 3, 3), dim_feed_forward=64,
            decoder_layers=2, max_src_len=32, max_tgt_len=10, batch_size=8,
            eval_graph="expected")
STEPS = {"pipe2": ((("data", 1), ("pipe", 2)), 2), "data2xpipe2": ((("data", 2), ("pipe", 2)), 4)}


@pytest.fixture(scope="module")
def pp_steps(tmp_path_factory):
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import batch_to_device
    from csat_tpu_torch.parallel.dryrun import random_global_batch

    runs = {}

    def get(shape):
        if shape not in runs:
            mesh_shape, world = STEPS[shape]
            cfg = get_config("python_pp", **STEP, mesh_shape=mesh_shape)
            batch = batch_to_device(random_global_batch(cfg, 8), torch.device("cpu"))
            ref = torch_dist.mesh_step(0, 1, None, dict(cfg=cfg, batch=batch, reference=True))
            ranks = torch_dist.run_ranks(torch_dist.mesh_step, world,
                                         tmp_path_factory.mktemp(f"pp_{shape}"),
                                         dict(cfg=cfg, batch=batch), timeout=180)
            runs[shape] = (cfg, batch, ref, ranks)
        return runs[shape]
    return get


@pytest.mark.parametrize("shape", list(STEPS))
def test_pp_step_equals_sequential_reference(pp_steps, shape):
    cfg, _, ref, ranks = pp_steps(shape)
    assert cfg.dropout == 0.2 and cfg.attention_dropout == 0.2
    assert ranks[0]["mesh"] == dict(STEPS[shape][0])
    m, want = ranks[0]["metrics"], ref["metrics"]
    for key in ("loss", "sparsity"):
        assert abs(float(m[key]) / float(want[key]) - 1) <= 1e-6, (key, m[key], want[key])
    assert abs(float(m["grad_norm"]) / float(want["grad_norm"]) - 1) <= 1e-5
    gmax = max(np.max(np.abs(g)) for g in ref["grads"].values())
    for name, g in ref["grads"].items():
        scale = max(np.max(np.abs(g)), 1e-2 * gmax)
        assert np.max(np.abs(ranks[0]["grads"][name] - g)) <= 1e-4 * scale, name
        for r in ranks[1:]:
            assert np.array_equal(r["grads"][name], ranks[0]["grads"][name]), name
    # every stage's blocks got their gradient (summed from the stage that ran them)
    for i in range(cfg.sbm_layers):
        assert np.any(ranks[0]["grads"][f"encoder.blocks.{i}.wq.weight"]), i


@pytest.mark.parametrize("shape", list(STEPS))
def test_pp_decode_equals_one_process(pp_steps, shape):
    """The expected-graph decode through the wavefront (every stage holds
    the memory) gives one process's tokens for the same rows."""
    cfg, batch, _, ranks = pp_steps(shape)
    for r in ranks:
        r0, b = r["rows"]
        want = torch_dist.decode_rows(cfg.replace(mesh_shape=(("data", 1),),
                                                  pipeline_stages=0),
                                      torch_dist.rows_of(batch, r0, r0 + b))
        np.testing.assert_array_equal(r["tokens"], want)


FIT = dict(pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=2, num_layers=1,
           sbm_layers=2, clusters=(4, 4), dim_feed_forward=64, decoder_layers=2,
           max_src_len=48, max_tgt_len=10, batch_size=4, pipeline_microbatches=2,
           tree_pos_width=4, tree_pos_height=8, val_interval=1, save_interval=1,
           guard_check_every=1, num_epochs=2, prefetch=0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from csat_tpu_torch.data.synthetic import make_corpus

    return make_corpus(str(tmp_path_factory.mktemp("pp_corpus")), n_train=24, n_dev=8,
                       n_test=8, seed=2, max_ast_len=48)


def test_pp_fit_rank0_checkpoints(corpus, tmp_path):
    from csat_tpu_torch.configs import get_config

    cfg = get_config("python_pp", data_dir=corpus, output_dir=str(tmp_path / "out"), **FIT)
    ranks = torch_dist.run_ranks(torch_dist.dp_fit, 2, tmp_path / "ranks", dict(cfg=cfg))
    assert ranks[0]["calls"] == [1, 2] and ranks[1]["calls"] == []
    assert ranks[0]["plan"].endswith("@hosts=1")  # one data shard, two stages
    assert ranks[0]["steps"] == ranks[1]["steps"] and len(ranks[0]["steps"]) == 2 * 6
    assert all(np.isfinite(s[2]) for s in ranks[0]["steps"])
    assert ranks[0]["val_bleu"] == ranks[1]["val_bleu"]
    for name in ranks[0]["params"]:
        assert np.array_equal(ranks[0]["params"][name], ranks[1]["params"][name]), name


def test_python_pp_through_both_command_lines(corpus, tmp_path, capsys):
    """``torchrun --standalone`` trains python_pp on two CPU processes (the
    two stages; rank 0 alone prints the scores and checkpoints), then
    ``summarize`` serves its best model in one process on the serving graph
    (the expected one; the encoder's sequential loop: no pipe axis there)."""
    import json
    import os
    import subprocess
    import sys

    from csat_tpu_torch.serve import cli as serve_cli

    out = tmp_path / "out"
    sets = [f"{k}={v!r}" for k, v in FIT.items() if k not in ("num_epochs", "batch_size")]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "csat_tpu_torch.cli", "--config", "python_pp", "--data_dir", corpus,
           "--device", "cpu", "--epochs", "1", "--batch_size", "4",
           *[a for s in sets for a in ("--set", s)], "--set", f"output_dir={str(out)!r}"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    finals = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    assert len(finals) == 1 and "val_best_bleu" in finals[0], res.stdout[-2000:]
    run_dir = os.path.join(out, "final_exp", "pp2_gpipe")
    assert os.listdir(os.path.join(run_dir, "checkpoints")) == ["state_1.pt"]

    snippet = tmp_path / "f.py"
    snippet.write_text("def add(a, b):\n    return a + b\n")
    serve_cli.main(["summarize", "--config", "python_pp", "--data_dir", corpus,
                    "--checkpoint_dir", run_dir, "--device", "cpu", "--max_new_tokens", "4",
                    *[a for s in sets for a in ("--set", s)], "--set", "eval_graph='expected'",
                    str(snippet)])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1 and lines[0].get("status", "OK") == "OK", lines


REFUSED = {
    "bucketing": dict(bucketing=True),
    "no_pipe_axis": dict(mesh_shape=(("data", -1),)),
    "seq_axis": dict(mesh_shape=(("data", 1), ("seq", 2), ("pipe", 2))),
    "micro_indivisible": dict(batch_size=6),
    "stages_indivisible": dict(pipeline_stages=3, mesh_shape=(("data", -1), ("pipe", 3))),
    "clusters_not_uniform": dict(clusters=(10, 10, 10, 8)),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_pipeline_validation_refusals(name):
    from csat_tpu_torch.configs import get_config

    with pytest.raises(ValueError):
        get_config("python_pp", **REFUSED[name])


@pytest.mark.parametrize("over", [dict(noise_mode="shared"), dict(bucketing=True)],
                         ids=["ring_needs_counter", "bucketing_under_seq"])
def test_seq_validation_refusals(over):
    from csat_tpu_torch.configs import get_config

    with pytest.raises(ValueError):
        get_config("python_long", mesh_shape=(("data", -1), ("seq", 2)), **over)


def test_dryrun_pipe_axis():
    from csat_tpu_torch.parallel.dryrun import dryrun_train_step

    loss, info = dryrun_train_step(2, timeout_s=240, pipe_par=2)
    assert np.isfinite(loss) and info["mesh"] == {"data": 1, "pipe": 2}
    assert info["decoded"] == [2, 11]


def test_reference_mesh_folds_the_data_shards():
    from csat_tpu_torch.parallel.mesh import pipeline_reference_mesh

    mesh = pipeline_reference_mesh((("data", 2), ("pipe", 2)))
    shard = mesh.shard(8)
    assert mesh.group is None and mesh.replicas == 1
    assert shard.pipe.size == 1 and shard.pipe_data_groups == 2
    assert (shard.row0, shard.rows) == (0, 8)
    assert dataclasses.replace(shard, pipe=None).pipe is None
    with pytest.raises(ValueError):
        pipeline_reference_mesh((("data", -1), ("pipe", 2)))
