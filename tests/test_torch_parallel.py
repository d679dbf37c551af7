"""The port's data parallelism (``csat_tpu_torch/parallel``) on the CPU.

Ranks run as spawned processes in one gloo group (``tests/torch_dist.py``:
a ``file://`` store under ``tmp_path``, one intra-op thread a rank, every
join bounded).

* a 2-process step — each rank holding half of the rows, the halves with
  unequal non-PAD target counts (12 and 18) — equals the 1-process step of
  the port and JAX's one-device ``make_train_step`` on the global batch: loss,
  sparsity, every gradient and every parameter after AdamW (the port's
  1-process step: loss 1e-6 relative, gradients 2e-6 + 1e-5 relative,
  parameters 1e-5; JAX: the whole-step tolerances of
  tests/test_torch_train.py); on the two ranks the metrics, the guard's
  decision, the gradients and the parameters after the step are the same
  bits (remat off here: the seeds handed to both packages are counted by
  draw, which a recompute would advance; tests/test_torch_long.py holds the
  remat step to JAX with the port's own draws);
* with model dropout on (the config's 0.2, the cluster projection's 0.2) and
  the port's own draws, remat on, a 2-process step equals the 1-process
  step on the global batch (counter and shared noise): each rank's dropout
  masks are its rows' slices of the global draw;
* the hash seeds every rank draws, all-gathered, are equal even when the
  ranks hold different row counts with model dropout on;
* ``coordinated_trigger`` stops both ranks when one is signalled, and
  ``abort_barrier`` returns ``"barrier"``;
* a 2-process ``Trainer.fit``: only rank 0 calls the checkpoint function,
  the ranks' losses and parameters are the same bits, the plan id carries
  ``@hosts=2``; a SIGTERM to rank 1 stops both ranks at the same step
  boundary, and the resumed run reproduces the uninterrupted run's losses
  bit for bit;
* the command line under ``torchrun --standalone`` with two CPU processes:
  rank 0 alone prints the scores and writes the checkpoint;
* the mesh: ``-1`` fills the process count, a mismatch is refused, a
  ``model`` axis is accepted but refused under a pipe axis or over heads it
  does not divide, and ``python_pp`` builds (the ``seq`` / ``pipe`` axes: test_torch_ring.py,
  test_torch_pipeline.py);
* the data-parallel dry run (``parallel/dryrun.py``) over 2 gloo ranks.
"""

import jax
import numpy as np
import pytest

import torch_dist
from torch_parity import SEEDS, configs, jax_train_step, step_batch, train_setup
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRAD_TOL = 3e-5
N_REAL = (150, 40, 160, 90)


def test_dp_step_equals_one_process_and_jax(monkeypatch, tmp_path):
    from csat_tpu_torch.convert import convert_params
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step
    from csat_tpu_torch.utils import PAD

    (jcfg, tcfg, jmodel, params, tmodel, _, _, _, _) = train_setup(
        "counter", monkeypatch, name="python_long", max_src_len=160, remat=False)
    jbatch, tbatch = step_batch(jcfg, tcfg, n_real=N_REAL)
    real = (np.asarray(tbatch.target) != PAD).sum(axis=1)
    assert real[:2].sum() != real[2:].sum()  # the halves weigh differently
    payload = dict(cfg=tcfg, state_dict={k: v.clone() for k, v in tmodel.state_dict().items()},
                   batch=tbatch, seeds=SEEDS)

    ranks = torch_dist.run_ranks(torch_dist.dp_step, 2, tmp_path, payload)
    assert [r["mesh"] for r in ranks] == [{"data": 2}] * 2
    assert [r["rows"] for r in ranks] == [(0, 2), (2, 2)]
    r0, r1 = ranks
    for key in r0["metrics"]:  # the guard's decision and every metric alike
        assert np.array_equal(r0["metrics"][key], r1["metrics"][key]), key
    assert not r0["metrics"]["nonfinite"]
    for name in r0["params"]:
        assert np.array_equal(r0["grads"][name], r1["grads"][name]), name
        assert np.array_equal(r0["params"][name], r1["params"][name]), name

    opt = default_optimizer(tcfg)
    state = create_train_state(tmodel, opt, seed=0)
    state, m = make_train_step(tmodel, opt, tcfg)(state, tbatch)
    for key in ("loss", "sparsity", "total", "grad_norm"):
        assert abs(float(r0["metrics"][key]) / float(m[key]) - 1) <= 1e-6, key
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(r0["grads"][name], p.grad.numpy(), atol=2e-6, rtol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(r0["params"][name], p.detach().numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)

    jstate, j_metrics, j_grads = jax_train_step(jcfg, jmodel, params, jbatch)
    for key in ("loss", "sparsity", "total"):
        assert abs(float(r0["metrics"][key]) - float(j_metrics[key])) <= 1e-5, key
    g_want = convert_params(jax.device_get(j_grads), tmodel)
    p_want = convert_params(jax.device_get(jstate.params), tmodel)
    for name in r0["params"]:
        np.testing.assert_allclose(r0["grads"][name], g_want[name].numpy(), atol=GRAD_TOL,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(r0["params"][name], p_want[name].numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("mode", ["counter", "shared"])
def test_dp_step_with_dropout_equals_one_process(mode, tmp_path):
    """The configuration's own dropout: model dropout 0.2 (the cluster
    projection's 0.2 too), attention dropout 0.2, remat on; the seeds and
    the noise are the port's own draws on both sides."""
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step
    from csat_tpu_torch.train.state import make_model

    jcfg, tcfg = configs("python_long", max_src_len=64, bucket_src_lens=(), sbm_layers=2,
                         clusters=(4, 3), noise_mode=mode,
                         seq_impl="ring" if mode == "counter" else "allgather")
    assert tcfg.dropout > 0 and tcfg.attention_dropout > 0 and tcfg.remat
    _, tbatch = step_batch(jcfg, tcfg, n_real=(60, 20, 64, 33))
    model = make_model(tcfg, torch_dist.SRC_V, torch_dist.TGT_V, torch_dist.TRIP_V,
                       device="cpu", seed=3)
    payload = dict(cfg=tcfg, state_dict={k: v.clone() for k, v in model.state_dict().items()},
                   batch=tbatch, seeds=None)
    r0, r1 = torch_dist.run_ranks(torch_dist.dp_step, 2, tmp_path, payload)
    for name in r0["params"]:
        assert np.array_equal(r0["params"][name], r1["params"][name]), name

    opt = default_optimizer(tcfg)
    state = create_train_state(model, opt, seed=0)
    state, m = make_train_step(model, opt, tcfg)(state, tbatch)
    for key in ("loss", "sparsity", "total", "grad_norm"):
        assert abs(float(r0["metrics"][key]) / float(m[key]) - 1) <= 1e-6, key
    for name, p in model.named_parameters():
        np.testing.assert_allclose(r0["grads"][name], p.grad.numpy(), atol=2e-6, rtol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(r0["params"][name], p.detach().numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["counter", "shared"])
def test_ranks_draw_the_same_seeds(mode, tmp_path):
    """Rank 0 holds 3 rows, rank 1 two; model dropout 0.2 draws each rank's
    masks as its slice of the global draw, so the hash seeds drawn between
    the masks are the same on both, draw for draw."""
    jcfg, tcfg = configs("python_long", max_src_len=64, bucket_src_lens=(), sbm_layers=2,
                         clusters=(4, 3), dropout=0.2, noise_mode=mode,
                         seq_impl="ring" if mode == "counter" else "allgather")
    _, tbatch = step_batch(jcfg, tcfg, n_real=(60, 20, 64, 33, 45))
    ranks = torch_dist.run_ranks(torch_dist.seeds_drawn, 2, tmp_path,
                                 dict(cfg=tcfg, batch=tbatch, rows=(3, 2)))
    seen = ranks[0]["gathered"]
    assert seen[0] == seen[1] == ranks[1]["seen"]
    per_layer = 2 if mode == "counter" else 1  # the sample seed, the dropout seed
    assert len(seen[0]) == 2 * per_layer * tcfg.sbm_layers  # two forwards
    assert len({v for _, v in seen[0]}) == len(seen[0])


def test_coordinated_trigger_and_abort_barrier(tmp_path):
    ranks = torch_dist.run_ranks(torch_dist.consensus, 2, tmp_path)
    assert [r["before"] for r in ranks] == [False, False]
    assert [r["after"] for r in ranks] == [True, True]
    assert [r["latched"] for r in ranks] == [True, True]
    assert [r["barrier"] for r in ranks] == ["barrier", "barrier"]


FIT = dict(pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=2, num_layers=1,
           sbm_layers=2, clusters=(4, 3), dim_feed_forward=64, decoder_layers=2,
           max_src_len=48, max_tgt_len=10, batch_size=4, attention_dropout=0.2,
           tree_pos_width=4, tree_pos_height=8, val_interval=1, save_interval=1,
           guard_check_every=1, num_epochs=2, prefetch=0, mesh_shape=(("data", -1),))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from csat_tpu_torch.data.synthetic import make_corpus

    return make_corpus(str(tmp_path_factory.mktemp("dp_corpus")), n_train=40, n_dev=8,
                       n_test=8, seed=1, max_ast_len=48)


def test_dp_fit_rank0_writes_and_sigterm_resumes(corpus, tmp_path):
    from csat_tpu_torch.configs import get_config

    def cfg(out):
        return get_config("python_long", data_dir=corpus, output_dir=str(tmp_path / out), **FIT)

    full = torch_dist.run_ranks(torch_dist.dp_fit, 2, tmp_path / "full",
                                dict(cfg=cfg("full")))
    assert full[0]["calls"] == [1, 2] and full[1]["calls"] == []
    assert full[0]["plan"].endswith("@hosts=2")
    assert full[0]["steps"] == full[1]["steps"] and len(full[0]["steps"]) == 2 * 5
    assert full[0]["val_bleu"] == full[1]["val_bleu"]
    for name in full[0]["params"]:
        assert np.array_equal(full[0]["params"][name], full[1]["params"][name]), name

    # SIGTERM to rank 1 before its 8th step (epoch 2, iteration 2): both stop there
    stopped = torch_dist.run_ranks(torch_dist.dp_fit, 2, tmp_path / "stop",
                                   dict(cfg=cfg("stop"), sigterm_at=7))
    assert [r["stopped"] for r in stopped] == [(2, 3), (2, 3)]
    assert stopped[0]["calls"] == [1] and stopped[1]["calls"] == []
    resumed = torch_dist.run_ranks(torch_dist.dp_fit, 2, tmp_path / "resume",
                                   dict(cfg=cfg("stop"), resume=True))
    assert resumed[0]["steps"] == resumed[1]["steps"] == full[0]["steps"][-2:]
    for name in full[0]["params"]:
        assert np.array_equal(resumed[0]["params"][name], full[0]["params"][name]), name


def test_build_mesh_fills_and_refuses_without_a_group():
    from csat_tpu_torch.parallel.mesh import build_mesh, mesh_descriptor

    mesh = build_mesh((("data", -1),))
    assert mesh.shape == {"data": 1} and mesh.rows(8) == (0, 8) and mesh.group is None
    assert build_mesh((("data", 1), ("model", 1))).data == 1
    with pytest.raises(ValueError, match="needs 2 processes"):
        build_mesh((("data", 2),))
    assert mesh_descriptor(None).startswith("solo/")
    assert mesh_descriptor(mesh).startswith("mesh[data=1]/")


@pytest.mark.parametrize("axis", [("model", 2), ("model", -1)])
def test_unported_axes_are_refused(axis):
    """A ``model`` axis runs now (tests/test_torch_tensor.py); what JAX
    refuses around it is refused: a ``model`` axis under a pipeline
    (``("model", 2)``: with ``python_pp``'s pipe axis), and a head count the
    axis does not divide (``("model", -1)`` stands for the filled axis of
    three processes: 8 heads over 3)."""
    from csat_tpu_torch.configs import get_config

    if axis[1] == 2:
        with pytest.raises(ValueError, match="composes with the 'data' mesh axis only"):
            get_config("python_pp", mesh_shape=(("data", 1), ("pipe", 2), axis))
    else:
        with pytest.raises(ValueError, match="num_heads=8 must divide evenly"):
            get_config("python", mesh_shape=(("data", 1), ("model", 3)))
        # the filled axis is checked where its size is known: at the mesh
        assert get_config("python", mesh_shape=(("data", 1), axis)).mesh_shape[1] == axis


def test_python_pp_is_refused():
    """``python_pp`` is no longer refused: the registry builds it with the
    JAX entry's pipeline fields.  A ``model`` axis given with ``--set`` is
    accepted by both command lines' config (the train CLI then asks for
    the processes the mesh needs), and an unknown config name is refused."""
    from csat_tpu_torch.cli import main
    from csat_tpu_torch.configs import cli_config, get_config

    cfg = get_config("python_pp")
    assert (cfg.mesh_shape, cfg.pipeline_stages, cfg.pipeline_microbatches) == (
        (("data", -1), ("pipe", 2)), 2, 4)
    model_axis = (("data", 1), ("model", 2))
    for name in ("python_long", "python"):
        assert dict(cli_config(name, {"mesh_shape": model_axis}).mesh_shape)["model"] == 2
        with pytest.raises(ValueError, match="needs 2 processes"):
            main(["--config", name, "--device", "cpu", "--data_dir", "/nonexistent",
                  "--set", f"mesh_shape={model_axis!r}"])
    with pytest.raises(SystemExit, match="unknown config"):
        main(["summarize", "--config", "no_such", "--device", "cpu"])


def test_dryrun_two_ranks():
    from csat_tpu_torch.parallel.dryrun import dryrun_train_step

    loss, info = dryrun_train_step(2, timeout_s=240)
    assert np.isfinite(loss) and info["mesh"] == {"data": 2}
    assert info["decoded"] == [2, 11]


def test_cli_under_torchrun(corpus, tmp_path):
    """``torchrun --standalone`` (a free local port) with two CPU processes:
    each joins the gloo group from torchrun's environment and trains on its
    shard; rank 0 alone prints the final scores line and writes the
    checkpoints."""
    import json
    import os
    import subprocess
    import sys

    out = tmp_path / "out"
    sets = [f"{k}={v!r}" for k, v in FIT.items() if k not in ("num_epochs", "batch_size")]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "csat_tpu_torch.cli", "--config", "python_long", "--data_dir", corpus,
           "--device", "cpu", "--epochs", "1", "--batch_size", "4",
           *[a for s in sets for a in ("--set", s)], "--set", f"output_dir={str(out)!r}"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    finals = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    assert len(finals) == 1 and "val_best_bleu" in finals[0], res.stdout[-2000:]
    assert res.stdout.count("epoch 1:") == 1  # rank 0's log line only
    ckpts = os.path.join(out, "final_exp", "long_ast_512", "checkpoints")
    assert os.listdir(ckpts) == ["state_1.pt"]
