"""The port's tensor parallelism (the ``model`` mesh axis) on the CPU.

Ranks run as spawned processes in one gloo group (``tests/torch_dist.py``),
each holding its shard of the parameters (``parallel.mesh.shard_model``).

* the port's ``PARAM_RULES`` are JAX's ``csat_tpu.parallel.mesh.PARAM_RULES``
  and every port parameter's spec is JAX's ``_spec_for`` of its flax path
  on a ``model`` 2 mesh;
* ``uniform_field`` at a head shard's ``(bh0, h_total)`` is the slice of the
  full field (``model`` 2, 4, 8);
* two ranks at ``("data", 1), ("model", 2)`` take one step equal to one
  process (loss 1e-5 relative, grad-norm 1e-4, every gathered gradient 2e-6
  + 1e-5 relative, parameters 1e-5 relative) and to JAX's one-device step
  from the same weights (model dropout 0, the seeds and noise handed over,
  the whole-step tolerances of tests/test_torch_train.py), in both noise
  modes; with the config's own dropout and the port's own draws, equal to
  one process too;
* four ranks at ``data 2 × model 2``, at ``model 2 × seq 2`` (the ring on
  a head shard) and at ``model 4`` (one head a member), each equal to one
  process;
* the CSE's kernel on a member's plane slice (the plain version, model 2,
  4, 8) equals the full launch's slice, and heads spanning both planes run
  one launch per plane;
* greedy decode under the ``model`` axis gives one process's tokens;
* a tensor-parallel state file holds whole arrays: it restores into one
  process with the same bits and back into the shards;
* the dry run (``python -m csat_tpu_torch.parallel.dryrun 2 --model 2``) and
  the command line under ``torchrun`` with a ``model`` axis;
* the refusals JAX makes: a ``model`` axis under a pipeline, a head count
  the axis does not divide.
"""

import jax
import numpy as np
import pytest

import torch_dist
import torch_tp
from torch_parity import SEEDS, configs, jax_train_step, step_batch, train_setup
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TP2 = (("data", 1), ("model", 2))
GRAD_TOL = 3e-5  # tests/test_torch_train.py's gradient tolerance against JAX


def _one_process(model, tcfg, tbatch, steps=1):
    from csat_tpu_torch.parallel.mesh import build_mesh
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step

    opt = default_optimizer(tcfg)
    state = create_train_state(model, opt, seed=0)
    step = make_train_step(model, opt, tcfg, build_mesh((("data", 1),)))
    losses = []
    for _ in range(steps):
        state, m = step(state, tbatch)
        losses.append(float(m["loss"]))
    return state, m, losses


def _equal_to_one_process(r0, model, m):
    """The whole-model check of a rank's gathered results against one
    process's step."""
    for key in ("loss", "sparsity", "total"):
        assert abs(float(r0["metrics"][key]) / float(m[key]) - 1) <= 1e-5, key
    assert abs(float(r0["metrics"]["grad_norm"]) / float(m["grad_norm"]) - 1) <= 1e-4
    assert not r0["metrics"]["nonfinite"]
    for name, p in model.named_parameters():
        np.testing.assert_allclose(r0["grads"][name], p.grad.numpy(), atol=2e-6, rtol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(r0["params"][name], p.detach().numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=name)


def _same_on_every_rank(ranks):
    r0 = ranks[0]
    for r in ranks[1:]:
        for key in r0["metrics"]:
            assert np.array_equal(r0["metrics"][key], r["metrics"][key]), key
        for name in r0["params"]:
            assert np.array_equal(r0["params"][name], r["params"][name]), name


@pytest.mark.parametrize("name", ["python", "java", "python_full_att", "python_triplet",
                                  "python_treepos", "python_seq"])
def test_param_specs_are_jax(name):
    from jax.sharding import Mesh

    from csat_tpu.parallel import mesh as jmesh
    from csat_tpu_torch.convert import flax_path
    from csat_tpu_torch.models import CSATrans
    from csat_tpu_torch.parallel import mesh as tmesh

    assert [(r, tuple(s)) for r, s in jmesh.PARAM_RULES] == list(tmesh.PARAM_RULES)
    over = {"python_treepos": dict(tree_pos_height=4),
            "python_seq": dict(pe_dim=0, pegen_dim=0)}.get(name, {})
    _, tcfg = configs(name, **over)
    model = CSATrans(tcfg, 200, 300, device="cpu", triplet_vocab_size=50)
    devices = np.asarray(jax.devices()[:2]).reshape(1, 2)
    mesh = Mesh(devices, ("data", "model"))
    sharded = 0
    for pname, _ in model.named_parameters():
        path = flax_path(pname)
        assert tmesh.spec_for(path, 2) == tuple(jmesh._spec_for(path, mesh)), pname
        assert tmesh.spec_for(path, 1) == ()
        sharded += tmesh.param_dim(pname, 2) is not None
    assert sharded > 0


@pytest.mark.parametrize("model_par", [2, 4, 8])
def test_uniform_field_is_the_head_slice(model_par):
    import torch

    from csat_tpu_torch.ops.hashrng import noise_stride, uniform_field

    b, h, n, b0, rows = 3, 8, 37, 2, 7
    seed = torch.tensor([1234567], dtype=torch.int32)
    full = uniform_field(seed, rows, h, n, n, noise_stride(n))
    per = h // model_par
    for r in range(model_par):
        got = uniform_field(seed, b, per, n, n, noise_stride(n), bh0=b0 * h + r * per,
                            h_total=h)
        assert torch.equal(got, full[b0:b0 + b, r * per:(r + 1) * per])
    # one shard: today's index
    assert torch.equal(uniform_field(seed, b, h, n, n, noise_stride(n), bh0=b0 * h, h_total=h),
                       uniform_field(seed, b, h, n, n, noise_stride(n), bh0=b0 * h))


@pytest.mark.parametrize("mode", ["counter", "shared"])
def test_tp_step_equals_one_process_and_jax(mode, monkeypatch, tmp_path):
    from csat_tpu_torch.convert import convert_params

    (jcfg, tcfg, jmodel, params, tmodel, _, _, _, _) = train_setup(
        mode, monkeypatch, mesh_shape=TP2)
    jbatch, tbatch = step_batch(jcfg, tcfg)
    payload = dict(cfg=tcfg, state_dict={k: v.clone() for k, v in tmodel.state_dict().items()},
                   batch=tbatch, seeds=SEEDS)
    if mode == "shared":  # train_setup's per-layer noise, handed to the ranks too
        b, n = jbatch.src_seq.shape
        payload["noise"] = [np.random.default_rng(60 + i).random(
            (b, jcfg.num_heads, n, n)).astype(np.float32) for i in range(jcfg.sbm_layers)]
    ranks = torch_dist.run_ranks(torch_tp.tp_step, 2, tmp_path, payload)
    assert [r["mesh"] for r in ranks] == [dict(TP2)] * 2
    # rank 1 holds the second half of every split parameter
    assert ranks[1]["local"]["decoder.layers.0.self_attn.q.weight"] == (16, 32)
    assert ranks[1]["local"]["generator.fc1.weight"] == (300, 16)
    _same_on_every_rank(ranks)

    _, m, _ = _one_process(tmodel, tcfg, tbatch)
    _equal_to_one_process(ranks[0], tmodel, m)

    jstate, j_metrics, j_grads = jax_train_step(jcfg, jmodel, params, jbatch)
    r0 = ranks[0]
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
def test_tp_step_with_dropout_equals_one_process(mode, tmp_path):
    """The configuration's own dropout (0.2, the cluster projection's 0.2,
    attention 0.2) and the port's own draws on both sides: each rank's
    masks of its heads and hidden units are its slices of the whole draw."""
    from csat_tpu_torch.train.state import make_model

    jcfg, tcfg = configs("python", max_src_len=48, bucket_src_lens=(), sbm_layers=2,
                         clusters=(4, 3), noise_mode=mode, mesh_shape=TP2)
    assert tcfg.dropout > 0 and tcfg.attention_dropout > 0
    _, tbatch = step_batch(jcfg, tcfg, n_real=(40, 20, 48, 33))
    model = make_model(tcfg, torch_dist.SRC_V, torch_dist.TGT_V, torch_dist.TRIP_V,
                       device="cpu", seed=3)
    payload = dict(cfg=tcfg, state_dict={k: v.clone() for k, v in model.state_dict().items()},
                   batch=tbatch, seeds=None, steps=3)
    ranks = torch_dist.run_ranks(torch_tp.tp_step, 2, tmp_path, payload)
    _same_on_every_rank(ranks)
    _, m, _ = _one_process(model, tcfg, tbatch)
    _equal_to_one_process(ranks[0], model, m)
    # three steps: every rank's generator and parameters went on alike
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert np.all(np.isfinite(ranks[0]["losses"]))


@pytest.mark.parametrize("mesh", [(("data", 2), ("model", 2)),
                                  (("data", 1), ("model", 2), ("seq", 2)),
                                  (("data", 1), ("model", 4))],
                         ids=["data2_model2", "model2_seq2_ring", "model4"])
def test_four_ranks_equal_one_process(mesh, tmp_path):
    from csat_tpu_torch.train.state import make_model

    over = dict(max_src_len=48, bucket_src_lens=(), sbm_layers=2, clusters=(4, 3),
                mesh_shape=mesh, batch_size=4, eval_graph="sample")
    name = "python_long" if dict(mesh).get("seq", 1) > 1 else "python"
    jcfg, tcfg = configs(name, **over)
    _, tbatch = step_batch(jcfg, tcfg, n_real=(40, 20, 48, 33))
    model = make_model(tcfg, torch_dist.SRC_V, torch_dist.TGT_V, torch_dist.TRIP_V,
                       device="cpu", seed=5)
    payload = dict(cfg=tcfg, state_dict={k: v.clone() for k, v in model.state_dict().items()},
                   batch=tbatch, seeds=None)
    ranks = torch_dist.run_ranks(torch_tp.tp_step, 4, tmp_path, payload, timeout=400)
    assert ranks[0]["mesh"] == dict(mesh)
    _same_on_every_rank(ranks)
    _, m, _ = _one_process(model, tcfg, tbatch)
    _equal_to_one_process(ranks[0], model, m)


@pytest.mark.parametrize("model_par", [2, 4, 8])
def test_cse_on_a_planes_slice_is_the_full_slice(model_par):
    """K1's plain version on each member's heads — the plane they lie in,
    ``rel`` / ``mask`` that plane's slice, ``group`` the member's heads —
    against the head slice of the full 8-head launch (model 2, 4, 8)."""
    import torch

    from csat_tpu_torch.ops.flex_core import flex_reference
    from csat_tpu_torch.ops.mods import cse_mod

    g = torch.Generator().manual_seed(model_par)
    b, h, n, dh, r_len = 3, 8, 21, 8, 21
    q, k, v = (torch.randn(b, h, n, dh, generator=g) for _ in range(3))
    rel = torch.randint(0, r_len, (b, 2, n, n), generator=g)
    mask = torch.rand((b, 2, n, n), generator=g) < 0.3
    lq, lk = (torch.randn(h, r_len, dh, generator=g) for _ in range(2))
    full, _ = flex_reference(q, k, v, *cse_mod(lq, lk, rel, mask))
    per = h // model_par
    for m in range(model_par):
        h0 = m * per
        plane = h0 // (h // 2)
        spec, aux = cse_mod(lq[h0:h0 + per], lk[h0:h0 + per], rel[:, plane:plane + 1],
                            mask[:, plane:plane + 1])
        assert spec.planes == 1 and spec.group == per
        part = lambda t: t[:, h0:h0 + per]
        out, _ = flex_reference(part(q), part(k), part(v), spec, aux)
        np.testing.assert_allclose(out.numpy(), full[:, h0:h0 + per].numpy(), atol=1e-6,
                                   rtol=0)


def test_cse_heads_across_planes_run_per_plane():
    """A member whose heads span the L and the T plane (6 heads over 3
    members: heads 2 and 3) runs one launch per plane."""
    from csat_tpu_torch.models.cse import DisentangledAttn

    _, tcfg = configs("python", num_heads=6, pegen_dim=18, sbm_enc_dim=36, hidden_size=36,
                      pe_dim=6, num_layers=1)
    attn = DisentangledAttn(tcfg)
    assert attn._plane_runs(2, 2) == [(0, 1), (1, 2)]
    assert attn._plane_runs(0, 3) == [(0, 3)] and attn._plane_runs(3, 3) == [(0, 3)]
    assert attn._plane_runs(0, 6) == [(0, 3), (3, 6)]


def test_three_ranks_with_heads_across_planes(tmp_path):
    """6 heads over ``("model", 3)``: the middle member's CSE heads (2, 3)
    span the L and the T plane and run one launch per plane; the step
    equals one process."""
    from csat_tpu_torch.train.state import make_model

    over = dict(max_src_len=48, bucket_src_lens=(), sbm_layers=2, clusters=(4, 3),
                num_heads=6, pe_dim=12, pegen_dim=24, sbm_enc_dim=24, hidden_size=24,
                dim_feed_forward=48, mesh_shape=(("data", 1), ("model", 3)))
    jcfg, tcfg = configs("python", **over)
    _, tbatch = step_batch(jcfg, tcfg, n_real=(40, 20, 48, 33))
    model = make_model(tcfg, torch_dist.SRC_V, torch_dist.TGT_V, torch_dist.TRIP_V,
                       device="cpu", seed=11)
    payload = dict(cfg=tcfg, state_dict={k: v.clone() for k, v in model.state_dict().items()},
                   batch=tbatch, seeds=None)
    ranks = torch_dist.run_ranks(torch_tp.tp_step, 3, tmp_path, payload)
    assert ranks[1]["local"]["pegen.layers.0.attn.wq.weight"] == (8, 24)
    _same_on_every_rank(ranks)
    _, m, _ = _one_process(model, tcfg, tbatch)
    _equal_to_one_process(ranks[0], model, m)


def test_tp_decode_tokens_equal_one_process(tmp_path):
    import torch

    from csat_tpu_torch.train.decode import greedy_decode
    from csat_tpu_torch.train.state import make_model

    jcfg, tcfg = configs("python", max_src_len=48, bucket_src_lens=(), sbm_layers=2,
                         clusters=(4, 3), mesh_shape=TP2, eval_graph="sample")
    _, tbatch = step_batch(jcfg, tcfg, n_real=(40, 20, 48, 33))
    model = make_model(tcfg, torch_dist.SRC_V, torch_dist.TGT_V, torch_dist.TRIP_V,
                       device="cpu", seed=7)
    payload = dict(cfg=tcfg, state_dict={k: v.clone() for k, v in model.state_dict().items()},
                   batch=tbatch, seeds=None, decode=True)
    ranks = torch_dist.run_ranks(torch_tp.tp_step, 2, tmp_path, payload)
    assert np.array_equal(ranks[0]["tokens"], ranks[1]["tokens"])
    state, _, _ = _one_process(model, tcfg, tbatch)
    want = greedy_decode(model, tbatch, torch.Generator().manual_seed(5)).numpy()
    assert np.array_equal(ranks[0]["tokens"], want)


def test_tp_checkpoint_restores_into_one_process(tmp_path):
    import torch

    from csat_tpu_torch.parallel.mesh import build_mesh
    from csat_tpu_torch.train import create_train_state, default_optimizer
    from csat_tpu_torch.train.checkpoint import restore_state
    from csat_tpu_torch.train.state import make_model

    jcfg, tcfg = configs("python", max_src_len=48, bucket_src_lens=(), sbm_layers=2,
                         clusters=(4, 3), mesh_shape=TP2)
    _, tbatch = step_batch(jcfg, tcfg, n_real=(40, 20, 48, 33))
    model = make_model(tcfg, torch_dist.SRC_V, torch_dist.TGT_V, torch_dist.TRIP_V,
                       device="cpu", seed=9)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    ck = str(tmp_path / "ck")
    ranks = torch_dist.run_ranks(torch_tp.tp_step, 2, tmp_path,
                                 dict(cfg=tcfg, state_dict=sd, batch=tbatch, seeds=None,
                                      checkpoint=ck))
    blob = torch.load(f"{ck}/state_1.pt", weights_only=True)
    for name, p in model.named_parameters():  # whole arrays, one process's shapes
        assert tuple(blob["params"][name].shape) == tuple(p.shape), name
        assert np.array_equal(blob["params"][name].numpy(), ranks[0]["params"][name]), name
    # into one process: the same bits
    opt = default_optimizer(tcfg)
    solo = restore_state(ck, create_train_state(model, opt, seed=0), 1, build_mesh(
        (("data", 1),)))
    for name, p in solo.params.items():
        assert np.array_equal(p.detach().numpy(), ranks[0]["params"][name]), name
    assert solo.step == 1
    assert np.array_equal(solo.generator.get_state().numpy(), ranks[0]["gen_state"])
    # and back into the shards
    back = torch_dist.run_ranks(torch_tp.tp_restore, 2, tmp_path / "back",
                                dict(cfg=tcfg, state_dict=sd, checkpoint=ck))
    for key in ("params", "mu", "nu"):
        for name, t in back[0][key].items():
            assert np.array_equal(t, blob[key][name].numpy()), (key, name)
    assert back[0]["step"] == back[1]["step"] == 1


def test_dryrun_model_axis():
    from csat_tpu_torch.parallel.dryrun import dryrun_train_step, tiny_multichip_config

    loss, info = dryrun_train_step(2, timeout_s=240, model_par=2)
    assert np.isfinite(loss) and info["mesh"] == {"data": 1, "model": 2}
    assert info["decoded"] == [2, 11]
    cfg = tiny_multichip_config(4, 1, 2, 2)
    assert cfg.mesh_shape == (("data", 1), ("model", 2), ("seq", 2))
    assert cfg.max_src_len == 64 and cfg.batch_size == 2


def test_cli_under_torchrun_with_a_model_axis(tmp_path):
    """``torchrun --standalone`` with two CPU processes on one ``model``
    axis: rank 0 alone prints the scores (with a one-process model of the
    whole parameters) and writes whole-array checkpoints."""
    import json
    import os
    import subprocess
    import sys

    import torch

    from csat_tpu_torch.data.synthetic import make_corpus

    corpus = make_corpus(str(tmp_path / "c"), n_train=24, n_dev=8, n_test=8, seed=1,
                         max_ast_len=48)
    out = tmp_path / "out"
    fit = dict(pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=4,
               num_layers=1, sbm_layers=2, clusters=(4, 3), dim_feed_forward=64,
               decoder_layers=2, max_src_len=48, max_tgt_len=10, tree_pos_width=4,
               tree_pos_height=8, val_interval=1, save_interval=1, prefetch=0,
               mesh_shape=(("data", -1), ("model", 2)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "csat_tpu_torch.cli", "--config", "python", "--data_dir", corpus,
           "--device", "cpu", "--epochs", "1", "--batch_size", "4",
           *[a for k, v in fit.items() for a in ("--set", f"{k}={v!r}")],
           "--set", f"output_dir={str(out)!r}"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    finals = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    assert len(finals) == 1 and "val_best_bleu" in finals[0], res.stdout[-2000:]
    ckpts = os.path.join(out, "final_exp", "256_512_512_4_4_10_10_10_10_b64_tgt50_vanilla",
                         "checkpoints")
    blob = torch.load(os.path.join(ckpts, "state_1.pt"), weights_only=True)
    assert tuple(blob["params"]["decoder.layers.0.self_attn.q.weight"].shape) == (32, 32)
    assert tuple(blob["params"]["generator.fc1.weight"].shape)[1] == 32


def test_model_axis_refusals_are_jax():
    from csat_tpu.configs import get_config as jax_config
    from csat_tpu_torch.configs import get_config as torch_config

    pipe_model = (("data", 1), ("pipe", 2), ("model", 2))
    for get in (jax_config, torch_config):
        with pytest.raises(ValueError, match="composes with the 'data' mesh axis only"):
            get("python_pp", mesh_shape=pipe_model)
    with pytest.raises(ValueError, match="num_heads=8 must divide evenly"):
        torch_config("python", mesh_shape=(("data", 1), ("model", 3)))
    # every model axis that divides the heads is accepted, as by JAX
    for m in (1, 2, 4, 8):
        mesh = (("data", -1), ("model", m))
        assert jax_config("python", mesh_shape=mesh).mesh_shape == torch_config(
            "python", mesh_shape=mesh).mesh_shape
