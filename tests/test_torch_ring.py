"""The port's ring attention over a ``seq`` axis (``csat_tpu_torch/parallel/ring.py``)
on the CPU, against the port's one-process counter path and JAX's ring.

Ranks run as spawned processes in one gloo group (``tests/torch_dist.py``);
each holds its data shard's rows and its N/P node rows.  The counterparts of
``tests/test_ring.py:34-226``:

* the ring at ``seq`` 2 and at ``data`` 2 × ``seq`` 2, with and without
  attention dropout, against the port's one-process sampled mod (the plain
  flex path): ΣA exactly equal, the output within 2e-5, every input gradient
  (q, k, v, Q̂, K̂, S) within 1e-4 relative (of the largest entry);
* the same inputs through JAX's ``ring_sbm_attention`` on a CPU mesh of the
  same shape (the conftest's 8 devices): the same limits;
* the dense ring (full attention) against masked softmax and JAX's dense
  ring; an N the seq axis does not divide is refused;
* a tiny python_long train step (model and attention dropout 0.2, remat on)
  at ``seq`` 2 and ``data`` 2 × ``seq`` 2 equal to one process: loss and
  sparsity within 1e-6, grad-norm within 1e-5 relative, every parameter's
  gradient within 1e-4 (of the larger of its own and 1 % of the largest
  gradient), the gradients the same bits on every rank; greedy decode
  tokens equal to the unsharded decode;
* the dry run over 4 gloo ranks at ``seq`` 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPES = {"seq2": ((("data", 1), ("seq", 2)), 2), "data2xseq2": ((("data", 2), ("seq", 2)), 4)}
B, H, N, DH, KK = 4, 2, 48, 8, 3
SEED, DSEED, FLOOR, GS_COEF = 1234, 777, 0.01, 1e-3
CASES = ((0.0, False), (0.2, False), (0.0, True))  # (attention dropout, full attention)
INPUTS = torch_dist.ring_inputs(B, H, N, DH, KK)


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """Every rank's results per mesh shape, computed once."""
    runs = {}

    def get(shape):
        if shape not in runs:
            mesh_shape, world = SHAPES[shape]
            runs[shape] = torch_dist.run_ranks(
                torch_dist.ring_rank, world, tmp_path_factory.mktemp(shape),
                dict(mesh_shape=mesh_shape, inputs=INPUTS, cases=CASES, seed=SEED, dseed=DSEED,
                     floor=FLOOR, gs_coef=GS_COEF), timeout=120)
        return runs[shape]
    return get


def _assemble(ranks, case):
    """The ranks' blocks of one case put back together: output, ΣA, and
    each input's gradient (S summed over every rank)."""
    out = np.zeros((B, H, N, DH), np.float32)
    gs = np.zeros((B, H), np.float32)
    grads = {n: np.zeros_like(INPUTS[n]) for n in torch_dist.RING_NAMES}
    for r in ranks:
        r0, b, n0, nl = r["where"]
        c = r["cases"][case]
        out[r0:r0 + b, :, n0:n0 + nl] = c["out"]
        gs[r0:r0 + b] = c["gs"]
        for name, g in c["grads"].items():
            if g is None:
                continue
            if name == "s_aff":
                grads[name] += g
            else:
                grads[name][r0:r0 + b, :, n0:n0 + nl] = g
    return out, gs, grads


def _one_process(rate):
    """The port's one-process counter path on the whole batch: (out, ΣA,
    gradients of Σ out·go + gs_coef·ΣA)."""
    from csat_tpu_torch.ops.flex_core import flex_attention
    from csat_tpu_torch.ops.mods import sbm_sampled_mod

    t = {n: torch.tensor(INPUTS[n]).requires_grad_() for n in torch_dist.RING_NAMES}
    spec, aux = sbm_sampled_mod(t["q_hat"], t["k_hat"], t["s_aff"], torch.tensor(INPUTS["pad"]),
                                torch.tensor([SEED], dtype=torch.int32), FLOOR)
    out, extras = flex_attention(t["q"], t["k"], t["v"], spec, aux, rate,
                                 torch.tensor([DSEED], dtype=torch.int32))
    (torch.sum(out * torch.tensor(INPUTS["go"])) + GS_COEF * torch.sum(extras["graph_sum"])
     ).backward()
    return (out.detach().numpy(), extras["graph_sum"].detach().numpy(),
            {n: v.grad.numpy() for n, v in t.items()})


def _jax_ring(shape, rate):
    """JAX's ring on a CPU mesh of ``shape``: (out, ΣA, gradients)."""
    from csat_tpu.parallel import build_mesh
    from csat_tpu.parallel.ring import ring_sbm_attention
    from csat_tpu.utils.compat import use_mesh

    args = [jnp.asarray(INPUTS[n]) for n in torch_dist.RING_NAMES]
    pad, go = jnp.asarray(INPUTS["pad"]), jnp.asarray(INPUTS["go"])

    def run(*a):
        return ring_sbm_attention(*a, pad, jnp.int32(SEED), rate, jnp.int32(DSEED), FLOOR)

    def loss(*a):
        out, gs = run(*a)
        return jnp.sum(out * go) + GS_COEF * jnp.sum(gs)

    with use_mesh(build_mesh(SHAPES[shape][0])):
        out, gs = jax.jit(run)(*args)
        grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*args)
    return (np.asarray(out), np.asarray(gs),
            {n: np.asarray(g) for n, g in zip(torch_dist.RING_NAMES, grads)})


def _check(out, gs, grads, ref_out, ref_gs, ref_grads, what):
    np.testing.assert_array_equal(gs, ref_gs, err_msg=f"{what}: ΣA")
    np.testing.assert_allclose(out, ref_out, atol=2e-5, rtol=0, err_msg=f"{what}: out")
    for name in torch_dist.RING_NAMES:
        rel = np.max(np.abs(grads[name] - ref_grads[name])) / np.max(np.abs(ref_grads[name]))
        assert rel <= 1e-4, (what, name, rel)


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["sampled", "dropout"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ring_equals_one_process(ring_runs, shape, rate):
    out, gs, grads = _assemble(ring_runs(shape), CASES.index((rate, False)))
    _check(out, gs, grads, *_one_process(rate), f"{shape} rate {rate} vs one process")


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["sampled", "dropout"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ring_equals_jax_ring(ring_runs, shape, rate):
    out, gs, grads = _assemble(ring_runs(shape), CASES.index((rate, False)))
    _check(out, gs, grads, *_jax_ring(shape, rate), f"{shape} rate {rate} vs JAX's ring")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_ring_full_attention_equals_dense(ring_runs, shape):
    """The dense ring against masked softmax attention (the port's
    ``FullAttention`` without dropout) and JAX's dense ring."""
    from csat_tpu.parallel import build_mesh
    from csat_tpu.parallel.ring import ring_full_attention
    from csat_tpu.utils.compat import use_mesh
    from csat_tpu_torch.models.sbm import FullAttention

    out, _, grads = _assemble(ring_runs(shape), CASES.index((0.0, True)))
    t = {n: torch.tensor(INPUTS[n]).requires_grad_() for n in ("q", "k", "v")}
    ref, _ = FullAttention(DH, 0.0)(t["q"], t["k"], t["v"], torch.tensor(INPUTS["pad"]) > 0.5)
    torch.sum(ref * torch.tensor(INPUTS["go"])).backward()
    np.testing.assert_allclose(out, ref.detach().numpy(), atol=2e-5, rtol=0)
    for name in ("q", "k", "v"):
        want = t[name].grad.numpy()
        rel = np.max(np.abs(grads[name] - want)) / np.max(np.abs(want))
        assert rel <= 1e-4, (name, rel)
    with use_mesh(build_mesh(SHAPES[shape][0])):
        jout = jax.jit(lambda q, k, v: ring_full_attention(q, k, v, jnp.asarray(INPUTS["pad"])))(
            *(jnp.asarray(INPUTS[n]) for n in ("q", "k", "v")))
    np.testing.assert_allclose(out, np.asarray(jout), atol=2e-5, rtol=0)


def test_ring_refuses_indivisible_n():
    from csat_tpu_torch.parallel.mesh import Axis
    from csat_tpu_torch.parallel.ring import node_block

    with pytest.raises(ValueError, match="divisible"):
        node_block(126, Axis("seq", 4, 1))
    assert node_block(128, Axis("seq", 4, 1)) == (32, 32)


# ---------------------------------------------------------------------------
# a python_long-shaped train step and decode under the seq axis
# ---------------------------------------------------------------------------

STEP = dict(pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=4,
            num_layers=1, sbm_layers=2, clusters=(4, 3), dim_feed_forward=64,
            decoder_layers=2, max_src_len=32, max_tgt_len=10, batch_size=4)


def _step_batch(cfg, rows=8, seed=0):
    from csat_tpu_torch.data.dataset import batch_to_device
    from csat_tpu_torch.parallel.dryrun import random_global_batch

    return batch_to_device(random_global_batch(cfg, rows, seed), torch.device("cpu"))


@pytest.fixture(scope="module")
def seq_steps(tmp_path_factory):
    from csat_tpu_torch.configs import get_config

    runs = {}

    def get(shape):
        if shape not in runs:
            mesh_shape, world = SHAPES[shape]
            cfg = get_config("python_long", **STEP, mesh_shape=mesh_shape)
            batch = _step_batch(cfg)
            one = torch_dist.mesh_step(0, 1, None, dict(
                cfg=cfg.replace(mesh_shape=(("data", 1),)), batch=batch))
            ranks = torch_dist.run_ranks(torch_dist.mesh_step, world,
                                         tmp_path_factory.mktemp(f"step_{shape}"),
                                         dict(cfg=cfg, batch=batch), timeout=180)
            runs[shape] = (cfg, one, ranks)
        return runs[shape]
    return get


@pytest.mark.parametrize("shape", list(SHAPES))
def test_seq_step_equals_one_process(seq_steps, shape):
    cfg, one, ranks = seq_steps(shape)
    assert cfg.dropout == 0.2 and cfg.attention_dropout == 0.2 and cfg.remat
    assert ranks[0]["mesh"] == dict(SHAPES[shape][0])
    m, ref = ranks[0]["metrics"], one["metrics"]
    for key in ("loss", "sparsity"):
        assert abs(float(m[key]) / float(ref[key]) - 1) <= 1e-6, (key, m[key], ref[key])
    assert abs(float(m["grad_norm"]) / float(ref["grad_norm"]) - 1) <= 1e-5
    assert not bool(m["nonfinite"])
    gmax = max(np.max(np.abs(g)) for g in one["grads"].values())
    for name, g in one["grads"].items():
        scale = max(np.max(np.abs(g)), 1e-2 * gmax)
        assert np.max(np.abs(ranks[0]["grads"][name] - g)) <= 1e-4 * scale, name
        for r in ranks[1:]:
            assert np.array_equal(r["grads"][name], ranks[0]["grads"][name]), name


@pytest.mark.parametrize("shape", list(SHAPES))
def test_seq_decode_equals_unsharded(seq_steps, shape):
    """Each rank decodes its data shard's rows through the ring-encoded,
    gathered memory: the tokens one process decodes for those rows."""
    cfg, _, ranks = seq_steps(shape)
    batch = _step_batch(cfg)
    for r in ranks:
        r0, b = r["rows"]
        want = torch_dist.decode_rows(cfg.replace(mesh_shape=(("data", 1),)),
                                      torch_dist.rows_of(batch, r0, r0 + b))
        np.testing.assert_array_equal(r["tokens"], want)


def test_dryrun_seq_axis():
    from csat_tpu_torch.parallel.dryrun import dryrun_train_step

    loss, info = dryrun_train_step(4, timeout_s=240, seq_par=2)
    assert np.isfinite(loss) and info["mesh"] == {"data": 2, "seq": 2}
    assert info["decoded"] == [2, 11]


def test_cli_trains_at_seq_2_under_torchrun(tmp_path):
    """``torchrun --standalone`` with two CPU processes and ``--set
    mesh_shape`` naming a seq axis of 2: both ranks hold every row, the ring
    takes the SBM stack, rank 0 alone prints the scores and checkpoints."""
    import json
    import os
    import subprocess
    import sys

    from csat_tpu_torch.data.synthetic import make_corpus

    corpus = make_corpus(str(tmp_path / "corpus"), n_train=16, n_dev=4, n_test=4, seed=3,
                         max_ast_len=32)
    out = tmp_path / "out"
    sets = [f"{k}={v!r}" for k, v in {**STEP, "max_src_len": 32, "val_interval": 1,
                                      "save_interval": 1, "prefetch": 0}.items()
            if k != "batch_size"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "csat_tpu_torch.cli", "--config", "python_long", "--data_dir", corpus,
           "--device", "cpu", "--epochs", "1", "--batch_size", "4",
           *[a for s in sets for a in ("--set", s)],
           "--set", "mesh_shape=(('data', -1), ('seq', 2))", "--set", f"output_dir={str(out)!r}"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    finals = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    assert len(finals) == 1 and "val_best_bleu" in finals[0], res.stdout[-2000:]
    assert res.stdout.count("epoch 1:") == 1
    ckpts = os.path.join(out, "final_exp", "long_ast_512", "checkpoints")
    assert os.listdir(ckpts) == ["state_1.pt"]
