"""The port's other encoders against the JAX package on the CPU: the PE
variants ``treepos``, ``triplet``, ``sequential`` and ``laplacian``, full
attention, and the RQ2 probe.

Both models carry the same (perturbed, converted) flax params at micro
widths in two width ratios — python's (pe : encoder : pegen = 1 : 2 : 2) and
java's (1 : 6 : 4, the encoder's heads 1.5× as wide as the CSE's):

* a deterministic forward: log-probs within 1e-4 (the tolerance of
  ``test_encode_memory_matches_jax``), sparsity within 1e-6 (exactly 1.0
  under full attention) and the post-expansion PE within 1e-5;
* one train step against JAX ``make_train_step`` (counter noise, attention
  dropout 0.2 from the shared hash stream for the SBM variants; model
  dropout 0, and full attention's dropout 0 too: flax draws both from
  ``jax.random``): loss within 1e-5, gradients within 3e-5 (the tolerance of
  ``test_torch_train.py``);
* ``laplacian_pe`` by invariants, not values, on real ASTs padded to N 37
  and 75: the same zero padding, orthonormal columns, ``‖Lv − λv‖ ≤ 1e-4``,
  eigenvalues within 1e-5 of JAX's, and the projector onto each eigenvalue
  cluster within 1e-4 of JAX's and of the float64 decomposition's
  (eigenvectors are a basis of each eigenspace, which neither package
  fixes).  A cluster gathers eigenvalues less than 1e-3 apart: an f32
  eigenvector is accurate to about eps / (distance to the next eigenvalue),
  6e-4 for eigenvalues 1e-4 apart, which these ASTs hold; the lap forward
  and train step with JAX's PE patched in for the port's;
* a converter round trip per variant, the triplet-table guard, the command
  line's fit for ``python_triplet`` (table sized by the dictionary on disk)
  and ``python_seq`` (bucketed) and the probe's command line on the saved
  model, and serving tokens equal to the JAX engine's for
  ``python_treepos``;
* the probe: ``tree_path`` and ``sample_pairs`` equal to JAX's, and
  ``run_probe`` from JAX's MLP draw gives JAX's accuracies, its final logits
  within 1e-4.

The JAX side runs ``backend="xla"`` (the plain evaluation of its flex mods,
as its own tests run it) except where the serving test names its backend.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    SRC_V, TRIP_V, configs, jax_model_and_params, jax_train_step, request_samples,
    step_batch, torch_model, train_setup)
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

# one intra-op thread: the suite's workers share the host's cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOGP_TOL = 1e-4
PE_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 3e-5

WIDTHS = {"python": dict(pe_dim=16, pegen_dim=32, sbm_enc_dim=32),
          "java": dict(pe_dim=8, pegen_dim=32, sbm_enc_dim=48)}
#: one SBM block and one decoder layer: each step compiles one JAX program
SHALLOW = dict(sbm_layers=1, clusters=(4,), decoder_layers=1)
VARIANTS = ("treepos", "triplet", "seq", "full_att", "lap")


def _variant(variant, width="python", **kw):
    """(registry name, overrides) of ``{width}_{variant}`` at micro widths."""
    over = dict(WIDTHS[width], **kw)
    if variant == "seq":
        over.update(pe_dim=0, pegen_dim=0)
    if variant == "full_att":
        over["attention_dropout"] = 0.0
    return f"{width}_{variant}", over


def _jax_lap_pe(monkeypatch):
    """Hand the port JAX's laplacian PE of the same inputs (the two
    packages' eigenvector bases differ inside repeated eigenvalues)."""
    from csat_tpu.models.pe import laplacian_pe as jlap
    from csat_tpu_torch.models import csa_trans

    def patched(adj, num_node, pegen_dim):
        pe = jlap(jnp.asarray(adj.numpy()), jnp.asarray(num_node.numpy()), pegen_dim)
        return torch.from_numpy(np.array(pe))

    monkeypatch.setattr(csa_trans, "laplacian_pe", patched)


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# forward and train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", ["python", "java"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax(variant, width, monkeypatch):
    if variant == "lap":
        _jax_lap_pe(monkeypatch)
    name, over = _variant(variant, width, **SHALLOW)
    jcfg, tcfg = configs(name, **over)
    jmodel, params = jax_model_and_params(jcfg)
    tmodel = torch_model(tcfg, params)
    jb, tb = step_batch(jcfg, tcfg, n_real=(40, 12, 48))
    j_lp, j_sp, j_pe, _, _ = jmodel.apply({"params": params}, jb)
    with torch.no_grad():
        t_lp, t_sp = tmodel(tb)
    _, t_sp2, t_pe = tmodel.encode_pe(tb)
    np.testing.assert_allclose(t_lp.numpy(), _np(j_lp), atol=LOGP_TOL, rtol=0)
    if variant == "full_att":
        assert float(t_sp) == float(j_sp) == 1.0
    else:
        assert abs(float(t_sp) - float(j_sp)) <= 1e-6
    assert float(t_sp2) == float(t_sp)
    if variant == "seq":
        assert t_pe is None and j_pe is None
    else:
        assert t_pe.shape == (3, jcfg.max_src_len, jcfg.pe_dim)
        np.testing.assert_allclose(t_pe.numpy(), _np(j_pe), atol=PE_TOL, rtol=0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_matches_jax(variant, monkeypatch):
    from csat_tpu_torch.convert import convert_params
    from csat_tpu_torch.train import create_train_state, default_optimizer, make_train_step

    name, over = _variant(variant, **SHALLOW)
    (jcfg, tcfg, jmodel, params, tmodel, jbatch, tbatch,
     _, tdraws) = train_setup("counter", monkeypatch, name, backend="xla", **over)
    if variant == "lap":
        _jax_lap_pe(monkeypatch)
    _, j_metrics, j_grads = jax_train_step(jcfg, jmodel, params, jbatch)
    opt = default_optimizer(tcfg)
    state = create_train_state(tmodel, opt, seed=0)
    state, metrics = make_train_step(tmodel, opt, tcfg)(state, tbatch)
    assert tdraws.calls == ({} if variant == "full_att" else {"sample": 1, "dropout": 1})
    assert not metrics["nonfinite"] and not bool(j_metrics["nonfinite"])
    for key in ("loss", "sparsity", "total"):
        assert abs(float(metrics[key]) - float(j_metrics[key])) <= LOSS_TOL, key
    g_want = convert_params(jax.device_get(j_grads), tmodel)
    for pname, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g_want[pname].numpy(), atol=GRAD_TOL,
                                   rtol=0, err_msg=pname)


# ---------------------------------------------------------------------------
# laplacian_pe by invariants
# ---------------------------------------------------------------------------

def _ast_adjacency(n_pad, sizes, seed):
    """(adj (B, N, N) uint8, num_node (B,)) of random ASTs through the
    port's collate (``|L| <= 1``)."""
    from csat_tpu_torch.configs import get_config
    from csat_tpu_torch.data.dataset import collate
    from csat_tpu_torch.data.synthetic import random_ast, request_sample

    cfg = get_config("python", max_src_len=n_pad)
    rng = np.random.default_rng(seed)
    samples = [request_sample(random_ast(rng, int(m)), cfg, 100) for m in sizes]
    arrs = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    arrs["tgt_seq"] = arrs["target"] = np.zeros((len(sizes), 1), np.int32)
    batch = collate(arrs, n_pad)
    return batch.adj, batch.num_node


def _clusters(lams, gap=1e-3):
    """Index groups of sorted eigenvalues no more than ``gap`` apart."""
    groups, start = [], 0
    for i in range(1, len(lams) + 1):
        if i == len(lams) or lams[i] - lams[i - 1] > gap:
            groups.append(range(start, i))
            start = i
    return groups


@pytest.mark.parametrize("n_pad", [37, 75])
def test_laplacian_pe_matches_jax_by_invariants(n_pad):
    from csat_tpu.models.pe import laplacian_pe as jlap
    from csat_tpu_torch.models.pe import laplacian_pe

    adj, num_node = _ast_adjacency(n_pad, (n_pad, n_pad - 6, n_pad // 2, 7), seed=n_pad)
    dim = n_pad + 3  # every eigenvector kept: clusters are whole
    t_pe = laplacian_pe(torch.from_numpy(adj), torch.from_numpy(num_node), dim).numpy()
    j_pe = np.asarray(jlap(jnp.asarray(adj), jnp.asarray(num_node), dim))
    assert t_pe.shape == j_pe.shape == (len(num_node), n_pad, dim)
    for i, n in enumerate(num_node):
        # zero padding: pad rows, pad-eigenvector columns and the columns
        # past N, exactly as JAX leaves them
        for pe in (t_pe[i], j_pe[i]):
            assert not pe[n:].any() and not pe[:, n:].any()
        a = adj[i, :n, :n].astype(np.float64)
        dinv = np.clip(a.sum(-1), 1.0, None) ** -0.5
        lap = np.eye(n) - dinv[:, None] * a * dinv[None, :]
        tv, jv = t_pe[i, :n, :n].astype(np.float64), j_pe[i, :n, :n].astype(np.float64)
        np.testing.assert_allclose(tv.T @ tv, np.eye(n), atol=1e-5)
        t_lam = np.einsum("ji,jk,ki->i", tv, lap, tv)
        j_lam = np.einsum("ji,jk,ki->i", jv, lap, jv)
        assert np.abs(lap @ tv - tv * t_lam).max() <= 1e-4
        np.testing.assert_allclose(t_lam, j_lam, atol=1e-5)
        assert np.all(np.diff(t_lam) >= -1e-5)  # ascending, as eigh returns them
        lam64, v64 = np.linalg.eigh(lap)
        for idx in _clusters(lam64):
            idx = list(idx)
            proj = tv[:, idx] @ tv[:, idx].T
            np.testing.assert_allclose(proj, jv[:, idx] @ jv[:, idx].T, atol=1e-4)
            np.testing.assert_allclose(proj, v64[:, idx] @ v64[:, idx].T, atol=1e-4)


def test_laplacian_pe_keeps_the_lowest_eigenvectors():
    """``pegen_dim`` below N keeps the first ``pegen_dim`` columns: the same
    eigenvalues as the full decomposition's first ones."""
    from csat_tpu_torch.models.pe import laplacian_pe

    adj, num_node = _ast_adjacency(37, (37, 30), seed=1)
    full = laplacian_pe(torch.from_numpy(adj), torch.from_numpy(num_node), 40).numpy()
    cut = laplacian_pe(torch.from_numpy(adj), torch.from_numpy(num_node), 16).numpy()
    assert cut.shape == (2, 37, 16)
    for i, n in enumerate(num_node):
        a = adj[i, :n, :n].astype(np.float64)
        dinv = np.clip(a.sum(-1), 1.0, None) ** -0.5
        lap = np.eye(n) - dinv[:, None] * a * dinv[None, :]
        lam = lambda v: np.einsum("ji,jk,ki->i", v, lap, v)
        np.testing.assert_allclose(lam(cut[i, :n].astype(np.float64)),
                                   lam(full[i, :n, :16].astype(np.float64)), atol=1e-5)


# ---------------------------------------------------------------------------
# converter, guard, command line, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_convert_round_trip(variant):
    from csat_tpu_torch.convert import convert_params, export_tree, flatten

    name, over = _variant(variant)
    jcfg, tcfg = configs(name, **over)
    _, params = jax_model_and_params(jcfg)
    model = torch_model(tcfg, params)
    sd = convert_params(params, model)
    leaves = flatten(params)
    assert len(sd) == len(leaves) == len(dict(model.named_parameters()))
    back = flatten(export_tree(dict(model.named_parameters()), params))
    assert set(back) == set(leaves)
    for path, arr in leaves.items():
        np.testing.assert_array_equal(back[path], arr, err_msg="/".join(path))
    if variant == "treepos":
        np.testing.assert_array_equal(sd["tree_pos_enc.p"].numpy(),
                                      params["tree_pos_enc"]["p"])
    if variant == "triplet":
        assert sd["triplet_emb.weight"].shape == (TRIP_V, jcfg.pegen_dim)
    has_cse = variant in ("full_att",)
    assert ("pegen" in params) == has_cse == hasattr(model, "pegen")


def test_triplet_fallback_rejects_oversized_dictionary(tmp_path):
    """The port's ``make_model`` refuses a triplet model sized by the
    fallback when the dictionary on disk is larger (an id past the table is a
    device-side assert on the card), and accepts explicit sizing."""
    from csat_tpu_torch.data.vocab import Vocab
    from csat_tpu_torch.models.pe import TRIPLET_VOCAB_FALLBACK
    from csat_tpu_torch.serve.ingest import PoisonRequestError, validate_sample
    from csat_tpu_torch.train.state import make_model

    _, tcfg = configs("python_triplet", **WIDTHS["python"], data_dir=str(tmp_path))
    big = Vocab(need_bos=False)
    fallback = TRIPLET_VOCAB_FALLBACK[tcfg.lang]
    for i in range(fallback + 10):
        big.add(f"(1, {i}, {i})")
    big.save(str(tmp_path / f"node_triplet_dictionary_{tcfg.lang}.pt"))
    with pytest.raises(ValueError, match="triplet dictionary"):
        make_model(tcfg, 97, 83, 0, device="cpu")
    model = make_model(tcfg, 97, 83, big.size(), device="cpu")
    assert model.triplet_emb.weight.shape[0] == big.size() == model.triplet_vocab_size
    # a request whose ids leave the table is refused at submit
    sample = request_samples(configs()[0], 1)[0]
    validate_sample(sample, tcfg, SRC_V, TRIP_V)
    with pytest.raises(PoisonRequestError, match="triplet"):
        validate_sample(dict(sample, triplet=sample["triplet"] + TRIP_V), tcfg, SRC_V, TRIP_V)


@pytest.fixture(scope="module")
def micro_corpus(tmp_path_factory):
    from csat_tpu_torch.data.synthetic import make_corpus

    data_dir = str(tmp_path_factory.mktemp("variants_corpus"))
    make_corpus(data_dir, n_train=48, n_dev=8, n_test=8, seed=3, max_ast_len=48)
    return data_dir


@pytest.mark.parametrize("variant", ["triplet", "seq"])
def test_cli_fits_a_variant_on_the_cpu(variant, micro_corpus, tmp_path, capsys):
    from csat_tpu_torch.cli import main
    from csat_tpu_torch.probe import main as probe_main
    from csat_tpu_torch.train.checkpoint import restore_params
    from csat_tpu_torch.train.state import triplet_dictionary

    name, over = _variant(variant)
    sets = dict(over, num_heads=4, hidden_size=32, dim_feed_forward=64, num_layers=1,
                sbm_layers=1, clusters=(4,), decoder_layers=1, max_src_len=48,
                max_tgt_len=10, batch_size=8, tree_pos_width=4, tree_pos_height=8,
                eval_graph="expected", val_interval=1, save_interval=1,
                output_dir=str(tmp_path))
    args = ["--config", name, "--data_dir", micro_corpus, "--epochs", "1", "--device", "cpu"]
    if variant == "seq":
        args.append("--bucketing")
    for field, value in sets.items():
        args += ["--set", f"{field}={value!r}"]
    main(args)
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("epoch 1: loss=") for line in lines)
    scores = json.loads(lines[-1])
    assert all(np.isfinite(v) for v in scores.values())
    (best,) = [p.parent for p in tmp_path.rglob("best_model.pt")]
    params = restore_params(str(best))
    if variant == "triplet":
        _, tcfg = configs(name, **{**over, "data_dir": micro_corpus})
        path, size = triplet_dictionary(tcfg)
        assert path is not None and params["triplet_emb.weight"].shape[0] == size
    else:
        assert not any(k.startswith(("pegen", "src_pe_embedding")) for k in params)
        assert "encoder.pe_expand.weight" not in params
    # the probe's command line on the saved model (sequential: its table)
    probe_args = ["--config", name, "--data_dir", micro_corpus, "--checkpoint", str(best),
                  "--hops", "3", "--epochs", "5", "--device", "cpu"]
    for field, value in sets.items():
        if field != "output_dir":
            probe_args += ["--set", f"{field}={value!r}"]
    report = probe_main(probe_args)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["probe"] == report["probe"]
    (res,) = report["probe"]
    assert res["hops"] == 3 and res["n_pairs"] >= 8
    assert 0.0 <= res["train_acc"] <= 1.0 and 0.0 <= res["test_acc"] <= 1.0


def test_port_engine_serves_treepos_tokens_as_jax():
    from csat_tpu.serve.engine import ServeEngine as JServeEngine
    from csat_tpu_torch.serve import ServeEngine

    budgets = [9, 3, 6, 9, 1]
    name, over = _variant("treepos")
    jcfg, tcfg = configs(name, **over)
    jmodel, params = jax_model_and_params(jcfg, seed=1)
    samples = request_samples(jcfg, len(budgets), seed=5, lo=2)

    def run(engine):
        ids = [engine.submit(s, b) for s, b in zip(samples, budgets)]
        engine.drain()
        assert engine.page_leaks() == 0
        return [engine.poll(i) for i in ids]

    jeng = JServeEngine(jmodel, params, jcfg.replace(serve_prefix_cache=0))
    try:
        j_res = run(jeng)
    finally:
        jeng.close()
    t_res = run(ServeEngine(torch_model(tcfg, params), tcfg, device="cpu"))
    for t, j in zip(t_res, j_res):
        assert t.ok and j.status == "OK"
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

def _probe_inputs(n_samples=12, seed=0):
    """Parents, node counts and node types of random ASTs, and a random
    (samples, N, 6) PE — the probe's inputs."""
    from csat_tpu_torch.data.ast_tools import ast_json_to_tree, tree_to_record, truncate_preorder
    from csat_tpu_torch.data.synthetic import random_ast

    rng = np.random.default_rng(seed)
    parents, n_nodes, types = [], [], []
    for _ in range(n_samples):
        rec = tree_to_record(truncate_preorder(
            ast_json_to_tree(random_ast(rng, int(rng.integers(12, 40)))), 48))
        parents.append(np.maximum(rec.parent_idx, 0))
        n_nodes.append(len(rec))
        types.append(rng.integers(0, 5, 48))
    pe = rng.standard_normal((n_samples, 48, 6)).astype(np.float32)
    return pe, parents, n_nodes, types


def test_tree_path_and_sample_pairs_match_jax():
    from csat_tpu import probe as jprobe
    from csat_tpu_torch import probe as tprobe

    _, parents, n_nodes, _ = _probe_inputs()
    for par, n in zip(parents, n_nodes):
        for a, b in ((0, n - 1), (n // 2, n - 1), (1, n // 3)):
            assert tprobe.tree_path(par, a, b) == jprobe.tree_path(par, a, b)
        for hops in (3, 5):
            assert (tprobe.sample_pairs(par, n, hops, np.random.default_rng(n))
                    == jprobe.sample_pairs(par, n, hops, np.random.default_rng(n)))


def test_run_probe_from_jax_draw_matches_jax(monkeypatch):
    """Both sides start from JAX's MLP draw: equal accuracies, and the final
    logits each side's accuracy reads within 1e-4."""
    from csat_tpu import probe as jprobe
    from csat_tpu_torch import probe as tprobe

    pe, parents, n_nodes, types = _probe_inputs()
    j_logits, t_logits = [], []
    j_apply = jprobe._MLP.apply

    def j_record(params, x):
        out = j_apply(params, x)
        if not isinstance(out, jax.core.Tracer):
            j_logits.append(np.asarray(out))
        return out

    monkeypatch.setattr(jprobe._MLP, "apply", staticmethod(j_record))
    t_forward = tprobe.ProbeMLP.forward

    def t_record(self, x):
        out = t_forward(self, x)
        if not torch.is_grad_enabled():
            t_logits.append(out.numpy())
        return out

    monkeypatch.setattr(tprobe.ProbeMLP, "forward", t_record)

    def jax_draw(in_dim, hidden, n_classes):
        return jax.tree.map(np.asarray,
                            jprobe._MLP(in_dim, hidden, n_classes, jax.random.key(0)).params)

    j_res = jprobe.run_probe(pe, parents, n_nodes, types, hops=3, epochs=30, seed=0)
    t_res = tprobe.run_probe(pe, parents, n_nodes, types, hops=3, epochs=30, seed=0,
                             init=jax_draw, device="cpu")
    assert j_res["n_pairs"] >= 8 and t_res == j_res
    assert len(t_logits) == len(j_logits) == 2  # the train and test accuracies
    for t, j in zip(t_logits, j_logits):
        np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)
