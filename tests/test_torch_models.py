"""The port's model modules against the JAX package, on converted weights.

Both models carry the same (perturbed) flax params at the micro
configuration and see the same numpy inputs, at ``deterministic=True``:

* the collate and the bucket ladder agree field for field;
* the CSE stack (both ``cse_empty_rows`` modes), the SBM encoder and the
  whole ``encode`` memory agree within 2e-5 absolute;
* ``decode_step`` through a paged pool agrees within 1e-4 on log-probs, and
  its ``k_step``/``v_step`` within 2e-5.

Tolerances: flax's LayerNorm takes the variance as E[x²] − E[x]² where
torch takes E[(x − E[x])²], and the two frameworks sum matmuls in other
orders; a few layers of each leave differences of a few 1e-6 on
activations, and the vocab-wide softmax/log of the generator amplifies
them on log-probs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    configs, jax_model_and_params, request_samples, torch_model)
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

# one intra-op thread: the suite's workers share the host's cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

ACT_TOL = 2e-5
LOGP_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs()
    jmodel, params = jax_model_and_params(jcfg)
    return jcfg, tcfg, jmodel, params, torch_model(tcfg, params)


def _batches(jcfg, tcfg, n_rows=3, seed=4):
    from csat_tpu.serve.prefill import collate_requests as jcollate
    from csat_tpu_torch.data.dataset import batch_to_device
    from csat_tpu_torch.serve.prefill import collate_requests as tcollate

    samples = request_samples(jcfg, n_rows, seed=seed)
    n = jcfg.max_src_len
    jb = jcollate(samples, n, n_rows, jcfg)
    tb = tcollate(samples, n, tcfg)
    return jb, batch_to_device(tb, torch.device("cpu")), tb


def _np(x):
    return np.asarray(x, np.float32)


def test_collate_and_ladder_match_jax(models):
    from csat_tpu.data.bucketing import src_bucket_ladder as jladder
    from csat_tpu_torch.data.bucketing import src_bucket_ladder as tladder

    jcfg, tcfg, _, _, _ = models
    jb, _, tb = _batches(jcfg, tcfg)
    for name in ("src_seq", "L", "T", "L_mask", "T_mask", "num_node", "adj",
                 "tree_pos", "triplet"):
        np.testing.assert_array_equal(getattr(tb, name), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert tladder(tcfg) == jladder(jcfg) == (24, 48)
    _, flag = configs(bucket_src_lens=(), max_src_len=150)
    assert tladder(flag) == (37, 75, 150)


def test_ast_matrices_match_jax():
    """The port's tree → pre-order → L/T builder equals the JAX package's
    on random ASTs, with and without truncation."""
    from csat_tpu.data import ast_tools as jast
    from csat_tpu_torch.data import ast_tools as tast
    from csat_tpu_torch.data.synthetic import random_ast

    rng = np.random.default_rng(0)
    for size, cap in ((12, 48), (70, 48), (150, 150)):
        tree = random_ast(rng, size)
        j_seq = jast.truncate_preorder(jast.ast_json_to_tree(tree), cap)
        t_seq = tast.truncate_preorder(tast.ast_json_to_tree(tree), cap)
        assert [n.label for n in t_seq] == [n.label for n in j_seq]
        for jm, tm in zip(jast.build_matrices(j_seq, cap), tast.build_matrices(t_seq, cap)):
            np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("empty_rows", ["uniform", "zero"])
def test_cse_stack_matches_jax(models, empty_rows):
    from csat_tpu_torch.models.cse import CSE

    jcfg, tcfg, jmodel, params, tmodel = models
    jcfg, tcfg = jcfg.replace(cse_empty_rows=empty_rows), tcfg.replace(cse_empty_rows=empty_rows)
    jb, tb, _ = _batches(jcfg, tcfg, seed=6)
    jmodel = jmodel.clone(cfg=jcfg)

    def run(m, b):
        pe = m.src_pe_embedding(b.src_seq)
        return m.pegen(pe, b.L.astype(jnp.int32), b.T.astype(jnp.int32), b.L_mask, b.T_mask)

    j_out = jmodel.apply({"params": params}, jb, method=run)
    cse = CSE(tcfg)
    cse.load_state_dict(tmodel.pegen.state_dict())
    with torch.no_grad():
        t_out = cse(tmodel.src_pe_embedding(tb.src_seq), tb.L, tb.T, tb.L_mask, tb.T_mask)
    np.testing.assert_allclose(t_out.numpy(), _np(j_out), atol=ACT_TOL, rtol=0)


def test_sbm_encoder_matches_jax(models):
    from csat_tpu.utils import PAD

    jcfg, tcfg, jmodel, params, tmodel = models
    jb, tb, _ = _batches(jcfg, tcfg, seed=7)
    rng = np.random.default_rng(7)
    b, n = jb.src_seq.shape
    src_emb = rng.standard_normal((b, n, tcfg.src_emb_dim)).astype(np.float32)
    src_pe = rng.standard_normal((b, n, tcfg.pegen_dim)).astype(np.float32)
    key_pad = np.asarray(jb.src_seq) == PAD

    def run(m, e, p, pad):
        x, sparsities, _, _, _ = m.encoder(e, p, pad)
        return x, sparsities

    j_x, j_sp = jmodel.apply({"params": params}, src_emb, src_pe, key_pad, method=run)
    with torch.no_grad():
        t_x, t_sp, _ = tmodel.encoder(torch.from_numpy(src_emb), torch.from_numpy(src_pe),
                                   torch.from_numpy(key_pad))
    np.testing.assert_allclose(t_x.numpy(), _np(j_x), atol=ACT_TOL, rtol=0)
    for a, bb in zip(t_sp, j_sp):
        np.testing.assert_allclose(a.numpy(), _np(bb), atol=1e-6, rtol=0)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_encode_memory_matches_jax(models, backend):
    from csat_tpu.models import CSATrans as JCSATrans

    jcfg, tcfg, jmodel, params, tmodel = models
    jmodel = jmodel.clone(cfg=jcfg.replace(backend=backend))
    jb, tb, _ = _batches(jcfg, tcfg, seed=8)
    j_mem, j_sp, _, _, _ = jmodel.apply({"params": params}, jb, method=JCSATrans.encode)
    t_mem, t_sp = tmodel.encode(tb)
    np.testing.assert_allclose(t_mem.numpy(), _np(j_mem), atol=ACT_TOL, rtol=0)
    np.testing.assert_allclose(float(t_sp), float(j_sp), atol=1e-6)


def _paged_state(tcfg, seed):
    """Random f32 pages, ragged self/cross chains, per-slot positions."""
    rng = np.random.default_rng(seed)
    s, h, page = 4, tcfg.num_heads, 4
    dh = tcfg.hidden_size // h
    steps, mem_len = tcfg.max_tgt_len - 1, tcfg.max_src_len
    sp, cp = -(-steps // page), -(-mem_len // page)
    n_pages = 1 + s * (sp + cp)
    pages = [{key: rng.standard_normal((n_pages, h, page, dh)).astype(np.float32)
              for key in ("k", "v")} for _ in range(tcfg.decoder_layers)]
    ids = iter(rng.permutation(np.arange(1, n_pages)))
    pos = np.asarray([0, 3, 8, 5], np.int32)
    n_real = np.asarray([30, 7, 48, 19])
    self_pt = np.zeros((s, sp), np.int32)
    cross_pt = np.zeros((s, cp), np.int32)
    src_mask = np.ones((s, mem_len), bool)
    for i in range(s):
        for j in range(pos[i] // page + 1):
            self_pt[i, j] = next(ids)
        for j in range(-(-n_real[i] // page)):
            cross_pt[i, j] = next(ids)
        src_mask[i, :n_real[i]] = False
    src_mask[1, 2] = True
    prev_pad = np.zeros((s, steps), bool)
    prev_pad[2, 4] = True  # a generated PAD earlier in row 2
    tok = rng.integers(4, 300, (s, 1)).astype(np.int32)
    return dict(pages=pages, self_pt=self_pt, cross_pt=cross_pt, src_mask=src_mask,
                prev_pad=prev_pad, tok=tok, pos=pos, steps=steps, mem_len=mem_len)


def test_decode_step_matches_jax(models):
    from csat_tpu.models import CSATrans as JCSATrans

    jcfg, tcfg, jmodel, params, tmodel = models
    st = _paged_state(tcfg, seed=9)
    ones = np.ones(st["pages"][0]["k"].shape[:-1] + (1,), np.float32)

    def side(e, table, width, cast):
        return {"pages_k": cast(e["k"]), "pages_v": cast(e["v"]), "scale_k": cast(ones),
                "scale_v": cast(ones), "table": cast(table), "width": width}

    jcache, tcaches = {}, []
    for i, e in enumerate(st["pages"]):
        jself = {**side(e, st["self_pt"], st["steps"], jnp.asarray),
                 "idx": jnp.asarray(st["pos"]), "paged": True}
        jcache[f"layer_{i}"] = {"self": jself,
                                "cross": side(e, st["cross_pt"], st["mem_len"], jnp.asarray)}
        tself = {**side(e, st["self_pt"], st["steps"], torch.from_numpy),
                 "idx": torch.from_numpy(st["pos"])}
        tcaches.append({"self": tself,
                        "cross": side(e, st["cross_pt"], st["mem_len"], torch.from_numpy)})
    j_lp, j_cache = jmodel.apply(
        {"params": params}, jnp.asarray(st["tok"]), jnp.asarray(st["pos"]), jcache, None,
        jnp.asarray(st["src_mask"]), jnp.asarray(st["prev_pad"]),
        method=JCSATrans.decode_step)
    t_lp, t_steps = tmodel.decode_step(
        torch.from_numpy(st["tok"]).long(), torch.from_numpy(st["pos"]), tcaches,
        torch.from_numpy(st["src_mask"]), torch.from_numpy(st["prev_pad"]))
    np.testing.assert_allclose(t_lp.numpy(), _np(j_lp), atol=LOGP_TOL, rtol=0)
    assert np.array_equal(t_lp.argmax(-1).numpy(), np.asarray(j_lp).argmax(-1))
    for i, (k_step, v_step) in enumerate(t_steps):
        j_self = j_cache[f"layer_{i}"]["self"]
        np.testing.assert_allclose(k_step.numpy(), _np(j_self["k_step"]), atol=ACT_TOL, rtol=0)
        np.testing.assert_allclose(v_step.numpy(), _np(j_self["v_step"]), atol=ACT_TOL, rtol=0)


def test_generator_reference_form_and_log_softmax(models):
    """``log(max(softmax, 1e-30))`` (reference order) and plain
    ``log_softmax`` agree with flax's ``Generator`` on large logits too."""
    from csat_tpu.models.components import Generator as JGenerator
    from csat_tpu_torch.models.components import Generator

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, 16)) * 30).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    bias = rng.standard_normal((40,)).astype(np.float32)
    for ref in (True, False):
        j = JGenerator(40, 0.0, reference_dropout=ref).apply(
            {"params": {"Dense_0": {"kernel": w, "bias": bias}}}, jnp.asarray(x))
        g = Generator(16, 40, reference_dropout=ref)
        g.load_state_dict({"fc1.weight": torch.from_numpy(w.T.copy()),
                           "fc1.bias": torch.from_numpy(bias)})
        with torch.no_grad():
            t = g(torch.from_numpy(x))
        np.testing.assert_allclose(t.numpy(), _np(j), atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("name", ["python_long", "java_long", "python_pp"])
def test_parallel_only_configs_absent(name):
    """The port registers every JAX registry entry, the parallel ones
    included (none is absent any more): the long-AST entries and
    ``python_pp`` (GPipe over a pipe axis) carry the JAX entries' fields."""
    from csat_tpu.configs import get_config as jax_config, list_configs as jax_list
    from csat_tpu_torch.configs import get_config, list_configs

    assert set(jax_list()) - set(list_configs()) == set()
    tcfg, jcfg = get_config(name), jax_config(name)
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name