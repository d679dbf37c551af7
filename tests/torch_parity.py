"""Shared set-up for the port's parity tests (tests/test_torch_*.py): one
micro configuration built in both packages, JAX params perturbed so biases
and LayerNorm parameters are non-trivial, the same params converted into
the port, and one whole train step's inputs, weights and noise handed to
both packages (:func:`train_setup`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

MICRO = dict(
    pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=4,
    num_layers=1, sbm_layers=1, clusters=(4,), dim_feed_forward=64,
    decoder_layers=2, max_src_len=48, max_tgt_len=10, tree_pos_width=4,
    tree_pos_height=8, eval_graph="expected", serve_slots=4, bucket_src_lens=(24, 48),
)
SRC_V, TGT_V, TRIP_V = 200, 300, 50


@pytest.fixture(scope="module")
def one_torch_thread():
    """A module's torch CPU work on one intra-op thread, restored after it.
    At micro widths the intra-op threads only add overhead, and the suite's
    workers share the host's cores: eight threads in each of several workers
    oversubscribe them and slow every worker many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(name="python", **kw):
    """(JAX config, port config) of registry entry ``name`` from the same
    overrides."""
    from csat_tpu.configs import get_config as jax_config
    from csat_tpu_torch.configs import get_config as torch_config

    over = {**MICRO, **kw}
    return jax_config(name, **over), torch_config(name, **over)


def jax_model_and_params(jcfg, seed=0):
    """Flax CSATrans + numpy params (init, then perturbed by N(0, 0.05))."""
    from csat_tpu.data.toy import random_request_sample
    from csat_tpu.serve.prefill import collate_requests
    from csat_tpu.train.state import make_model

    model = make_model(jcfg, SRC_V, TGT_V, TRIP_V)
    warm = collate_requests(
        [random_request_sample(jcfg, SRC_V, TRIP_V, 8, seed=0)],
        jcfg.max_src_len, 1, jcfg, tgt_width=jcfg.max_tgt_len - 1)
    params = model.init(
        {"params": jax.random.key(seed), "sample": jax.random.key(seed + 1)}, warm)["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(x.shape).astype(np.float32), params)
    return model, params


def torch_model(tcfg, params):
    """The port's CSATrans on the CPU carrying ``params``."""
    from csat_tpu_torch.convert import load_flax_params
    from csat_tpu_torch.models import CSATrans

    model = CSATrans(tcfg, SRC_V, TGT_V, device="cpu", triplet_vocab_size=TRIP_V)
    return load_flax_params(model, params)


def request_samples(jcfg, n, seed=0, lo=3):
    """``n`` flagship-width request samples of mixed real lengths."""
    from csat_tpu.data.toy import random_request_sample

    rng = np.random.default_rng(seed)
    return [random_request_sample(jcfg, SRC_V, TRIP_V, int(ln), seed=100 * seed + i)
            for i, ln in enumerate(rng.integers(lo, jcfg.max_src_len + 1, n))]


# ---------------------------------------------------------------------------
# one whole train step, the same in both packages
# ---------------------------------------------------------------------------

N_REAL = (75, 30, 80)
SEEDS = {("sample", 0): 11, ("dropout", 0): 2**31 - 5, ("sample", 1): 123456,
         ("dropout", 1): 7}


class Draws:
    """Per-name call counters: the n-th draw of a name is SBM layer n's, in
    both packages (each draws its sample seed, then its dropout seed, layer by
    layer)."""

    def __init__(self):
        self.calls = {}

    def next(self, name):
        i = self.calls.get(name, 0)
        self.calls[name] = i + 1
        return i


def step_batch(jcfg, tcfg, n_real=N_REAL):
    """Request samples of ``n_real`` nodes with random summaries, collated by
    each package at ``max_src_len``: ``(JAX batch, port batch on the
    CPU)``."""
    from csat_tpu.data.dataset import collate as jcollate
    from csat_tpu.data.toy import random_request_sample
    from csat_tpu_torch.data.dataset import batch_to_device, collate as tcollate

    samples = [random_request_sample(jcfg, SRC_V, TRIP_V, n, seed=40 + i)
               for i, n in enumerate(n_real)]
    rng = np.random.default_rng(6)
    tgt = rng.integers(4, TGT_V, (len(samples), jcfg.max_tgt_len)).astype(np.int32)
    tgt[1, 4:] = 0
    arrs = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    arrs["tgt_seq"], arrs["target"] = tgt[:, :-1], tgt[:, 1:]
    return (jcollate(arrs, jcfg.max_src_len),
            batch_to_device(tcollate(arrs, tcfg.max_src_len), torch.device("cpu")))


def train_setup(mode, monkeypatch, name="python", backend="pallas", **over):
    """Registry entry ``name`` at the micro widths (2 SBM layers, n up to
    80, model dropout 0, attention dropout 0.2 unless ``over`` says
    otherwise, noise mode ``mode``), JAX on ``backend``; the same
    params in both models, the same batch, the per-layer seeds (and, shared,
    the uniform noise) handed to both packages, and the cluster
    projection's own dropout off in both."""
    from csat_tpu.models import sbm as jsbm
    from csat_tpu_torch.models import sbm as tsbm

    jcfg, tcfg = configs(name, **{**dict(
        max_src_len=80, bucket_src_lens=(), sbm_layers=2, clusters=(4, 3), dropout=0.0,
        attention_dropout=0.2, noise_mode=mode), **over})
    jcfg = jcfg.replace(backend=backend)
    jmodel, params = jax_model_and_params(jcfg, seed=2)
    tmodel = torch_model(tcfg, params)

    jbatch, tbatch = step_batch(jcfg, tcfg)
    b, n = jbatch.src_seq.shape

    class ClusterProj(jsbm.ClusterProj):  # JAX fixes 0.2; disabled here only
        dropout: float = 0.0

    monkeypatch.setattr(jsbm, "ClusterProj", ClusterProj)
    monkeypatch.setattr(tsbm.ClusterProj, "dropout", 0.0)
    h = jcfg.num_heads
    noise = [np.random.default_rng(60 + i).random((b, h, n, n)).astype(np.float32)
             for i in range(jcfg.sbm_layers)]
    jdraws, tdraws = Draws(), Draws()
    monkeypatch.setattr(jsbm, "draw_counter_seed", lambda module, name: jnp.int32(
        SEEDS[(name, jdraws.next(name))]))
    monkeypatch.setattr(tsbm, "draw_seed", lambda gen, name: torch.tensor(
        [SEEDS[(name, tdraws.next(name))]], dtype=torch.int32))
    monkeypatch.setattr(jsbm, "bernoulli_noise", lambda key, shape: jnp.asarray(
        noise[jdraws.next("noise")]))
    monkeypatch.setattr(tsbm, "bernoulli_noise", lambda gen, shape: torch.from_numpy(
        noise[tdraws.next("noise")]))
    return jcfg, tcfg, jmodel, params, tmodel, jbatch, tbatch, jdraws, tdraws


def keeping_grads(tx):
    """``tx`` whose state also holds the gradients of its last update, so
    the gradients of JAX's own train step can be read back after it."""
    import optax

    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def jax_train_step(jcfg, jmodel, params, jbatch):
    """One JAX ``make_train_step`` from ``params``: ``(state, metrics,
    gradients)``."""
    from csat_tpu.train.loop import make_train_step as jmake_step
    from csat_tpu.train.state import TrainState as JTrainState, default_optimizer as jopt

    tx = keeping_grads(jopt(jcfg))
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = JTrainState(step=jnp.zeros([], jnp.int32), params=jparams,
                         opt_state=tx.init(jparams), rng=jax.random.key(0))
    jstate, j_metrics = jmake_step(jmodel, tx, jcfg)(jstate, jbatch)
    return jstate, j_metrics, jstate.opt_state[1]
