"""Shared set-up for the port's parity tests (tests/test_torch_*.py): one
micro configuration built in both packages, JAX params perturbed so biases
and LayerNorm parameters are non-trivial, and the same params converted into
the port."""

import jax
import numpy as np

MICRO = dict(
    pe_dim=8, pegen_dim=16, sbm_enc_dim=32, hidden_size=32, num_heads=4,
    num_layers=1, sbm_layers=1, clusters=(4,), dim_feed_forward=64,
    decoder_layers=2, max_src_len=48, max_tgt_len=10, tree_pos_width=4,
    tree_pos_height=8, eval_graph="expected", serve_slots=4, bucket_src_lens=(24, 48),
)
SRC_V, TGT_V, TRIP_V = 200, 300, 50


def configs(**kw):
    """(JAX config, port config) from the same overrides."""
    from csat_tpu.configs import get_config as jax_config
    from csat_tpu_torch.configs import get_config as torch_config

    over = {**MICRO, **kw}
    return jax_config("python", **over), torch_config("python", **over)


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

    model = CSATrans(tcfg, SRC_V, TGT_V, device="cpu")
    return load_flax_params(model, params)


def request_samples(jcfg, n, seed=0, lo=3):
    """``n`` flagship-width request samples of mixed real lengths."""
    from csat_tpu.data.toy import random_request_sample

    rng = np.random.default_rng(seed)
    return [random_request_sample(jcfg, SRC_V, TRIP_V, int(ln), seed=100 * seed + i)
            for i, ln in enumerate(rng.integers(lo, jcfg.max_src_len + 1, n))]
