"""The flax → port weight converter consumes every flax leaf exactly once
and fills every port parameter with the right shape; it fails loudly on a
leaf it cannot place or a parameter it leaves unfilled."""

import numpy as np
import pytest

from torch_parity import configs, jax_model_and_params


@pytest.fixture(scope="module")
def setup():
    from csat_tpu_torch.models import CSATrans

    jcfg, tcfg = configs()
    _, params = jax_model_and_params(jcfg)
    model = CSATrans(tcfg, 200, 300, device="cpu")
    return params, model


def test_every_leaf_consumed_once_and_shapes_match(setup):
    from csat_tpu_torch.convert import convert_params, flatten

    params, model = setup
    sd = convert_params(params, model)
    leaves = flatten(params)
    assert len(sd) == len(leaves) == len(model.state_dict())
    # values land transposed for Dense kernels, verbatim elsewhere
    k = params["decoder"]["layer_0"]["self_attn"]["q"]["kernel"]
    np.testing.assert_array_equal(sd["decoder.layers.0.self_attn.q.weight"].numpy(), k.T)
    c = params["encoder"]["transformer_0"]["SBMAttention_0"]["clusters"]
    np.testing.assert_array_equal(sd["encoder.blocks.0.attn.clusters"].numpy(), c)
    np.testing.assert_array_equal(sd["pegen.L_q"].numpy(), params["pegen"]["L_q"])
    ln = params["encoder"]["transformer_0"]["LayerNorm_1"]["scale"]
    np.testing.assert_array_equal(sd["encoder.blocks.0.ff_norm.weight"].numpy(), ln)


def test_unknown_leaf_fails(setup):
    from csat_tpu_torch.convert import convert_params

    params, model = setup
    bad = {**params, "stray": {"weird_0": {"kernel": np.zeros((2, 2), np.float32)}}}
    with pytest.raises(KeyError, match="no rule"):
        convert_params(bad, model)


def test_unfilled_parameter_fails(setup):
    from csat_tpu_torch.convert import convert_params

    params, model = setup
    partial = {k: v for k, v in params.items() if k != "generator"}
    with pytest.raises(KeyError, match="unfilled"):
        convert_params(partial, model)


def test_shape_mismatch_fails(setup):
    from csat_tpu_torch.convert import convert_params

    params, model = setup
    gen = {"Dense_0": {"kernel": np.zeros((32, 7), np.float32),
                       "bias": np.zeros((7,), np.float32)}}
    with pytest.raises(ValueError, match="shape"):
        convert_params({**params, "generator": gen}, model)


def test_gradient_tree_maps_onto_named_parameters(setup):
    """A gradient tree has the params' structure: it converts onto
    ``named_parameters()`` with the same transposes, so each entry lines up
    with its parameter's ``.grad``."""
    import jax

    from csat_tpu_torch.convert import convert_params

    params, model = setup
    grads = jax.tree_util.tree_map(lambda x: 2.0 * np.asarray(x), params)
    g = convert_params(grads, model)
    p = convert_params(params, model)
    assert list(g) == list(p) and set(g) == {name for name, _ in model.named_parameters()}
    for name in g:
        np.testing.assert_array_equal(g[name].numpy(), 2.0 * p[name].numpy())
