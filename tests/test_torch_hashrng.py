"""The port's counter hash stream is the JAX package's, bit for bit.

``hash_bits`` and ``uniform_field`` over seeds near 0 and near 2³¹ − 1 (and
negative int32 seeds, which JAX wraps to uint32), at the hash stride of the
flagship node count, and the dropout keep-field of ``flex_core``: all exactly
equal, no tolerance — the CUDA kernels draw the same bits (``csrc/
hashrng.cuh``), so a kernel and both plain paths sample the same graph.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

SEEDS = [0, 1, 2, 2**31 - 3, 2**31 - 2, 2**31 - 1, -1, -(2**31)]


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_field_bitwise_equal_to_jax(seed):
    from csat_tpu.ops import hashrng as jh
    from csat_tpu_torch.ops import hashrng as th

    b, h, n = 2, 3, 150
    stride = th.noise_stride(n)
    assert stride == jh.noise_stride(n) == 256  # the TPU tile, not the CUDA block
    j = np.asarray(jh.uniform_field(jnp.int32(seed), b, h, n, n, stride))
    t = th.uniform_field(torch.tensor([seed], dtype=torch.int32), b, h, n, n, stride)
    np.testing.assert_array_equal(t.numpy(), j)
    assert t.dtype == torch.float32 and 0.0 <= float(t.min()) and float(t.max()) < 1.0


@pytest.mark.parametrize("seed", SEEDS[:3] + SEEDS[-3:])
def test_hash_bits_bitwise_equal_to_jax(seed):
    from csat_tpu.ops import hashrng as jh
    from csat_tpu_torch.ops import hashrng as th

    rows = np.arange(0, 4000, 7)[:, None]
    cols = np.arange(0, 300, 3)[None, :]
    for bh in (0, 5, 511, 2**20 + 3):
        j = np.asarray(jh.hash_bits(jnp.int32(seed), jnp.uint32(bh), jnp.asarray(rows),
                                    jnp.asarray(cols), 384))
        t = th.hash_bits(seed, bh, torch.from_numpy(rows), torch.from_numpy(cols), 384)
        np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_keep_field_bitwise_equal_to_jax(rate):
    from csat_tpu.ops.flex_core import keep_field as jkeep
    from csat_tpu_torch.ops.flex_core import keep_field as tkeep
    from csat_tpu_torch.ops.hashrng import noise_stride

    b, h, n = 2, 4, 70
    seed = 2**31 - 2
    bh = (np.arange(b)[:, None] * h + np.arange(h)[None, :])[:, :, None, None]
    idx = np.arange(n)
    j = np.asarray(jkeep(jnp.int32(seed), jnp.asarray(bh, jnp.uint32),
                         jnp.asarray(idx[None, None, :, None]), jnp.asarray(idx[None, None, None, :]),
                         noise_stride(n), rate))
    t = tkeep(torch.tensor([seed], dtype=torch.int32), b, h, n, noise_stride(n), rate)
    np.testing.assert_array_equal(t.numpy(), np.broadcast_to(j, t.shape))
    assert set(np.unique(t.numpy())) == {0.0, np.float32(1.0 / (1.0 - rate))}
