"""In-memory random batches and request samples at arbitrary scale — the
JAX package's ``data/toy.py`` for the port: benchmarks and traffic traces
(``serve/traffic.py``) that must not depend on an on-disk corpus.

A copy, not an import (the port imports nothing of the JAX package): every
definition is the original's, statement for statement
(``tests/test_torch_imports.py``), so the same seed gives the same arrays bit
for bit.  Shapes and value ranges match what
:func:`csat_tpu_torch.data.dataset.collate` produces (offset distances,
raw-distance masks, adjacency, tree positions, triplets), so any model
variant runs on these batches.
"""

from __future__ import annotations

import numpy as np

from csat_tpu_torch.configs import Config
from csat_tpu_torch.data.dataset import Batch

__all__ = ["random_batch", "random_request_sample"]


def random_request_sample(
    cfg: Config,
    src_vocab_size: int,
    triplet_vocab_size: int,
    n_real: int,
    seed: int = 0,
) -> dict:
    """One *raw* (pre-collate) sample dict at the flagship width — the
    request payload the serving engine ingests (``csat_tpu_torch/serve``): raw
    signed L/T distances (the collate derives masks/offsets/adjacency),
    PAD beyond ``n_real`` real nodes."""
    rng = np.random.default_rng(seed)
    n = cfg.max_src_len
    n_real = int(min(max(n_real, 1), n))
    src = np.zeros((n,), np.int32)
    src[:n_real] = rng.integers(4, src_vocab_size, (n_real,))
    raw_l = np.zeros((n, n), np.int16)
    raw_t = np.zeros((n, n), np.int16)
    l_real = rng.integers(-6, 7, (n_real, n_real))
    t_real = rng.integers(-4, 5, (n_real, n_real))
    for m, real in ((raw_l, l_real), (raw_t, t_real)):
        upper = np.triu(real, k=1)
        m[:n_real, :n_real] = (upper - upper.T).astype(np.int16)
    tp_dim = cfg.tree_pos_width * cfg.tree_pos_height
    tree_pos = np.zeros((n, tp_dim), np.uint8)
    tree_pos[:n_real] = (rng.random((n_real, tp_dim)) < 0.1).astype(np.uint8)
    triplet = np.zeros((n,), np.int32)
    triplet[:n_real] = rng.integers(1, triplet_vocab_size, (n_real,))
    return {
        "src_seq": src,
        "L_raw": raw_l,
        "T_raw": raw_t,
        "num_node": np.asarray(n_real, np.int32),
        "tree_pos": tree_pos,
        "triplet": triplet,
    }


def random_batch(
    cfg: Config,
    batch_size: int,
    src_vocab_size: int,
    tgt_vocab_size: int,
    triplet_vocab_size: int = 64,
    seed: int = 0,
    n_real_nodes: int | None = None,
) -> Batch:
    rng = np.random.default_rng(seed)
    n = cfg.max_src_len
    t = cfg.max_tgt_len - 1
    n_real = n_real_nodes or n
    src = rng.integers(4, src_vocab_size, (batch_size, n))
    src[:, n_real:] = 0
    # plausible raw distances: small signed ints, zero diagonal, and
    # ANTISYMMETRIC like the real L/T matrices (my_ast.py:198-273 emits
    # L[i,j] = -L[j,i]) — real collate derives a symmetric adj=|L|<=1 from
    # this, and the laplacian path assumes that symmetry
    raw_l = rng.integers(-6, 7, (batch_size, n, n)).astype(np.int32)
    raw_t = rng.integers(-4, 5, (batch_size, n, n)).astype(np.int32)
    for m in (raw_l, raw_t):
        upper = np.triu(m, k=1)
        m[:] = upper - upper.transpose(0, 2, 1)
    off, hi = n // 2, n - 1
    tgt = rng.integers(4, tgt_vocab_size, (batch_size, t))
    tp_dim = cfg.tree_pos_width * cfg.tree_pos_height
    return Batch(
        src_seq=src.astype(np.int32),
        tgt_seq=tgt.astype(np.int32),
        target=np.roll(tgt, -1, axis=1).astype(np.int32),
        L=np.clip(raw_l + off, 0, hi).astype(np.int16),
        T=np.clip(raw_t + off, 0, hi).astype(np.int16),
        L_mask=raw_l == 0,
        T_mask=raw_t == 0,
        num_node=np.full((batch_size,), n_real, np.int32),
        adj=(np.abs(raw_l) <= 1).astype(np.uint8),
        tree_pos=(rng.random((batch_size, n, tp_dim)) < 0.1).astype(np.uint8),
        triplet=rng.integers(1, triplet_vocab_size, (batch_size, n)).astype(np.int32),
    )
