"""Request validation (the JAX package's ``serve/ingest.py:65-115``)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from csat_tpu_torch.configs import Config

__all__ = ["PoisonRequestError", "validate_sample"]


class PoisonRequestError(ValueError):
    """A request sample that would crash or silently corrupt the engine:
    missing fields, wrong shape/dtype, out-of-range node count or token ids."""


_SAMPLE_FIELDS = {"src_seq": 1, "L_raw": 2, "T_raw": 2, "num_node": 0,
                  "tree_pos": 2, "triplet": 1}


def validate_sample(sample: Dict[str, np.ndarray], cfg: Config,
                    src_vocab_size: int = 0, triplet_vocab_size: int = 0) -> None:
    """Required keys, flagship-width shapes, integer dtypes,
    ``1 <= num_node <= max_src_len``, token ids in ``[0, vocab)`` and, with
    ``triplet_vocab_size`` (a triplet model's table), triplet ids in ``[0,
    triplet_vocab_size)``: on the card an id past the table is a device-side
    assert that ends the process, where JAX clips it."""
    if not isinstance(sample, dict):
        raise PoisonRequestError(
            f"sample must be a dict of arrays, got {type(sample).__name__}")
    missing = [k for k in _SAMPLE_FIELDS if k not in sample]
    if missing:
        raise PoisonRequestError(f"sample missing required keys {missing}")
    N = cfg.max_src_len
    tp_dim = cfg.tree_pos_width * cfg.tree_pos_height
    want_shape = {"src_seq": (N,), "L_raw": (N, N), "T_raw": (N, N), "num_node": (),
                  "tree_pos": (N, tp_dim), "triplet": (N,)}
    for key, ndim in _SAMPLE_FIELDS.items():
        try:
            arr = np.asarray(sample[key])
        except (TypeError, ValueError) as e:  # ragged lists, objects
            raise PoisonRequestError(f"sample[{key!r}] is not array-like: {e}") from e
        if arr.ndim != ndim or arr.shape != want_shape[key]:
            raise PoisonRequestError(
                f"sample[{key!r}] has shape {arr.shape}, expected {want_shape[key]}")
        if not np.issubdtype(arr.dtype, np.integer):
            raise PoisonRequestError(
                f"sample[{key!r}] has dtype {arr.dtype}, expected an integer dtype")
    n = int(np.asarray(sample["num_node"]))
    if not 1 <= n <= N:
        raise PoisonRequestError(f"num_node={n} outside [1, max_src_len={N}]")
    src = np.asarray(sample["src_seq"])
    if src.min() < 0:
        raise PoisonRequestError("src_seq contains negative token ids")
    if src_vocab_size and src.max() >= src_vocab_size:
        raise PoisonRequestError(
            f"src_seq token id {int(src.max())} >= src vocab size {src_vocab_size}")
    if triplet_vocab_size:
        trip = np.asarray(sample["triplet"])
        if trip.min() < 0 or trip.max() >= triplet_vocab_size:
            raise PoisonRequestError(
                f"triplet ids span [{int(trip.min())}, {int(trip.max())}], outside the "
                f"triplet table [0, {triplet_vocab_size})")
