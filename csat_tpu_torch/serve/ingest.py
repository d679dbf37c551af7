"""Request ingestion: raw source code → engine samples, and validation.

The JAX package's ``serve/ingest.py``: :func:`sample_from_source` runs one
code snippet through the L0 extractor (``data/extract.py``, the stdlib-``ast``
backend, or tree-sitter where its grammar imports), the L1 distance matrices
(``data/ast_tools.py``) and the vocab — exactly the offline preprocessing
pipeline, per request —, :func:`sample_from_dataset` takes a request sample
from a built dataset's row, and :func:`validate_sample` refuses malformed
samples at submit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from csat_tpu_torch.configs import Config
from csat_tpu_torch.data.ast_tools import (
    ast_json_to_tree, build_matrices, tree_to_record, truncate_preorder)
from csat_tpu_torch.data.dataset import ASTDataset, gen_tree_positions, node_triplets
from csat_tpu_torch.data.extract import source_to_ast_json
from csat_tpu_torch.utils import UNK

__all__ = ["PoisonRequestError", "sample_from_source", "sample_from_dataset", "validate_sample"]


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
            raise PoisonRequestError(f"sample[{key!r}] is not array-like: "
                                     f"{type(e).__name__}: {e}") from e
        if arr.ndim != ndim or arr.shape != want_shape[key]:
            raise PoisonRequestError(
                f"sample[{key!r}] has shape {arr.shape}, expected {want_shape[key]} "
                "(flagship width, serve/ingest.py)")
        if not np.issubdtype(arr.dtype, np.integer):
            raise PoisonRequestError(
                f"sample[{key!r}] has dtype {arr.dtype}, expected an integer dtype")
    n = int(np.asarray(sample["num_node"]))
    if not 1 <= n <= N:
        raise PoisonRequestError(
            f"num_node={n} outside [1, max_src_len={N}] — oversized inputs must be "
            "truncated at ingest (truncate_preorder), not submitted")
    src = np.asarray(sample["src_seq"])
    if src.min() < 0:
        raise PoisonRequestError("src_seq contains negative token ids")
    if src_vocab_size and src.max() >= src_vocab_size:
        raise PoisonRequestError(
            f"src_seq token id {int(src.max())} >= src vocab size {src_vocab_size} "
            "(OOV ids must map to <unk> at ingest)")
    if triplet_vocab_size:
        trip = np.asarray(sample["triplet"])
        if trip.min() < 0 or trip.max() >= triplet_vocab_size:
            raise PoisonRequestError(
                f"triplet ids span [{int(trip.min())}, {int(trip.max())}], outside the "
                f"triplet table [0, {triplet_vocab_size})")


def sample_from_source(source: str, cfg: Config, src_vocab, trip_vocab=None,
                       language: str = "") -> Dict[str, np.ndarray]:
    """One code snippet → a request sample (``src_vocab`` / ``trip_vocab``
    are ``data.vocab.Vocab``s; raises ``SyntaxError`` and the like on
    unparseable input — callers report that per request)."""
    N = cfg.max_src_len
    nodes = source_to_ast_json(source, language or cfg.lang)
    seq = truncate_preorder(ast_json_to_tree(nodes), N)
    L, T = build_matrices(seq, N)
    rec = tree_to_record(seq)
    n = len(rec)

    src_seq = np.zeros((N,), np.int32)
    ast_tokens = [":".join(e.split(":")[1:-1]) for e in rec.labels[:N]]
    src_seq[: len(ast_tokens)] = [src_vocab.w2i.get(t, UNK) for t in ast_tokens]

    tp_dim = cfg.tree_pos_width * cfg.tree_pos_height
    tree_pos = np.zeros((N, tp_dim), np.uint8)
    tp = gen_tree_positions(rec, cfg.tree_pos_width, cfg.tree_pos_height)
    tree_pos[: tp.shape[0]] = tp

    triplet = np.zeros((N,), np.int32)
    trips = node_triplets(rec)
    triplet[: len(trips)] = (
        [trip_vocab.w2i.get(t, UNK) for t in trips] if trip_vocab else [UNK] * len(trips))
    return {
        "src_seq": src_seq,
        "L_raw": L[:N, :N].astype(np.int16),
        "T_raw": T[:N, :N].astype(np.int16),
        "num_node": np.asarray(min(n, N), np.int32),
        "tree_pos": tree_pos,
        "triplet": triplet,
    }


def sample_from_dataset(dataset: ASTDataset, i: int) -> Dict[str, np.ndarray]:
    """Row ``i`` of a built dataset as a request sample (views, no copy)."""
    a = dataset.arrays
    return {
        "src_seq": a["src_seq"][i],
        "L_raw": a["L_raw"][i],
        "T_raw": a["T_raw"][i],
        "num_node": a["num_node"][i],
        "tree_pos": a["tree_pos"][i],
        "triplet": a["triplet"][i],
    }
