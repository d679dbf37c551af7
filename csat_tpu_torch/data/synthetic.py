"""Seeded random ASTs and the serving requests built from them.

In the spirit of the JAX package's ``data/synthetic.py:40-90`` generator
(random ASTs in the tree-sitter ``ast.original`` JSON format):
``random_ast`` draws a tree with an exact node count, so a caller can spread
requests over every prefill bucket; ``request_sample``
turns a JSON AST into the flagship-width sample dict the serving engine
ingests, through the same tree → pre-order → L/T matrices pipeline the
preprocessing runs; ``train_sample`` adds a random summary as the decoder
input and target.  Token ids come from a stable hash of each node's value,
so no vocabulary file is needed.
"""

from __future__ import annotations

import zlib
from typing import Dict, List

import numpy as np

from csat_tpu_torch.configs import Config
from csat_tpu_torch.data.ast_tools import (
    ast_json_to_tree, build_matrices, truncate_preorder)
from csat_tpu_torch.utils import BOS, EOS

__all__ = ["random_ast", "request_sample", "train_sample"]

VERBS = ["get", "set", "load", "save", "parse", "build", "find", "update", "check", "make"]
NOUNS = ["node", "tree", "value", "config", "index", "token", "graph", "batch", "path", "cache"]
KINDS = ["identifier", "call", "assign", "block", "attribute", "argument_list",
         "binary_operator", "return_statement", "if_statement", "string"]


def _node(labels: List[str], children: List[List[int]], kind: str, value: str) -> int:
    idx = len(labels)
    labels.append(f"{kind}:{value}:0:0:{idx + 1}")
    children.append([])
    return idx


def _to_json(labels: List[str], child_lists: List[List[int]]) -> List[dict]:
    out = []
    for i, lab in enumerate(labels):
        entry = {"label": lab}
        if child_lists[i]:
            entry["children"] = [f"ref:{c + 1}" for c in child_lists[i]]
        out.append(entry)
    return out


def random_ast(rng: np.random.Generator, num_nodes: int) -> List[dict]:
    """A random AST with exactly ``num_nodes`` nodes: each new node hangs
    under one of the last few nodes drawn, which gives both deep chains (L
    distances) and wide sibling lists (T distances)."""
    labels: List[str] = []
    child_lists: List[List[int]] = []
    _node(labels, child_lists, "nont", "function_definition")
    for i in range(1, num_nodes):
        parent = int(rng.integers(max(0, i - 6), i))
        if rng.random() < 0.5:
            kind, value = "nont", KINDS[rng.integers(len(KINDS))]
        else:
            kind, value = "idt", (VERBS + NOUNS)[rng.integers(len(VERBS) + len(NOUNS))]
        child_lists[parent].append(_node(labels, child_lists, kind, value))
    return _to_json(labels, child_lists)


def request_sample(ast_json: List[dict], cfg: Config,
                   src_vocab_size: int) -> Dict[str, np.ndarray]:
    """A JSON AST → the flagship-width request sample (the fields
    ``serve.ingest.validate_sample`` checks).  Token id of a node: a stable
    hash of its value into ``[4, src_vocab_size)``."""
    N = cfg.max_src_len
    seq = truncate_preorder(ast_json_to_tree(ast_json), N)
    L, T = build_matrices(seq, N)
    src_seq = np.zeros((N,), np.int32)
    for i, node in enumerate(seq):
        value = ":".join(node.label.split(":")[1:-1])
        src_seq[i] = 4 + zlib.crc32(value.encode()) % (src_vocab_size - 4)
    tp_dim = cfg.tree_pos_width * cfg.tree_pos_height
    return {
        "src_seq": src_seq,
        "L_raw": L.astype(np.int16),
        "T_raw": T.astype(np.int16),
        "num_node": np.asarray(len(seq), np.int32),
        "tree_pos": np.zeros((N, tp_dim), np.uint8),
        "triplet": np.zeros((N,), np.int32),
    }


def train_sample(ast_json: List[dict], cfg: Config, src_vocab_size: int,
                 tgt_vocab_size: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """:func:`request_sample` plus a summary of 3 to ``max_tgt_len - 2``
    random words: ``tgt_seq`` (BOS, words…) and ``target`` (words…, EOS),
    PAD beyond, both ``max_tgt_len - 1`` wide — the collate's training
    fields."""
    sample = request_sample(ast_json, cfg, src_vocab_size)
    t = cfg.max_tgt_len
    words = rng.integers(4, tgt_vocab_size, int(rng.integers(3, t - 1)))
    seq = np.zeros((t,), np.int32)
    seq[0] = BOS
    seq[1:1 + len(words)] = words
    seq[1 + len(words)] = EOS
    sample["tgt_seq"], sample["target"] = seq[:-1], seq[1:]
    return sample
