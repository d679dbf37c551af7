"""Seeded random ASTs and the serving requests built from them.

In the spirit of the JAX package's ``data/synthetic.py:40-90`` generator
(random ASTs in the tree-sitter ``ast.original`` JSON format):
``random_ast`` draws a tree with an exact node count, so a caller can spread
requests over every prefill bucket; ``request_sample``
turns a JSON AST into the flagship-width sample dict the serving engine
ingests, through the same tree → pre-order → L/T matrices pipeline the
preprocessing runs, with the tree positions and node triplets of the
preprocessing's record (``serve/ingest.py:138-148`` in JAX), so every PE
variant reads real structure; ``train_sample`` adds a random summary as the
decoder input and target.  Token and triplet ids come from a stable hash of
each node's value or triplet, so no vocabulary file is needed.

``gen_ast_nl`` and ``make_corpus`` are the port's copy of the JAX package's
synthetic code-summarization corpus (``data/synthetic.py:40-114``): random
"function" ASTs with a summary that is a deterministic function of the tree
(so a correct model learns it), written as ``ast.original`` / ``nl.original``
and run through ``data/preprocess.py``.  From the same seed both packages
write the same corpus (``tests/test_torch_data.py``).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from csat_tpu_torch.configs import Config
from csat_tpu_torch.data.ast_tools import (
    ast_json_to_tree, build_matrices, tree_to_record, truncate_preorder)
from csat_tpu_torch.data.dataset import gen_tree_positions, node_triplets
from csat_tpu_torch.data.vocab import Vocab
from csat_tpu_torch.models.pe import TRIPLET_VOCAB_FALLBACK
from csat_tpu_torch.utils import BOS, EOS, UNK

__all__ = ["random_ast", "request_sample", "train_sample", "gen_ast_nl", "grow_ast",
           "make_corpus"]

VERBS = ["get", "set", "load", "save", "parse", "build", "find", "update", "check", "make"]
NOUNS = ["node", "tree", "value", "config", "index", "token", "graph", "batch", "path", "cache"]
STMTS = ["assign", "return", "call", "if", "for", "while"]
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


def _hash_id(text: str, size: int) -> int:
    return 4 + zlib.crc32(text.encode()) % (size - 4)


def request_sample(ast_json: List[dict], cfg: Config, src_vocab_size: int,
                   trip_vocab: Optional[Vocab] = None) -> Dict[str, np.ndarray]:
    """A JSON AST → the flagship-width request sample (the fields
    ``serve.ingest.validate_sample`` checks).  Token id of a node: a stable
    hash of its value into ``[4, src_vocab_size)``.  ``tree_pos``: the
    one-hot child-index chains of ``data.dataset.gen_tree_positions``.
    Triplet id of a node: its id in ``trip_vocab`` (UNK when absent), or
    without one a stable hash of its triplet into ``[4,
    TRIPLET_VOCAB_FALLBACK[cfg.lang])``, the table a model without a
    dictionary gets."""
    N = cfg.max_src_len
    seq = truncate_preorder(ast_json_to_tree(ast_json), N)
    L, T = build_matrices(seq, N)
    rec = tree_to_record(seq)
    src_seq = np.zeros((N,), np.int32)
    for i, node in enumerate(seq):
        src_seq[i] = _hash_id(":".join(node.label.split(":")[1:-1]), src_vocab_size)
    tree_pos = np.zeros((N, cfg.tree_pos_width * cfg.tree_pos_height), np.uint8)
    tp = gen_tree_positions(rec, cfg.tree_pos_width, cfg.tree_pos_height)
    tree_pos[: tp.shape[0]] = tp
    triplet = np.zeros((N,), np.int32)
    trips = node_triplets(rec)
    triplet[: len(trips)] = (
        [trip_vocab.w2i.get(t, UNK) for t in trips] if trip_vocab is not None
        else [_hash_id(t, TRIPLET_VOCAB_FALLBACK[cfg.lang]) for t in trips])
    return {
        "src_seq": src_seq,
        "L_raw": L.astype(np.int16),
        "T_raw": T.astype(np.int16),
        "num_node": np.asarray(len(seq), np.int32),
        "tree_pos": tree_pos,
        "triplet": triplet,
    }


def train_sample(ast_json: List[dict], cfg: Config, src_vocab_size: int,
                 tgt_vocab_size: int, rng: np.random.Generator,
                 trip_vocab: Optional[Vocab] = None) -> Dict[str, np.ndarray]:
    """:func:`request_sample` plus a summary of 3 to ``max_tgt_len - 2``
    random words: ``tgt_seq`` (BOS, words…) and ``target`` (words…, EOS),
    PAD beyond, both ``max_tgt_len - 1`` wide — the collate's training
    fields."""
    sample = request_sample(ast_json, cfg, src_vocab_size, trip_vocab)
    t = cfg.max_tgt_len
    words = rng.integers(4, tgt_vocab_size, int(rng.integers(3, t - 1)))
    seq = np.zeros((t,), np.int32)
    seq[0] = BOS
    seq[1:1 + len(words)] = words
    seq[1 + len(words)] = EOS
    sample["tgt_seq"], sample["target"] = seq[:-1], seq[1:]
    return sample


def gen_ast_nl(rng: np.random.Generator) -> Tuple[List[dict], List[str]]:
    """One random function AST (JSON node list) + its NL summary tokens."""
    labels: List[str] = []
    child_lists: List[List[int]] = []

    root = _node(labels, child_lists, "nont", "function_definition")
    verb = VERBS[rng.integers(len(VERBS))]
    noun = NOUNS[rng.integers(len(NOUNS))]
    name = _node(labels, child_lists, "nont", "identifier")
    child_lists[root].append(name)
    v_tok = _node(labels, child_lists, "idt", verb)
    child_lists[name].append(v_tok)
    n_tok = _node(labels, child_lists, "idt", noun)
    child_lists[v_tok].append(n_tok)  # sub-token chain, as the extractor builds

    params = _node(labels, child_lists, "nont", "parameters")
    child_lists[root].append(params)
    for _ in range(rng.integers(0, 3)):
        p = _node(labels, child_lists, "nont", "identifier")
        child_lists[params].append(p)
        t = _node(labels, child_lists, "idt", NOUNS[rng.integers(len(NOUNS))])
        child_lists[p].append(t)

    body = _node(labels, child_lists, "nont", "block")
    child_lists[root].append(body)
    extra_nouns: List[str] = []
    for _ in range(rng.integers(1, 5)):
        kind = STMTS[rng.integers(len(STMTS))]
        st = _node(labels, child_lists, "nont", kind)
        child_lists[body].append(st)
        for _ in range(rng.integers(1, 3)):
            w = NOUNS[rng.integers(len(NOUNS))]
            extra_nouns.append(w)
            idn = _node(labels, child_lists, "nont", "identifier")
            child_lists[st].append(idn)
            tok = _node(labels, child_lists, "idt", w)
            child_lists[idn].append(tok)

    ast_json = []
    for i, lab in enumerate(labels):
        entry = {"label": lab}
        if child_lists[i]:
            entry["children"] = [f"ref:{c + 1}" for c in child_lists[i]]
        ast_json.append(entry)

    nl = [verb, "the", noun]
    if extra_nouns:
        nl += ["using", extra_nouns[0]]
    return ast_json, nl


def grow_ast(ast_json: List[dict], rng: np.random.Generator, num_nodes: int) -> List[dict]:
    """Append random nodes to a JSON AST until it has ``num_nodes`` (a
    larger tree is returned as it is): each new node hangs under one of the
    last few nodes, as in :func:`random_ast`.  The head of the tree, which
    the summary of :func:`gen_ast_nl` is a function of, stays in place."""
    out = [dict(entry, children=list(entry.get("children", ()))) for entry in ast_json]
    for i in range(len(out), num_nodes):
        parent = int(rng.integers(max(0, i - 6), i))
        if rng.random() < 0.5:
            kind, value = "nont", KINDS[rng.integers(len(KINDS))]
        else:
            kind, value = "idt", NOUNS[rng.integers(len(NOUNS))]
        out.append({"label": f"{kind}:{value}:0:0:{i + 1}", "children": []})
        out[parent]["children"].append(f"ref:{i + 1}")
    return [e if e["children"] else {"label": e["label"]} for e in out]


def make_corpus(
    data_dir: str,
    n_train: int = 256,
    n_dev: int = 64,
    n_test: int = 64,
    seed: int = 0,
    max_ast_len: int = 150,
    node_range: Optional[Tuple[int, int]] = None,
) -> str:
    """Generate + preprocess a corpus under ``data_dir``. Returns ``data_dir``.

    ``node_range=(lo, hi)`` (the port's addition) grows every AST to a node
    count drawn uniformly from ``[lo, hi]``, so a corpus spreads over the
    length buckets; without it the files equal the JAX package's."""
    from csat_tpu_torch.data.preprocess import process_dataset

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("dev", n_dev), ("test", n_test)):
        d = os.path.join(data_dir, split)
        os.makedirs(d, exist_ok=True)
        asts, nls = [], []
        for _ in range(n):
            a, nl = gen_ast_nl(rng)
            if node_range is not None:
                a = grow_ast(a, rng, int(rng.integers(node_range[0], node_range[1] + 1)))
            asts.append(json.dumps(a))
            nls.append(" ".join(nl))
        with open(os.path.join(d, "ast.original"), "w") as f:
            f.write("\n".join(asts))
        with open(os.path.join(d, "nl.original"), "w") as f:
            f.write("\n".join(nls) + "\n")
    process_dataset(data_dir, max_ast_len=max_ast_len, make_vocab=True)
    return data_dir
