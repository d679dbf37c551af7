"""A training corpus drawn from the seed.

``generate(mix, model, seed, seconds)`` → the per-sample arrays of
``mix["corpus_size"]`` samples at the configuration's flagship width, the
fields the port's dataset holds (``src_seq``, ``tgt_seq``, ``target``,
``L_raw``, ``T_raw``, ``num_node``, ``tree_pos``, ``triplet``):

* AST node counts at the quantiles of the mix's histogram (``nodes``,
  capped at ``max_src_len``) and summary lengths at the quantiles of its
  ``words``: the same multisets for every seed, paired and ordered by it;
* trees from :mod:`portbench.traffic.trees` at each count, real L / T
  distances;
* token ids uniform over the source and target vocabularies (ids 0–3 are
  PAD, UNK, BOS, EOS); the summary is BOS, its words, EOS.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.traffic.lengths import load_histogram, quantiles
from portbench.traffic.trees import distance_planes, draw_parents

__all__ = ["generate", "sample_arrays"]

BOS, EOS = 2, 3  # the vocabulary's special ids (PAD 0, UNK 1)


def sample_arrays(model: Dict, nodes: np.ndarray, words: np.ndarray,
                  rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """The arrays of ``len(nodes)`` samples (``words`` may be empty: no
    summaries, the serving fields only)."""
    n_max, t = model["max_src_len"], model["max_tgt_len"]
    s = len(nodes)
    src = np.zeros((s, n_max), np.int32)
    L = np.zeros((s, n_max, n_max), np.int16)
    T = np.zeros((s, n_max, n_max), np.int16)
    for i, n in enumerate(nodes):
        L[i], T[i] = distance_planes(draw_parents(rng, int(n)), n_max)
        src[i, :n] = rng.integers(4, model["src_vocab_size"], int(n))
    out = {"src_seq": src, "L_raw": L, "T_raw": T, "num_node": np.asarray(nodes, np.int32),
           "tree_pos": np.zeros((s, n_max, model["tree_pos_width"] * model["tree_pos_height"]),
                                 np.uint8),
           "triplet": np.zeros((s, n_max), np.int32)}
    if len(words):
        seq = np.zeros((s, t), np.int32)
        seq[:, 0] = BOS
        for i, w in enumerate(words):
            seq[i, 1:1 + w] = rng.integers(4, model["tgt_vocab_size"], int(w))
            seq[i, 1 + w] = EOS
        out["tgt_seq"], out["target"] = seq[:, :-1].copy(), seq[:, 1:].copy()
    return out


def generate(mix: Dict, model: Dict, seed: int, seconds: int) -> Dict[str, np.ndarray]:
    hist = load_histogram(mix["lengths"])
    k = int(mix["corpus_size"])
    rng = np.random.default_rng([int(seed), 1])
    nodes = np.minimum(quantiles(hist["nodes"], k), model["max_src_len"])
    words = np.minimum(quantiles(hist["words"], k), model["max_tgt_len"] - 2)
    return sample_arrays(model, rng.permutation(nodes), rng.permutation(words), rng)
