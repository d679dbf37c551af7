"""Vocabulary: word↔id maps with frequency-capped construction.

Capability parity with the reference's ``utils/vocab.py``:

* special ids PAD=0 UNK=1 (+BOS=2 EOS=3 when ``need_bos``) (ref ``:38-45``)
* NFD unicode normalization on add (ref ``:49-50``)
* ``generate_dict`` keeps the ``cap - len(specials)`` most frequent tokens
  (ref ``:67-78``)
* pickle save/load of the w2i dict (ref ``:80-86``)
* ``create_vocab`` builds the AST-token vocab (cap 10k), NL vocab (cap 20k)
  and the node-triplet vocab ``(level, parent.child_idx, child_idx)``
  (ref ``:154-226``); the AST vocab is built from the *value* field of each
  label (``e.split(":")[1]``, ref ``:167``).

File formats are identical to the reference (pickled dict; triplet vocab file
named ``node_triplet_dictionary_{lang}.pt``) so artifacts interoperate.

The port's own copy of the JAX package's ``data/vocab.py`` (host-only code, no JAX
in it); ``tests/test_torch_data.py`` holds the two together.
"""

from __future__ import annotations

import ast as _pyast
import os
import pickle
import unicodedata
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

from csat_tpu_torch.utils import BOS, BOS_WORD, EOS, EOS_WORD, PAD, PAD_WORD, UNK, UNK_WORD

__all__ = ["Vocab", "create_vocab", "load_vocab", "read_pot_file"]


class Vocab:
    def __init__(self, need_bos: bool, file_path: str = ""):
        if need_bos:
            self.w2i: Dict[str, int] = {PAD_WORD: PAD, UNK_WORD: UNK, BOS_WORD: BOS, EOS_WORD: EOS}
        else:
            self.w2i = {PAD_WORD: PAD, UNK_WORD: UNK}
        self.i2w: Dict[int, str] = {v: k for k, v in self.w2i.items()}
        self.file_path = file_path

    @staticmethod
    def normalize(token: str) -> str:
        return unicodedata.normalize("NFD", token)

    def size(self) -> int:
        return len(self.w2i)

    def __len__(self) -> int:
        return len(self.w2i)

    def add(self, token: str, normalize: bool = True) -> None:
        if normalize:
            token = self.normalize(token)
        if token not in self.w2i:
            idx = len(self.w2i)
            self.w2i[token] = idx
            self.i2w[idx] = token

    def generate_dict(
        self,
        token_seqs: Iterable[Sequence[str]],
        max_vocab_size: int = -1,
        flat: bool = False,
    ) -> None:
        """Add the most frequent tokens (cap includes the specials)."""
        counter = Counter(token_seqs if flat else (t for seq in token_seqs for t in seq))
        if max_vocab_size < 0:
            words = [w for w, _ in counter.most_common()]
        else:
            words = [w for w, _ in counter.most_common(max_vocab_size - len(self.w2i))]
        for w in words:
            self.add(w, normalize=not flat)
        if self.file_path:
            self.save()

    def encode(self, tokens: Sequence[str]) -> List[int]:
        return [self.w2i.get(t, UNK) for t in tokens]

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [self.i2w.get(int(i), UNK_WORD) for i in ids]

    def save(self, path: str = "") -> None:
        with open(path or self.file_path, "wb") as f:
            pickle.dump(self.w2i, f)

    def load(self, path: str = "") -> "Vocab":
        with open(path or self.file_path, "rb") as f:
            self.w2i = pickle.load(f)
        self.i2w = {v: k for k, v in self.w2i.items()}
        return self


def read_pot_file(path: str) -> List[List[str]]:
    """Read ``split_pot.seq``: each line is ``str((labels,))`` — a stringified
    1-tuple whose element is the label list (ref writes ``str(line)`` at
    ``my_ast.py:98-100``; readers take ``line[0]``). Parsed with
    ``ast.literal_eval`` instead of the reference's ``eval`` (SURVEY §8.8).
    """
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            val = _pyast.literal_eval(line)
            out.append(val[0] if isinstance(val, tuple) else val)
    return out


def create_vocab(
    data_dir: str,
    lang: str = "",
    src_cap: int = 10_000,
    tgt_cap: int = 20_000,
) -> Tuple[Vocab, Vocab, Vocab]:
    """Build AST / NL / triplet vocabs from train+dev splits on disk.

    Writes ``{data_dir}/vocab/split_ast_vocab.pkl``, ``nl_vocab.pkl`` and
    ``node_triplet_dictionary_{lang}.pt`` next to the data dir, matching the
    reference's artifact names (``utils/vocab.py:154-226``).
    """
    if not lang:
        lang = "java" if "java" in data_dir else "python"
    vocab_dir = os.path.join(data_dir, "vocab")
    os.makedirs(vocab_dir, exist_ok=True)

    ast_tokens: List[List[str]] = []
    nl_tokens: List[List[str]] = []
    for split in ("train", "dev"):
        for labels in read_pot_file(os.path.join(data_dir, split, "split_pot.seq")):
            ast_tokens.append([e.split(":")[1] for e in labels])
        with open(os.path.join(data_dir, split, "nl.original"), "r", encoding="utf-8") as f:
            nl_tokens.extend(line.split() for line in f)

    src_vocab = Vocab(need_bos=False, file_path=os.path.join(vocab_dir, "split_ast_vocab.pkl"))
    src_vocab.generate_dict(ast_tokens, src_cap)
    tgt_vocab = Vocab(need_bos=True, file_path=os.path.join(vocab_dir, "nl_vocab.pkl"))
    tgt_vocab.generate_dict(nl_tokens, tgt_cap)

    # triplet vocab from the stored tree records
    from csat_tpu_torch.data.dataset import load_matrices, node_triplets

    triplet_seqs: List[List[str]] = []
    for split in ("train", "dev"):
        mats = load_matrices(os.path.join(data_dir, split, "split_matrices.npz"))
        for rec in mats["root_first_seq"]:
            triplet_seqs.append(node_triplets(rec))
    trip_vocab = Vocab(
        need_bos=False,
        file_path=os.path.join(data_dir, f"node_triplet_dictionary_{lang}.pt"),
    )
    trip_vocab.generate_dict(triplet_seqs)
    return src_vocab, tgt_vocab, trip_vocab


def load_vocab(data_dir: str) -> Tuple[Vocab, Vocab]:
    """Load AST + NL vocabs (ref ``utils/vocab.py:131-151``)."""
    src_vocab = Vocab(need_bos=False, file_path=os.path.join(data_dir, "vocab", "split_ast_vocab.pkl")).load()
    tgt_vocab = Vocab(need_bos=True, file_path=os.path.join(data_dir, "vocab", "nl_vocab.pkl")).load()
    return src_vocab, tgt_vocab
