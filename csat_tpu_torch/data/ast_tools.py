"""AST core: tree building, pre-order truncation, and the L/T matrices.

The parts of the JAX package's ``data/ast_tools.py:41-209`` (itself the
reference's ``my_ast.py``) that turn a JSON AST into model inputs:
``build_matrices`` gives the signed ancestor
distance matrix ``L`` (``L[a, x] = +d`` for an ancestor ``a`` at path
distance ``d`` above ``x``, ``L[x, a] = -d``) and the signed sibling gap
matrix ``T``; every other pair is 0, the "unrelated" value the CSE masks key
off.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Node", "ast_json_to_tree", "preorder", "truncate_preorder", "build_matrices"]


class Node:
    """One AST node; ``label`` is ``"kind:value:orig_idx"``, ``num`` its
    pre-order index once truncated."""

    __slots__ = ("label", "parent", "children", "num")

    def __init__(self, label: str = ""):
        self.label = label
        self.parent: Optional["Node"] = None
        self.children: List["Node"] = []
        self.num: int = -1


def ast_json_to_tree(ast_json: Sequence[dict]) -> Node:
    """Linked tree from one JSON AST: dicts with ``label`` =
    ``"kind:value:start:end:idx"`` and ``children`` whose trailing ``:idx``
    is a 1-indexed node id."""
    nodes = [Node() for _ in ast_json]
    for i, attr in enumerate(ast_json):
        parts = attr["label"].split(":")
        node = nodes[i]
        node.label = ":".join(parts[:-3] + [parts[-1]])
        for child_ref in attr.get("children", ()):
            child = nodes[int(child_ref.split(":")[-1]) - 1]
            child.parent = node
            node.children.append(child)
    return nodes[0]


def preorder(root: Node) -> List[Node]:
    out: List[Node] = []
    stack = [root]
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(reversed(n.children))
    return out


def truncate_preorder(root: Node, max_size: int) -> List[Node]:
    """Prune so the pre-order sequence has ≤ ``max_size`` nodes; set ``num``."""
    seq = preorder(root)
    if max_size > 0 and len(seq) > max_size:
        seq = seq[:max_size]
        kept = set(id(n) for n in seq)
        for n in seq:
            n.children = [c for c in n.children if id(c) in kept]
    for i, n in enumerate(seq):
        n.num = i
    return seq


def build_matrices(seq: List[Node], max_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Signed ancestor (L) and sibling (T) distance matrices, ``max_size²``."""
    L = np.zeros((max_size, max_size), dtype=np.float32)
    T = np.zeros((max_size, max_size), dtype=np.float32)
    for node in seq:
        d = 0
        anc = node.parent
        while anc is not None:
            d += 1
            if anc.num < max_size and node.num < max_size and anc.num >= 0:
                L[anc.num, node.num] = d
                L[node.num, anc.num] = -d
            anc = anc.parent
        ch = [c for c in node.children if 0 <= c.num < max_size]
        for i in range(len(ch)):
            for j in range(i + 1, len(ch)):
                T[ch[i].num, ch[j].num] = j - i
                T[ch[j].num, ch[i].num] = i - j
    return L, T
