"""AST core: tree building, pre-order truncation, and L/T relative matrices.

Capability parity with the reference's ``my_ast.py`` (the reference's ``my_ast.py``):

* ``ast_json_to_tree`` — JSON node list → linked ``Node`` tree
  (ref ``my_ast.py:103-126``; child ids are 1-indexed in the JSON).
* ``truncate_preorder`` — prune the tree so its pre-order traversal has at
  most ``max_size`` nodes, assigning each surviving node its pre-order index
  ``num`` (ref ``__sub_tree``, ``my_ast.py:129-143``).
* ``build_matrices`` — signed ancestor-distance matrix ``L`` and signed
  sibling-distance matrix ``T``: for an ancestor ``a`` at tree-path distance
  ``d`` above descendant ``x``, ``L[a,x]=+d`` and ``L[x,a]=-d``; for siblings
  ``s_i``, ``s_j`` (children of one parent, positions i<j), ``T[s_i,s_j]=j-i``
  and ``T[s_j,s_i]=i-j`` (ref ``__get_matrices``, ``my_ast.py:198-273``).
  All other pairs are 0 — which is also the "unrelated" sentinel the masks
  key off downstream.

Everything here is plain Python/NumPy: it runs on host CPU before batches are
shipped to the TPU, so there is no JAX in this module.

The port's own copy of the JAX package's ``data/ast_tools.py`` (host-only code, no JAX
in it); ``tests/test_torch_data.py`` holds the two together.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Node",
    "ast_json_to_tree",
    "preorder",
    "truncate_preorder",
    "build_matrices",
    "TreeRecord",
    "tree_to_record",
    "split_variable",
]


class Node:
    """One AST node. ``label`` is ``"kind:value:orig_idx"``.

    ``child_idx`` is the position among the parent's children; ``level`` is
    the depth below the root; ``num`` is the pre-order index assigned by
    :func:`truncate_preorder`.
    """

    __slots__ = (
        "label",
        "parent",
        "children",
        "child_idx",
        "level",
        "num",
        "start_lineno",
        "end_lineno",
    )

    def __init__(self, label: str = ""):
        self.label = label
        self.parent: Optional["Node"] = None
        self.children: List["Node"] = []
        self.child_idx: int = -1
        self.level: int = 0
        self.num: int = -1
        self.start_lineno: int = -1
        self.end_lineno: int = -1

    @property
    def kind(self) -> str:
        return self.label.split(":")[0]

    @property
    def value(self) -> str:
        # middle fields of "kind:value:idx" (values may themselves contain ':')
        return ":".join(self.label.split(":")[1:-1])

    def __repr__(self) -> str:  # pragma: no cover
        return f"Node({self.label!r}, n_children={len(self.children)})"


def ast_json_to_tree(ast_json: Sequence[dict]) -> Node:
    """Build a linked tree from one JSON AST (a list of node dicts).

    Each dict has ``label`` = ``"kind:value:start:end:idx"`` and optionally
    ``children`` = list of child labels whose trailing ``:idx`` field is a
    **1-indexed** node id (ref ``my_ast.py:108-122``). The stored label drops
    the line-number fields, keeping ``"kind:value:idx"``.
    """
    nodes = [Node() for _ in ast_json]
    for i, attr in enumerate(ast_json):
        parts = attr["label"].split(":")
        node = nodes[i]
        node.label = ":".join(parts[:-3] + [parts[-1]])
        node.start_lineno = int(parts[-3])
        node.end_lineno = int(parts[-2])
        for child_pos, child_ref in enumerate(attr.get("children", ())):
            child_id = int(child_ref.split(":")[-1]) - 1
            child = nodes[child_id]
            child.parent = node
            child.child_idx = child_pos
            node.children.append(child)
    root = nodes[0]
    _assign_levels(root)
    return root


def _assign_levels(root: Node) -> None:
    stack = [(root, 0)]
    while stack:
        node, lvl = stack.pop()
        node.level = lvl
        for c in node.children:
            stack.append((c, lvl + 1))


def preorder(root: Node) -> List[Node]:
    """Pre-order (root-first) traversal."""
    out: List[Node] = []
    stack = [root]
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(reversed(n.children))
    return out


def truncate_preorder(root: Node, max_size: int) -> List[Node]:
    """Prune so the pre-order sequence has ≤ ``max_size`` nodes; set ``num``.

    Children falling wholly beyond the budget are dropped from their parent's
    child list, matching the reference's in-place pruning
    (``my_ast.py:129-143``). Returns the surviving pre-order sequence.
    """
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
    """Signed ancestor (L) and sibling (T) distance matrices, ``max_size²``.

    Semantics per ``my_ast.py:228-263``: distances are path lengths along
    root-to-leaf ancestor chains (L) and positional gaps within one node's
    child list (T); the first-in-pre-order member of a pair gets ``+d``, the
    other ``-d``. Nodes are indexed by their pre-order ``num``.
    """
    L = np.zeros((max_size, max_size), dtype=np.float32)
    T = np.zeros((max_size, max_size), dtype=np.float32)
    for node in seq:
        # ancestor chain: walk up from `node`, distance = #edges climbed
        d = 0
        anc = node.parent
        while anc is not None:
            d += 1
            if anc.num < max_size and node.num < max_size and anc.num >= 0:
                L[anc.num, node.num] = d
                L[node.num, anc.num] = -d
            anc = anc.parent
        # sibling gaps among this node's children
        ch = [c for c in node.children if 0 <= c.num < max_size]
        for i in range(len(ch)):
            for j in range(i + 1, len(ch)):
                gap = j - i
                T[ch[i].num, ch[j].num] = gap
                T[ch[j].num, ch[i].num] = -gap
    return L, T


class TreeRecord:
    """Plain-array snapshot of one processed tree (pickles without the class
    graph of linked ``Node`` objects; this is what ``split_matrices.npz``
    stores per sample in the ``root_first_seq`` slot).
    """

    __slots__ = ("labels", "parent_idx", "child_idx", "levels")

    def __init__(self, labels, parent_idx, child_idx, levels):
        self.labels = list(labels)  # "kind:value:orig_idx" per node
        self.parent_idx = np.asarray(parent_idx, dtype=np.int32)  # -1 for root
        self.child_idx = np.asarray(child_idx, dtype=np.int32)
        self.levels = np.asarray(levels, dtype=np.int32)

    def __len__(self) -> int:
        return len(self.labels)

    def children_of(self, i: int) -> List[int]:
        return [j for j in range(len(self)) if self.parent_idx[j] == i]


def tree_to_record(seq: List[Node]) -> TreeRecord:
    num_of = {id(n): n.num for n in seq}
    parent_idx = [
        num_of[id(n.parent)] if n.parent is not None and id(n.parent) in num_of else -1
        for n in seq
    ]
    return TreeRecord(
        labels=[n.label for n in seq],
        parent_idx=parent_idx,
        child_idx=[n.child_idx for n in seq],
        levels=[n.level for n in seq],
    )


_CAMEL_RE = re.compile(r".+?(?:(?<=[a-z])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])|$)")


def split_variable(name: str) -> List[str]:
    """snake_case + CamelCase identifier splitting, lowercased
    (ref ``my_ast.py:285-297``)."""
    blocks: List[str] = []
    for chunk in name.split("_"):
        blocks.extend(m.group(0) for m in _CAMEL_RE.finditer(chunk))
    return [b.lower() for b in blocks]
