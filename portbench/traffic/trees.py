"""Random ASTs with real tree structure, and their distance planes.

A frozen copy of the port's seeded tree draw (``data/synthetic.py``
``random_ast`` / ``grow_ast``): each new node hangs under one of the last
six nodes drawn, which gives both deep ancestor chains (the L plane) and
wide sibling lists (the T plane).  The planes follow the port's tree-distance
derivation (``data/ast_tools.py`` ``build_matrices``, the reference's
``my_ast.py``) over the pre-order numbering: for an ancestor ``a`` at depth
distance ``d`` above ``x``, ``L[a, x] = d`` and ``L[x, a] = -d``; for
siblings at child positions ``i < j``, ``T[s_i, s_j] = j - i`` and
``T[s_j, s_i] = i - j``; every other pair 0.  Here it is vectorised with
NumPy, so a run makes thousands of trees in its set-up.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["draw_parents", "distance_planes"]


def draw_parents(rng: np.random.Generator, num_nodes: int) -> np.ndarray:
    """Parent of each node in draw order (-1 for the root): node ``i``
    hangs under a node drawn uniformly from ``[max(0, i - 6), i)``."""
    i = np.arange(num_nodes)
    lo = np.maximum(0, i - 6)
    parent = lo + np.floor(rng.random(num_nodes) * (i - lo)).astype(np.int64)
    parent[0] = -1
    return parent


def _preorder(parent: np.ndarray) -> np.ndarray:
    """Pre-order index of each node (children in draw order)."""
    n = len(parent)
    children = [[] for _ in range(n)]
    for c in range(1, n):
        children[parent[c]].append(c)
    order = np.empty(n, np.int64)
    stack, k = [0], 0
    while stack:
        v = stack.pop()
        order[v] = k
        k += 1
        stack.extend(reversed(children[v]))
    return order


def distance_planes(parent: np.ndarray, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(L, T)`` int16 ``(width, width)`` planes of the tree ``parent``
    (draw order), indexed by pre-order number."""
    n = len(parent)
    pre = _preorder(parent)
    par = np.full(n, -1, np.int64)           # parent in pre-order numbering
    par[pre[1:]] = pre[parent[1:]]
    pos = np.zeros(n, np.int64)              # position among the parent's children
    seen = np.zeros(n, np.int64)
    for c in range(1, n):                     # draw order = child order
        pos[pre[c]] = seen[parent[c]]
        seen[parent[c]] += 1
    L = np.zeros((width, width), np.int16)
    T = np.zeros((width, width), np.int16)
    nodes = np.arange(n)
    anc = par.copy()
    d = 1
    while True:
        live = anc >= 0
        if not live.any():
            break
        x, a = nodes[live], anc[live]
        L[a, x] = d
        L[x, a] = -d
        anc = np.where(live, par[np.maximum(anc, 0)], -1)
        d += 1
    same = (par[:, None] == par[None, :]) & (par[:, None] >= 0)
    np.fill_diagonal(same, False)
    T[:n, :n] = np.where(same, pos[None, :] - pos[:, None], 0)
    return L, T
