"""L0 — AST extraction: source code → the ``ast.original`` JSON node list.

A copy of the stdlib-``ast`` backend of the JAX package's
``data/extract.py`` (which imports no JAX; the port imports nothing of that
package): parse a Python function, build a DFS-ordered node graph where

* non-terminals are ``"nont:<type>:<start>:<end>:<idx>"``;
* identifier leaves are ``"idt:<token>:<start>:<end>:<idx>"``; snake_case /
  camelCase identifiers are split into sub-token **chains**, each split
  becoming a chained child of the previous one;
* string and number literals and punctuation are skipped;

in the schema ``data/ast_tools.py:ast_json_to_tree`` consumes:
``{"label": ..., "children": [child labels]}`` with **1-indexed** trailing
ids.  Node *types* are CPython AST class names.  The tree-sitter backend is
not carried: other languages raise the JAX package's error when no
tree-sitter grammar is importable.
"""

from __future__ import annotations

import ast as py_ast
from typing import List, Optional

__all__ = ["split_camelcase", "split_identifier_into_parts", "python_to_ast_json",
           "source_to_ast_json"]


def split_camelcase(token: str) -> List[str]:
    """``camelCaseHTTP2Word`` → ``['camel', 'Case', 'HTTP', '2', 'Word']``.

    Behavior-equivalent to the reference splitter
    (ref ``py/process_utils.py:split_camelcase``): a new word starts at a
    lower→upper, alpha→digit, or alnum→special boundary; a run of uppers
    followed by a lower keeps its last upper as the next word's head
    (``HTTPWord`` → ``HTTP``, ``Word``).
    """
    if not token:
        return []
    parts: List[str] = []
    cur = token[0]
    for ch in token[1:]:
        prev = cur[-1]
        new_upper = ch.isupper() and not prev.isupper()
        new_digit = ch.isdigit() and not prev.isdigit()
        new_special = (not ch.isalnum()) and prev.isalnum()
        left_digit = (not ch.isdigit()) and prev.isdigit()
        left_special = ch.isalnum() and not prev.isalnum()
        if new_upper or new_digit or new_special:
            parts.append(cur)
            cur = ch
        elif not ch.isupper() and prev.isupper() and len(cur) > 1:
            # end of an upper run: its last char heads the new word
            parts.append(cur[:-1])
            cur = cur[-1] + ch
        elif left_digit or left_special:
            parts.append(cur)
            cur = ch
        else:
            cur += ch
    parts.append(cur)
    return parts


def split_identifier_into_parts(identifier: str) -> List[str]:
    """snake_case first, then camelCase within each part, **lowercased**
    (ref ``py/process_utils.py:106-119``)."""
    out: List[str] = []
    for snake in identifier.split("_"):
        if not snake:
            continue
        out.extend(s.lower() for s in split_camelcase(snake))
    return out or [identifier]


class _NodeGraph:
    """Accumulates DFS-ordered nodes with reference label syntax."""

    def __init__(self) -> None:
        self.labels: List[str] = []
        self.children: List[List[int]] = []

    def add(self, kind: str, value: str, start: int, end: int) -> int:
        value = value.replace(":", "") or "_"
        idx = len(self.labels) + 1  # 1-indexed ids (ref my_ast.py:118-119)
        self.labels.append(f"{kind}:{value}:{start}:{end}:{idx}")
        self.children.append([])
        return idx

    def link(self, parent: int, child: int) -> None:
        self.children[parent - 1].append(child)

    def add_identifier_chain(self, parent: int, token: str, start: int, end: int) -> None:
        """Sub-token chain: each split is a child of the previous split
        (ref ``py/process_utils.py:222-229``)."""
        prev = parent
        for part in split_identifier_into_parts(token):
            node = self.add("idt", part, start, end)
            self.link(prev, node)
            prev = node

    def to_json(self) -> List[dict]:
        out = []
        for label, kids in zip(self.labels, self.children):
            rec: dict = {"label": label}
            if kids:
                rec["children"] = [self.labels[k - 1] for k in kids]
            out.append(rec)
        return out


def _py_walk(graph: _NodeGraph, node: py_ast.AST, parent: Optional[int]) -> None:
    kind = type(node).__name__
    start = getattr(node, "lineno", 0) or 0
    end = getattr(node, "end_lineno", start) or start
    me = graph.add("nont", kind, start, end)
    if parent is not None:
        graph.link(parent, me)

    # identifier-bearing fields become idt sub-token chains; string/number
    # literals and pure punctuation are skipped (ref process_utils.py:201+)
    for field in ("name", "id", "attr", "arg", "module"):
        val = getattr(node, field, None)
        if isinstance(val, str) and val:
            graph.add_identifier_chain(me, val, start, end)
    for child in py_ast.iter_child_nodes(node):
        if isinstance(child, (py_ast.Load, py_ast.Store, py_ast.Del)):
            continue  # expression-context markers carry no structure
        _py_walk(graph, child, me)


def python_to_ast_json(source: str) -> List[dict]:
    """One Python function/module source → JSON node list (``ast.original``
    line format)."""
    tree = py_ast.parse(source)
    # a single top-level def is the common corpus shape; descend into it so
    # the root is the function, matching the reference's per-function trees
    root: py_ast.AST = tree
    if isinstance(tree, py_ast.Module) and len(tree.body) == 1:
        root = tree.body[0]
    graph = _NodeGraph()
    _py_walk(graph, root, None)
    return graph.to_json()



def source_to_ast_json(source: str, language: str = "python") -> List[dict]:
    """Python source → node list through the stdlib ``ast``; any other
    language raises, as the JAX package does without its grammar."""
    if language != "python":
        raise RuntimeError(
            f"extracting {language!r} requires the tree_sitter_{language} grammar; "
            "only Python has a stdlib fallback"
        )
    return python_to_ast_json(source)
