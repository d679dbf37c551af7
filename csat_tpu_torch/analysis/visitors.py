"""Shared AST machinery for the csat-lint rules.

Everything here is pure, source-only analysis: no module under lint is
ever imported (importing ``csat_tpu_torch.serve.engine`` would pull in torch
and the kernel loader — a linter must stay cheap and side-effect free).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_functions(
        tree: ast.Module) -> Iterator[Tuple[str, ast.AST, Optional[str]]]:
    """Yield ``(qualname, node, class_name)`` for every def in the
    module, depth-first.  Methods are ``Class.method``; nested defs are
    ``outer.inner`` (module-level) / ``Class.method.inner``."""

    def visit(node: ast.AST, prefix: str, cls: Optional[str]):
        for child in getattr(node, "body", []):
            if isinstance(child, FunctionNode):
                yield prefix + child.name, child, cls
                yield from visit(child, prefix + child.name + ".", cls)
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, prefix + child.name + ".", child.name)

    yield from visit(tree, "", None)


def parent_map(tree: ast.Module) -> Dict[int, ast.AST]:
    """``id(child) -> parent`` for every node in the tree."""
    out: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


def ancestors(node: ast.AST, parents: Dict[int, ast.AST]) -> Iterator[ast.AST]:
    cur = parents.get(id(node))
    while cur is not None:
        yield cur
        cur = parents.get(id(cur))


def call_graph_closure(tree: ast.Module, roots: Tuple[str, ...],
                       stop: Set[str]) -> Dict[str, ast.AST]:
    """Expand ``roots`` (qualnames) through the module's own call graph.

    Resolution is intentionally local: ``self.x()`` inside class ``C``
    resolves to ``C.x``; a bare ``f()`` resolves to module-level ``f``.
    Cross-module calls are not followed — each module declares its own
    hot roots.  ``stop`` names are reachable-but-not-entered (declared
    cold boundaries)."""
    funcs: Dict[str, ast.AST] = {}
    cls_of: Dict[str, Optional[str]] = {}
    for qual, node, cls in iter_functions(tree):
        funcs[qual] = node
        cls_of[qual] = cls

    def callees(qual: str) -> Set[str]:
        cls = cls_of.get(qual)
        out: Set[str] = set()
        for n in ast.walk(funcs[qual]):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if (cls and isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name) and f.value.id == "self"):
                out.add(f"{cls}.{f.attr}")
            elif isinstance(f, ast.Name):
                out.add(f.id)
        return out

    seen: Dict[str, ast.AST] = {}
    queue = [r for r in roots if r in funcs]
    while queue:
        qual = queue.pop()
        if qual in seen or qual in stop:
            continue
        seen[qual] = funcs[qual]
        queue.extend(c for c in callees(qual) if c in funcs and c not in seen)
    return seen


def docstring_constants(tree: ast.Module) -> Set[int]:
    """``id()`` of every Constant node that is a docstring."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef) + FunctionNode):
            body = getattr(node, "body", [])
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                out.add(id(body[0].value))
    return out


def device_array_names(func: ast.AST, roots: frozenset) -> Set[str]:
    """Names assigned (anywhere in ``func``) from a call rooted at a
    device namespace (``torch.*``) — the linter's lightweight
    stand-in for type inference.  Tuple unpacking marks every target."""
    out: Set[str] = set()
    for node in ast.walk(func):
        if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            continue
        value = node.value
        if value is None or not isinstance(value, ast.Call):
            continue
        name = dotted_name(value.func)
        if name is None or name.split(".")[0] not in roots:
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            for leaf in ast.walk(t):
                if isinstance(leaf, ast.Name):
                    out.add(leaf.id)
    return out


def assigned_names(stmt: ast.AST) -> Set[str]:
    """Plain-Name targets bound by an assignment/for/with statement."""
    out: Set[str] = set()
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.For):
        targets = [stmt.target]
    elif isinstance(stmt, ast.withitem) and stmt.optional_vars is not None:
        targets = [stmt.optional_vars]
    for t in targets:
        for leaf in ast.walk(t):
            if isinstance(leaf, ast.Name):
                out.add(leaf.id)
    return out
