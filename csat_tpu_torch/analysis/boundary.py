"""Boundary rules: the layer manifests, enforced.

Five rules, one per invariant the old ``TestStatic*`` scans carried
(plus the serve-mesh boundary):

* ``private-reach`` — files in a :data:`~csat_tpu_torch.analysis.manifests.
  BOUNDARIES` layer may not touch ``obj._name`` on a non-``self``
  object.
* ``legacy-kernel-import`` — the one-kernel model: nothing imports
  the deleted legacy Pallas kernels.
* ``backend-literal`` — ``models/`` has no backend string constants
  outside docstrings; ``flex_core.select_impl`` is the single dispatch.
* ``mesh-axis-literal`` — ``models/`` and ``serve/`` have no mesh axis
  name string constants; ``parallel/mesh.py`` owns the axis spelling.
* ``injector-ctor-kwargs`` — chaos compiles onto the
  :class:`FaultInjector` ctor's PUBLIC hook kwargs only (checked against
  the ctor's own AST, no import needed).
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from csat_tpu_torch.analysis.core import Finding, Repo, rule
from csat_tpu_torch.analysis.manifests import (
    BACKEND_LITERAL_SCOPE, BACKEND_LITERALS, BOUNDARIES,
    INJECTOR_CALL_FILES, INJECTOR_CLASS_FILE, INJECTOR_CLASS_NAME,
    LEGACY_IMPORT_SCOPE, LEGACY_KERNELS, MESH_AXIS_LITERAL_SCOPE,
    MESH_AXIS_LITERALS)
from csat_tpu_torch.analysis.visitors import docstring_constants


@rule("private-reach",
      "bounded layers compose the rest of the system through public "
      "surfaces only: no `obj._name` access on a non-`self` object")
def check_private_reach(repo: Repo) -> Iterator[Finding]:
    for boundary in BOUNDARIES:
        for rel in boundary.files:
            ctx = repo.ctx(rel)
            if ctx is None or ctx.tree is None:
                continue
            for node in ast.walk(ctx.tree):
                if (isinstance(node, ast.Attribute)
                        and node.attr.startswith("_")
                        and not node.attr.startswith("__")
                        and not (isinstance(node.value, ast.Name)
                                 and node.value.id == "self")):
                    yield Finding(
                        rel, node.lineno, "private-reach",
                        f".{node.attr} reaches into a private surface — "
                        f"the {boundary.name!r} layer must stay on "
                        "public API")


@rule("legacy-kernel-import",
      "no module may import the deleted legacy Pallas kernels "
      "(the one-kernel model)")
def check_legacy_imports(repo: Repo) -> Iterator[Finding]:
    for ctx in repo.files():
        if not ctx.rel.startswith(LEGACY_IMPORT_SCOPE):
            continue
        for node in ast.walk(ctx.tree):
            names: List[str] = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                if set(name.split(".")) & LEGACY_KERNELS:
                    yield Finding(
                        ctx.rel, node.lineno, "legacy-kernel-import",
                        f"imports legacy kernel module {name!r} — "
                        "flex_core + mods is the one programming model")


@rule("backend-literal",
      "models/ and serve/ may not branch on backend name literals; "
      "flex_core.select_impl(cfg.backend) is the single dispatch")
def check_backend_literals(repo: Repo) -> Iterator[Finding]:
    for ctx in repo.files():
        if not ctx.rel.startswith(BACKEND_LITERAL_SCOPE):
            continue
        docs = docstring_constants(ctx.tree)
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Constant)
                    and node.value in BACKEND_LITERALS
                    and id(node) not in docs):
                yield Finding(
                    ctx.rel, node.lineno, "backend-literal",
                    f"backend literal {node.value!r} outside a docstring "
                    "— dispatch through flex_core.select_impl")


@rule("mesh-axis-literal",
      "models/ and serve/ may not spell mesh axis names as string "
      "literals; parallel/mesh.py constants are the one spelling")
def check_mesh_axis_literals(repo: Repo) -> Iterator[Finding]:
    for ctx in repo.files():
        if not ctx.rel.startswith(MESH_AXIS_LITERAL_SCOPE):
            continue
        docs = docstring_constants(ctx.tree)
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Constant)
                    and node.value in MESH_AXIS_LITERALS
                    and id(node) not in docs):
                yield Finding(
                    ctx.rel, node.lineno, "mesh-axis-literal",
                    f"mesh axis literal {node.value!r} outside a docstring "
                    "— use the parallel/mesh.py axis constants "
                    "(DATA_AXIS, HEAD_AXIS, ...) and constrain helpers")


def injector_ctor_params(repo: Repo) -> Optional[Tuple[str, ...]]:
    """The :class:`FaultInjector` ctor's kwarg names, read from its AST
    (None when the class file is absent — fixture repos)."""
    ctx = repo.ctx(INJECTOR_CLASS_FILE)
    if ctx is None or ctx.tree is None:
        return None
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef) and node.name == INJECTOR_CLASS_NAME:
            for item in node.body:
                if (isinstance(item, ast.FunctionDef)
                        and item.name == "__init__"):
                    args = item.args
                    names = [a.arg for a in args.posonlyargs + args.args
                             if a.arg != "self"]
                    names += [a.arg for a in args.kwonlyargs]
                    if args.kwarg is not None:
                        return None  # **kwargs: surface is open, rule moot
                    return tuple(names)
    return None


def injector_ctor_calls(repo: Repo) -> List[Tuple[str, ast.Call]]:
    """Every ``FaultInjector(...)`` construction in the manifest's call
    files — exposed so tests can assert the compile path still exists."""
    out: List[Tuple[str, ast.Call]] = []
    for rel in INJECTOR_CALL_FILES:
        ctx = repo.ctx(rel)
        if ctx is None or ctx.tree is None:
            continue
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == INJECTOR_CLASS_NAME):
                out.append((rel, node))
    return out


@rule("injector-ctor-kwargs",
      "FaultPlan compiles onto FaultInjector's public ctor kwargs only, "
      "passed by keyword — a hook rename breaks here, not at drill time")
def check_injector_kwargs(repo: Repo) -> Iterator[Finding]:
    params = injector_ctor_params(repo)
    if params is None:
        return
    allowed = set(params)
    for rel, call in injector_ctor_calls(repo):
        if call.args:
            yield Finding(
                rel, call.lineno, "injector-ctor-kwargs",
                "FaultInjector hooks must be passed by keyword")
        for kw in call.keywords:
            if kw.arg is None:
                yield Finding(
                    rel, call.lineno, "injector-ctor-kwargs",
                    "FaultInjector hooks must be literal keywords, not a "
                    "**splat — the compile surface must be checkable")
            elif kw.arg not in allowed:
                yield Finding(
                    rel, call.lineno, "injector-ctor-kwargs",
                    f"{kw.arg!r} is not a FaultInjector ctor kwarg "
                    f"(public hooks: {', '.join(sorted(allowed))})")
