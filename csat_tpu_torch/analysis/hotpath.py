"""Host-sync rule: no device syncs on the serving hot path.

Two scopes, both manifest-driven:

* :data:`ZERO_SYNC_MODULES` (trace path, SLO math, router, streaming
  client): ANY device interaction is a finding — sync reads, host copies
  (``.cpu()``, ``.numpy()``, ``.tolist()``, ``torch.as_tensor``,
  ``np.asarray``), even plain ``torch.*`` calls.
* :data:`HOT_ROOTS` call graphs (engine tick/submit/poll, front door
  step/drain, expanded through same-module calls, stopping at declared
  cold boundaries): the sync reads — ``.item()``, ``.synchronize()``,
  ``torch.cuda.synchronize`` — plus ``float()``/``int()``/truthiness on
  names the per-function inference knows are device tensors.

The engine's one deliberate read per tick (the packed status fetch in
``_tick_body``) and result readbacks stay legal because they go through
host copies (``.cpu()`` / ``.numpy()`` / ``.tolist()``), which only the
zero-sync scope bans, as the JAX package's go through ``np.asarray`` — the
tick graph ban is on the patterns that silently serialize the stream.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from csat_tpu_torch.analysis.core import FileCtx, Finding, Repo, rule
from csat_tpu_torch.analysis.manifests import (
    COLD_BOUNDARIES, DEVICE_ROOTS, HOT_ROOTS, SYNC_ATTR_CALLS,
    SYNC_DOTTED_CALLS, TRANSFER_ATTR_CALLS, TRANSFER_DOTTED_CALLS,
    ZERO_SYNC_MODULES)
from csat_tpu_torch.analysis.visitors import (
    call_graph_closure, device_array_names, dotted_name)

RULE = "host-sync"


def _sync_findings(ctx: FileCtx, func: ast.AST, where: str,
                   zero_sync: bool) -> Iterator[Finding]:
    arrays: Set[str] = device_array_names(func, DEVICE_ROOTS)

    def is_array(node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in arrays
        if isinstance(node, ast.Subscript):
            return is_array(node.value)
        if isinstance(node, ast.Call):
            d = dotted_name(node.func)
            return d is not None and d.split(".")[0] in DEVICE_ROOTS
        return False

    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            f = node.func
            dotted = dotted_name(f)
            if (isinstance(f, ast.Attribute) and f.attr in SYNC_ATTR_CALLS
                    and not node.args):
                yield Finding(
                    ctx.rel, node.lineno, RULE,
                    f".{f.attr}() is a device sync inside {where}")
            elif dotted in SYNC_DOTTED_CALLS:
                yield Finding(
                    ctx.rel, node.lineno, RULE,
                    f"{dotted}() is a device sync inside {where}")
            elif zero_sync and dotted in TRANSFER_DOTTED_CALLS:
                yield Finding(
                    ctx.rel, node.lineno, RULE,
                    f"{dotted}() transfers to host inside {where} — this "
                    "scope must not touch arrays at all")
            elif (zero_sync and isinstance(f, ast.Attribute)
                    and f.attr in TRANSFER_ATTR_CALLS and not node.args):
                yield Finding(
                    ctx.rel, node.lineno, RULE,
                    f".{f.attr}() copies to host inside {where} — this "
                    "scope must not touch tensors at all")
            elif zero_sync and dotted is not None and (
                    dotted.split(".")[0] in DEVICE_ROOTS):
                yield Finding(
                    ctx.rel, node.lineno, RULE,
                    f"{dotted}() does device work inside {where} — this "
                    "scope is host-clock/host-data only")
            elif (isinstance(f, ast.Name) and f.id in ("float", "int", "bool")
                    and len(node.args) == 1 and is_array(node.args[0])):
                yield Finding(
                    ctx.rel, node.lineno, RULE,
                    f"{f.id}() on a device array syncs inside {where}")
        elif isinstance(node, (ast.If, ast.While)):
            if is_array(node.test):
                yield Finding(
                    ctx.rel, node.lineno, RULE,
                    f"array truthiness syncs the device inside {where}")
        elif isinstance(node, ast.BoolOp):
            for v in node.values:
                if is_array(v):
                    yield Finding(
                        ctx.rel, v.lineno, RULE,
                        f"array truthiness syncs the device inside {where}")


def hot_graph(repo: Repo, rel: str):
    """The expanded hot call graph for ``rel`` (qualname → def node)."""
    ctx = repo.ctx(rel)
    if ctx is None or ctx.tree is None:
        return {}
    return call_graph_closure(
        ctx.tree, HOT_ROOTS[rel], set(COLD_BOUNDARIES))


@rule(RULE,
      "no device syncs in the engine tick/submit call graph; no device "
      "work at all on the trace/SLO/router path")
def check_host_sync(repo: Repo) -> Iterator[Finding]:
    for rel in ZERO_SYNC_MODULES:
        ctx = repo.ctx(rel)
        if ctx is None or ctx.tree is None:
            continue
        yield from _sync_findings(
            ctx, ctx.tree, f"zero-sync module {rel}", zero_sync=True)
    for rel in HOT_ROOTS:
        ctx = repo.ctx(rel)
        if ctx is None or ctx.tree is None:
            continue
        for qual, func in hot_graph(repo, rel).items():
            yield from _sync_findings(
                ctx, func, f"hot-path function {qual}", zero_sync=False)
