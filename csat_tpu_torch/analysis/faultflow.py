"""Swallowed-fault rule: fault paths degrade structurally, never silently.

The contract: every serve/resilience failure mode comes back as a
structured outcome — a ``warmstart_miss{reason}``, a terminal request
status, a ``fleet.spawn_failed`` event — never a silently-eaten
exception.  A bare/broad ``except`` inside
:data:`~csat_tpu_torch.analysis.manifests.FAULT_SCOPES` must therefore either
re-raise or call something from the structured-event vocabulary
(:data:`EVENT_MARKERS`: ``obs.emit``, ``stats.record_*``,
``self._note_fault``, ``self._finish``, ``counter.inc``, …) inside the
handler body.  Deliberate keepers (e.g. "diagnostics must not mask the
abort") carry an inline suppression with a reason.
"""

from __future__ import annotations

import ast
from typing import Iterator

from csat_tpu_torch.analysis.core import Finding, Repo, rule
from csat_tpu_torch.analysis.manifests import (
    BROAD_EXCEPTIONS, EVENT_MARKER_NAMES, EVENT_MARKERS, FAULT_SCOPES)
from csat_tpu_torch.analysis.visitors import dotted_name

RULE = "swallowed-fault"


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for node in types:
        name = dotted_name(node)
        if name is not None and name.split(".")[-1] in BROAD_EXCEPTIONS:
            return True
    return False


def _is_structured(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = None
            if isinstance(node.func, ast.Attribute):
                name = node.func.attr
            elif isinstance(node.func, ast.Name):
                name = node.func.id
            if name is None:
                continue
            low = name.lower()
            if low in EVENT_MARKER_NAMES or any(
                    m in low for m in EVENT_MARKERS):
                return True
    return False


@rule(RULE,
      "broad excepts on serve/resilience fault paths must re-raise or "
      "emit a structured event/metric/terminal outcome")
def check_swallowed_faults(repo: Repo) -> Iterator[Finding]:
    for ctx in repo.files():
        if not ctx.rel.startswith(FAULT_SCOPES):
            continue
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _is_broad(node) and not _is_structured(node):
                caught = ("bare except" if node.type is None
                          else f"except {ast.unparse(node.type)}")
                yield Finding(
                    ctx.rel, node.lineno, RULE,
                    f"{caught} neither re-raises nor emits a structured "
                    "event — the fault's reason is dropped on the floor")
