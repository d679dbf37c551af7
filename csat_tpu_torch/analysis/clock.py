"""Clock-discipline rule: wall clocks never enter interval arithmetic.

``time.time()`` is NTP-stepped and DST-proof only by luck; any backoff,
deadline, watchdog window or duration computed from it can jump
backwards or stall.  The repo's convention (engine/fleet/watchdog): the
monotonic family for arithmetic, wall clock only as a timestamp stamped
into records.

The rule follows the value, not the call: a ``time.time()`` read is a
finding when it (a) sits directly inside a BinOp/Compare, or (b) is
bound to a local name that later appears in a BinOp/Compare within the
same function.  ``{"ts": time.time()}`` and ``round(time.time(), 3)``
stay legal.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from csat_tpu_torch.analysis.core import FileCtx, Finding, Repo, rule
from csat_tpu_torch.analysis.manifests import WALL_CLOCK_CALLS
from csat_tpu_torch.analysis.visitors import (
    FunctionNode, ancestors, dotted_name)

RULE = "wall-clock"


def _enclosing_function(node: ast.AST, ctx: FileCtx) -> Optional[ast.AST]:
    for anc in ancestors(node, ctx.parents):
        if isinstance(anc, FunctionNode):
            return anc
    return None


def _arith_names(scope: ast.AST) -> Set[str]:
    """Names that appear inside a BinOp or Compare within ``scope``."""
    out: Set[str] = set()
    for node in ast.walk(scope):
        if isinstance(node, (ast.BinOp, ast.Compare)):
            for leaf in ast.walk(node):
                if isinstance(leaf, ast.Name):
                    out.add(leaf.id)
    return out


@rule(RULE,
      "time.time() must not feed interval arithmetic (backoff, "
      "deadlines, durations) — use time.monotonic()/perf_counter()")
def check_wall_clock(repo: Repo) -> Iterator[Finding]:
    for ctx in repo.files():
        arith_cache = {}
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and dotted_name(node.func) in WALL_CLOCK_CALLS):
                continue
            # climb until the VALUE is consumed: a Call/container ancestor
            # means the float left wall-clock land as a record field
            # (round(time.time()) in a dict is legal); BinOp/Compare
            # first means the raw reading entered arithmetic
            direct = False
            for a in ancestors(node, ctx.parents):
                if isinstance(a, (ast.BinOp, ast.Compare)):
                    direct = True
                    break
                if isinstance(a, (ast.Call, ast.Dict, ast.List, ast.Tuple,
                                  ast.Set, ast.FormattedValue, ast.stmt)):
                    break
            if direct:
                yield Finding(
                    ctx.rel, node.lineno, RULE,
                    "time.time() inside interval arithmetic — wall clocks "
                    "step; use time.monotonic()/perf_counter()")
                continue
            # flow: bound DIRECTLY to a name (t0 = time.time()) that
            # later enters arithmetic?  Wrapped/containered values were
            # already cleared by the climb above.
            stmt = next(iter(ancestors(node, ctx.parents)), None)
            if not (isinstance(stmt, ast.Assign) and stmt.value is node):
                continue
            names = {t.id for t in stmt.targets if isinstance(t, ast.Name)}
            if not names:
                continue
            scope = _enclosing_function(node, ctx) or ctx.tree
            if id(scope) not in arith_cache:
                arith_cache[id(scope)] = _arith_names(scope)
            used = names & arith_cache[id(scope)]
            if used:
                yield Finding(
                    ctx.rel, node.lineno, RULE,
                    f"time.time() bound to {sorted(used)[0]!r} which feeds "
                    "interval arithmetic — use "
                    "time.monotonic()/perf_counter()")
