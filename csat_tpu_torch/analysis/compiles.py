"""Untracked-compile rule: steady state must not build programs.

The port's compile constructors
(:data:`~csat_tpu_torch.analysis.manifests.COMPILE_DOTTED_CALLS`) are
``torch.compile``, CUDA graph capture and the kernel library build and
load of ``ops/build.py``:

* one constructed lexically inside a ``for`` / ``while`` loop — anywhere
  in the lint targets — builds a program object (or asks the library
  cache) per iteration, the JAX package's ``jax.jit``-in-a-loop bug;
* one inside the serving hot graph
  (:data:`~csat_tpu_torch.analysis.manifests.HOT_ROOTS`, same expansion
  as the host-sync rule) is a per-tick/per-request compile — UNLESS it
  sits under an ``if <x> is None:`` cache-miss guard, the tracked compile
  idiom.  The engine's library warm-up is a declared cold boundary
  (:data:`~csat_tpu_torch.analysis.manifests.COLD_BOUNDARIES`).
"""

from __future__ import annotations

import ast
from typing import Iterator

from csat_tpu_torch.analysis.core import FileCtx, Finding, Repo, rule
from csat_tpu_torch.analysis.manifests import COMPILE_DOTTED_CALLS, HOT_ROOTS
from csat_tpu_torch.analysis.visitors import ancestors, dotted_name

RULE = "untracked-compile"


def _compile_calls(node: ast.AST) -> Iterator[ast.Call]:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and dotted_name(n.func) in COMPILE_DOTTED_CALLS:
            yield n


def _is_cache_miss_guarded(call: ast.Call, ctx: FileCtx) -> bool:
    """True when an ancestor ``if`` tests ``<expr> is None`` — the
    compile-once-then-cache idiom."""
    for anc in ancestors(call, ctx.parents):
        if isinstance(anc, ast.If):
            test = anc.test
            if (isinstance(test, ast.Compare)
                    and len(test.ops) == 1
                    and isinstance(test.ops[0], ast.Is)
                    and isinstance(test.comparators[0], ast.Constant)
                    and test.comparators[0].value is None):
                return True
    return False


@rule(RULE,
      "no torch.compile / CUDA graph capture / kernel library build "
      "inside loops, and none in the serving hot graph outside an "
      "`is None` cache-miss guard")
def check_untracked_compiles(repo: Repo) -> Iterator[Finding]:
    for ctx in repo.files():
        for call in _compile_calls(ctx.tree):
            for anc in ancestors(call, ctx.parents):
                if isinstance(anc, (ast.For, ast.While, ast.AsyncFor)):
                    yield Finding(
                        ctx.rel, call.lineno, RULE,
                        f"{dotted_name(call.func)}() constructed inside a "
                        "loop — build the program once outside and reuse it")
                    break
    from csat_tpu_torch.analysis.hotpath import hot_graph
    for rel in HOT_ROOTS:
        ctx = repo.ctx(rel)
        if ctx is None or ctx.tree is None:
            continue
        for qual, func in hot_graph(repo, rel).items():
            for call in _compile_calls(func):
                if not _is_cache_miss_guarded(call, ctx):
                    yield Finding(
                        ctx.rel, call.lineno, RULE,
                        f"{dotted_name(call.func)}() in hot-path function "
                        f"{qual} without an `is None` cache-miss guard — "
                        "this compiles per tick/request and breaks the "
                        "zero-steady-state-recompile tripwire")
