"""RNG-discipline rules: a seed feeds ONE stream; every draw names its
generator.

``rng-reuse`` — the counter-hash stream of ``ops/hashrng.py``
(:data:`~csat_tpu_torch.analysis.manifests.HASH_CONSUMERS`:
``hash_bits``, ``uniform_field``, ``block_uniform``, ``KeyedStream``) is a
pure function of its seed and the draw's indices, as a ``jax.random``
consumer is of its key: passing the same seed name to two draws without an
intervening rebinding (a fresh seed drawn from the step's generator, or
one derived by hashing) yields the same bits twice — the classic silent
statistics bug.  The checker simulates each function body in statement
order, tracking which seed names have already fed a draw:

* a draw whose seed argument is not a plain name (a fresh derivation, a
  subscript, an attribute) consumes nothing;
* assignment rebinds: ``seed = draw_seed(gen)`` clears the name;
* loop bodies are simulated twice, so a draw from a seed defined OUTSIDE
  the loop (same stream every iteration) is caught even though it
  appears once lexically;
* ``if``/``else`` branches are simulated on copies and unioned — two
  exclusive branches may both draw from a seed, but a use after the
  conditional still counts as reuse.

``rng-implicit`` — a torch draw without ``generator=``, a ``*_like`` draw
(which takes none), or a draw from numpy's or the stdlib's global state
reads a generator nobody seeded for this run: the port's counterpart of
an implicit key.  Every draw names an explicit ``torch.Generator`` /
``np.random.Generator`` / ``random.Random``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple

from csat_tpu_torch.analysis.core import Finding, Repo, rule
from csat_tpu_torch.analysis.manifests import (
    GLOBAL_TORCH_DRAWS, HASH_CONSUMERS, NUMPY_GENERATOR_MAKERS,
    STDLIB_GENERATORS, TENSOR_DRAWS, TORCH_DRAWS)
from csat_tpu_torch.analysis.visitors import (
    FunctionNode, assigned_names, dotted_name)

RULE = "rng-reuse"
IMPLICIT_RULE = "rng-implicit"


def _hash_fn(call: ast.Call) -> Optional[str]:
    """``uniform_field`` for ``uniform_field(...)`` /
    ``hashrng.uniform_field(...)``; None for anything else."""
    d = dotted_name(call.func)
    if d is None:
        return None
    name = d.split(".")[-1]
    return name if name in HASH_CONSUMERS else None


def _seed_args(call: ast.Call, fn: str) -> List[ast.AST]:
    positions, names = HASH_CONSUMERS[fn]
    out = [call.args[i] for i in positions if i < len(call.args)]
    out += [kw.value for kw in call.keywords if kw.arg in names]
    return out


class _Sim:
    def __init__(self, rel: str):
        self.rel = rel
        self.findings: List[Finding] = []

    def run(self, body: List[ast.stmt], consumed: Dict[str, Tuple[int, int]]) -> None:
        for stmt in body:
            self._stmt(stmt, consumed)

    def _stmt(self, stmt: ast.stmt, consumed: Dict[str, Tuple[int, int]]) -> None:
        if isinstance(stmt, FunctionNode + (ast.ClassDef,)):
            return  # nested defs are separate scopes, simulated separately
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            self._expr_events(stmt, consumed, own_body=True)
            for _ in range(2):  # a loop body runs "at least twice"
                body_consumed = consumed
                for s in stmt.body:
                    self._stmt(s, body_consumed)
            self.run(stmt.orelse, consumed)
            return
        if isinstance(stmt, ast.If):
            self._expr_events(stmt, consumed, own_body=True)
            branches = []
            for body in (stmt.body, stmt.orelse):
                c = dict(consumed)
                self.run(body, c)
                branches.append(c)
            consumed.clear()
            for c in branches:
                consumed.update(c)
            return
        if isinstance(stmt, ast.Try):
            for body in (stmt.body, stmt.orelse, stmt.finalbody):
                self.run(body, consumed)
            for h in stmt.handlers:
                self.run(h.body, consumed)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._expr_events(stmt, consumed, own_body=True)
            self.run(stmt.body, consumed)
            return
        self._expr_events(stmt, consumed, own_body=False)
        # rebinding clears consumption — the new value is a new stream
        for name in assigned_names(stmt):
            consumed.pop(name, None)

    def _expr_events(self, stmt: ast.stmt, consumed: Dict[str, Tuple[int, int]],
                     own_body: bool) -> None:
        """Process counter-hash draws in ``stmt``'s own expressions (for
        compound statements, skip the nested body — handled by _stmt)."""
        nodes: List[ast.AST]
        if own_body:
            nodes = []
            for field_ in ("test", "iter", "target", "items"):
                v = getattr(stmt, field_, None)
                if isinstance(v, list):
                    nodes.extend(v)
                elif v is not None:
                    nodes.append(v)
        else:
            nodes = [stmt]
        for top in nodes:
            for node in ast.walk(top):
                if not isinstance(node, ast.Call):
                    continue
                fn = _hash_fn(node)
                if fn is None:
                    continue
                for seed in _seed_args(node, fn):
                    if not isinstance(seed, ast.Name):
                        continue  # fresh derivation / attribute seeds: no claim
                    site = (seed.lineno, seed.col_offset)
                    prev = consumed.get(seed.id)
                    if prev is None:
                        consumed[seed.id] = site
                    elif prev == site:
                        # same call site seen again: only loops revisit a
                        # statement, so the seed crosses iterations as is
                        self.findings.append(Finding(
                            self.rel, node.lineno, RULE,
                            f"seed {seed.id!r} feeds the same counter-hash "
                            "draw every loop iteration — draw or derive a "
                            "per-iteration seed"))
                    else:
                        self.findings.append(Finding(
                            self.rel, node.lineno, RULE,
                            f"seed {seed.id!r} already fed a counter-hash "
                            f"draw at line {prev[0]} — draw or derive a "
                            "fresh seed before reuse (identical seeds give "
                            "identical streams)"))


@rule(RULE,
      "a seed may feed only one counter-hash draw; draw or derive a fresh "
      "seed before the next (loops are simulated twice)")
def check_rng_reuse(repo: Repo) -> Iterator[Finding]:
    for ctx in repo.files():
        for node in ast.walk(ctx.tree):
            if isinstance(node, FunctionNode):
                sim = _Sim(ctx.rel)
                sim.run(node.body, {})
                yield from sim.findings


def _implicit_draw(call: ast.Call) -> Optional[str]:
    """Why ``call`` draws from a generator nobody passed, or None."""
    d = dotted_name(call.func)
    kws = {kw.arg for kw in call.keywords}
    attr = call.func.attr if isinstance(call.func, ast.Attribute) else None
    if d is not None:
        parts = d.split(".")
        if parts[0] == "torch" and len(parts) == 2:
            if parts[1] in GLOBAL_TORCH_DRAWS:
                return f"{d}() takes no generator: it draws from torch's global one"
            if parts[1] in TORCH_DRAWS and "generator" not in kws:
                return f"{d}() without generator= draws from torch's global generator"
        if parts[0] in ("np", "numpy") and len(parts) == 3 and parts[1] == "random":
            if parts[2] not in NUMPY_GENERATOR_MAKERS:
                return f"{d}() draws from numpy's global state"
            if parts[2] in ("default_rng", "RandomState") and not (call.args or kws):
                return f"{d}() without a seed is seeded from the OS"
        if parts[0] == "random" and len(parts) == 2 and parts[1] not in STDLIB_GENERATORS:
            return f"{d}() draws from the stdlib's global generator"
    if attr in TENSOR_DRAWS and "generator" not in kws:
        return f".{attr}() without generator= draws from torch's global generator"
    return None


@rule(IMPLICIT_RULE,
      "every random draw names its generator: torch draws pass "
      "generator=, numpy and stdlib draws go through an explicit "
      "Generator / Random object")
def check_rng_implicit(repo: Repo) -> Iterator[Finding]:
    for ctx in repo.files():
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                why = _implicit_draw(node)
                if why is not None:
                    yield Finding(ctx.rel, node.lineno, IMPLICIT_RULE, why)
