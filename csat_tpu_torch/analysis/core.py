"""csat-lint core: findings, rule registry, suppressions, runner.

A rule is a function ``(repo) -> iterable[Finding]`` registered under a
kebab-case name.  The runner parses every target file once, hands rules
a :class:`Repo` of cached :class:`FileCtx` objects, then applies inline
suppressions:

    x = compute()  # csat-lint: disable=<rule>[,<rule>]  <reason>

A suppression matches findings of the named rules on its own line (or,
when written as a standalone comment line, on the line below).  Every
suppression MUST carry a reason — a reason-less or unknown-rule
suppression is itself a finding (``bad-suppression``) and cannot be
suppressed.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from csat_tpu_torch.analysis.manifests import LINT_TARGETS
from csat_tpu_torch.analysis.visitors import parent_map

META_RULES = ("bad-suppression", "parse-error")

_SUPPRESS_RE = re.compile(r"#\s*csat-lint:\s*disable=([\w,-]+)(.*)$")


@dataclass(frozen=True, order=True)
class Finding:
    path: str          # repo-relative, forward slashes
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> Dict[str, object]:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "message": self.message}


@dataclass
class Suppression:
    line: int
    rules: Tuple[str, ...]
    reason: str


class FileCtx:
    """One parsed target file: source, AST, per-line suppressions."""

    def __init__(self, root: str, rel: str):
        self.root = root
        self.rel = rel
        self.path = os.path.join(root, rel)
        with open(self.path, "r", encoding="utf-8") as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(self.source, filename=self.path)
        except SyntaxError as e:
            self.parse_error = e
        self.suppressions = self._parse_suppressions()
        self._parents: Optional[Dict[int, ast.AST]] = None

    @property
    def parents(self) -> Dict[int, ast.AST]:
        if self._parents is None:
            self._parents = parent_map(self.tree) if self.tree else {}
        return self._parents

    def _parse_suppressions(self) -> List[Suppression]:
        out: List[Suppression] = []
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = tuple(r for r in m.group(1).split(",") if r)
            reason = m.group(2).strip().lstrip("—–:- ").strip()
            # a standalone comment line suppresses the line BELOW it
            line = i + 1 if text.strip().startswith("#") else i
            out.append(Suppression(line=line, rules=rules, reason=reason))
        return out


class Repo:
    """Lint context: the target file set, parsed lazily and cached."""

    def __init__(self, root: str, targets: Optional[Iterable[str]] = None):
        self.root = os.path.abspath(root)
        self.targets = tuple(targets) if targets else LINT_TARGETS
        self._ctxs: Dict[str, FileCtx] = {}
        self._rels = self._discover()

    def _discover(self) -> Tuple[str, ...]:
        rels: List[str] = []
        for target in self.targets:
            top = os.path.join(self.root, target)
            if os.path.isfile(top):
                rels.append(target.replace(os.sep, "/"))
                continue
            for dirpath, dirnames, filenames in os.walk(top):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        rel = os.path.relpath(
                            os.path.join(dirpath, fn), self.root)
                        rels.append(rel.replace(os.sep, "/"))
        return tuple(sorted(set(rels)))

    def files(self) -> Iterable[FileCtx]:
        for rel in self._rels:
            ctx = self.ctx(rel)
            if ctx is not None and ctx.tree is not None:
                yield ctx

    def ctx(self, rel: str) -> Optional[FileCtx]:
        """The parsed file (cached) — also resolves files OUTSIDE the
        target set (e.g. the injector ctor source a boundary rule needs),
        as long as they exist under the root."""
        if rel not in self._ctxs:
            path = os.path.join(self.root, rel)
            if not os.path.isfile(path):
                return None
            self._ctxs[rel] = FileCtx(self.root, rel)
        return self._ctxs[rel]

    def has(self, rel: str) -> bool:
        return rel in self._rels


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

RuleFn = Callable[[Repo], Iterable[Finding]]


@dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    fn: RuleFn


_REGISTRY: Dict[str, Rule] = {}


def rule(name: str, doc: str) -> Callable[[RuleFn], RuleFn]:
    def deco(fn: RuleFn) -> RuleFn:
        if name in _REGISTRY:
            raise ValueError(f"duplicate rule {name!r}")
        _REGISTRY[name] = Rule(name=name, doc=doc, fn=fn)
        return fn
    return deco


def _load_rules() -> None:
    # import for registration side effects; late to avoid import cycles
    from csat_tpu_torch.analysis import (  # noqa: F401
        boundary, clock, compiles, faultflow, hotpath, rng)


def all_rules() -> Dict[str, Rule]:
    _load_rules()
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

@dataclass
class LintReport:
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    rules: Tuple[str, ...] = ()
    files: int = 0

    @property
    def clean(self) -> bool:
        return not self.findings

    def format(self) -> str:
        out = [f.format() for f in self.findings]
        out.append(
            f"csat-lint: {len(self.findings)} finding"
            f"{'' if len(self.findings) == 1 else 's'} "
            f"({len(self.suppressed)} suppressed) across {self.files} files")
        return "\n".join(out)

    def to_json(self) -> str:
        return json.dumps({
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "rules": list(self.rules),
            "files": self.files,
        }, indent=2, sort_keys=True)


def _suppression_findings(repo: Repo, known: Iterable[str]) -> List[Finding]:
    known = set(known) | set(META_RULES)
    out: List[Finding] = []
    for ctx in repo.files():
        for sup in ctx.suppressions:
            if not sup.reason:
                out.append(Finding(
                    ctx.rel, sup.line, "bad-suppression",
                    f"suppression of {','.join(sup.rules)} carries no "
                    "reason — every disable must say why"))
            for r in sup.rules:
                if r not in known:
                    out.append(Finding(
                        ctx.rel, sup.line, "bad-suppression",
                        f"suppression names unknown rule {r!r}"))
    return out


def _parse_error_findings(repo: Repo) -> List[Finding]:
    out: List[Finding] = []
    for rel in repo._rels:
        ctx = repo.ctx(rel)
        if ctx is not None and ctx.parse_error is not None:
            out.append(Finding(
                rel, ctx.parse_error.lineno or 1, "parse-error",
                f"file does not parse: {ctx.parse_error.msg}"))
    return out


def run_lint(root: str, targets: Optional[Iterable[str]] = None,
             rules: Optional[Iterable[str]] = None) -> LintReport:
    """Run ``rules`` (default: all registered) over ``targets`` under
    ``root``; returns the report with suppressions already applied."""
    registry = all_rules()
    names = tuple(rules) if rules else tuple(sorted(registry))
    unknown = [n for n in names if n not in registry]
    if unknown:
        raise KeyError(f"unknown rule(s): {unknown}; "
                       f"known: {sorted(registry)}")
    repo = Repo(root, targets)

    raw: List[Finding] = []
    for name in names:
        raw.extend(registry[name].fn(repo))
    raw.extend(_parse_error_findings(repo))
    raw = sorted(set(raw))

    # suppression application (meta rules are never suppressible —
    # a reason-less suppression must not be able to silence itself)
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in raw:
        ctx = repo.ctx(f.path)
        sups = ctx.suppressions if ctx is not None else []
        if f.rule not in META_RULES and any(
                s.line == f.line and f.rule in s.rules and s.reason
                for s in sups):
            suppressed.append(f)
        else:
            kept.append(f)
    kept.extend(_suppression_findings(repo, registry))
    return LintReport(findings=sorted(set(kept)),
                      suppressed=sorted(set(suppressed)),
                      rules=names, files=sum(1 for _ in repo.files()))
