"""The port stands alone: no file of ``csat_tpu_torch/`` nor ``chip_smoke.py``
imports JAX, flax or the JAX package, every module imports with those
blocked and without ``nvcc`` (``tools/build_real_corpus_torch.py`` too),
``chip_smoke.py`` fails without a GPU or without the package beside it, and
the port's copies of JAX-free modules (the prefix cache, the request tracer,
the serve stats, the KV tier store, the extractor's leaf tables, identifier
splitters, dispatch and corpus writer, the real-corpus harvest, the router, the autoscaler, the
traffic zoo, the toy samples, the chaos runner and invariant monitor, the
SLO engine, the network front door and client, ``top`` with its table
readers from ``tools/``, csat-lint's rule machinery: its core, AST visitors
and boundary, fault-path and clock rules, the run-history ledger, and the
calibration probes' names, digest and normalisation) define exactly what
their originals do."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "csat_tpu")


#: the port's tools, which import nothing of the JAX package either
PORT_TOOLS = ("tools/build_real_corpus_torch.py",)


def _port_files():
    return (sorted((REPO / "csat_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
            + [REPO / tool for tool in PORT_TOOLS])


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_package_imports(path):
    bad = sorted({root for root in _imported_roots(path) if root in FORBIDDEN})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _run(code_or_args, cwd, env_extra=None, timeout=120):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env["PATH"] = os.path.dirname(sys.executable)  # no nvcc reachable
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_every_module_imports_with_jax_blocked_and_no_nvcc():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'csat_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, csat_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(csat_tpu_torch.__path__, 'csat_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import tools.build_real_corpus_torch\n"
        "from csat_tpu_torch.ops import build\n"
        "assert not build._LIBS and all(v == 0 for v in build.launch_counts().values())\n"
        "print(len(mods))\n"
    )
    res = _run(["-c", code], cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 96


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    res = _run(["chip_smoke.py"], cwd=REPO, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    res = _run(["chip_smoke.py"], cwd=tmp_path, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def _is_doc(node) -> bool:
    return (isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str))


def _strip_docs(tree):
    """Every function's and class's docstring taken out (the copies below
    describe the port where their originals describe the JAX package)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            body = [n for n in node.body if not _is_doc(n)]
            node.body = body or [ast.Pass()]
    return tree


def _defs(path: Path, docs: bool = True):
    """Top-level statements of a module as AST dumps, by name, docstring and
    imports left out, the package's own name normalised; ``docs=False``
    leaves out every inner docstring too."""
    tree = ast.parse(path.read_text())
    if not docs:
        _strip_docs(tree)
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)) or _is_doc(node):
            continue
        target = (node.targets[0] if isinstance(node, ast.Assign) and len(node.targets) == 1
                  else getattr(node, "target", None))
        name = (getattr(node, "name", None)
                or (target.id if isinstance(target, ast.Name) else ast.dump(node)[:60]))
        out[name] = ast.dump(node).replace("csat_tpu_torch", "csat_tpu")
    return out


def _methods(path: Path, cls: str):
    """A class's methods as AST dumps (docstrings left out), by name."""
    tree = _strip_docs(ast.parse(path.read_text()))
    node = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls)
    return {m.name: ast.dump(m).replace("csat_tpu_torch", "csat_tpu") for m in node.body
            if isinstance(m, ast.FunctionDef)}


# the port's copies of JAX-free modules: (port module, original, names,
# docstrings compared).  ``names`` None is a whole-module copy: every
# definition is the original's, statement for statement, and there are no
# others; a tuple holds those definitions alone (the extractor's stdlib
# backend and its CST walk, whose node-graph class carries the port's own
# name, are held to the original by their outputs, tests/test_torch_extract.py
# and tests/test_torch_serve_cli.py; ``top`` and its table readers copy what the
# console of ``tools/`` uses of those files).  Copies whose docstrings
# describe the port are compared without them
COPIES = [("serve/prefix.py", "csat_tpu/serve/prefix.py", None, True),
          ("obs/rtrace.py", "csat_tpu/obs/rtrace.py", None, True),
          ("serve/stats.py", "csat_tpu/serve/stats.py", None, True),
          ("serve/tiering.py", "csat_tpu/serve/tiering.py", None, True),
          ("data/extract.py", "csat_tpu/data/extract.py",
           ("IDENTIFIER_TYPE", "STRING_TYPE", "_NUMBER_TYPES", "_is_number", "split_camelcase",
            "split_identifier_into_parts", "have_tree_sitter", "_treesitter_to_ast_json",
            "source_to_ast_json", "extract_corpus"), True),
          ("serve/router.py", "csat_tpu/serve/router.py", None, True),
          ("serve/autoscale.py", "csat_tpu/serve/autoscale.py", None, True),
          ("serve/traffic.py", "csat_tpu/serve/traffic.py", None, True),
          ("data/toy.py", "csat_tpu/data/toy.py", None, True),
          ("resilience/chaos.py", "csat_tpu/resilience/chaos.py", None, False),
          ("resilience/invariants.py", "csat_tpu/resilience/invariants.py", None, False),
          ("obs/slo.py", "csat_tpu/obs/slo.py", None, False),
          ("serve/netfront.py", "csat_tpu/serve/netfront.py", None, False),
          ("serve/netclient.py", "csat_tpu/serve/netclient.py", None, False),
          ("obs/report.py", "tools/obs_report.py",
           ("_fmt_table", "_REPLICA_KEY_RE", "_FLEET_COLS", "_HEALTH_NAMES",
            "split_fleet_snapshot", "fleet_table", "_TIER_COLS", "kv_pages_table", "_NET_COLS",
            "net_table", "trace_lines"), False),
          ("obs/top.py", "tools/serve_top.py",
           ("_CLEAR", "last_snapshot", "_g", "header_lines", "pages_lines", "net_lines",
            "slo_lines", "render", "main"), False),
          *((f"analysis/{m}.py", f"csat_tpu/analysis/{m}.py", None, False)
            for m in ("core", "visitors", "boundary", "faultflow", "clock")),
          ("obs/perfdb.py", "csat_tpu/obs/perfdb.py", None, False),
          ("../tools/build_real_corpus_torch.py", "tools/build_real_corpus.py",
           ("_WORD", "_nl_tokens", "harvest"), False),
          ("obs/calibrate.py", "csat_tpu/obs/calibrate.py",
           ("PROBES", "REFERENCE_PROBE", "fingerprint_id", "_median", "normalization_ratio",
            "normalize"), False)]


#: text the port's copy words otherwise (a pattern and its replacement, applied
#: to the original's dumps): the legacy-kernel rule's description, which names
#: where the JAX package's history introduced the model
REWORDED = {"analysis/boundary.py": ((r"\(one-kernel model, [^)]*\)", "(the one-kernel model)"),)}


@pytest.mark.parametrize("rel,orig,names,docs", COPIES, ids=[c[0] for c in COPIES])
def test_copies_equal_their_originals(rel, orig, names, docs):
    port = _defs(REPO / "csat_tpu_torch" / rel, docs=docs)
    ref = _defs(REPO / orig, docs=docs)
    for pattern, new in REWORDED.get(rel, ()):
        ref = {name: re.sub(pattern, new, dump) for name, dump in ref.items()}
    if names is None:  # a whole-module copy
        assert sorted(port) == sorted(ref)
        names = list(ref)
    assert all(port.get(n) == ref[n] for n in names), [n for n in names if port.get(n) != ref[n]]
