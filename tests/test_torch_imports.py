"""The port stands alone: no file of ``csat_tpu_torch/`` nor ``chip_smoke.py``
imports JAX, flax or the JAX package, every module imports with those
blocked and without ``nvcc``, ``chip_smoke.py`` fails without a GPU or
without the package beside it, and the port's copies of JAX-free modules
(the prefix cache, the request tracer, the serve stats, the KV tier store,
the identifier splitters of the extractor, the router, the autoscaler, the
traffic zoo, the toy samples, and the chaos runner and invariant monitor
short of their network parts) define exactly what their originals do."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "csat_tpu")


def _port_files():
    return sorted((REPO / "csat_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


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
        "from csat_tpu_torch.ops import build\n"
        "assert not build._LIBS and all(v == 0 for v in build.launch_counts().values())\n"
        "print(len(mods))\n"
    )
    res = _run(["-c", code], cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 62


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
        name = getattr(node, "name", None) or ast.dump(node)[:60]
        out[name] = ast.dump(node).replace("csat_tpu_torch", "csat_tpu")
    return out


def _methods(path: Path, cls: str):
    """A class's methods as AST dumps (docstrings left out), by name."""
    tree = _strip_docs(ast.parse(path.read_text()))
    node = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls)
    return {m.name: ast.dump(m).replace("csat_tpu_torch", "csat_tpu") for m in node.body
            if isinstance(m, ast.FunctionDef)}


# the port's copies of JAX-free modules of the JAX package: every definition
# is the original's, statement for statement (the extractor's stdlib backend
# is held to the original by its outputs, tests/test_torch_serve_cli.py)
COPIES = [("serve/prefix.py", None), ("obs/rtrace.py", None), ("serve/stats.py", None),
          ("serve/tiering.py", None),
          ("data/extract.py", ("split_camelcase", "split_identifier_into_parts")),
          ("serve/router.py", None), ("serve/autoscale.py", None), ("serve/traffic.py", None),
          ("data/toy.py", None)]


@pytest.mark.parametrize("rel,names", COPIES, ids=[c[0] for c in COPIES])
def test_copies_equal_their_originals(rel, names):
    port, ref = _defs(REPO / "csat_tpu_torch" / rel), _defs(REPO / "csat_tpu" / rel)
    if names is None:  # a whole-module copy
        assert sorted(port) == sorted(ref)
    assert all(port[n] == ref[n] for n in names or ref), rel


# copies short of the network front door's parts (JAX's run_net_chaos,
# check_streams and the network draw of FaultPlan.random): every other
# definition and method is the original's, docstrings aside
PARTIAL = [("resilience/chaos.py", ("run_net_chaos",), "FaultPlan", ("random",)),
           ("resilience/invariants.py", (), "InvariantMonitor", ("check_streams",))]


@pytest.mark.parametrize("rel,absent,cls,changed", PARTIAL, ids=[c[0] for c in PARTIAL])
def test_partial_copies_equal_their_originals(rel, absent, cls, changed):
    port = _defs(REPO / "csat_tpu_torch" / rel, docs=False)
    ref = _defs(REPO / "csat_tpu" / rel, docs=False)
    skip = set(absent) | {cls} | {n for n in ref if n.startswith("Assign(targets=[Name(id='__all__'")}
    assert sorted(n for n in port if n not in skip) == sorted(n for n in ref if n not in skip)
    assert all(port[n] == ref[n] for n in ref if n not in skip), rel
    assert not set(absent) & set(port)
    pm, rm = _methods(REPO / "csat_tpu_torch" / rel, cls), _methods(REPO / "csat_tpu" / rel, cls)
    assert sorted(set(rm) - set(changed) - set(pm)) == [] and all(
        pm[n] == rm[n] for n in rm if n not in changed), f"{rel}:{cls}"
