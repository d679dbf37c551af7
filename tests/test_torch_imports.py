"""The port stands alone: no file of ``csat_tpu_torch/`` nor ``chip_smoke.py``
imports JAX, flax or the JAX package, every module imports with those
blocked and without ``nvcc``, and ``chip_smoke.py`` fails without a GPU or
without the package beside it."""

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
    assert int(res.stdout.split()[-1]) >= 20


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    res = _run(["chip_smoke.py"], cwd=REPO, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    res = _run(["chip_smoke.py"], cwd=tmp_path, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
