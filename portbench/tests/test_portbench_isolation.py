"""Nothing the benchmark runs imports JAX, jaxlib, flax, optax or the JAX
package (top-level module names compared whole: ``csat_tpu_torch`` is not
``csat_tpu``), and the reference imports nothing of the port."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "csat_tpu")


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"}, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_part_of_the_benchmark_loads_without_jax():
    code = """
import json, sys
sys.argv = ["run.py"]
import portbench.run
from pathlib import Path
from portbench.core.spec import load_part
for kind in ("drivers", "traffic", "metrics"):
    for f in sorted((Path("portbench") / kind).glob("*.py")):
        if f.stem != "__init__":
            load_part(kind, f.stem)
import portbench.reference.model, portbench.core.faults, portbench.core.profile
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    tops = _loaded(code)
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)
    assert "portbench" in tops


def test_a_whole_cpu_run_loads_without_jax():
    code = """
import json, sys
sys.path.insert(0, "portbench/tests")
from conftest import cpu_run, tiny_cell
res = cpu_run(tiny_cell("python-train-b64"))
assert res["correct"]
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    tops = _loaded(code)
    assert "csat_tpu_torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_the_yardstick_loads_nothing_of_the_port():
    code = """
import json, sys
import portbench.reference.model, portbench.core.weights, portbench.core.counts
import portbench.core.gates, portbench.core.readers, portbench.traffic.corpus
import portbench.traffic.poisson, portbench.traffic.trees
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    tops = _loaded(code)
    assert not tops & (set(FORBIDDEN) | {"csat_tpu_torch"})


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(ROOT))
    from portbench.run import forbidden_loaded

    before = forbidden_loaded()
    sys.modules["csat_tpu_torch_lookalike"] = sys.modules["json"]
    try:
        assert forbidden_loaded() == before
    finally:
        del sys.modules["csat_tpu_torch_lookalike"]
