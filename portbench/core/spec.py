"""What a cell is, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration and
traffic mix; everything else is a file found by its name:

* ``portbench/configs/<file>``: the configuration, as ``BENCHMARK.json``'s
  ``configs[].file`` names it;
* ``portbench/mixes/<traffic>.json``: the mix, which names its generator
  ``portbench/traffic/<generator>.py`` and its driver
  ``portbench/drivers/<driver>.py``;
* ``portbench/metrics/<metric>.py``: one reader per metric.

A new configuration, mix, generator, driver or metric is a new file and a
new entry; no file that is there needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

__all__ = ["ROOT", "BENCH", "Cell", "load_cell", "load_part", "cell_metrics"]

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

_MODULES: Dict[str, ModuleType] = {}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    model: Dict            # the configuration file
    mix: Dict              # the mix file
    benchmark: Dict        # BENCHMARK.json


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    model = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "portbench" / "mixes" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), model=model, mix=mix, benchmark=bench)


def load_part(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = root / "portbench" / kind / f"{name}.py"
    key = f"portbench_{kind}_{name}"
    if key not in _MODULES:
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None or not path.exists():
            raise SystemExit(f"no {kind} named {name!r} ({path})")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def cell_metrics(cell: Cell, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with
    ``trace`` its per-layer ones.  A metric with ``workloads`` belongs to the
    cells it lists; a per-layer one without, to every cell that reports the
    end-to-end metric it moves."""
    bench = cell.benchmark
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell.name in m["workloads"]]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}

    def belongs(m: Dict) -> bool:
        return cell.name in m["workloads"] if "workloads" in m else m["moves"] in mine

    return [m for m in bench["per_layer"] if belongs(m)]
