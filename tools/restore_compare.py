"""Time this tree's KV tier restore beside another tree's on the card.

    python3 tools/restore_compare.py --other build/parent   # from the repo root

``--other`` is a checkout of another revision (a parent commit unpacked with
``git archive`` into a directory ``.gitignore`` lists) whose
``csat_tpu_torch/serve/pages.py`` has ``tier_restore``; that function is
loaded from its file and put in the serving engine's place.  Each round
runs ``chip_smoke.tier_drill`` (the ``storage`` phase's (a): the serving
trace on the tight tiered pool, warm, spill, replay, corrupted replay, every
gate of it) at f32 and int8 pages, in turns (other, this, this, other per
round).  Prints one JSON line per drill — restore host wall (mean, p95), its
``get`` and pool-write parts, spill ms per chain — then a summary line and
the card's ``nvidia-smi`` name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from csat_tpu_torch.ops import build  # noqa: E402
from csat_tpu_torch.serve import engine as engine_module  # noqa: E402

DTYPES = ("float32", "int8")


def other_restore(tree: Path):
    """``tier_restore`` of ``tree``'s ``serve/pages.py``."""
    path = tree / "csat_tpu_torch/serve/pages.py"
    spec = importlib.util.spec_from_file_location("other_pages", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module.tier_restore


def drill(label: str, restore, page_dtype: str, tmp: str) -> dict:
    engine_module.tier_restore = restore
    rec = cs.tier_drill(page_dtype, tmp)
    row = dict(tree=label, page_dtype=page_dtype, restores=rec["restores"],
               restore_ms_mean=rec["restore_ms_mean"], restore_p95_ms=rec["restore_p95_ms"],
               get_ms=rec["restore_get_ms"], write_ms=rec["restore_write_ms"],
               spill_ms_per_chain=rec["spill_ms_per_chain"])
    print(json.dumps(row), flush=True)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    smi = cs.device_phase()
    build.build_all(sorted(build.SERVE_LIBRARIES))
    # the launch gates of tier_drill need phase 3's shape checks; this tool
    # times the restore and leaves the kernels' checks to chip_smoke.py
    cs._check_launched = cs._check_rates = lambda *a, **kw: None
    cs.emit = lambda *a, **kw: None
    restores = {"other": other_restore(args.other), "this": engine_module.tier_restore}
    rows = []
    tmp = tempfile.mkdtemp(prefix="restore_compare_")
    try:
        for _ in range(args.rounds):
            for label in ("other", "this", "this", "other"):
                for page_dtype in DTYPES:
                    rows.append(drill(label, restores[label], page_dtype, tmp))
                    shutil.rmtree(Path(tmp) / f"tiers_{page_dtype}", ignore_errors=True)
    finally:
        engine_module.tier_restore = restores["this"]
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {}
    for label in restores:
        for page_dtype in DTYPES:
            mine = [r for r in rows if r["tree"] == label and r["page_dtype"] == page_dtype]
            summary[f"{label}_{page_dtype}"] = dict(
                restore_ms_mean=float(np.mean([r["restore_ms_mean"] for r in mine])),
                restore_p95_ms=[r["restore_p95_ms"] for r in mine],
                write_ms_mean=float(np.mean([r["write_ms"]["mean"] for r in mine])),
                get_ms_mean=float(np.mean([r["get_ms"]["mean"] for r in mine])))
    print(json.dumps({"summary": summary, "other": str(args.other)}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
