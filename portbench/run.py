"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the mix names its generator and its
driver.  The run makes its inputs and weights from ``--seed``, warms up the
shapes its traffic uses (set-up), measures for ``--seconds``, checks the
timed path's outputs against the plain reference, and prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones,
each read by ``portbench/metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit,
which also end standard error.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), and when the process has loaded JAX, jaxlib, flax,
optax or the JAX package (``csat_tpu``; top-level module names compared
whole).  Build and kernel caches stay in fixed directories under the
checkout's ``build/``.  torch and NumPy run one intra-op thread.

``--readings SEEDS`` (comma-separated) is for setting the limits: one process
runs the cell's set-up, window and check once per seed and prints the
compared numbers per seed, of the program and (``--control``) of the
reference in TF32 in its place; ``--fault NAME`` plants one of
``portbench/core/faults.py``'s faults in the timed path.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# One intra-op thread for torch and NumPy: the program's host work is the
# Python dispatch and the prefetch worker, which a pool of spinning OpenMP
# threads on the same few cores only slows, and by an amount that changes
# from run to run.  Set before either library loads.
os.environ["OMP_NUM_THREADS"] = "1"

#: top-level modules no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "csat_tpu")


@dataclasses.dataclass
class Opts:
    seed: int
    seconds: int
    trace: bool
    device: Any
    t_process: float
    fault: Optional[Callable] = None
    control: bool = False


def forbidden_loaded() -> List[str]:
    """Forbidden top-level names among the loaded modules."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache of the program in fixed directories
    inside the checkout (the port builds its CUDA and C++ libraries under
    ``build/`` by itself)."""
    base = root / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CSAT_TPU_CACHE_DIR", "csat_cache")):
        os.environ[var] = str(base / sub)


def measure(cell, opts: Opts) -> Dict:
    """One run of ``cell``: set-up, window and check by the mix's driver module, then the
    metric readers.  → the result object (without the JAX check)."""
    import torch

    from portbench.core import gates
    from portbench.core.record import Record
    from portbench.core.spec import cell_metrics, load_part

    rec = Record(cell=cell.name, model=cell.model, mix=cell.mix)
    out = load_part("drivers", cell.mix["driver"]).run(cell, rec, opts)
    verdict = gates.judge(cell.name, out["values"])
    metrics = {}
    for m in cell_metrics(cell, opts.trace):
        value = load_part("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = opts.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result: Dict[str, Any] = {"correct": bool(verdict["ok"] and out["attempted"] > 0),
                              "attempted": int(out["attempted"]), "failed": int(out["failed"]),
                              "metrics": metrics, "device": device}
    prof = rec.profile
    if opts.trace and prof is not None:
        device["busy_s"] = prof.busy_s
        device["window_s"] = prof.window_s
        ops = sorted(prof.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = {"device_ops": [[name, t] for name, (t, _) in ops],
                               "idle_gaps": [[name, t] for name, t in prof.idle_gaps[:10]]}
    result["checks"] = verdict["checks"]
    result["_record"] = rec
    result["_out"] = out
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--readings", default="", help="comma-separated seeds: print the compared "
                   "numbers of each, for setting the limits")
    p.add_argument("--control", action="store_true", help="with --readings: the reference in "
                   "TF32 in the program's place too")
    p.add_argument("--fault", default="", help="plant this fault of portbench/core/faults.py")
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                   help="with --readings: override a field of the cell's mix (a rate sweep)")
    args = p.parse_args(argv)

    set_cache_dirs(ROOT)
    from portbench.core.spec import load_cell

    cell = load_cell(args.workload)
    if args.set and not args.readings:
        p.error("--set goes with --readings: a measured run takes its mix as it is")
    for item in args.set:
        key, _, value = item.partition("=")
        cell.mix[key] = json.loads(value)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.init()
    fault = None
    if args.fault:
        from portbench.core.faults import make_fault

        fault = make_fault(args.fault, cell)

    if args.readings:
        for seed in (int(s) for s in args.readings.split(",")):
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats(device)
            opts = Opts(seed=seed, seconds=args.seconds, trace=False, device=device,
                        t_process=t0, fault=fault, control=args.control)
            res = measure(cell, opts)
            out = res["_out"]
            rec = res["_record"]
            counters = {k: v for k, v in rec.counters.items() if not isinstance(v, list)}
            print(json.dumps({"seed": seed, "fault": args.fault or None, "set": args.set,
                              "values": out["values"], "control": out.get("control"),
                              "attempted": out["attempted"], "failed": out["failed"],
                              "metrics": res["metrics"], "counters": counters,
                              "memory_peak_bytes": out["memory_peak_bytes"],
                              "seconds": time.perf_counter() - t0}), flush=True)
        return 0

    opts = Opts(seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=device,
                t_process=T_PROCESS, fault=fault)
    result = measure(cell, opts)
    result.pop("_record")
    result.pop("_out")
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
