"""``top``: the live fleet console over the serving telemetry files — the
JAX repo's ``tools/serve_top.py`` for the port (``tests/test_torch_imports.py``
holds each definition to the original's, and its tests hold the rendered
lines equal on one metrics file)::

    python -m csat_tpu_torch.cli top --metrics serve_metrics.jsonl \\
        --traces serve_traces.jsonl
    python -m csat_tpu_torch.cli top --metrics serve_metrics.jsonl --once

It tails the metrics JSONL that ``serve --metrics_file`` writes and repaints
one screen per refresh: the fleet header (healthy / target replicas,
capacity, queue and busy slots, or the single engine's equivalents), the
per-replica table, KV page occupancy, the network front door's connection /
stall / resume counters, the SLO burn gauges (``obs/slo.py``) and, given a
trace dump (``--traces_file``), the slowest recent request traces.
Everything is read from files; the console never touches a live engine.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Tuple

from csat_tpu_torch.obs.report import (
    _fmt_table,
    fleet_table,
    kv_pages_table,
    net_table,
    split_fleet_snapshot,
    trace_lines,
)

__all__ = ["render", "main"]

_CLEAR = "\x1b[2J\x1b[H"


def last_snapshot(path: str) -> Tuple[dict, int]:
    """(last snapshot, total snapshot count) from a metrics JSONL file —
    re-read per refresh so the console follows a file being appended to."""
    snap: dict = {}
    n = 0
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    snap = json.loads(line)
                    n += 1
                except ValueError:
                    continue  # torn tail line mid-append — keep previous
    except OSError:
        return {}, 0
    return snap, n


def _g(snap: dict, key: str, default=0):
    v = snap.get(key)
    return default if v is None else v


def header_lines(snap: dict, n_snaps: int) -> List[str]:
    t = snap.get("t")
    stamp = (time.strftime("%H:%M:%S", time.localtime(t))
             if isinstance(t, (int, float)) else "?")
    out = [f"csat_tpu top — snapshot {n_snaps} @ {stamp}"]
    if "fleet_capacity_frac" in snap:
        out.append(
            f"  fleet: {_g(snap, 'fleet_healthy_replicas')}"
            f"/{_g(snap, 'fleet_target_replicas')} healthy  "
            f"capacity {_g(snap, 'fleet_capacity_frac', 1.0):.2f}  "
            f"queue {_g(snap, 'fleet_queue_depth')}  "
            f"busy {_g(snap, 'fleet_slots_occupied')}  "
            f"resubmissions {_g(snap, 'fleet_resubmissions_total')}  "
            f"spawned {_g(snap, 'fleet_replicas_spawned_total')}")
    else:
        mesh = _g(snap, "serve_mesh_devices", 1)
        out.append(
            f"  engine: queue {_g(snap, 'serve_queue_depth')}  "
            f"busy {_g(snap, 'serve_slots_occupied')}  "
            f"ok {_g(snap, 'serve_requests_ok_total')}  "
            f"shed {_g(snap, 'serve_requests_shed_total')}  "
            f"gen_tokens {_g(snap, 'serve_gen_tokens_total')}"
            + (f"  mesh_chips {mesh}" if mesh > 1 else ""))
    return out


def pages_lines(snaps: List[dict]) -> List[str]:
    """KV page occupancy per replica: HBM in-use / usable / peak, plus the
    host/disk tier residency columns whenever a replica serves with the
    tiered store (the column set lives in ``obs/report.py``).  Rectangle-layout replicas (0 usable
    pages) are skipped."""
    table = kv_pages_table(snaps)
    if not table:
        return []
    return ["== kv pages ==", *table.splitlines()]


def net_lines(snaps: List[dict]) -> List[str]:
    """Network front-door connection/stall/resume columns — shown whenever
    a replica serves behind ``--net`` (the column set lives in
    ``obs/report.py``)."""
    table = net_table(snaps)
    if not table:
        return []
    return ["== net front door ==", *table.splitlines()]


def slo_lines(snap: dict) -> List[str]:
    """Burn-rate table + active alerts from the ``slo_*`` gauges the SLO
    engine writes into the scrape registry."""
    names = sorted(k[len("slo_burn_fast_"):] for k in snap
                   if k.startswith("slo_burn_fast_"))
    if not names:
        return []
    rows = []
    firing = []
    for name in names:
        alert = _g(snap, f"slo_alert_{name}")
        if alert:
            firing.append(name)
        rows.append((name,
                     f"{_g(snap, f'slo_burn_fast_{name}', 0.0):.2f}",
                     f"{_g(snap, f'slo_burn_slow_{name}', 0.0):.2f}",
                     "FIRING" if alert else "ok"))
    out = ["== slo burn ==",
           *_fmt_table(rows, ("objective", "fast", "slow", "alert"))
           .splitlines()]
    out.append("active alerts: " + (", ".join(firing) if firing else "none"))
    return out


def render(metrics_path: str, traces_path: str = "",
           slowest: int = 5) -> str:
    """One full console frame as a string (main() repaints it)."""
    snap, n_snaps = last_snapshot(metrics_path)
    if not snap:
        return f"(no snapshots yet in {metrics_path})"
    lines = header_lines(snap, n_snaps)
    replicas = split_fleet_snapshot(snap)
    if replicas:
        lines += ["", "== replicas =="]
        lines += fleet_table(replicas).splitlines()
        pages = pages_lines(replicas)
        if pages:
            lines += [""] + pages
        net = net_lines(replicas)
        if net:
            lines += [""] + net
    else:
        pages = pages_lines([snap])
        if pages:
            lines += [""] + pages
        net = net_lines([snap])
        if net:
            lines += [""] + net
    slo = slo_lines(snap)
    if slo:
        lines += [""] + slo
    if traces_path and os.path.exists(traces_path):
        lines += [""] + trace_lines(traces_path, slowest)
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--metrics", required=True,
                   help="metrics JSONL the serve CLI writes "
                        "(--metrics_file)")
    p.add_argument("--traces", default="",
                   help="request-trace dump JSONL (--traces_file); "
                        "renders the slowest recent traces")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh period in seconds")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit (no screen clearing) — "
                        "what the tests and scripts use")
    p.add_argument("--slowest", type=int, default=5,
                   help="how many of the slowest traces to show")
    args = p.parse_args(argv)
    try:
        if args.once:
            print(render(args.metrics, args.traces, args.slowest))
            return 0
        while True:
            frame = render(args.metrics, args.traces, args.slowest)
            sys.stdout.write(_CLEAR + frame + "\n")
            sys.stdout.flush()
            time.sleep(max(args.interval, 0.1))
    except KeyboardInterrupt:
        return 0
    except BrokenPipeError:
        # `top --once | head` closing the pipe is a clean exit
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
