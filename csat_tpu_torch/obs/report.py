"""The table readers of ``top`` over the serving telemetry files: the JAX
repo's ``tools/obs_report.py`` renderers that ``tools/serve_top.py`` uses,
for the port (``tests/test_torch_imports.py`` holds each definition to the
original's).  They read the metrics JSONL the serve command line writes
(``--metrics_file``: ``MetricsFile`` snapshots, a fleet's per-replica series
under a ``replica<k>_`` prefix) and the request-trace dumps
(``--traces_file``, :mod:`csat_tpu_torch.obs.rtrace`); nothing here touches a
live engine.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

__all__ = ["split_fleet_snapshot", "fleet_table", "kv_pages_table", "net_table",
           "trace_lines"]


def _fmt_table(rows: List[Tuple], headers: Tuple) -> str:
    rows = [tuple(str(c) for c in r) for r in rows]
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()
    sep = "  ".join("-" * w for w in widths)
    return "\n".join([line(headers), sep] + [line(r) for r in rows])


_REPLICA_KEY_RE = re.compile(r"^replica(\d+)_(.+)$")


# (column header, per-replica metric key) for the fleet table; counters
# sum into the fleet totals row, the latency histogram renders as mean ms
_FLEET_COLS = (
    ("submitted", "serve_requests_submitted_total"),
    ("ok", "serve_requests_ok_total"),
    ("failed", "serve_requests_failed_total"),
    ("timeout", "serve_requests_timeout_total"),
    ("shed", "serve_requests_shed_total"),
    ("queue", "serve_queue_depth"),
    ("busy", "serve_slots_occupied"),
    ("gen_tokens", "serve_gen_tokens_total"),
)


# serve_health_state gauge encoding (serve/fleet.py)
_HEALTH_NAMES = {0: "HEALTHY", 1: "DRAINING", 2: "SICK"}


def split_fleet_snapshot(snap: dict) -> List[dict]:
    """One fleet snapshot (``Fleet.snapshot`` — per-replica series under a
    ``replica<k>_`` key prefix) → per-replica plain dicts, index order.
    Each dict carries its replica index under ``_index`` — elastic fleets
    have gaps: retired indices disappear, replacements land at
    fresh monotonic indices, so list position is not identity."""
    per: Dict[int, dict] = {}
    for key, v in snap.items():
        m = _REPLICA_KEY_RE.match(key)
        if m:
            per.setdefault(int(m.group(1)), {})[m.group(2)] = v
    for k, d in per.items():
        d["_index"] = k
    return [per[k] for k in sorted(per)]


def fleet_table(snaps: List[dict]) -> str:
    """Per-replica counter table (with the health state from each
    replica's ``serve_health_state`` gauge) plus a summed fleet totals
    row, from the replicas' last metrics snapshots."""
    rows: List[Tuple] = []
    totals = {col: 0 for col, _ in _FLEET_COLS}
    for k, snap in enumerate(snaps):
        row: List = [f"replica{snap.get('_index', k)}"]
        health = snap.get("serve_health_state")
        row.append(_HEALTH_NAMES.get(health, "-") if health is not None
                   else "-")
        for col, key in _FLEET_COLS:
            v = snap.get(key, 0) or 0
            row.append(v)
            totals[col] += v
        lat_n = snap.get("serve_request_latency_seconds_count") or 0
        lat_s = snap.get("serve_request_latency_seconds_sum") or 0.0
        row.append(round(lat_s / lat_n * 1e3, 1) if lat_n else "-")
        rows.append(tuple(row))
    rows.append(("fleet", "-", *(totals[c] for c, _ in _FLEET_COLS), "-"))
    return _fmt_table(
        rows,
        ("replica", "health", *(c for c, _ in _FLEET_COLS), "lat_mean_ms"))


# per-tier occupancy gauges (serve/tiering.py): shown next to
# the HBM page occupancy whenever any replica reports them
_TIER_COLS = (
    ("host", "serve_tier_host_pages_in_use"),
    ("disk", "serve_tier_disk_pages_in_use"),
)


def kv_pages_table(snaps: List[dict]) -> str:
    """KV page occupancy per replica — HBM in-use / usable (plus peak),
    with the host/disk tier residency columns when any replica runs the
    tiered store, and mesh columns (chip count + worst-chip page load)
    when any replica spans more than one chip.  Rectangle-layout
    replicas (0 usable pages) are skipped; returns "" when nothing is
    paged."""
    tiered = any(s.get(key) is not None for s in snaps for _, key in _TIER_COLS)
    meshed = any((s.get("serve_mesh_devices") or 1) > 1 for s in snaps)
    rows: List[Tuple] = []
    for k, s in enumerate(snaps):
        usable = s.get("serve_kv_pages") or 0
        if not usable:
            continue
        used = s.get("serve_kv_pages_in_use") or 0
        row: List = [f"replica{s.get('_index', k)}", used, usable,
                     f"{used / usable:.1%}", s.get("serve_kv_pages_peak") or 0]
        if meshed:
            row += [s.get("serve_mesh_devices") or 1,
                    s.get("serve_kv_pages_in_use_worst_chip")
                    if s.get("serve_kv_pages_in_use_worst_chip") is not None
                    else "-"]
        if tiered:
            row += [s[key] if s.get(key) is not None else "-"
                    for _, key in _TIER_COLS]
        rows.append(tuple(row))
    if not rows:
        return ""
    headers: Tuple = ("replica", "hbm_in_use", "usable", "occ", "peak")
    if meshed:
        headers += ("chips", "worst_chip")
    if tiered:
        headers += tuple(c for c, _ in _TIER_COLS)
    return _fmt_table(rows, headers)


# network front-door gauges/counters (serve/netfront.py):
# rendered per replica whenever any snapshot carries the connection gauge
_NET_COLS = (
    ("conns", "serve_net_connections"),
    ("stalled", "serve_net_stalled"),
    ("frames", "serve_net_frames_total"),
    ("stall_drops", "serve_net_stall_drops_total"),
    ("resumes", "serve_net_resumes_total"),
    ("disconnects", "serve_net_disconnects_total"),
    ("malformed", "serve_net_malformed_total"),
)


def net_table(snaps: List[dict]) -> str:
    """Network front-door connection/stall/resume table —
    one row per replica reporting the ``serve_net_*`` series; returns ""
    when no snapshot ran behind a front door."""
    rows: List[Tuple] = []
    for k, s in enumerate(snaps):
        if s.get("serve_net_connections") is None:
            continue
        rows.append((f"replica{s.get('_index', k)}",
                     *(s.get(key, 0) or 0 for _, key in _NET_COLS)))
    if not rows:
        return ""
    return _fmt_table(rows, ("replica", *(c for c, _ in _NET_COLS)))


def trace_lines(path: str, slowest: int = 5) -> List[str]:
    """The slowest-N request traces from a ``Tracer.dump`` JSONL artifact
    as indented span trees — one header row per trace (id,
    status, end-to-end duration, attempts), then its spans in time order
    with per-span durations and extra fields."""
    from csat_tpu_torch.obs.rtrace import load_traces

    traces = load_traces(path)
    done = [t for t in traces if t.get("status")]
    done.sort(key=lambda t: -float(t.get("dur", 0.0)))
    shown = done[:slowest] if slowest else done
    out = [f"== slowest traces ({len(shown)} of {len(traces)} in "
           f"{path}) =="]
    if not shown:
        return out + ["  (no finished traces in dump)"]
    for t in shown:
        out.append(
            f"  {t.get('trace_id', '?')}  status={t.get('status', '?')}  "
            f"dur={float(t.get('dur', 0.0)) * 1e3:.1f}ms  "
            f"attempts={t.get('attempt', 1)}")
        t0 = float(t.get("t0", 0.0))
        rows = []
        for sp in t.get("spans", ()):
            extra = {k: v for k, v in sp.items()
                     if k not in ("name", "t0", "dur", "attempt")}
            rows.append((
                sp.get("name", "?"),
                sp.get("attempt", 1),
                f"+{float(sp.get('t0', t0)) - t0:.4f}s",
                f"{float(sp.get('dur', 0.0)) * 1e3:.2f}",
                " ".join(f"{k}={v}" for k, v in sorted(extra.items())),
            ))
        table = _fmt_table(rows, ("span", "att", "start", "dur_ms", "fields"))
        out.extend("    " + ln for ln in table.splitlines())
    return out
