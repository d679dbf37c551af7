"""Run-history ledger and code-vs-environment regression attribution.

A benchmark of the port appends its full record to an append-only JSONL
ledger: the headline (raw and calibration-normalized), the ``calibration{}``
probe block and the ``machine_fingerprint`` (``obs/calibrate.py``).  The
ledger is what makes a performance claim comparable across sessions and
machines:

* the **reference fingerprint** is the first calibrated entry — every
  later entry's ``value_cal`` is its raw headline re-expressed on that
  machine (``value / matmul-probe ratio``), so a trajectory lives on one
  axis even when the machine changes speed under it (a card held below its
  power limit, a busier host);
* :func:`attribute_delta` splits any two entries' headline delta into
  ``{environment, code, unexplained}`` in log space: environment is what
  the calibration probes moved, code is the residual beyond the noise
  tolerance, unexplained is the residual within it (or everything, when a
  side has no calibration — an uncalibrated entry is honest about being
  unattributable);
* :func:`regression_check` is a benchmark's loud-failure gate: a headline
  that drops more than ``drop_tol`` *after* normalization against the
  ledger best marks the record ``degraded`` with a structured
  ``regression{}`` note (kind ``code``); a raw drop whose normalized value
  held is annotated kind ``environment`` — published, not degraded.

The JAX package's ``obs/perfdb.py``, definition for definition.  Plain
host-side Python: tolerant JSONL parsing (a corrupt line is skipped and
never stops a benchmark).  Where the ledger lives is the benchmark's
choice: nothing here names a file.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional

from csat_tpu_torch.obs.calibrate import normalization_ratio

__all__ = [
    "SCHEMA_VERSION", "HEADLINE_METRIC", "make_entry", "append_entry",
    "load_history", "reference_entry", "best_entry", "last_entry",
    "attribute_delta", "regression_check",
]

SCHEMA_VERSION = 1
HEADLINE_METRIC = "ast_nodes_per_sec_per_chip"

# a normalized delta within this band is noise, not a code signal.  The
# value is the JAX package's, chosen from its own runs' jitter; the port's
# run-to-run jitter on the card is not measured yet
NOISE_TOL = 0.05
# normalized drop beyond this marks the record degraded (kind "code"); the
# JAX package's value, not yet measured on the card either
DROP_TOL = 0.10


def make_entry(bench_out: dict, *, run_id: str, ts: Optional[float] = None,
               source: str = "bench.py", git_rev: Optional[str] = None,
               reference: Optional[dict] = None) -> dict:
    """Build a ledger entry from a benchmark's JSON record.  ``value_cal``
    must already be stamped by the caller (the benchmark computes it against
    the live ledger's reference entry); ``reference`` records which entry
    anchored the normalization."""
    entry = {
        "schema": SCHEMA_VERSION,
        "run_id": run_id,
        "ts": round(float(ts if ts is not None else time.time()), 3),
        "source": source,
        "metric": bench_out.get("metric", HEADLINE_METRIC),
        "value": bench_out.get("value", 0.0),
        "value_cal": bench_out.get(
            f"{_cal_field(bench_out)}", bench_out.get("value", 0.0)),
        "machine_fingerprint": bench_out.get("machine_fingerprint"),
        "calibration": bench_out.get("calibration"),
        "degraded_reasons": sorted(bench_out.get("degraded_reasons", ())),
        "record": bench_out,
    }
    if git_rev:
        entry["git_rev"] = git_rev
    if reference:
        entry["reference"] = reference
    if bench_out.get("regression"):
        entry["regression"] = bench_out["regression"]
    return entry


def _cal_field(bench_out: dict) -> str:
    metric = bench_out.get("metric", HEADLINE_METRIC)
    # a record publishes e.g. nodes_per_sec_per_chip_cal next to the raw value
    return f"{metric.split('ast_', 1)[-1]}_cal"


def append_entry(path: str, entry: dict) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry) + "\n")


def load_history(path: str) -> List[dict]:
    """All parseable ledger entries, oldest first.  Malformed lines and a
    missing file read as empty — the ledger must never block a benchmark."""
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and "value" in rec:
                    out.append(rec)
    except OSError:
        pass
    return out


def reference_entry(history: List[dict]) -> Optional[dict]:
    """The ledger's normalization anchor: the FIRST entry that carries a
    usable calibration block.  First (not best/latest) so the anchor never
    shifts as the ledger grows — every ``value_cal`` stays comparable."""
    for e in history:
        cal = e.get("calibration")
        if cal and (cal.get("probes") or {}):
            return e
    return None


def _comparable(e: dict) -> bool:
    """Entries eligible as a regression baseline: a real measurement whose
    number is trusted.  ``no_device`` stays eligible; parity failures and
    already-flagged code regressions do not."""
    bad = set(e.get("degraded_reasons", ()))
    return (float(e.get("value") or 0.0) > 0.0
            and not bad.intersection({"parity", "regression"}))


def best_entry(history: List[dict],
               metric: str = HEADLINE_METRIC) -> Optional[dict]:
    """Highest calibration-normalized headline among comparable entries."""
    pool = [e for e in history if e.get("metric") == metric and _comparable(e)]
    return max(pool, key=lambda e: float(e.get("value_cal") or 0.0),
               default=None)


def last_entry(history: List[dict],
               metric: str = HEADLINE_METRIC) -> Optional[dict]:
    for e in reversed(history):
        if e.get("metric") == metric and float(e.get("value") or 0.0) > 0.0:
            return e
    return None


def _pct(log_delta: float) -> float:
    return (math.exp(log_delta) - 1.0) * 100.0


def attribute_delta(old: dict, new: dict, *,
                    noise_tol: float = NOISE_TOL) -> dict:
    """Split ``new`` vs ``old``'s headline delta into environment / code /
    unexplained, using the calibration probe ratio between the two runs.

    Log-space: ``ln(raw_new/raw_old) = env + residual`` where ``env`` is
    the machine-speed ratio the probes measured.  Residual beyond
    ``noise_tol`` is attributed to code; residual within it is noise
    (``unexplained``).  When either side lacks calibration the whole delta
    beyond noise is ``unexplained`` — unattributable, said out loud.
    """
    raw_old = float(old.get("value") or 0.0)
    raw_new = float(new.get("value") or 0.0)
    if raw_old <= 0.0 or raw_new <= 0.0:
        return {"comparable": False,
                "why": "one side has no positive headline value"}
    total = math.log(raw_new / raw_old)
    cal_old, cal_new = old.get("calibration"), new.get("calibration")
    calibrated = bool(
        cal_old and (cal_old.get("probes") or {})
        and cal_new and (cal_new.get("probes") or {}))
    env = math.log(normalization_ratio(cal_new, cal_old)) if calibrated else 0.0
    residual = total - env
    noise_band = math.log1p(noise_tol)
    if calibrated and abs(residual) > noise_band:
        code, unexplained = residual, 0.0
    else:
        code, unexplained = 0.0, residual
    if code < 0:
        verdict = "code_regression"
    elif code > 0:
        verdict = "code_improvement"
    elif calibrated and abs(env) > noise_band:
        verdict = "environment"
    elif not calibrated and abs(total) > noise_band:
        verdict = "unattributable"
    else:
        verdict = "noise"
    return {
        "comparable": True,
        "calibrated": calibrated,
        "total_pct": round(_pct(total), 2),
        "environment_pct": round(_pct(env), 2),
        "code_pct": round(_pct(code), 2),
        "unexplained_pct": round(_pct(unexplained), 2),
        "noise_tol_pct": round(noise_tol * 100.0, 1),
        "verdict": verdict,
    }


def regression_check(entry: dict, history: List[dict], *,
                     drop_tol: float = DROP_TOL,
                     noise_tol: float = NOISE_TOL) -> Optional[dict]:
    """A benchmark's loud-failure gate: compare a fresh entry against the
    ledger best.  Returns a structured ``regression{}`` note, or None when
    there is nothing to flag (no baseline, or the delta is within bounds).

    ``kind == "code"``: the calibration-NORMALIZED headline dropped more
    than ``drop_tol`` — the caller must mark the record ``degraded``
    instead of silently publishing.  ``kind == "environment"``: the raw
    headline dropped but the normalized one held — annotation only, the
    record publishes (the machine slowed, not the code).

    Only CALIBRATED ledger entries are eligible baselines: an uncalibrated
    best cannot certify a code regression, because its "normalized" value is
    just its raw value — a machine that slowed since would read as a code
    regression, the false positive this module exists to prevent.
    """
    pool = [e for e in history
            if ((e.get("calibration") or {}).get("probes") or {})]
    best = best_entry(pool, entry.get("metric", HEADLINE_METRIC))
    if best is None or not _comparable(best):
        return None
    value = float(entry.get("value") or 0.0)
    value_cal = float(entry.get("value_cal") or value)
    if value <= 0.0:
        return None
    best_raw = float(best.get("value") or 0.0)
    best_cal = float(best.get("value_cal") or best_raw)
    raw_drop = 1.0 - value / best_raw if best_raw > 0 else 0.0
    cal_drop = 1.0 - value_cal / best_cal if best_cal > 0 else 0.0
    att = attribute_delta(best, entry, noise_tol=noise_tol)
    note = {
        "vs_run": best.get("run_id"),
        "vs_value": round(best_raw, 1),
        "vs_value_cal": round(best_cal, 1),
        "raw_drop_pct": round(raw_drop * 100.0, 2),
        "normalized_drop_pct": round(cal_drop * 100.0, 2),
        "drop_tol_pct": round(drop_tol * 100.0, 1),
        "attribution": att,
    }
    if cal_drop > drop_tol:
        # calibration says the machine did not slow this much — code did
        note["kind"] = "code"
        note["degraded"] = True
        return note
    if raw_drop > drop_tol:
        # raw dropped, normalized held: the machine slowed around the code
        note["kind"] = "environment"
        note["degraded"] = False
        return note
    return None
