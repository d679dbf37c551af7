"""Telemetry the trainer and the serving engine carry (the JAX package's
``obs/``, the parts they use): a typed metrics registry with Prometheus text
and JSONL snapshots (``metrics.py``), a bounded event flight recorder dumped
to rolling post-mortem files on fault paths (``events.py``), the recorder's
export as Chrome trace-event JSON (``trace.py``), request-scoped traces
of the serving engine (``rtrace.py``), burn-rate SLOs read off the serving
registries (``slo.py``), and the ``top`` console over the metrics JSONL
(``top.py``, its table readers in ``report.py``), the machine's calibration
probes and fingerprint (``calibrate.py``) and the run-history ledger that
splits a headline's change into code and environment (``perfdb.py``).

The telemetry is host-side (host clocks only, no device syncs) and gated by
the ``obs_*`` config fields — cheap-on by default; the calibration probes
run on the device they measure, when a caller asks for them."""

from csat_tpu_torch.obs.calibrate import (
    machine_fingerprint, normalization_ratio, run_calibration)
from csat_tpu_torch.obs.events import EventRecorder, Span
from csat_tpu_torch.obs.metrics import (
    Counter, Gauge, Histogram, MetricsFile, MetricsRegistry, merge_histograms)
from csat_tpu_torch.obs.rtrace import TraceRecord, Tracer, TraceSpan, load_traces
from csat_tpu_torch.obs.slo import Objective, SLOEngine, objectives_from_config
from csat_tpu_torch.obs.trace import (
    load_chrome_trace, to_chrome_events, validate_chrome_trace, write_chrome_trace)

__all__ = ["machine_fingerprint", "normalization_ratio", "run_calibration", "EventRecorder",
           "Span", "Counter", "Gauge", "Histogram", "MetricsFile", "MetricsRegistry",
           "merge_histograms", "TraceRecord", "Tracer", "TraceSpan", "load_traces", "Objective",
           "SLOEngine", "objectives_from_config", "load_chrome_trace", "to_chrome_events",
           "validate_chrome_trace", "write_chrome_trace"]
