"""Telemetry the trainer and the serving engine carry (the JAX package's
``obs/``, the parts they use): a typed metrics registry with Prometheus text
and JSONL snapshots (``metrics.py``), a bounded event flight recorder dumped
to rolling post-mortem files on fault paths (``events.py``), the recorder's
export as Chrome trace-event JSON (``trace.py``), and request-scoped traces
of the serving engine (``rtrace.py``).

All of it is host-side (host clocks only, no device syncs) and gated by the
``obs_*`` config fields — cheap-on by default."""

from csat_tpu_torch.obs.events import EventRecorder, Span
from csat_tpu_torch.obs.metrics import (
    Counter, Gauge, Histogram, MetricsFile, MetricsRegistry, merge_histograms)
from csat_tpu_torch.obs.rtrace import TraceRecord, Tracer, TraceSpan, load_traces
from csat_tpu_torch.obs.trace import (
    load_chrome_trace, to_chrome_events, validate_chrome_trace, write_chrome_trace)

__all__ = ["EventRecorder", "Span", "Counter", "Gauge", "Histogram", "MetricsFile",
           "MetricsRegistry", "merge_histograms", "TraceRecord", "Tracer", "TraceSpan",
           "load_traces", "load_chrome_trace", "to_chrome_events",
           "validate_chrome_trace", "write_chrome_trace"]
