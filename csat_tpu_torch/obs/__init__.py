"""Telemetry the trainer carries (the JAX package's ``obs/``, the parts the
trainer uses): a typed metrics registry with Prometheus text and JSONL
snapshots (``metrics.py``), a bounded event flight recorder dumped to
rolling post-mortem files on fault paths (``events.py``), and the
recorder's export as Chrome trace-event JSON (``trace.py``).

All of it is host-side (host clocks only, no device syncs) and gated by the
``obs_*`` config fields — cheap-on by default."""

from csat_tpu_torch.obs.events import EventRecorder, Span
from csat_tpu_torch.obs.metrics import (
    Counter, Gauge, Histogram, MetricsFile, MetricsRegistry, merge_histograms)
from csat_tpu_torch.obs.trace import (
    load_chrome_trace, to_chrome_events, validate_chrome_trace, write_chrome_trace)

__all__ = ["EventRecorder", "Span", "Counter", "Gauge", "Histogram", "MetricsFile",
           "MetricsRegistry", "merge_histograms", "load_chrome_trace", "to_chrome_events",
           "validate_chrome_trace", "write_chrome_trace"]
