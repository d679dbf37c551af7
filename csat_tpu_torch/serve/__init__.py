"""Continuous-batching serving over the block-paged KV pool: the engine with
its prefix cache and five request outcomes (``engine.py``), its storage —
the rectangle layout (``slots.py``), the KV tiers below the page pool
(``tiering.py``) and the warm-start store of kernel libraries
(``warmstart.py``) —, the replica fleet behind its router (``fleet.py``,
``router.py``) and its autoscaler (``autoscale.py``), the traffic zoo
(``traffic.py``), the serve stats (``stats.py``), raw-code ingest
(``ingest.py``) and the ``summarize`` / ``serve`` command line
(``cli.py``)."""

from csat_tpu_torch.serve.autoscale import AutoScaler
from csat_tpu_torch.serve.engine import PagePlan, Request, RequestStatus, ServeEngine
from csat_tpu_torch.serve.fleet import Fleet, Replica
from csat_tpu_torch.serve.ingest import PoisonRequestError, validate_sample
from csat_tpu_torch.serve.prefix import PrefixCache, PrefixEntry, sample_hash
from csat_tpu_torch.serve.router import DRAINING, HEALTHY, SICK, Router
from csat_tpu_torch.serve.stats import ServeStats, percentile
from csat_tpu_torch.serve.traffic import (
    DEFAULT_CLASSES, TRACE_ZOO, PriorityClass, Trace, TraceItem, TraceSpec, make_trace, replay,
    zoo_spec)
from csat_tpu_torch.serve.warmstart import WarmStartStore

__all__ = ["AutoScaler", "PagePlan", "Request", "RequestStatus", "ServeEngine", "Fleet",
           "Replica", "PoisonRequestError", "validate_sample", "PrefixCache", "PrefixEntry",
           "sample_hash", "DRAINING", "HEALTHY", "SICK", "Router", "ServeStats", "percentile",
           "DEFAULT_CLASSES", "TRACE_ZOO", "PriorityClass", "Trace", "TraceItem", "TraceSpec",
           "make_trace", "replay", "zoo_spec", "WarmStartStore"]
