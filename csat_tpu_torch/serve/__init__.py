"""Continuous-batching serving over the block-paged KV pool: the engine with
its prefix cache and five request outcomes (``engine.py``), its storage —
the rectangle layout (``slots.py``), the KV tiers below the page pool
(``tiering.py``) and the warm-start store of kernel libraries
(``warmstart.py``) —, the serve stats (``stats.py``), raw-code ingest
(``ingest.py``) and the ``summarize`` / ``serve`` command line
(``cli.py``)."""

from csat_tpu_torch.serve.engine import PagePlan, Request, RequestStatus, ServeEngine
from csat_tpu_torch.serve.ingest import PoisonRequestError, validate_sample
from csat_tpu_torch.serve.prefix import PrefixCache, PrefixEntry, sample_hash
from csat_tpu_torch.serve.stats import ServeStats, percentile

__all__ = ["PagePlan", "Request", "RequestStatus", "ServeEngine", "PoisonRequestError",
           "validate_sample", "PrefixCache", "PrefixEntry", "sample_hash", "ServeStats",
           "percentile"]
