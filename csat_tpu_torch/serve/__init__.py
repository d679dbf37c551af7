"""Continuous-batching serving over the block-paged KV pool."""

from csat_tpu_torch.serve.engine import PagePlan, Request, RequestStatus, ServeEngine
from csat_tpu_torch.serve.ingest import PoisonRequestError, validate_sample

__all__ = ["PagePlan", "Request", "RequestStatus", "ServeEngine", "PoisonRequestError",
           "validate_sample"]
