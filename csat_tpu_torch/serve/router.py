"""Health-aware replica routing for the serve fleet — the JAX package's
``serve/router.py`` for the port, a copy (``tests/test_torch_imports.py``
holds every definition to the original's).

The router is a pure function of public replica state: it reads
``engine.queue_depth`` and ``engine.occupancy`` (properties of
:class:`~csat_tpu_torch.serve.engine.ServeEngine`) and the fleet's
per-replica health record, never engine internals
(``tests/test_torch_fleet.py`` scans for private reads).  Being stateless
makes the fleet's dispatch a deterministic function of the submitted trace.

Health states form a one-way ladder per replica:

* ``HEALTHY`` — in rotation: receives new work.
* ``DRAINING`` — operator-initiated retirement: no new admissions, keeps
  ticking until its queue and slots empty, then closes.
* ``SICK`` — fault-tripped (rebuild cap exhausted, watchdog timeout, reap
  storm): retired at once and routed around; its queued work is
  resubmitted to healthy replicas by the fleet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

__all__ = ["HEALTHY", "SICK", "DRAINING", "Router"]

HEALTHY = "HEALTHY"
DRAINING = "DRAINING"
SICK = "SICK"


class Router:
    """Deterministic join-shortest-queue dispatch over HEALTHY replicas.

    Load is ``queue_depth + occupancy`` — the work a replica still owes,
    which is what bounds a new request's wait (queue position) plus slot
    contention.  Ties break on the LOWEST replica index, so dispatch is a
    pure function of the trace (the fleet determinism test replays a
    seeded trace and asserts identical routes)."""

    @staticmethod
    def load(replica) -> int:
        return replica.engine.queue_depth + replica.engine.occupancy

    @staticmethod
    def placement(pick, replicas: Sequence) -> Dict[str, int]:
        """Decision context for the request trace's ``route`` span: the
        chosen replica's load and how many healthy candidates it beat —
        enough to reconstruct WHY the router placed a request where it
        did without replaying the whole fleet state."""
        return {"load": Router.load(pick),
                "healthy": sum(1 for r in replicas if r.health == HEALTHY)}

    def pick(self, replicas: Sequence) -> Optional[object]:
        """The HEALTHY replica new work goes to; None when none remain."""
        healthy = [r for r in replicas if r.health == HEALTHY]
        if not healthy:
            return None
        return min(healthy, key=lambda r: (self.load(r), r.index))

    def shed_target(self, replicas: Sequence) -> Optional[object]:
        """Where fleet-level ``shed_oldest`` sheds from: the HEALTHY
        replica with the deepest queue (ties on lowest index) — shedding
        anywhere else would leave the worst backlog untouched."""
        healthy = [r for r in replicas
                   if r.health == HEALTHY and r.engine.queue_depth]
        if not healthy:
            return None
        return min(healthy,
                   key=lambda r: (-r.engine.queue_depth, r.index))
