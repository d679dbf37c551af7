"""Metrics-driven fleet supervisor: heal, scale up, scale down — the JAX
package's ``serve/autoscale.py`` for the port, a copy
(``tests/test_torch_imports.py`` holds every definition to the original's).

The fleet gives the levers (``add_replica`` / ``set_target`` /
``drain_replica``); this module closes the loop from its metrics to them.
Each evaluation, gated on fleet ticks, does at most one thing, in order:

1. **Heal** — the fleet is below target (a replica was retired by a watchdog
   trip, rebuild-cap exhaustion, a reap storm or chaos): spawn a
   replacement at once.  No hysteresis and no cooldown, but a heal counts
   against the churn budget, so a crash-looping bring-up degrades to a
   bounded retry cadence instead of a spawn storm.
2. **Scale up** — any pressure signal over its threshold (fleet queue depth
   per healthy slot, the worst healthy replica's KV page occupancy, class-0
   p95 against an optional SLO) for ``serve_autoscale_hysteresis``
   consecutive evaluations raises the target by one and spawns.
3. **Scale down** — both underload signals (queue per slot and busy-slot
   fraction) under threshold for as long drains the highest-index healthy
   replica after lowering the target, so ``capacity_frac`` never dips below
   1.0 on a voluntary shrink.

Scale actions also respect ``serve_autoscale_cooldown_s``, and every action
shares the sliding-window churn bound (``serve_autoscale_max_actions`` per
``serve_autoscale_churn_window_s``).  The supervisor reads the fleet and its
engines only through public surfaces (``tests/test_torch_fleet.py`` scans for
private reads) and emits ``autoscale.heal`` / ``autoscale.up`` /
``autoscale.down`` into the fleet's recorder.  ``slo`` is any object with
``alerts``, e.g. the burn-rate :class:`~csat_tpu_torch.obs.slo.SLOEngine`:
the objectives firing when a decision is taken are stamped into its event.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, List, Optional

from csat_tpu_torch.configs import Config

__all__ = ["AutoScaler"]


class AutoScaler:
    """Drives one :class:`~csat_tpu_torch.serve.fleet.Fleet` from its metrics.

    Call :meth:`step` from the serve loop (every iteration is fine — the
    evaluation cadence is self-gated on fleet ticks).  Returns the list
    of actions taken (``"heal" | "up" | "down"``), empty when idle."""

    def __init__(self, fleet: Any, cfg: Optional[Config] = None,
                 log: Callable[[str], None] = lambda m: None,
                 slo: Any = None):
        self.fleet = fleet
        self.cfg = cfg if cfg is not None else fleet.cfg
        # optional SLO engine (anything with ``alerts``): when set, each
        # heal/up/down event carries the objectives firing at decision
        # time, so burn-rate pressure and the supervisor's response sit
        # on the same timeline row
        self.slo = slo
        c = self.cfg
        self.min_replicas = c.serve_min_replicas
        # ceiling defaults to the constructed size so `--autoscale` on a
        # fixed `--replicas N` fleet heals but never silently outgrows it
        self.max_replicas = c.serve_max_replicas or max(
            fleet.target_replicas, c.serve_min_replicas)
        self.log = log
        self._last_eval_tick = -(10 ** 9)
        self._last_scale_t = -float("inf")
        self._over = 0   # consecutive over-pressure evaluations
        self._under = 0  # consecutive underload evaluations
        self._actions: Deque[float] = deque()  # action timestamps (churn)
        self.heals = 0
        self.ups = 0
        self.downs = 0

    # ---------------- the control loop ----------------

    def step(self) -> List[str]:
        f = self.fleet
        if f.ticks - self._last_eval_tick < self.cfg.serve_autoscale_every_ticks:
            return []
        self._last_eval_tick = f.ticks
        now = f.clock()
        healthy = f.healthy_replicas

        # 1) heal toward target — before any sizing decision
        want = min(f.target_replicas, self.max_replicas)
        if len(healthy) < want:
            if not self._churn_ok(now):
                return []
            self._actions.append(now)
            rep = f.add_replica()
            self.heals += 1
            f.obs.emit("autoscale.heal", ok=int(rep is not None),
                       healthy=len(f.healthy_replicas), target=want,
                       **self._slo_fields())
            return ["heal"]

        qfrac, page_occ, p95, busy = self._signals(healthy)
        c = self.cfg
        over = (qfrac >= c.serve_autoscale_up_queue_frac
                or page_occ >= c.serve_autoscale_up_page_frac
                or (c.serve_autoscale_p95_slo_s > 0
                    and p95 > c.serve_autoscale_p95_slo_s))
        under = (qfrac <= c.serve_autoscale_down_queue_frac
                 and busy <= c.serve_autoscale_down_busy_frac)
        self._over = self._over + 1 if over else 0
        self._under = self._under + 1 if under else 0

        # 2) scale up
        if (self._over >= c.serve_autoscale_hysteresis
                and len(healthy) < self.max_replicas
                and self._cooldown_ok(now) and self._churn_ok(now)):
            self._note_scale(now)
            f.set_target(f.target_replicas + 1)
            rep = f.add_replica()
            self.ups += 1
            self._over = 0
            f.obs.emit("autoscale.up", ok=int(rep is not None),
                       target=f.target_replicas, queue_frac=round(qfrac, 3),
                       page_occ=round(page_occ, 3), p95_s=round(p95, 4),
                       **self._slo_fields())
            self.log(f"# autoscale: up → target {f.target_replicas} "
                     f"(queue/slot {qfrac:.2f}, pages {page_occ:.2f}, "
                     f"p95 {p95:.3f}s)")
            return ["up"]

        # 3) scale down (drain-then-remove; the fleet tick closes it)
        if (self._under >= c.serve_autoscale_hysteresis
                and len(healthy) > self.min_replicas
                and f.target_replicas > self.min_replicas
                and self._cooldown_ok(now) and self._churn_ok(now)):
            victim = max(healthy, key=lambda r: r.index)
            self._note_scale(now)
            f.set_target(f.target_replicas - 1)
            f.drain_replica(victim.index)
            self.downs += 1
            self._under = 0
            f.obs.emit("autoscale.down", replica=victim.index,
                       target=f.target_replicas, queue_frac=round(qfrac, 3),
                       busy_frac=round(busy, 3), **self._slo_fields())
            self.log(f"# autoscale: down → target {f.target_replicas} "
                     f"(draining replica {victim.index})")
            return ["down"]
        return []

    # ---------------- signals + rate limits ----------------

    def _slo_fields(self) -> dict:
        if self.slo is None or not self.slo.alerts:
            return {}
        return {"slo_firing": ",".join(sorted(self.slo.alerts))}

    def _signals(self, healthy: List[Any]):
        """(queue per healthy slot, worst page occupancy, class-0 p95,
        busy-slot fraction) — all from public fleet/engine surfaces."""
        f = self.fleet
        slots = sum(r.engine.num_slots for r in healthy) or 1
        qfrac = f.queue_depth / slots
        occs = [r.engine.stats.pages_in_use / r.engine.stats.pages_usable
                for r in healthy if r.engine.stats.pages_usable]
        page_occ = max(occs) if occs else 0.0
        p95 = max((r.engine.stats.class_p95(0) for r in healthy),
                  default=0.0)
        busy = f.occupancy / slots
        return qfrac, page_occ, p95, busy

    def _cooldown_ok(self, now: float) -> bool:
        return (now - self._last_scale_t
                >= self.cfg.serve_autoscale_cooldown_s)

    def _note_scale(self, now: float) -> None:
        self._last_scale_t = now
        self._actions.append(now)

    def _churn_ok(self, now: float) -> bool:
        win = self.cfg.serve_autoscale_churn_window_s
        while self._actions and now - self._actions[0] > win:
            self._actions.popleft()
        return len(self._actions) < self.cfg.serve_autoscale_max_actions
