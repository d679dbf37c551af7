"""Step watchdog: a heartbeat thread that refuses to wedge forever.

Counterpart of the JAX package's ``resilience/watchdog.py``.  A device step
that never completes leaves the host blocked in a runtime call and the job
sitting silently until a human kills it.  The watchdog turns that into a
bounded outage: the training loop beats once per step; if no beat arrives
within the timeout while armed, the watchdog dumps diagnostics (all thread
stacks — including where the main thread is stuck — via ``faulthandler``)
and invokes its timeout action, by default ``os._exit(EXIT_WATCHDOG)`` so a
supervisor can restart and resume.  ``os._exit`` is deliberate: a wedged
runtime can hang interpreter finalizers, which is exactly the state being
escaped.

The watchdog arms at the first beat, so the first step — which builds the
port's kernels with ``nvcc`` at first use, for minutes — cannot trip it; the
loop disarms it around phases of another cadence (validation decodes,
checkpoint saves) and the next beat re-arms it.

Host beats track *host-observable* progress only: PyTorch enqueues kernels
and returns, so the host can keep beating for a while after the device has
stopped completing work.  The optional **device-side liveness probe**
(``cfg.watchdog_device_probe``, :func:`device_liveness_probe`) closes that
gap: on a thread of its own it enqueues a tiny op on the training stream —
behind whatever the steps queued there — and blocks until it completes; if
probes stop completing while the watchdog is armed, it trips even though
host beats continue.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

__all__ = ["EXIT_WATCHDOG", "StepWatchdog", "device_liveness_probe"]

# distinct from EXIT_PREEMPTED so supervisors can tell "hung hardware" from
# "preempted", while both mean "resume me"
EXIT_WATCHDOG = 76


def _default_abort() -> None:  # pragma: no cover - exits the process
    os._exit(EXIT_WATCHDOG)


def device_liveness_probe(device=None) -> Callable[[], None]:
    """→ a zero-argument callable that enqueues a one-element add on the
    stream the caller's thread uses now — the training stream, when the
    training loop builds the probe — and blocks until the device has run
    it.  The op queues *behind* every step enqueued before it, so a wedged
    step stalls the probe: the probe thread stops updating its completion
    time and the armed watchdog trips.  On the CPU the add runs at once.
    ``device`` defaults to ``cuda``."""
    import torch

    device = torch.device(device or "cuda")
    pulse = torch.zeros((), device=device)
    if device.type != "cuda":
        def probe() -> None:
            pulse.add_(1)

        return probe
    stream = torch.cuda.current_stream(device)

    def probe() -> None:
        with torch.cuda.stream(stream):
            pulse.add_(1)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()

    return probe


class StepWatchdog:
    """Heartbeat monitor for the training step.

    ``beat()`` marks progress and (re-)arms; ``disarm()`` suspends
    monitoring between armed phases.  The monitor thread polls at
    ``timeout_s / 4`` granularity, so a hang is detected within
    ``~1.25 × timeout_s`` of the last beat."""

    def __init__(
        self,
        timeout_s: float,
        on_timeout: Optional[Callable[[], None]] = None,
        diag_path: Optional[str] = None,
        log: Callable[[str], None] = lambda m: print(m, file=sys.stderr),
        probe: Optional[Callable[[], None]] = None,
        probe_interval_s: Optional[float] = None,
        on_trip: Optional[Callable[[str, float], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        assert timeout_s > 0, timeout_s
        self.timeout_s = float(timeout_s)
        self._on_timeout = on_timeout or _default_abort
        # observability hook: called with (what, stalled_s) BEFORE the
        # diagnostics and the abort, so the trip lands in the flight
        # recorder and a post-mortem is dumped while the process still
        # exists.  Runs on the monitor thread; its exceptions are swallowed
        # — telemetry must never mask the abort itself
        self._on_trip = on_trip
        # the time base of beats and probes: wall time in production; a
        # drill passes a virtual clock and calls check() itself, so the trip
        # depends on no thread's timing
        self._clock = clock
        self._diag_path = diag_path
        self._log = log
        self._lock = threading.Lock()
        self._armed = False
        self._last_beat = 0.0
        self._stop = threading.Event()
        self._tripped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # optional device-side liveness probe: runs on its own thread so a
        # wedged device blocks the PROBE, not the monitor — the monitor
        # just watches completion staleness
        self._probe = probe
        self._probe_interval = float(
            probe_interval_s if probe_interval_s is not None
            else max(0.05, self.timeout_s / 4.0))
        self._last_probe = 0.0
        self._probe_thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "StepWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="step-watchdog",
                                            daemon=True)
            self._thread.start()
        if self._probe is not None and self._probe_thread is None:
            self._last_probe = self._clock()  # grace until the first probe
            self._probe_thread = threading.Thread(target=self._run_probe,
                                                  name="device-probe", daemon=True)
            self._probe_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s)
            self._thread = None
        if self._probe_thread is not None:
            # a probe blocked on a wedged device never joins — it is a
            # daemon thread, abandon it rather than hang shutdown
            self._probe_thread.join(timeout=self._probe_interval)
            self._probe_thread = None

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- heartbeat ---------------------------------------------------------

    def beat(self) -> None:
        """Record progress and arm (or re-arm) the monitor."""
        with self._lock:
            self._last_beat = self._clock()
            self._armed = True

    def disarm(self) -> None:
        """Suspend monitoring (validation, checkpoint save)."""
        with self._lock:
            self._armed = False

    @property
    def tripped(self) -> bool:
        return self._tripped.is_set()

    # -- monitor -----------------------------------------------------------

    def _run(self) -> None:
        poll = self.timeout_s / 4.0
        while not self._stop.wait(poll):
            if self.check():
                return

    def check(self) -> bool:
        """One look at the beats (the monitor thread's poll): trip when the
        armed watchdog has seen no beat — or, with the device leg, no
        completed probe — within the timeout.  Returns whether it has
        tripped; it trips at most once."""
        with self._lock:
            if self._tripped.is_set():
                return True
            armed, last = self._armed, self._last_beat
            last_probe = self._last_probe
            now = self._clock()
            if not armed:
                return False
            if now - last > self.timeout_s:
                stalled, what = now - last, "no completed step"
            # device leg: host beats can keep flowing while the device is
            # wedged — a stalled PROBE is the authoritative device-down
            # signal.  The window adds one probe interval so a probe in
            # flight at the deadline is not a false positive
            elif (self._probe is not None
                    and now - last_probe > self.timeout_s + self._probe_interval):
                stalled, what = now - last_probe, "no completed device probe"
            else:
                return False
            self._tripped.set()
        self._trip(stalled, what)
        return True

    def _run_probe(self) -> None:
        while not self._stop.wait(self._probe_interval):
            try:
                self._probe()
            except Exception:  # noqa: BLE001 — a failing device must trip, not
                continue       # crash the thread: staleness accumulates until the check fires
            with self._lock:
                self._last_probe = self._clock()

    def _trip(self, stalled_s: float, what: str = "no completed step") -> None:
        if self._on_trip is not None:
            try:
                self._on_trip(what, stalled_s)
            except Exception:  # noqa: BLE001 — a broken hook must not block the abort
                pass
        self._log(
            f"# watchdog: {what} for {stalled_s:.1f}s "
            f"(timeout {self.timeout_s:.1f}s) — dumping diagnostics and "
            "aborting with a resumable exit; the run can continue with "
            "fit(resume=True)")
        self._dump_diagnostics()
        self._on_timeout()

    def _dump_diagnostics(self) -> None:
        """All thread stacks → stderr and (when configured) a diagnostics
        file, so the post-mortem shows exactly which call wedged."""
        try:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        except Exception:  # noqa: BLE001 — diagnostics must not mask the abort
            pass
        if self._diag_path:
            try:
                os.makedirs(os.path.dirname(self._diag_path), exist_ok=True)
                with open(self._diag_path, "w") as f:
                    f.write(f"watchdog trip at monotonic {time.monotonic()}\n"
                            f"timeout_s={self.timeout_s}\n")
                    faulthandler.dump_traceback(file=f, all_threads=True)
            except Exception:  # noqa: BLE001 — best-effort file; stderr has the stacks
                pass
