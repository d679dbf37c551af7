"""``device_idle``: share of the traced sub-window in which no operation ran
on the card (the union of the profiler's device intervals)."""

from portbench.core.readers import device_idle as read  # noqa: F401
