"""``kernel_roofline``: Σ bound / Σ device time over the port's kernel
launches in the traced sub-window (profiler, by kernel name; each launch's
bound from its shape, ``portbench/core/counts.py``)."""

from portbench.core.readers import kernel_roofline as read  # noqa: F401
