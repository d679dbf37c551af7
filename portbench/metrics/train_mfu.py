"""``train_mfu``: model FLOPs of the window's real nodes and tokens (forward
and backward, ``portbench/core/counts.py``) over the window, as a share of
the card's f32-exact tensor-core peak."""

from portbench.core.readers import train_mfu as read  # noqa: F401
