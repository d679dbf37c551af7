"""``serve_mfu``: model FLOPs of the prefills and decode steps of the
requests that ended in the window, over the window, as a share of the card's
f32-exact tensor-core peak."""

from portbench.core.readers import serve_mfu as read  # noqa: F401
