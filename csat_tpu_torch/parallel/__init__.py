"""The parallel layer on ``torch.distributed``: the data mesh axis.

Counterpart of the JAX package's ``parallel/``: ``host.py`` joins the
process group (NCCL between cards, gloo on the CPU or for processes sharing
a card), ``mesh.py`` builds the mesh over it and sums gradients over its
``data`` axis, ``dryrun.py`` takes one data-parallel step over a gloo group.
Tensor parallelism, the ring and GPipe (``model``, ``seq`` and ``pipe``
axes) are not ported yet (``configs.NEXT_PARALLEL_SLICE``).
"""

from csat_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, DataShard, Mesh, allreduce_grads, allreduce_sums, broadcast_params, build_mesh,
    mesh_descriptor)
