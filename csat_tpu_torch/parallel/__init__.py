"""The parallel layer on ``torch.distributed``: the data, seq and pipe mesh axes.

Counterpart of the JAX package's ``parallel/``: ``host.py`` joins the
process group (NCCL between cards, gloo on the CPU or for processes sharing
a card), ``mesh.py`` builds the mesh over it (a process group per line of
each axis) and sums gradients, ``collectives.py`` holds the autograd-aware
collectives along one axis (``ppermute``, ``all_gather_axis``,
``psum_axis``), ``ring.py`` the ring attention of the ``seq`` axis,
``pipeline.py`` the GPipe wavefront of the ``pipe`` axis, and ``dryrun.py``
takes one step over a gloo group.  Tensor parallelism (a ``model`` axis)
and serve meshes are not ported yet (``configs.NEXT_PARALLEL_SLICE``).
"""

from csat_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, PIPE_AXIS, SEQ_AXIS, Axis, DataShard, Mesh, allreduce_grads, allreduce_sums,
    broadcast_params, build_mesh, mesh_descriptor, pipeline_reference_mesh)
