"""The parallel layer on ``torch.distributed``: the data, model, seq and pipe
mesh axes, and the serve mesh.

Counterpart of the JAX package's ``parallel/``: ``host.py`` joins the
process group (NCCL between cards, gloo on the CPU or for processes sharing
a card), ``mesh.py`` builds the mesh over it (a process group per line of
each axis), shards the parameters over the ``model`` axis (JAX's
``PARAM_RULES``), sums gradients and lays a serving engine's KV pages over
head shards, ``collectives.py`` holds the autograd-aware collectives along
one axis (``ppermute``, ``all_gather_axis``, ``psum_axis`` and the Megatron
pairs of the ``model`` axis), ``ring.py`` the ring attention of the ``seq``
axis, ``pipeline.py`` the GPipe wavefront of the ``pipe`` axis, and
``dryrun.py`` takes one step over a gloo group.
"""

from csat_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, HEAD_AXIS, PIPE_AXIS, SEQ_AXIS, Axis, DataShard, Mesh, ServeMesh, allreduce_grads,
    allreduce_sums, broadcast_params, build_mesh, build_serve_mesh, gather_params,
    mesh_descriptor, pipeline_reference_mesh, shard_model, shard_params)
