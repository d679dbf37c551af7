"""Multi-process bring-up: the reference's ``idist.Parallel(backend="nccl")``
launch (``script/train.py:331``) on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/host.py:27-74``, where
``jax.distributed.initialize`` joins the hosts.  Here every process of the
job calls :func:`initialize_multihost` once, with the backend named
explicitly — NCCL between cards, gloo for processes on the CPU and for
processes that share one card — and nothing falls back from one backend to
the other: a job that cannot join raises, rather than training unsynced
copies.  Each process then feeds its own slice of the batch stream, and
only rank 0 writes checkpoints and logs (:func:`is_primary`), as the
reference gates them (``train.py:196,210,247``).

Beside the default group, NCCL jobs get a gloo group over the same processes
for the host's small agreements — the preemption flag every step, the
barriers around a save — so those read nothing from the card and never wait
behind its queued work (:func:`host_group`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

__all__ = ["initialize_multihost", "global_mesh", "is_primary", "world", "host_group",
           "barrier", "shutdown"]

#: the gloo group of an NCCL job's processes (None: the default group serves)
_HOST_GROUP = []


def initialize_multihost(backend: str, init_method: str = "env://",
                         world_size: Optional[int] = None, rank: Optional[int] = None) -> None:
    """Join the job's process group: ``torch.distributed.init_process_group``
    with ``backend`` (``"nccl"`` or ``"gloo"``), ``init_method`` (``env://``
    reads ``MASTER_ADDR`` / ``MASTER_PORT``, as ``torchrun`` sets them;
    ``tcp://host:port`` or ``file:///path``), and ``world_size`` / ``rank``
    (from ``WORLD_SIZE`` / ``RANK`` when None).  A no-op when the group is
    already up.  Failures propagate."""
    import torch.distributed as dist

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if dist.is_initialized():
        return
    kw = {}
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if rank is not None:
        kw["rank"] = int(rank)
    dist.init_process_group(backend=backend, init_method=init_method, **kw)
    _HOST_GROUP.clear()
    if backend == "nccl":
        _HOST_GROUP.append(dist.new_group(backend="gloo"))


def host_group():
    """The group for host-side agreements: the gloo side group of an NCCL
    job (made by :func:`initialize_multihost`, or here, collectively, for a
    group joined another way), else the default group."""
    import torch.distributed as dist

    if _HOST_GROUP:
        return _HOST_GROUP[0]
    if dist.get_backend() != "gloo":
        _HOST_GROUP.append(dist.new_group(backend="gloo"))
        return _HOST_GROUP[0]
    return None


def global_mesh(mesh_shape: Sequence[Tuple[str, int]] = (("data", -1),)):
    """The mesh of ``mesh_shape`` over every process of the job."""
    from csat_tpu_torch.parallel.mesh import build_mesh

    return build_mesh(mesh_shape)


def world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_primary() -> bool:
    """The rank-0 gate for checkpoints and logs (true without a group)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def barrier() -> None:
    """Every process of the job waits here for the others (host side only);
    nothing on one process.  A failed rendezvous propagates."""
    import torch.distributed as dist

    if world() > 1:
        dist.barrier(group=host_group())


def shutdown() -> None:
    """Leave the process group (and drop the host side group)."""
    import torch.distributed as dist

    from csat_tpu_torch.parallel.mesh import forget_groups

    _HOST_GROUP.clear()
    forget_groups()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
