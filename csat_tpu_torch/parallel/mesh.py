"""The data mesh axis over ``torch.distributed``: data parallelism.

Counterpart of the JAX package's ``parallel/mesh.py:74-163, 272-284``.  There
a named ``jax.sharding.Mesh`` over every device shards the batch on its
``data`` axis and XLA inserts the gradient ``psum``.  Here each process of a
``torch.distributed`` group is one member of the ``data`` axis: it feeds its
own rows of the global batch (``iterate_batches(num_shards=world,
shard_index=rank)``), the train step sums the gradients of every process with
one flat ``all_reduce`` per dtype (:func:`allreduce_grads`), and the
parameters stay replicated because every process applies the same update.

:func:`build_mesh` resolves a ``-1`` axis against the world size and refuses
a mesh that does not cover it exactly.  Only the ``data`` axis may be larger
than 1 (``configs.NEXT_PARALLEL_SLICE``).  Without a process group the mesh
is the one process: every collective here is then skipped, and the step is
the one-process step (under a group of one process they run, as identities).

:class:`DataShard` is what the model needs to know of it: the first global
row this process holds and the global row count — so the counter hash
streams are drawn at global batch·head indices (``bh0 = row0 · H``), the
shared graph noise and the model-dropout masks are this process's slices of
draws at the global batch's shape, and the sparsity term is normalised by
the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["DATA_AXIS", "Mesh", "DataShard", "build_mesh", "mesh_descriptor",
           "allreduce_grads", "allreduce_sums", "broadcast_params"]

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axis sizes over a process group (``None``: no group, one
    process) and this process's rank in it."""

    axes: Tuple[Tuple[str, int], ...]
    rank: int = 0
    group: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def data(self) -> int:
        """Members of the ``data`` axis: the processes that split a batch."""
        return self.shape.get(DATA_AXIS, 1)

    @property
    def size(self) -> int:
        out = 1
        for _, n in self.axes:
            out *= n
        return out

    def rows(self, local_rows: int) -> Tuple[int, int]:
        """``(b0, B_loc)``: the global rows ``[b0, b0 + B_loc)`` this
        process holds when each member of the data axis holds
        ``local_rows`` (the rank-ordered concatenation of the members'
        batches is the global batch)."""
        return self.rank * local_rows, local_rows


@dataclasses.dataclass(frozen=True)
class DataShard:
    """A process's rows of a global batch, as the model sees them.

    ``row0`` is the first global row held, ``rows`` the global batch's row
    count.  Every random tensor the model draws for its rows (the shared
    noise mode's graph noise, the model-dropout masks) is drawn at the
    global batch's shape and sliced, so the processes' generators advance
    alike whatever their local row counts, and the per-layer hash seeds
    drawn between those tensors are the same on every process."""

    row0: int
    rows: int


def _world() -> Tuple[int, int, Optional[object]]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    return 1, 0, None


def build_mesh(mesh_shape: Sequence[Tuple[str, int]] = ((DATA_AXIS, -1),)) -> Mesh:
    """The mesh of ``mesh_shape`` over the current process group (one
    process when there is none).  A ``-1`` entry takes the processes the
    other axes leave; the axes must cover the group exactly — a smaller mesh
    would leave processes training copies nobody reads, a larger one cannot
    be placed."""
    world, rank, group = _world()
    names = [n for n, _ in mesh_shape]
    sizes = [int(s) for _, s in mesh_shape]
    if -1 in sizes:
        fixed = 1
        for s in sizes:
            if s != -1:
                fixed *= s
        if world % fixed:
            raise ValueError(f"mesh {tuple(mesh_shape)} cannot fill {world} processes")
        sizes[sizes.index(-1)] = world // fixed
    mesh = Mesh(axes=tuple(zip(names, sizes)), rank=rank, group=group)
    if mesh.size != world:
        raise ValueError(
            f"mesh {mesh.shape} needs {mesh.size} processes but the group has {world}; "
            "give the data axis -1 (e.g. --set \"mesh_shape=(('data', -1),)\") to fill it")
    unported = {n: s for n, s in mesh.axes if n != DATA_AXIS and s != 1}
    if unported:
        from csat_tpu_torch.configs import NEXT_PARALLEL_SLICE

        raise NotImplementedError(f"mesh axes {unported}: {NEXT_PARALLEL_SLICE}")
    return mesh


def mesh_descriptor(mesh: Optional[Mesh]) -> str:
    """Stable topology digest: axis names and sizes and the device kinds
    (``solo/...`` for no mesh), as the JAX package's warm-start key reads
    it."""
    if torch.cuda.is_available():
        kinds = sorted({torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())})
    else:
        kinds = ["cpu"]
    if mesh is None:
        return f"solo/{'+'.join(kinds)}"
    axes = ",".join(f"{n}={s}" for n, s in mesh.axes)
    return f"mesh[{axes}]/{'+'.join(kinds)}"


def _flat_groups(tensors: Sequence[torch.Tensor]):
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return by_dtype.values()


def allreduce_grads(grads: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Sum ``grads`` over the data axis, in place: one flat bucket and one
    ``all_reduce(SUM)`` per dtype.  Reads nothing on the host (on NCCL the
    collective is queued on the current stream), so the step still syncs
    nothing; the summed gradients are the same bits on every process."""
    if mesh.group is None:
        return
    import torch.distributed as dist

    for group in _flat_groups(grads):
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        torch._foreach_copy_(group, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in group]), group)])


def allreduce_sums(values: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``values`` summed over the data axis (a new tensor; the input itself
    without a process group)."""
    if mesh.group is None:
        return values
    import torch.distributed as dist

    out = values.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def broadcast_params(params: Dict[str, torch.Tensor], mesh: Mesh) -> None:
    """Make every process start from rank 0's parameters, in place, and check
    that each process's own were already equal to them (they are drawn from
    the same seed; a difference means the processes were configured apart).
    Raises ``RuntimeError`` on every process when any differed."""
    if mesh.group is None:
        return
    import torch.distributed as dist

    tensors = [p.detach() for p in params.values()]
    apart = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    for group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        mine = flat.clone()
        dist.broadcast(flat, src=0, group=mesh.group)
        apart = apart + (~torch.eq(flat, mine)).sum()
        torch._foreach_copy_(group, [f.view_as(t) for f, t in zip(
            flat.split([t.numel() for t in group]), group)])
    dist.all_reduce(apart, op=dist.ReduceOp.MAX, group=mesh.group)
    if float(apart):
        raise RuntimeError(f"initial parameters differ across processes in {int(apart)} "
                           "entries on some process: every process must build the model "
                           "from the same config and seed")
