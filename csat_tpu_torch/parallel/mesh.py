"""Mesh axes over ``torch.distributed``: data, sequence and pipeline parallelism.

Counterpart of the JAX package's ``parallel/mesh.py:74-163, 272-284``.  There
a named ``jax.sharding.Mesh`` over every device shards the batch on its
``data`` axis, the node axis on ``seq`` and the encoder's blocks on ``pipe``.
Here each process of a ``torch.distributed`` group is one device of the mesh:
its rank is the flat index of its coordinates in ``mesh_shape`` order, as JAX
lays devices out row-major (``mesh.py:74-87``), and every line of every axis
(the processes that differ only in that axis's coordinate) gets a process
group of its own, which the collectives along that axis use
(:mod:`csat_tpu_torch.parallel.collectives`).

* ``data``: each member of the axis feeds its own rows of the global batch
  (``iterate_batches(num_shards=data, shard_index=<data coordinate>)``);
  processes that differ only in ``seq`` / ``pipe`` hold the same rows.
* ``seq``: every member holds the whole batch; the SBM stack keeps its own
  N/P node rows and the ring rotates K/V blocks around the axis
  (``parallel/ring.py``).
* ``pipe``: every member holds the whole batch and all parameters; stage r
  runs blocks ``[r·L/P, (r+1)·L/P)`` of the GPipe wavefront
  (``parallel/pipeline.py``).

The train step sums the gradients of every process with one flat
``all_reduce`` per dtype (:func:`allreduce_grads`) after scaling each
process's loss by ``1/(seq·pipe)`` (:attr:`Mesh.replicas`): a parameter used
replicated along ``seq`` / ``pipe`` then gets its gradient once, one used on
a shard gets the shards' sum.  The metrics are summed over the ``data`` line
only (:func:`allreduce_sums`).  A ``model`` axis larger than 1 is refused
(``configs.NEXT_PARALLEL_SLICE``).  Without a process group the mesh is the
one process: every collective here is then skipped, and the step is the
one-process step (under a group of one process they run, as identities).

:class:`DataShard` is what the model needs to know of it
(:meth:`Mesh.shard`): the first global row this process holds and the
global row count — so the counter hash streams are drawn at global
batch·head indices (``bh0 = row0 · H``), the shared graph noise and the
model-dropout masks are this process's slices of draws at the global
batch's shape, and the sparsity term is normalised by the global batch —
and the ``seq`` / ``pipe`` axes it runs along.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["DATA_AXIS", "SEQ_AXIS", "PIPE_AXIS", "Axis", "Mesh", "DataShard",
           "build_mesh", "pipeline_reference_mesh", "mesh_descriptor", "allreduce_grads",
           "allreduce_sums", "broadcast_params", "forget_groups"]

DATA_AXIS = "data"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"


@dataclasses.dataclass(frozen=True)
class Axis:
    """This process's line along one mesh axis: its ``size``, this process's
    ``index`` on it, the process ``group`` of the line (None when the axis
    has one member or there is no process group: its collectives are then
    identities) and the line's global ranks by index."""

    name: str
    size: int = 1
    index: int = 0
    group: Optional[object] = None
    ranks: Tuple[int, ...] = (0,)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axis sizes over a process group (``None``: no group, one
    process), this process's rank in it, its coordinates and its lines.

    ``pipe_data_groups`` > 1 marks the one-process stand-in for a pipeline
    run over that many data shards (:func:`pipeline_reference_mesh`)."""

    axes: Tuple[Tuple[str, int], ...]
    rank: int = 0
    group: Optional[object] = None
    lines: Tuple[Axis, ...] = ()
    pipe_data_groups: int = 1

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

    @property
    def replicas(self) -> int:
        """The processes that hold one data shard (``seq · pipe``): each
        process's loss is scaled by its inverse before the backward."""
        return self.size // self.data

    def axis(self, name: str) -> Axis:
        """This process's line along ``name`` (a one-member axis when the mesh
        has no such axis)."""
        for line in self.lines:
            if line.name == name:
                return line
        return Axis(name)

    def coord(self, name: str) -> int:
        return self.axis(name).index

    def rows(self, local_rows: int) -> Tuple[int, int]:
        """``(b0, B_loc)``: the global rows ``[b0, b0 + B_loc)`` this
        process holds when each member of the data axis holds
        ``local_rows`` (the data-coordinate-ordered concatenation of the
        members' batches is the global batch)."""
        return self.coord(DATA_AXIS) * local_rows, local_rows

    def shard(self, local_rows: int) -> "DataShard":
        """The :class:`DataShard` of this process's ``local_rows`` rows."""
        row0, rows = self.rows(local_rows)
        seq = self.axis(SEQ_AXIS)
        pipe = self.axis(PIPE_AXIS) if PIPE_AXIS in self.shape else None
        return DataShard(row0=row0, rows=rows * self.data,
                         seq=seq if seq.size > 1 else None, pipe=pipe,
                         pipe_data_groups=self.pipe_data_groups)

    def decode_shard(self, rows: int) -> Optional["DataShard"]:
        """The shard of an eval batch this process decodes on its own (its
        data line's share of a dataset, rows from 0) along its ``seq`` /
        ``pipe`` axes; None when the mesh has neither."""
        shard = self.shard(rows)
        if shard.seq is None and shard.pipe is None:
            return None
        return dataclasses.replace(shard, row0=0, rows=rows, pipe_data_groups=1)


@dataclasses.dataclass(frozen=True)
class DataShard:
    """A process's rows of a global batch, as the model sees them.

    ``row0`` is the first global row held, ``rows`` the global batch's row
    count.  Every random tensor the model draws for its rows (the shared
    noise mode's graph noise, the model-dropout masks) is drawn at the
    global batch's shape and sliced, so the processes' generators advance
    alike whatever their local row counts, and the per-layer hash seeds
    drawn between those tensors are the same on every process.

    ``seq`` is the sequence axis the SBM stack's node rows are split over
    (None: whole rows); inside that stack ``node0`` / ``nodes`` place this
    process's node rows in the batch's ``nodes`` (a dropout mask is then
    drawn at the whole node count and sliced too).  ``pipe`` is the pipeline
    axis the encoder's blocks run along (None: the sequential loop), with
    ``pipe_data_groups`` data shards folded into one process by the
    one-process reference."""

    row0: int
    rows: int
    seq: Optional[Axis] = None
    pipe: Optional[Axis] = None
    pipe_data_groups: int = 1
    node0: int = 0
    nodes: Optional[int] = None


def _world() -> Tuple[int, int, Optional[object]]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    return 1, 0, None


#: the line groups made per (axes, world): every process makes every group
#: once, in the same order; dropped when the process group is left
_GROUPS: Dict[Tuple, Tuple[Axis, ...]] = {}


def forget_groups() -> None:
    """Drop the cached line groups (the process group they belong to was
    left)."""
    _GROUPS.clear()


def _lines(axes: Tuple[Tuple[str, int], ...], rank: int, world: int, group) -> Tuple[Axis, ...]:
    """Each axis's line through ``rank``: the ranks that differ from it only
    in that axis's coordinate, with their group — the whole group when the
    line is the whole group, none when it is one process, else a
    ``dist.new_group`` made by every process for every line, in the same
    order."""
    sizes = [s for _, s in axes]
    coords = []
    rest = rank
    for s in reversed(sizes):
        coords.append(rest % s)
        rest //= s
    coords.reverse()
    out = []
    for i, (name, size) in enumerate(axes):
        mine_ranks, mine_group = (rank,), None
        if size == world and group is not None:
            mine_ranks, mine_group = tuple(range(world)), group
        elif size > 1:
            import torch.distributed as dist

            others = [range(s) if j != i else range(1) for j, s in enumerate(sizes)]
            for fixed in itertools.product(*others):
                line = []
                for k in range(size):
                    c = list(fixed)
                    c[i] = k
                    flat = 0
                    for cj, sj in zip(c, sizes):
                        flat = flat * sj + cj
                    line.append(flat)
                made = dist.new_group(line)
                if rank in line:
                    mine_ranks, mine_group = tuple(line), made
        out.append(Axis(name, size, coords[i], mine_group, mine_ranks))
    return tuple(out)


def build_mesh(mesh_shape: Sequence[Tuple[str, int]] = ((DATA_AXIS, -1),)) -> Mesh:
    """The mesh of ``mesh_shape`` over the current process group (one
    process when there is none).  A ``-1`` entry takes the processes the
    other axes leave; the axes must cover the group exactly — a smaller mesh
    would leave processes training copies nobody reads, a larger one cannot
    be placed.  A ``model`` axis larger than 1 is refused."""
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
    axes = tuple(zip(names, sizes))
    size = 1
    for s in sizes:
        size *= s
    if size != world:
        raise ValueError(
            f"mesh {dict(axes)} needs {size} processes but the group has {world}; "
            "give the data axis -1 (e.g. --set \"mesh_shape=(('data', -1),)\") to fill it")
    unported = {n: s for n, s in axes if n not in (DATA_AXIS, SEQ_AXIS, PIPE_AXIS) and s != 1}
    if unported:
        from csat_tpu_torch.configs import NEXT_PARALLEL_SLICE

        raise NotImplementedError(f"mesh axes {unported}: {NEXT_PARALLEL_SLICE}")
    key = (axes, world, rank)
    if key not in _GROUPS:
        _GROUPS[key] = _lines(axes, rank, world, group)
    return Mesh(axes=axes, rank=rank, group=group, lines=_GROUPS[key])


def pipeline_reference_mesh(mesh_shape: Sequence[Tuple[str, int]]) -> Mesh:
    """One process computing what a pipeline run over ``mesh_shape``'s
    ``data`` × ``pipe`` axes computes: the blocks run as the sequential
    microbatched loop with the wavefront's keys (microbatches formed per data
    shard, key (l, m) shared by the shards), on the global batch.  The
    pipeline tests' and the card gate's one-process side."""
    data = dict(mesh_shape).get(DATA_AXIS, 1)
    if data < 1:
        raise ValueError(f"the reference needs a fixed data axis, got {tuple(mesh_shape)}")
    axes = ((DATA_AXIS, 1), (PIPE_AXIS, 1))
    return Mesh(axes=axes, lines=(Axis(DATA_AXIS), Axis(PIPE_AXIS)), pipe_data_groups=data)


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
    """Sum ``grads`` over every process of the mesh, in place: one flat
    bucket and one ``all_reduce(SUM)`` per dtype.  Reads nothing on the host
    (on NCCL the collective is queued on the current stream), so the step
    still syncs nothing; the summed gradients are the same bits on every
    process."""
    if mesh.group is None:
        return
    import torch.distributed as dist

    for group in _flat_groups(grads):
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        torch._foreach_copy_(group, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in group]), group)])


def allreduce_sums(values: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``values`` summed over this process's ``data`` line (a new tensor;
    the input itself when the line is one process or there is no group)."""
    group = mesh.axis(DATA_AXIS).group
    if group is None:
        return values
    import torch.distributed as dist

    out = values.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
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
