"""Mesh axes over ``torch.distributed``: data, tensor, sequence and pipeline
parallelism, and the serve mesh.

Counterpart of the JAX package's ``parallel/mesh.py``.  There a named
``jax.sharding.Mesh`` over every device shards the batch on its ``data``
axis, the heads and the FFN hidden on ``model``, the node axis on ``seq``
and the encoder's blocks on ``pipe``.
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
* ``model``: every member holds the whole batch and its shard of the
  parameters :data:`PARAM_RULES` match — JAX's regexes over the flax paths
  (``convert.flax_path``) — in the Megatron column/row layout: attention
  q/k/v and the first FFN dense split on their outputs (this member's heads
  and hidden units), the out-projections, the second FFN dense and the
  output head on their inputs, the embedding tables on their features
  (:func:`shard_params` / :func:`gather_params`, :func:`shard_model`).  The
  modules run their own heads and hidden units between the autograd pairs
  of ``parallel/collectives.py``.

The train step scales each process's loss by ``1/(seq·pipe)``
(:attr:`Mesh.replicas`) and sums the gradients with one flat
``all_reduce`` per dtype (:func:`allreduce_grads`): over the processes that
hold the same parameter shard (every axis but ``model``, :attr:`Mesh.
replica_line`) — a parameter used replicated along ``seq`` / ``pipe`` then
gets its gradient once, one used on a shard gets the shards' sum, and a
``model`` shard or a replicated parameter the Megatron pairs make whole
on every ``model`` member is not counted ``model`` times — and, for the
replicated parameters each ``model`` member applies to its own heads only
(:data:`HEAD_LOCAL_RULES`: their gradients are the members' parts), over
every process.  The metrics are summed over the ``data`` line only
(:func:`allreduce_sums`).  Without a process group the mesh is the one
process: every collective here is then skipped, and the step is the
one-process step (under a group of one process they run, as identities).

A serve mesh (:func:`build_serve_mesh`) is the JAX package's single
controller: one process and one engine whose KV pages are split on the head
axis over a device per head shard (:func:`serve_head_shards`,
:func:`serve_page_sharding`), everything else on the engine's own device.

:class:`DataShard` is what the model needs to know of it
(:meth:`Mesh.shard`): the first global row this process holds and the
global row count — so the counter hash streams are drawn at global
batch·head indices (``bh0 = row0 · H + h0``, the head stride ``H``), the
shared graph noise and the model-dropout masks are this process's slices of
draws at the global batch's shape, and the sparsity term is normalised by
the global batch — and the ``seq`` / ``pipe`` axes it runs along.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["DATA_AXIS", "HEAD_AXIS", "SEQ_AXIS", "PIPE_AXIS", "PARAM_RULES",
           "HEAD_LOCAL_RULES", "Axis", "Mesh", "DataShard", "build_mesh",
           "pipeline_reference_mesh", "mesh_descriptor", "spec_for", "param_dim",
           "head_local", "shard_params", "gather_params", "shard_model", "model_axis",
           "global_grad_norm", "allreduce_grads", "allreduce_sums", "broadcast_params",
           "forget_groups", "ServeMesh", "build_serve_mesh", "serve_head_shards",
           "serve_page_sharding", "serve_pool_shardings"]

DATA_AXIS = "data"
HEAD_AXIS = "model"  # tensor parallelism: attention heads / FFN hidden
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"

# flax param-path regex → the spec of the flax leaf (one entry per dimension:
# the axis it is split over, or None).  First match wins; default replicated.
# The JAX package's table (csat_tpu/parallel/mesh.py:96-110) word for word:
# attention q/k/v sharded on the output (head) dim, out-projections on their
# input dim; FFN first dense column-sharded, second row-sharded; the output
# head row-sharded; embedding tables on the feature axis.
PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r".*/(wq|wk|wv|q|k|v)/kernel$", (None, HEAD_AXIS)),
    (r".*/(wo|out)/kernel$", (HEAD_AXIS, None)),
    (r".*(/ff|FeedForward_\d+)/Dense_0/kernel$", (None, HEAD_AXIS)),
    (r".*(/ff|FeedForward_\d+)/Dense_1/kernel$", (HEAD_AXIS, None)),
    (r".*transformer_\d+/Dense_0/kernel$", (None, HEAD_AXIS)),  # encoder MLP up
    (r".*transformer_\d+/Dense_1/kernel$", (HEAD_AXIS, None)),  # encoder MLP down
    (r".*generator/Dense_0/kernel$", (HEAD_AXIS, None)),  # row-parallel head
    (r".*embedding$", (None, HEAD_AXIS)),
)

# the replicated parameters a ``model`` member applies to its own heads or
# hidden units only, so that its gradient is its part of the whole one: the
# column-parallel layers' biases, the CSE's relative tables and their
# projections, the SBM cluster centres and the cluster MLP
HEAD_LOCAL_RULES: Tuple[str, ...] = (
    r".*/(wq|wk|wv|q|k|v)/bias$",
    r".*(/ff|FeedForward_\d+)/Dense_0/bias$",
    r".*transformer_\d+/Dense_0/bias$",
    r".*DisentangledAttn_0/(l_q|l_k|t_q|t_k)/(kernel|bias)$",
    r"pegen/(L_q|T_q)$",
    r".*SBMAttention_0/clusters$",
    r".*SBMAttention_0/ClusterProj_0/Dense_\d+/(kernel|bias)$",
)


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
    def model(self) -> int:
        """Members of the ``model`` axis: the processes that split the heads."""
        return self.shape.get(HEAD_AXIS, 1)

    @property
    def replicas(self) -> int:
        """The processes that run one data shard's loss in parts (``seq ·
        pipe``): each process's loss is scaled by its inverse before the
        backward.  The ``model`` members each hold the whole loss."""
        return self.size // (self.data * self.model)

    @property
    def replica_line(self) -> "Axis":
        """The processes that hold this process's parameter shard: every
        axis but ``model``.  Its group is the mesh's own when ``model`` is
        1."""
        for line in self.lines:
            if line.name == _REPLICAS:
                return line
        return Axis(_REPLICAS, self.size, self.rank, self.group,
                    tuple(range(self.size)) if self.group is not None else (0,))

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
#: the name of the line over every axis but ``model`` (not an axis name)
_REPLICAS = "replicas"


def forget_groups() -> None:
    """Drop the cached line groups (the process group they belong to was
    left)."""
    _GROUPS.clear()


def _coords(rank: int, sizes: Sequence[int]) -> List[int]:
    coords = []
    rest = rank
    for s in reversed(sizes):
        coords.append(rest % s)
        rest //= s
    return coords[::-1]


def _flat(coords: Sequence[int], sizes: Sequence[int]) -> int:
    flat = 0
    for c, s in zip(coords, sizes):
        flat = flat * s + c
    return flat


def _line(name: str, dims: Sequence[int], sizes: Sequence[int], rank: int, world: int,
          group) -> Axis:
    """The line through ``rank`` over the axes ``dims``: the ranks that
    differ from it only in those coordinates, with their group — the whole
    group when the line is the whole group, none when it is one process,
    else a ``dist.new_group`` made by every process for every line, in the
    same order."""
    size = 1
    for d in dims:
        size *= sizes[d]
    mine = _coords(rank, sizes)
    index = _flat([mine[d] for d in dims], [sizes[d] for d in dims])
    if size == world and group is not None:
        return Axis(name, size, index, group, tuple(range(world)))
    if size == 1:
        return Axis(name, 1, 0, None, (rank,))
    import torch.distributed as dist

    mine_ranks, mine_group = (rank,), None
    others = [range(1) if j in dims else range(s) for j, s in enumerate(sizes)]
    for fixed in itertools.product(*others):
        line = []
        for along in itertools.product(*[range(sizes[d]) for d in dims]):
            c = list(fixed)
            for d, k in zip(dims, along):
                c[d] = k
            line.append(_flat(c, sizes))
        made = dist.new_group(line)
        if rank in line:
            mine_ranks, mine_group = tuple(line), made
    return Axis(name, size, index, mine_group, mine_ranks)


def _lines(axes: Tuple[Tuple[str, int], ...], rank: int, world: int, group) -> Tuple[Axis, ...]:
    """Each axis's line through ``rank``, then — under a ``model`` axis of
    more than one member — the line over every other axis (the processes
    holding this process's parameter shard)."""
    sizes = [s for _, s in axes]
    out = [_line(name, [i], sizes, rank, world, group) for i, (name, _) in enumerate(axes)]
    names = [n for n, _ in axes]
    if HEAD_AXIS in names and sizes[names.index(HEAD_AXIS)] > 1:
        rest = [i for i, n in enumerate(names) if n != HEAD_AXIS]
        out.append(_line(_REPLICAS, rest, sizes, rank, world, group))
    return tuple(out)


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
    axes = tuple(zip(names, sizes))
    size = 1
    for s in sizes:
        size *= s
    if size != world:
        raise ValueError(
            f"mesh {dict(axes)} needs {size} processes but the group has {world}; "
            "give the data axis -1 (e.g. --set \"mesh_shape=(('data', -1),)\") to fill it")
    unknown = [n for n, s in axes if n not in (DATA_AXIS, HEAD_AXIS, SEQ_AXIS, PIPE_AXIS)
               and s != 1]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown} in {tuple(mesh_shape)}")
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


def _kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def mesh_descriptor(mesh) -> str:
    """Stable topology digest: axis names and sizes and the device kinds
    (``solo/...`` for no mesh), as the JAX package's warm-start key reads
    it.  ``mesh`` is a training :class:`Mesh` (the visible devices' kinds)
    or a :class:`ServeMesh` (its shards' devices' kinds)."""
    if isinstance(mesh, ServeMesh):
        kinds = sorted({_kind(d) for d in mesh.devices})
    elif torch.cuda.is_available():
        kinds = sorted({torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())})
    else:
        kinds = ["cpu"]
    if mesh is None:
        return f"solo/{'+'.join(kinds)}"
    axes = ",".join(f"{n}={s}" for n, s in mesh.axes)
    return f"mesh[{axes}]/{'+'.join(kinds)}"


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """One serving engine across head shards (the JAX single controller's
    serve mesh): its axes — ``(model,)`` or ``(data, model)``, the data axis 1
    — and the device of each head shard, in head order.  Shard ``s`` holds
    heads ``[s·H/h, (s+1)·H/h)`` of every layer's KV pages and their scales
    on ``devices[s]``; everything else stays single on the engine's device."""

    axes: Tuple[Tuple[str, int], ...]
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)


def build_serve_mesh(shape: Sequence[int],
                     devices: Optional[Sequence] = None) -> ServeMesh:
    """Serve mesh from plain axis sizes: ``(h,)`` → a head axis only, ``(d,
    h)`` → (data, head).  ``devices`` (default: every visible card) gives
    the head shards theirs, in order; several shards may share one device.
    Refuses a mesh larger than ``devices``."""
    sizes = tuple(int(s) for s in shape) or (1,)
    names = (HEAD_AXIS,) if len(sizes) == 1 else (DATA_AXIS, HEAD_AXIS)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    total = 1
    for s in sizes:
        total *= s
    if total > len(devices):
        raise ValueError(f"serve mesh {sizes} needs {total} devices, have {len(devices)}")
    return ServeMesh(axes=tuple(zip(names, sizes)), devices=tuple(devices[:total]))


def serve_head_shards(mesh: Optional[ServeMesh]) -> int:
    """Head-axis size of a serve mesh (1 = effectively solo)."""
    return 1 if mesh is None else int(mesh.shape.get(HEAD_AXIS, 1))


def serve_page_sharding(mesh: ServeMesh) -> int:
    """The dimension of a per-layer page array ``(NP, H, page, dh)`` — and
    of its f32 scales ``(NP, H, page, 1)``, whose head axis sits at the same
    place — that the head shards split: 1.  The page axis stays whole, so a
    shard's page reads stay on its device."""
    return 1


def serve_pool_shardings(pool: List[Dict[str, torch.Tensor]], mesh: ServeMesh
                         ) -> List[List[Dict[str, torch.Tensor]]]:
    """A whole paged pool (per layer ``{"k", "v", "k_scale", "v_scale"}``)
    cut into the head shards' pools: shard ``s``'s heads of every array, on
    ``mesh.devices[s]``."""
    hs = serve_head_shards(mesh)
    dim = serve_page_sharding(mesh)
    out = []
    for s, dev in enumerate(mesh.devices):
        shard = []
        for layer in pool:
            part = {}
            for key, t in layer.items():
                n = t.shape[dim] // hs
                part[key] = t.narrow(dim, s * n, n).to(dev, copy=True).contiguous()
            shard.append(part)
        out.append(shard)
    return out


def _flat_groups(tensors: Sequence[torch.Tensor]):
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return by_dtype.values()


def model_axis(mesh: Optional[Mesh]) -> Optional[Axis]:
    """This process's ``model`` line when it has more than one member (the
    modules' ``tp``), else None."""
    if mesh is None:
        return None
    line = mesh.axis(HEAD_AXIS)
    return line if line.size > 1 else None


def spec_for(path: str, model: int) -> Tuple[Optional[str], ...]:
    """The spec of the flax leaf ``path`` on a mesh whose ``model`` axis has
    ``model`` members: the first :data:`PARAM_RULES` match, else replicated
    (``()``, and always under one member) — the JAX ``_spec_for``."""
    if model <= 1:
        return ()
    for pattern, spec in PARAM_RULES:
        if re.match(pattern, path):
            return spec
    return ()


def param_dim(name: str, model: int) -> Optional[int]:
    """The dimension of the port parameter ``name`` split over ``model``
    members (None: replicated).  A flax ``Dense`` kernel ``(in, out)`` is the
    transposed ``Linear`` weight ``(out, in)``, so its spec reads reversed."""
    from csat_tpu_torch.convert import flax_path

    path = flax_path(name)
    spec = spec_for(path, model)
    if HEAD_AXIS not in spec:
        return None
    dim = spec.index(HEAD_AXIS)
    return len(spec) - 1 - dim if path.endswith("/kernel") else dim


def head_local(name: str) -> bool:
    """Whether the replicated parameter ``name`` is applied by each
    ``model`` member to its own heads or hidden units only
    (:data:`HEAD_LOCAL_RULES`)."""
    from csat_tpu_torch.convert import flax_path

    path = flax_path(name)
    return any(re.match(pattern, path) for pattern in HEAD_LOCAL_RULES)


def _split(t: torch.Tensor, dim: int, axis: Axis, name: str) -> torch.Tensor:
    if t.shape[dim] % axis.size:
        raise ValueError(f"{name}: dimension {dim} of {tuple(t.shape)} does not split over "
                         f"{axis.size} 'model' members")
    part = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * part, part).contiguous()


def shard_params(full: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This process's shards of whole parameters ``full`` (port names, e.g.
    ``convert.convert_params``'s output or a checkpoint's): each tensor
    :data:`PARAM_RULES` splits, its ``model``-coordinate slice; the others as
    they are.  The inverse of :func:`gather_params`."""
    axis = model_axis(mesh)
    if axis is None:
        return dict(full)
    out = {}
    for name, t in full.items():
        dim = param_dim(name, axis.size)
        out[name] = t if dim is None else _split(t, dim, axis, name)
    return out


@torch.no_grad()
def gather_params(shards: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Whole parameters from every ``model`` member's ``shards`` (a
    collective over the ``model`` line: each of its members makes the call,
    with the same names in the same order); replicated tensors as they are,
    detached.  What one process would hold."""
    axis = model_axis(mesh)
    if axis is None:
        return {name: t.detach() for name, t in shards.items()}
    from csat_tpu_torch.parallel.collectives import gather_over

    out = {}
    for name, t in shards.items():
        dim = param_dim(name, axis.size)
        out[name] = t.detach() if dim is None else gather_over(t.detach(), axis, dim)
    return out


@torch.no_grad()
def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Cut ``model``'s parameters to this process's shards in place (before
    an optimizer state is made over them) and hand every module that runs
    sharded (a ``tp`` attribute) the ``model`` line.  The identity without a
    ``model`` axis of more than one member."""
    axis = model_axis(mesh)
    if axis is None:
        return model
    for name, p in model.named_parameters():
        dim = param_dim(name, axis.size)
        if dim is not None:
            p.data = _split(p.data, dim, axis, name)
    for module in model.modules():
        if hasattr(module, "tp"):
            module.tp = axis
    return model


def global_grad_norm(grads: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> torch.Tensor:
    """``sqrt(Σ g²)`` over the whole parameters: a ``model`` shard's squares
    summed over the ``model`` line, each replicated parameter counted once —
    the same bits on every process; the plain global norm without a
    ``model`` axis."""
    axis = model_axis(mesh)
    if axis is None:
        from csat_tpu_torch.resilience.guards import global_norm

        return global_norm(grads)
    from csat_tpu_torch.parallel.collectives import sum_over

    zero = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
    sharded, replicated = zero, zero
    for name, g in grads.items():
        sq = torch.sum(g * g)
        if param_dim(name, axis.size) is None:
            replicated = replicated + sq
        else:
            sharded = sharded + sq
    return torch.sqrt(sum_over(sharded, axis) + replicated)


def _allreduce(tensors: Sequence[torch.Tensor], group) -> None:
    import torch.distributed as dist

    for bucket in _flat_groups(tensors):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        torch._foreach_copy_(bucket, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in bucket]), bucket)])


def allreduce_grads(grads: Dict[str, torch.Tensor], mesh: Mesh) -> None:
    """Sum the gradients ``grads`` (port names) in place, one flat bucket
    and one ``all_reduce(SUM)`` per dtype and group: over the processes that
    hold the same shard (:attr:`Mesh.replica_line`, every process when the
    mesh has no ``model`` axis), and — for the :data:`HEAD_LOCAL_RULES`
    parameters under a ``model`` axis, whose gradients are each member's
    part — over every process.  Reads nothing on the host (on NCCL the
    collectives are queued on the current stream), so the step still syncs
    nothing; the summed gradients are the same bits on every process of a
    line."""
    if mesh.group is None:
        return
    axis = model_axis(mesh)
    parts = [g for name, g in grads.items() if axis is not None and head_local(name)]
    whole = [g for name, g in grads.items() if axis is None or not head_local(name)]
    line = mesh.replica_line
    if whole and line.group is not None:
        _allreduce(whole, line.group)
    if parts:
        _allreduce(parts, mesh.group)


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
    """Make every process start from the parameters of the first process
    holding its shard (rank 0 without a ``model`` axis), in place, and check
    that each process's own were already equal to them (they are drawn from
    the same seed; a difference means the processes were configured apart).
    Raises ``RuntimeError`` on every process when any differed."""
    if mesh.group is None:
        return
    import torch.distributed as dist

    line = mesh.replica_line
    tensors = [p.detach() for p in params.values()]
    apart = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    for group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        mine = flat.clone()
        if line.group is not None:
            dist.broadcast(flat, src=line.ranks[0], group=line.group)
        apart = apart + (~torch.eq(flat, mine)).sum()
        torch._foreach_copy_(group, [f.view_as(t) for f, t in zip(
            flat.split([t.numel() for t in group]), group)])
    dist.all_reduce(apart, op=dist.ReduceOp.MAX, group=mesh.group)
    if float(apart):
        raise RuntimeError(f"initial parameters differ across processes in {int(apart)} "
                           "entries on some process: every process must build the model "
                           "from the same config and seed")
