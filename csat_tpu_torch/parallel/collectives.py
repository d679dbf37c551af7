"""Autograd-aware collectives along one mesh axis.

What ``jax.lax`` gives the JAX package inside ``shard_map`` —
``ppermute``, ``all_gather``, ``psum`` — over one axis's process group
(:class:`~csat_tpu_torch.parallel.mesh.Axis`), each with the backward its
transpose has:

* :func:`ppermute` sends to ``index + shift`` and receives from
  ``index − shift`` on the axis (cyclically, or not at all past either end);
  its backward is the inverse rotation of the cotangents.  One call moves
  several tensors in one message each way, built on
  ``dist.batch_isend_irecv`` (``torch.distributed.nn.functional`` has no
  point-to-point), so every member of the axis makes the same call in the
  same order;
* :func:`all_gather_axis` concatenates the members' tensors along one
  dimension; its backward is the reduce-scatter of the sum;
* :func:`psum_axis` sums over the axis; its backward sums the cotangents.

Along the ``model`` axis, where every member holds the whole loss, the
Megatron pairs (identity one way, all-reduce the other) carry a replicated
activation into a member's heads and back:

* :func:`copy_to_model` (Megatron's ``f``): identity forward, the members'
  cotangents summed backward — before a column-parallel layer, whose input
  gradient each member holds only its heads' part of;
* :func:`reduce_from_model` (``g``): the members' partial products summed
  forward, identity backward — after a row-parallel layer;
* :func:`gather_features` all-gathers a feature-sharded activation (the
  embeddings, the per-head sparsities); its backward keeps this member's
  slice of the (replicated) cotangent;
* :func:`scatter_features` keeps this member's feature slice of a replicated
  activation (a row-parallel layer's input); its backward all-gathers.

A gloo group stages every collective through a pinned host copy of a CUDA
tensor (two processes sharing one card run over gloo); an NCCL group runs
them on the card.  The group's backend decides this, never a caught error.
An axis of one member (or no process group) makes each an identity.
:func:`hop` and :func:`sum_over` are the plain (non-differentiable) forms,
for a caller that schedules its own backward (``parallel/pipeline.py``), and
:func:`gather_over` the plain all-gather (``mesh.gather_params``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["ppermute", "all_gather_axis", "psum_axis", "hop", "sum_over", "gather_over",
           "copy_to_model", "reduce_from_model", "gather_features", "scatter_features"]


def _host_staged(axis, t: torch.Tensor) -> bool:
    """Whether ``t`` crosses ``axis``'s group through a host copy: a CUDA
    tensor over a gloo group."""
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(axis.group) == "gloo"


def _staging(t: torch.Tensor, staged: bool) -> torch.Tensor:
    if not staged:
        return t.contiguous()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def hop(xs: Sequence[torch.Tensor], axis, shift: int = 1,
        cyclic: bool = True) -> List[torch.Tensor]:
    """Each of ``xs`` sent to axis index ``index + shift``, the same-shaped
    tensors of ``index − shift`` received (zeros where no member sends)."""
    p, i = axis.size, axis.index
    dst, src = i + shift, i - shift
    if cyclic:
        dst, src = dst % p, src % p
    send, recv = 0 <= dst < p and dst != i, 0 <= src < p and src != i
    if p == 1 or axis.group is None or (cyclic and dst == i):
        return [x if cyclic else torch.zeros_like(x) for x in xs]
    import torch.distributed as dist

    flat = torch.cat([x.reshape(-1) for x in xs])
    staged = _host_staged(axis, flat)
    sbuf = _staging(flat, staged)
    rbuf = torch.zeros_like(sbuf)
    ops = []
    if send:
        ops.append(dist.P2POp(dist.isend, sbuf, axis.ranks[dst], axis.group))
    if recv:
        ops.append(dist.P2POp(dist.irecv, rbuf, axis.ranks[src], axis.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = rbuf.to(flat.device) if staged else rbuf
    return [o.view_as(x) for o, x in zip(out.split([x.numel() for x in xs]), xs)]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, shift: int, cyclic: bool, *xs):
        ctx.axis, ctx.shift, ctx.cyclic = axis, shift, cyclic
        ctx.likes = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(hop(xs, axis, shift, cyclic))

    @staticmethod
    def backward(ctx, *gs):
        gs = [g if g is not None else torch.zeros(s, dtype=d, device=dev)
              for g, (s, d, dev) in zip(gs, ctx.likes)]
        return (None, None, None, *hop(gs, ctx.axis, -ctx.shift, ctx.cyclic))


def ppermute(xs: Sequence[torch.Tensor], axis, shift: int = 1,
             cyclic: bool = True) -> Tuple[torch.Tensor, ...]:
    """``xs`` (tensors of one dtype) moved ``shift`` places along ``axis``:
    each member sends to ``index + shift`` and receives from ``index −
    shift`` (mod the axis size when ``cyclic``; else the first ``shift``
    members receive zeros and the last send nothing — JAX's ``ppermute``
    with ``[(i, i + shift)]``).  Every member of the axis must make the call.
    The backward moves the cotangents back the other way."""
    return _PPermute.apply(axis, int(shift), bool(cyclic), *xs)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, dim: int, x):
        import torch.distributed as dist

        ctx.axis, ctx.dim = axis, dim
        staged = _host_staged(axis, x)
        src = _staging(x, staged)
        parts = [torch.empty_like(src) for _ in range(axis.size)]
        dist.all_gather(parts, src, group=axis.group)
        out = torch.cat(parts, dim=dim)
        return out.to(x.device) if staged else out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        axis, dim = ctx.axis, ctx.dim
        if dist.get_backend(axis.group) == "gloo":
            # gloo has no reduce-scatter: sum the whole cotangent, keep our part
            mine = sum_over(g, axis).chunk(axis.size, dim=dim)[axis.index]
            return None, None, mine.contiguous()
        chunks = [c.contiguous() for c in g.chunk(axis.size, dim=dim)]
        mine = torch.empty_like(chunks[axis.index])
        dist.reduce_scatter(mine, chunks, op=dist.ReduceOp.SUM, group=axis.group)
        return None, None, mine


def all_gather_axis(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim`` in axis order (every
    member gets the same tensor).  Backward: each member's slice of the
    members' summed cotangents."""
    if axis is None or axis.size == 1 or axis.group is None:
        return x
    return _AllGather.apply(axis, dim, x)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return sum_over(x, axis)

    @staticmethod
    def backward(ctx, g):
        return None, sum_over(g, ctx.axis)


def sum_over(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` summed over the members of ``axis``, a new tensor with the same
    bits on each (``x`` itself on an axis of one member)."""
    if axis.size == 1 or axis.group is None:
        return x
    import torch.distributed as dist

    staged = _host_staged(axis, x)
    buf = _staging(x, True) if staged else x.contiguous().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=axis.group)
    return buf.to(x.device) if staged else buf


def psum_axis(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` summed over the members of ``axis`` (the same bits on each).
    Backward: the members' cotangents summed."""
    if axis is None or axis.size == 1 or axis.group is None:
        return x
    return _PSum.apply(axis, x)


def gather_over(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim`` in axis order (the
    same tensor on each; ``x`` itself on an axis of one member)."""
    if axis is None or axis.size == 1 or axis.group is None:
        return x
    import torch.distributed as dist

    staged = _host_staged(axis, x)
    src = _staging(x, staged)
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def _mine(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    return x.chunk(axis.size, dim=dim)[axis.index].contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, sum_over(g, ctx.axis)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        return sum_over(x, axis)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, dim: int, x):
        ctx.axis, ctx.dim = axis, dim
        return gather_over(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return None, None, _mine(g, ctx.axis, ctx.dim)


class _ScatterFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, dim: int, x):
        ctx.axis, ctx.dim = axis, dim
        return _mine(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return None, None, gather_over(g.contiguous(), ctx.axis, ctx.dim)


def _one(axis) -> bool:
    return axis is None or axis.size == 1 or axis.group is None


def copy_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` (replicated over ``axis``) entering this member's heads:
    identity forward; backward, the members' cotangents summed."""
    return x if _one(axis) else _CopyToModel.apply(axis, x)


def reduce_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    """The members' partial ``x`` summed (the same bits on each); backward,
    the identity."""
    return x if _one(axis) else _ReduceFromModel.apply(axis, x)


def gather_features(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The members' feature slices ``x`` concatenated along ``dim``;
    backward, this member's slice of the cotangent."""
    return x if _one(axis) else _GatherFeatures.apply(axis, dim, x)


def scatter_features(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """This member's slice of the replicated ``x`` along ``dim``; backward,
    the members' cotangent slices gathered."""
    return x if _one(axis) else _ScatterFeatures.apply(axis, dim, x)
