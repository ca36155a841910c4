"""The process mesh's collectives under autograd.

The mesh paths of the models (``attention``, ``mlp``, ``moe``,
``transformer``) call these in place of the bare ``AxisCollectives``
methods: each forward IS that method's code, so forward values (and the
serving path's bits) are what they were, and each backward is the
transpose the mesh's convention asks for:

  **a replicated activation carries the same, whole cotangent on every
  rank.**

So a parameter's gradient on a rank is the whole gradient of what the
rank computed: a tensor-parallel slice's gradient is its slice's, a
replicated parameter's is the same on every model rank, and summing the
ranks' gradients over the data axes gives the gradient of the global
loss. Where ranks use a replicated parameter on different data (the
"a2a" router, each model rank routing its own sequence chunk), the
parameter enters through ``enter``, whose backward sums its gradient over
"model".

  * ``sum_partials``: the sum of tensor-parallel partials into a replicated
    tensor (ordered ``psum``; backward: identity, each partial takes the
    whole cotangent).
  * ``enter``: a replicated tensor entering a region where each rank
    computes a different part (identity; backward: the ordered ``psum`` of
    the partial cotangents).
  * ``all_reduce``: ``psum`` whose output each rank uses on its own data
    (backward: ``psum`` of the cotangents), the true transpose.
  * ``mean_replicated``: the mean of a value every rank already holds
    alike (``psum / n``; backward: identity).
  * ``gather``: blocks concatenated along a dimension into a replicated
    tensor (backward: this rank's block of the whole cotangent).
  * ``take_block``: this rank's block of a replicated tensor (backward: the
    blocks' cotangents gathered, so the tensor's cotangent is whole).
  * ``all_to_all``: the leading-axis exchange (backward: the same exchange,
    which is its own inverse).
  * ``pmax`` has no gradient: the vocab-parallel loss (``transformer``)
    uses it inside its own backward-defining function.

Every collective is issued in one order on every rank: forward in program
order, backward in autograd's order, which is fixed for one device per
rank, and a remat recompute repeats the forward's collectives on every
rank alike. On an axis of size 1 each function is the identity.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

Tensor = torch.Tensor


def _psum_f32(mesh, x: Tensor, axis: str) -> Tensor:
    """The ordered sum of ``x`` over ``axis``, added in f32 and rounded to
    ``x``'s dtype once (a cotangent's partials)."""
    return mesh.psum(x.float(), axis).to(x.dtype)


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum_f32(ctx.mesh, g, ctx.axis), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _psum_f32(ctx.mesh, g, ctx.axis), None, None


class _MeanReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.psum(x, axis) / mesh.axis_size(axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.size = mesh, axis, dim, x.shape[dim]
        return torch.cat(tuple(mesh.all_gather(x, axis)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None, None


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        n = x.shape[dim] // mesh.axis_size(axis)
        return x.narrow(dim, mesh.axis_index(axis) * n, n)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(tuple(ctx.mesh.all_gather(g, ctx.axis)), dim=ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g, ctx.axis), None, None


def _live(mesh, axis: str) -> bool:
    return mesh is not None and mesh.axis_size(axis) > 1


def sum_partials(mesh, x: Tensor, axis: str) -> Tensor:
    return _SumPartials.apply(x, mesh, axis) if _live(mesh, axis) else x


def enter(mesh, x: Tensor, axis: str) -> Tensor:
    return _Enter.apply(x, mesh, axis) if _live(mesh, axis) else x


def all_reduce(mesh, x: Tensor, axis: str) -> Tensor:
    return _AllReduce.apply(x, mesh, axis) if _live(mesh, axis) else x


def mean_replicated(mesh, x: Tensor, axis: str) -> Tensor:
    return _MeanReplicated.apply(x, mesh, axis) if _live(mesh, axis) else x


def gather(mesh, x: Tensor, axes: Union[str, Sequence[str]], dim: int) -> Tensor:
    """Blocks along ``dim`` over ``axes`` (one axis, or several split
    row-major: the minor axis is gathered first, as ``gather_tensor``)."""
    for axis in reversed((axes,) if isinstance(axes, str) else tuple(axes)):
        if _live(mesh, axis):
            x = _Gather.apply(x, mesh, axis, dim)
    return x


def take_block(mesh, x: Tensor, axes: Union[str, Sequence[str]], dim: int) -> Tensor:
    """This rank's block of ``dim`` over ``axes`` (row-major), the inverse
    of ``gather``."""
    for axis in ((axes,) if isinstance(axes, str) else tuple(axes)):
        if _live(mesh, axis):
            x = _TakeBlock.apply(x, mesh, axis, dim)
    return x


def all_to_all(mesh, x: Tensor, axis: str) -> Tensor:
    return _AllToAll.apply(x, mesh, axis) if _live(mesh, axis) else x


def mean_of_partials(mesh, x: Tensor, axes: Sequence[str]) -> Tensor:
    """The mean over ``axes`` of a value each rank computed on its own data:
    ``sum_partials`` then a division, axis by axis, so each rank's value
    takes 1/n of the cotangent and the ranks' gradients sum to the mean's."""
    for axis in axes:
        if _live(mesh, axis):
            x = sum_partials(mesh, x, axis) / mesh.axis_size(axis)
    return x
