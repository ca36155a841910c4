"""3D process grid for SUMMA (paper §III-B).

A grid is ``pr × pc × l``: process rows, process columns, layers.
``P(:,:,k)`` is layer k (a 2D SUMMA grid) and ``P(i,j,:)`` a *fiber*
(AllToAll-Fiber runs along it). Every collective of the multiply goes
through the methods below, one per grid axis.

The 1×1×1 grid is one process, and every collective is the identity. Any
other shape runs one process per grid point over ``torch.distributed``:

  * Rank layout: rank ``(i·pc + j)·l + k`` sits at grid point (i, j, k),
    the reference's ``devices.reshape(pr, pc, l)`` and
    ``distsparse._tile_layout``'s row-major tile id. A grid read from a
    mesh (``grid_from_mesh``) keeps the mesh's ranks instead: its
    ``ranks`` lists the rank at every grid point, and ``point_id`` (not the
    rank) is the tile id.
  * Subgroups: one per (i, k) for the column axis, one per (j, k) for the
    row axis and one per (i, j) for the layer axis. A subgroup's ranks
    rise with the axis index, so its group rank IS the axis index and a
    gather stacks blocks in axis order.
  * Float sums run in a fixed order, by choice: the blocks are gathered
    and added in axis order, so every rank, and every run, gets the same
    bits (the ESC and binned multiplies and the MCL loops repeat bit for
    bit, and a resumed run must too). A backend's reducing sum leaves the
    order to the backend. Integer sums and maxima are exact in any order
    and go through ``all_reduce``.
  * The backend is the caller's: NCCL for one rank per card, gloo for the
    CPU and for several ranks sharing one card. gloo runs every operation
    used here on CUDA tensors, so the grid never moves data to the host.
  * The shift along an axis (``ppermute``, the Cannon ring's step) is an
    ``all_to_all_single`` with uneven splits, which both backends run on
    the tensor's device; a backend that refuses it raises.

The per-axis collectives live in ``AxisCollectives``, which the LM's
process mesh (``launch.mesh.Mesh``) shares: a mesh sums, gathers and
exchanges along "data" or "model" by the same rules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor

ROW_AX, COL_AX, LAYER_AX = "gr", "gc", "gl"


class AxisCollectives:
    """Collectives along one named axis of a process grid or mesh: the
    subclass gives ``axis_size(axis)``, ``axis_index(axis)`` and
    ``groups`` (axis -> this rank's subgroup, whose group rank is the axis
    index). Float sums are gathered and added in axis order; integer sums
    and maxima go through ``all_reduce``."""

    def _gather(self, x: Tensor, n: int, group) -> Tensor:
        x = x.contiguous()
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
        return out.reshape(n, *x.shape)

    def _reduce(self, x: Tensor, op, group) -> Tensor:
        out = x.clone(memory_format=torch.contiguous_format)  # NCCL takes dense rows only
        dist.all_reduce(out, op=op, group=group)
        return out

    def all_gather(self, x: Tensor, axis: str) -> Tensor:
        """Stack every process's ``x`` along a new leading axis, in axis order."""
        n = self.axis_size(axis)
        if n == 1:
            return x.unsqueeze(0)
        return self._gather(x, n, self.groups[axis])

    def all_to_all(self, x: Tensor, axis: str) -> Tensor:
        """Exchange the leading-axis blocks of ``x`` along ``axis``: block s
        goes to the process at axis index s, and block s of the result
        came from it."""
        if self.axis_size(axis) == 1:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.groups[axis])
        return out

    def ppermute(self, x: Tensor, axis: str, shift: int) -> Tensor:
        """Cyclic shift along ``axis``: the process at axis index s sends
        ``x`` to index (s − shift) mod size and returns what index
        (s + shift) mod size sent (``lax.ppermute`` with the pairs
        (s, (s − shift) % size)). Every process of one subgroup passes the
        same ``shift`` and an ``x`` of one shape; subgroups may shift by
        different amounts. One ``all_to_all_single`` with uneven splits
        carries it, the whole of ``x`` to one peer and nothing to the
        others, on the tensor's own device over NCCL or gloo."""
        n = self.axis_size(axis)
        if n == 1 or shift % n == 0:
            return x
        s = self.axis_index(axis)
        flat = x.contiguous().reshape(-1)
        send = [0] * n
        recv = [0] * n
        send[(s - shift) % n] = recv[(s + shift) % n] = flat.numel()
        out = torch.empty_like(flat)
        dist.all_to_all_single(out, flat, output_split_sizes=recv, input_split_sizes=send,
                               group=self.groups[axis])
        return out.reshape(x.shape)

    def psum(self, x: Tensor, axis: str) -> Tensor:
        if self.axis_size(axis) == 1:
            return x
        if x.is_floating_point():
            return _sum_in_order(self.all_gather(x, axis))
        return self._reduce(x, dist.ReduceOp.SUM, self.groups[axis])

    def pmax(self, x: Tensor, axis: str) -> Tensor:
        if self.axis_size(axis) == 1:
            return x
        return self._reduce(x, dist.ReduceOp.MAX, self.groups[axis])

    def psum_scatter(self, x: Tensor, axis: str, dim: int) -> Tensor:
        """Sum ``x`` over ``axis`` and keep this process's 1/size slice of
        dimension ``dim`` (a tiled reduce-scatter): the slices travel by
        one ``all_to_all`` and are added in axis order."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        y = x.movedim(dim, 0)
        y = self.all_to_all(y.reshape(n, y.shape[0] // n, *y.shape[1:]), axis)
        return _sum_in_order(y).movedim(0, dim).contiguous()


@dataclasses.dataclass(frozen=True)
class Grid(AxisCollectives):
    pr: int
    pc: int
    l: int
    device: torch.device
    rank: int = 0
    # axis -> this rank's subgroup, for the axes of size > 1 (multi-process only)
    groups: Dict[str, object] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)
    # the rank at every grid point, (i, j, k) row-major; None: the layout
    # (i·pc + j)·l + k
    ranks: Optional[Tuple[int, ...]] = None

    @property
    def p(self) -> int:
        return self.pr * self.pc * self.l

    @property
    def axis_names(self) -> Tuple[str, str, str]:
        return (ROW_AX, COL_AX, LAYER_AX)

    @property
    def point_id(self) -> int:
        """This process's grid point, ``(i·pc + j)·l + k``: its tile id."""
        return self.rank if self.ranks is None else self.ranks.index(self.rank)

    @property
    def coords(self) -> Tuple[int, int, int]:
        """This process's (row, column, layer) position on the grid."""
        g = self.point_id
        return (g // (self.pc * self.l), g // self.l % self.pc, g % self.l)

    def axis_size(self, axis: str) -> int:
        return {ROW_AX: self.pr, COL_AX: self.pc, LAYER_AX: self.l}[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def _by_point(self, stacked: Tensor) -> Tensor:
        """Blocks gathered in rank order, put in grid-point order."""
        if self.ranks is None:
            return stacked
        return stacked[torch.tensor(self.ranks, device=stacked.device)]

    def gather_grid(self, x: Tensor) -> Tensor:
        """Every process's ``x`` (one shape on all), stacked as (pr, pc, l, ...)."""
        if self.p == 1:
            return x.reshape(1, 1, 1, *x.shape)
        return self._by_point(self._gather(x, self.p, None)).reshape(
            self.pr, self.pc, self.l, *x.shape)

    def psum_all(self, x: Tensor) -> Tensor:
        """Sum of ``x`` over the whole grid."""
        if self.p == 1:
            return x
        if x.is_floating_point():
            return _sum_in_order(self._by_point(self._gather(x, self.p, None)))
        return self._reduce(x, dist.ReduceOp.SUM, None)

    def pmax_all(self, x: Tensor) -> Tensor:
        """Maximum of ``x`` over the whole grid."""
        if self.p == 1:
            return x
        return self._reduce(x, dist.ReduceOp.MAX, None)


def _sum_in_order(blocks: Tensor) -> Tensor:
    """``blocks[0] + blocks[1] + …``, added left to right."""
    out = blocks[0]
    for b in blocks[1:]:
        out = out + b
    return out


def _axis_members(pr: int, pc: int, l: int):
    """(axis, ranks) of every subgroup of a grid, in one order for all
    ranks; each rank list rises with the axis index."""
    rank = lambda i, j, k: (i * pc + j) * l + k
    for axis, size, outer, member in (
        (COL_AX, pc, [(i, k) for i in range(pr) for k in range(l)],
         lambda o, s: rank(o[0], s, o[1])),
        (ROW_AX, pr, [(j, k) for j in range(pc) for k in range(l)],
         lambda o, s: rank(s, o[0], o[1])),
        (LAYER_AX, l, [(i, j) for i in range(pr) for j in range(pc)],
         lambda o, s: rank(o[0], o[1], s)),
    ):
        if size > 1:
            for o in outer:
                yield axis, [member(o, s) for s in range(size)]


def make_grid(pr: int, pc: int, l: int, device="cuda") -> Grid:
    """Build a pr×pc×l grid on ``device``. Layers must be square (pr == pc)
    or the grid single-layer (l == 1), as in the reference. A grid of more
    than one point needs the default process group initialised with
    pr·pc·l ranks (``repro_torch.launch.spawn`` starts them); this rank's
    grid point follows from its rank."""
    if not (pr == pc or l == 1):
        raise ValueError(f"need square per-layer grids or l == 1, got {pr}x{pc}x{l}")
    p = pr * pc * l
    if p == 1:
        return Grid(1, 1, 1, torch.device(device))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"grid {pr}x{pc}x{l} runs one process per grid point: it needs an "
            f"initialised default process group of {p} ranks, and there is none")
    world = dist.get_world_size()
    if world != p:
        raise RuntimeError(
            f"grid {pr}x{pc}x{l} needs a process group of {p} ranks, found world "
            f"size {world}")
    rank = dist.get_rank()
    groups = {}
    # every rank creates every subgroup, in the same order
    for axis, ranks in _axis_members(pr, pc, l):
        group = dist.new_group(ranks)
        if rank in ranks:
            groups[axis] = group
    return Grid(pr, pc, l, torch.device(device), rank, groups)


def grid_from_mesh(mesh, row_axis: str = "data", col_axis: str = "model",
                   layer_axis: Optional[str] = "pod") -> Grid:
    """A process mesh (``launch.mesh.Mesh``) read as a SUMMA grid, the
    reference's production mapping: ``row_axis`` -> grid rows,
    ``col_axis`` -> columns, ``layer_axis`` -> layers (one layer when the
    mesh has no such axis). Square per-layer grids only (pr == pc), as in
    the reference. The grid reuses the mesh's subgroups (a mesh axis's
    group holds the same ranks as the grid axis it becomes, in the same
    order) and keeps the mesh's ranks: on a ("pod", "data", "model") mesh
    rank (pod·data + i)·model + j sits at grid point (i, j, pod), so the
    grid carries that layout in ``ranks``."""
    sizes = mesh.shape
    axes = [row_axis, col_axis] + ([layer_axis] if layer_axis and layer_axis in sizes else [])
    other = [a for a in sizes if a not in axes and sizes[a] > 1]
    if other:
        raise ValueError(f"mesh axes {other} map to no grid axis")
    pr, pc = sizes[row_axis], sizes[col_axis]
    l = sizes[layer_axis] if len(axes) == 3 else 1
    if pr != pc:
        raise ValueError(f"square per-layer grid required, got {pr}x{pc}")
    ranks = tuple(mesh.rank_of(dict(zip(axes, (i, j, k))))
                  for i in range(pr) for j in range(pc) for k in range(l))
    groups = {g: mesh.groups[a] for g, a in zip((ROW_AX, COL_AX, LAYER_AX), axes)
              if sizes[a] > 1}
    return Grid(pr, pc, l, mesh.device, mesh.rank, groups,
                None if ranks == tuple(range(len(ranks))) else ranks)


def square_grid_for(p: int, l: int) -> Tuple[int, int, int]:
    """Paper's grid shape: sqrt(p/l) × sqrt(p/l) × l."""
    side = math.isqrt(p // l)
    if side * side * l != p:
        raise ValueError(f"p={p} not expressible as s*s*{l}")
    return side, side, l
