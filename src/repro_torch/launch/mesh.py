"""The LM's process mesh: named axes over ``torch.distributed`` ranks.

A mesh is ("data", "model") or, across pods, ("pod", "data", "model"): data
parallel over "pod" and "data", tensor and expert parallel over "model",
the JAX package's ``launch/mesh.py`` axes. One process runs each mesh
point, and the ranks run row-major over the axes: rank
``(pod·data + d)·model + m`` sits at (pod, d, m), the order of the
reference's ``devices.reshape(shape)``. Every axis of size > 1 has one
subgroup a line (its ranks rising with the axis index, so a group rank IS
the axis index), and the collectives along an axis are the process grid's
(``core.grid.AxisCollectives``): float sums are gathered and added in axis
order, integer sums and maxima go through ``all_reduce``.

A 1 x 1 mesh is one process and needs no process group; any other shape
needs an initialised default group of exactly its size
(``launch.spawn.run_mesh`` starts the ranks). ``core.grid.grid_from_mesh``
reads a mesh as a SpGEMM grid.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.grid import AxisCollectives

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh(AxisCollectives):
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device
    rank: int = 0
    # axis -> this rank's subgroup, for the axes of size > 1 (multi-process only)
    groups: Dict[str, object] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def coords(self) -> Dict[str, int]:
        """{axis name: this rank's index along it}."""
        return dict(zip(self.axis_names, _point(self.rank, self.sizes)))

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def pmax_all(self, x: torch.Tensor) -> torch.Tensor:
        """Maximum of ``x`` over the whole mesh."""
        if self.size == 1:
            return x
        return self._reduce(x, dist.ReduceOp.MAX, None)

    def rank_of(self, coords: Dict[str, int]) -> int:
        """The rank at mesh point ``coords`` (missing axes at index 0)."""
        r = 0
        for name, n in zip(self.axis_names, self.sizes):
            r = r * n + coords.get(name, 0)
        return r


def _point(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    """The row-major mesh point of ``rank``."""
    out = []
    for n in reversed(sizes):
        rank, i = divmod(rank, n)
        out.append(i)
    return tuple(reversed(out))


def _mesh_members(sizes: Sequence[int]):
    """(axis position, ranks) of every subgroup of a mesh, in one order for
    all ranks; each rank list rises with the axis index."""
    for a, n in enumerate(sizes):
        if n == 1:
            continue
        lines: Dict[Tuple[int, ...], list] = {}
        for r in range(math.prod(sizes)):  # ranks rise, so each line does
            pt = _point(r, sizes)
            lines.setdefault(pt[:a] + pt[a + 1:], []).append(r)
        for key in sorted(lines):
            yield a, lines[key]


def make_mesh(sizes: Sequence[int], names: Sequence[str], device="cuda") -> Mesh:
    """A mesh of ``sizes`` over axes ``names`` on ``device``. More than one
    point needs the default process group initialised with exactly
    prod(sizes) ranks; this rank's point follows from its rank."""
    sizes, names = tuple(int(n) for n in sizes), tuple(names)
    if len(sizes) != len(names):
        raise ValueError(f"{len(sizes)} sizes for axes {names}")
    p = math.prod(sizes)
    if p == 1:
        return Mesh(names, sizes, torch.device(device))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"mesh {dict(zip(names, sizes))} runs one process per point: it "
                           f"needs an initialised default process group of {p} ranks")
    world = dist.get_world_size()
    if world != p:
        raise RuntimeError(f"mesh {dict(zip(names, sizes))} needs a process group of {p} "
                           f"ranks, found world size {world}")
    rank = dist.get_rank()
    groups = {}
    for a, ranks in _mesh_members(sizes):  # every rank makes every group, in order
        group = dist.new_group(ranks)
        if rank in ranks:
            groups[names[a]] = group
    return Mesh(names, sizes, torch.device(device), rank, groups)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16 x 16 ("data", "model"), or 2 x 16 x 16 with "pod" (512 ranks)."""
    return (make_mesh((2, 16, 16), POD_AXES, device) if multi_pod
            else make_mesh((16, 16), AXES, device))


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0, device="cuda") -> Mesh:
    """A small mesh for tests and examples: ("data", "model"), or
    ("pod", "data", "model") when ``pod`` > 0."""
    if pod:
        return make_mesh((pod, data, model), POD_AXES, device)
    return make_mesh((data, model), AXES, device)
