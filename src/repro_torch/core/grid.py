"""3D process grid for SUMMA (paper §III-B).

A grid is ``pr × pc × l``: process rows, process columns, layers.
``P(:,:,k)`` is layer k (a 2D SUMMA grid) and ``P(i,j,:)`` a *fiber*
(AllToAll-Fiber runs along it). Every collective of the multiply goes
through the methods below, one per grid axis.

The port runs one process on one card for now, a 1×1×1 grid, where every
collective is the identity. The multi-process grid over
``torch.distributed`` (row/column/layer subgroups) is not ported yet, and
``make_grid`` refuses any other shape.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

Tensor = torch.Tensor

ROW_AX, COL_AX, LAYER_AX = "gr", "gc", "gl"


@dataclasses.dataclass(frozen=True)
class Grid:
    pr: int
    pc: int
    l: int
    device: torch.device

    @property
    def p(self) -> int:
        return self.pr * self.pc * self.l

    @property
    def axis_names(self) -> Tuple[str, str, str]:
        return (ROW_AX, COL_AX, LAYER_AX)

    @property
    def coords(self) -> Tuple[int, int, int]:
        """This process's (row, column, layer) position on the grid."""
        return (0, 0, 0)

    def axis_size(self, axis: str) -> int:
        return {ROW_AX: self.pr, COL_AX: self.pc, LAYER_AX: self.l}[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def _single(self, axis: str) -> None:
        if self.axis_size(axis) != 1:
            raise NotImplementedError(
                f"collectives over a grid axis of size {self.axis_size(axis)} "
                f"need the multi-process grid, which is not ported yet"
            )

    def all_gather(self, x: Tensor, axis: str) -> Tensor:
        """Stack every process's ``x`` along a new leading axis."""
        self._single(axis)
        return x.unsqueeze(0)

    def all_to_all(self, x: Tensor, axis: str) -> Tensor:
        """Exchange the leading-axis blocks of ``x`` along ``axis``."""
        self._single(axis)
        return x

    def psum(self, x: Tensor, axis: str) -> Tensor:
        self._single(axis)
        return x

    def pmax_all(self, x: Tensor) -> Tensor:
        """Maximum of ``x`` over the whole grid."""
        for ax in self.axis_names:
            self._single(ax)
        return x


def make_grid(pr: int, pc: int, l: int, device="cuda") -> Grid:
    """Build a pr×pc×l grid on ``device``; only 1×1×1 for now."""
    if (pr, pc, l) != (1, 1, 1):
        raise NotImplementedError(
            f"grid {pr}x{pc}x{l}: the port runs a 1x1x1 grid on one card; the "
            f"multi-process grid over torch.distributed is not ported yet"
        )
    return Grid(pr, pc, l, torch.device(device))
