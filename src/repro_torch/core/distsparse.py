"""Distributed sparse matrices on the 3D grid (paper Fig. 1 distributions).

A ``DistSparse`` stores one padded-COO tile per grid point, stacked into
tensors of shape (pr, pc, l, cap); indices are LOCAL tile coordinates. The
global↔local maps implement the paper's three distributions:

  kind="A": 2D blocks (w × w), each process-column block split column-wise
            into l layer slices → tile (w × w/l).       [Fig. 1(c,d,e)]
  kind="B": 2D blocks (w × w), each process-row block split row-wise into
            l layer slices → tile (w/l × w).            [Fig. 1(f,g,h)]
  kind="C": distributed like A (paper §III-B chooses this).

A tile (i,s,k) covers global columns s·w + k·(w/l) + [0,w/l), and B tile
(s,j,k) covers the same global rows — so per-layer 2D SUMMA contracts
stage-s tiles directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .grid import Grid
from .sparse import SparseCOO, empty, from_numpy_coo

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DistSparse:
    rows: Tensor  # i32[pr, pc, l, cap] — local tile row indices
    cols: Tensor  # i32[pr, pc, l, cap]
    vals: Tensor  # f32[pr, pc, l, cap]
    nnz: Tensor  # i32[pr, pc, l]
    shape: Tuple[int, int]  # global (m, n)
    tile_shape: Tuple[int, int]  # local (tm, tn)
    grid_shape: Tuple[int, int, int]  # (pr, pc, l)
    kind: str  # "A" | "B" | "C"

    @property
    def cap(self) -> int:
        return self.rows.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def local(self, i: int, j: int, k: int) -> SparseCOO:
        """The tile at grid position (i, j, k)."""
        return SparseCOO(
            self.rows[i, j, k], self.cols[i, j, k], self.vals[i, j, k],
            self.nnz[i, j, k], self.tile_shape,
        )


def from_tile(t: SparseCOO, shape: Tuple[int, int], grid: Grid, kind: str) -> DistSparse:
    """The ``DistSparse`` whose tile on this process is ``t``."""
    stack = lambda x: x.reshape(grid.pr, grid.pc, grid.l, *x.shape)
    return DistSparse(
        rows=stack(t.rows), cols=stack(t.cols), vals=stack(t.vals), nnz=stack(t.nnz),
        shape=shape, tile_shape=t.shape, grid_shape=(grid.pr, grid.pc, grid.l), kind=kind,
    )


def _host(x: Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _tile_layout(a: SparseCOO, grid: Grid, kind: str):
    """Tile-index math shared by scatter/count: returns
    ``(tile_id, lr, lc, vals, tm, tn, counts)`` for the block layout of
    ``kind`` on ``grid`` (tile_id row-major over (pr, pc, l))."""
    m, n = a.shape
    pr, pc, l = grid.pr, grid.pc, grid.l
    if kind in ("A", "C"):
        assert m % pr == 0 and n % (pc * l) == 0, (a.shape, (pr, pc, l))
    else:
        assert m % (pr * l) == 0 and n % pc == 0, (a.shape, (pr, pc, l))
    nnz = int(a.nnz)
    g_rows = _host(a.rows[:nnz])
    g_cols = _host(a.cols[:nnz])
    vals = _host(a.vals[:nnz])

    if kind in ("A", "C"):
        w, wl = n // pc, n // pc // l
        ti = g_rows // (m // pr)
        lr = g_rows % (m // pr)
        tj = g_cols // w
        off = g_cols % w
        tk = off // wl
        lc = off % wl
        tm, tn = m // pr, wl
    else:
        w, wl = m // pr, m // pr // l
        ti = g_rows // w
        off = g_rows % w
        tk = off // wl
        lr = off % wl
        tj = g_cols // (n // pc)
        lc = g_cols % (n // pc)
        tm, tn = wl, n // pc

    tile_id = (ti * pc + tj) * l + tk
    counts = np.bincount(tile_id, minlength=pr * pc * l)
    return tile_id, lr, lc, vals, tm, tn, counts


def tile_nnz_counts(a: SparseCOO, grid: Grid, kind: str) -> np.ndarray:
    """Per-tile nnz of ``a`` scattered as ``kind`` on ``grid`` (flat,
    row-major over (pr, pc, l)) without moving any data."""
    *_, counts = _tile_layout(a, grid, kind)
    return counts


def scatter_to_grid(
    a: SparseCOO, grid: Grid, kind: str, cap_slack: float = 1.3,
    min_cap: int = 8, cap: Optional[int] = None,
) -> DistSparse:
    """Partition a global SparseCOO into grid tiles (paper Fig. 1) on the
    grid's device.

    Capacity = max tile nnz × slack, uniform across tiles (the slack absorbs
    mild imbalance; the symbolic step sizes the multiply outputs). An
    explicit ``cap`` overrides the data-derived capacity (it must hold the
    fullest tile).
    """
    m, n = a.shape
    pr, pc, l = grid.pr, grid.pc, grid.l
    tile_id, lr, lc, vals, tm, tn, counts = _tile_layout(a, grid, kind)
    nnz = int(a.nnz)
    if cap is None:
        cap = max(int(np.ceil(counts.max() * cap_slack)), min_cap)
    else:
        assert cap >= counts.max(), (cap, int(counts.max()))

    rows_t = np.full((pr * pc * l, cap), tm, np.int32)
    cols_t = np.full((pr * pc * l, cap), tn, np.int32)
    vals_t = np.zeros((pr * pc * l, cap), vals.dtype)
    order = np.argsort(tile_id, kind="stable")
    slot = np.arange(nnz) - np.concatenate([[0], np.cumsum(counts)])[tile_id[order]]
    rows_t[tile_id[order], slot] = lr[order]
    cols_t[tile_id[order], slot] = lc[order]
    vals_t[tile_id[order], slot] = vals[order]

    dev = grid.device
    return DistSparse(
        rows=torch.from_numpy(rows_t.reshape(pr, pc, l, cap)).to(dev),
        cols=torch.from_numpy(cols_t.reshape(pr, pc, l, cap)).to(dev),
        vals=torch.from_numpy(vals_t.reshape(pr, pc, l, cap)).to(dev),
        nnz=torch.from_numpy(counts.reshape(pr, pc, l).astype(np.int32)).to(dev),
        shape=(m, n),
        tile_shape=(tm, tn),
        grid_shape=(pr, pc, l),
        kind=kind,
    )


def gather_to_global(d: DistSparse) -> SparseCOO:
    """Inverse of scatter_to_grid, through the host (tests / small outputs)."""
    m, n = d.shape
    pr, pc, l = d.grid_shape
    tm, tn = d.tile_shape
    rows_l, cols_l, vals_l = [], [], []
    R, C, V, N = _host(d.rows), _host(d.cols), _host(d.vals), _host(d.nnz)
    for i in range(pr):
        for j in range(pc):
            for k in range(l):
                cnt = int(N[i, j, k])
                lr, lc = R[i, j, k, :cnt], C[i, j, k, :cnt]
                if d.kind in ("A", "C"):
                    w = n // pc
                    gr = i * tm + lr
                    gc = j * w + k * (w // l) + lc
                else:
                    w = m // pr
                    gr = i * w + k * (w // l) + lr
                    gc = j * tn + lc
                rows_l.append(gr)
                cols_l.append(gc)
                vals_l.append(V[i, j, k, :cnt])
    rows = np.concatenate(rows_l)
    if len(rows) == 0:
        return empty((m, n), cap=8, dtype=d.vals.dtype, device=d.device)
    return from_numpy_coo(
        rows, np.concatenate(cols_l), np.concatenate(vals_l), (m, n), device=d.device
    )
