"""Distributed sparse matrices on the 3D grid (paper Fig. 1 distributions).

A ``DistSparse`` holds the padded-COO tile of this process's grid point,
stacked into tensors of shape (1, 1, 1, cap); indices are LOCAL tile
coordinates, ``coords`` the grid point and ``grid_shape`` the whole grid.
Every tile of one matrix has the same capacity, so tiles gather through
the grid at a fixed size. The global↔local maps implement the paper's
three distributions:

  kind="A": 2D blocks (w × w), each process-column block split column-wise
            into l layer slices → tile (w × w/l).       [Fig. 1(c,d,e)]
  kind="B": 2D blocks (w × w), each process-row block split row-wise into
            l layer slices → tile (w/l × w).            [Fig. 1(f,g,h)]
  kind="C": distributed like A (paper §III-B chooses this).

A tile (i,s,k) covers global columns s·w + k·(w/l) + [0,w/l), and B tile
(s,j,k) covers the same global rows — so per-layer 2D SUMMA contracts
stage-s tiles directly. ``local_col_reduce``/``dist_col_reduce`` reduce
per global column over the grid axes that split it (MCL's normalization).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import semiring as sr
from . import sortkeys
from .grid import LAYER_AX, ROW_AX, Grid
from .sparse import SparseCOO, empty, from_numpy_coo

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DistSparse:
    rows: Tensor  # i32[1, 1, 1, cap] — local tile row indices
    cols: Tensor  # i32[1, 1, 1, cap]
    vals: Tensor  # f32[1, 1, 1, cap]
    nnz: Tensor  # i32[1, 1, 1]
    shape: Tuple[int, int]  # global (m, n)
    tile_shape: Tuple[int, int]  # local (tm, tn)
    grid_shape: Tuple[int, int, int]  # (pr, pc, l)
    kind: str  # "A" | "B" | "C"
    coords: Tuple[int, int, int] = (0, 0, 0)  # the grid point of the tile held

    @property
    def cap(self) -> int:
        return self.rows.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def local(self, i: int, j: int, k: int) -> SparseCOO:
        """The tile at grid position (i, j, k), which must be this process's."""
        if (i, j, k) != self.coords:
            raise ValueError(f"tile {(i, j, k)} lives on another process; this "
                             f"one holds {self.coords}")
        return SparseCOO(
            self.rows[0, 0, 0], self.cols[0, 0, 0], self.vals[0, 0, 0],
            self.nnz[0, 0, 0], self.tile_shape,
        )


def from_tile(t: SparseCOO, shape: Tuple[int, int], grid: Grid, kind: str) -> DistSparse:
    """The ``DistSparse`` whose tile on this process is ``t``."""
    stack = lambda x: x.reshape(1, 1, 1, *x.shape)
    return DistSparse(
        rows=stack(t.rows), cols=stack(t.cols), vals=stack(t.vals), nnz=stack(t.nnz),
        shape=shape, tile_shape=t.shape, grid_shape=(grid.pr, grid.pc, grid.l), kind=kind,
        coords=grid.coords,
    )


def tile_nnz(d: DistSparse, grid: Grid) -> np.ndarray:
    """Every tile's nnz, (pr, pc, l) on the host."""
    return _host(grid.gather_grid(d.nnz.reshape(1))).reshape(d.grid_shape)


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
    """Partition a global SparseCOO into grid tiles (paper Fig. 1) and keep
    this process's tile, on the grid's device. Every process passes the
    same ``a``.

    Capacity = max tile nnz × slack, uniform across tiles (the slack absorbs
    mild imbalance; the symbolic step sizes the multiply outputs). It comes
    from the global counts, so every process finds it without talking to
    the others. An explicit ``cap`` overrides the data-derived capacity (it
    must hold the fullest tile).
    """
    m, n = a.shape
    pr, pc, l = grid.pr, grid.pc, grid.l
    tile_id, lr, lc, vals, tm, tn, counts = _tile_layout(a, grid, kind)
    if cap is None:
        cap = max(int(np.ceil(counts.max() * cap_slack)), min_cap)
    else:
        assert cap >= counts.max(), (cap, int(counts.max()))

    mine = np.flatnonzero(tile_id == grid.point_id)  # in input order, as a stable sort
    live = len(mine)
    rows_t = np.full(cap, tm, np.int32)
    cols_t = np.full(cap, tn, np.int32)
    vals_t = np.zeros(cap, vals.dtype)
    rows_t[:live], cols_t[:live], vals_t[:live] = lr[mine], lc[mine], vals[mine]

    dev = grid.device
    stack = lambda x: torch.from_numpy(x.reshape(1, 1, 1, *x.shape)).to(dev)
    return DistSparse(
        rows=stack(rows_t), cols=stack(cols_t), vals=stack(vals_t),
        nnz=stack(np.array(live, np.int32)),
        shape=(m, n),
        tile_shape=(tm, tn),
        grid_shape=(pr, pc, l),
        kind=kind,
        coords=grid.coords,
    )


def gather_to_global(d: DistSparse, grid: Optional[Grid] = None) -> SparseCOO:
    """Inverse of scatter_to_grid, through the host (tests / small outputs):
    the tiles are gathered through ``grid`` (needed on a multi-process
    grid), and every process gets the whole matrix."""
    m, n = d.shape
    pr, pc, l = d.grid_shape
    tm, tn = d.tile_shape
    if grid is None and pr * pc * l > 1:
        raise ValueError("gather_to_global of a multi-process grid's tile needs the grid")
    tiles = (d.rows, d.cols, d.vals, d.nnz)
    if grid is not None:
        tiles = tuple(grid.gather_grid(x[0, 0, 0]) for x in tiles)
    rows_l, cols_l, vals_l = [], [], []
    R, C, V, N = (_host(x) for x in tiles)
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


# ---------------------------------------------------------------------------
# Distributed column reductions (device-resident MCL building blocks)
# ---------------------------------------------------------------------------
def col_reduce_axes(kind: str) -> Tuple[str, ...]:
    """Grid axes a per-LOCAL-column reduction must be combined over so every
    process reads the reduction of the full GLOBAL column it holds a piece of.

    A/C-kind: a global column is owned by one (grid column, layer) pair and
    split across the pr row blocks → reduce over the row axis. B-kind: a
    global column spans the whole pr×l fiber plane of its grid column.
    """
    if kind in ("A", "C"):
        return (ROW_AX,)
    if kind == "B":
        return (ROW_AX, LAYER_AX)
    raise ValueError(kind)


def local_col_reduce(
    vals: Tensor, cols: Tensor, valid: Tensor, tn: int, op: str = "sum",
    axes: Tuple[str, ...] = (ROW_AX,), *, grid: Grid,
) -> Tensor:
    """Per-column reduction of one tile's entries: reduce ``vals`` by local
    column (padding goes to a discard segment ``tn``), then combine over
    ``axes`` of ``grid`` (``psum`` for sum, ``pmax`` for max). Returns
    ``vals.dtype[tn]``. ``op="max"`` treats empty columns as 0 (MCL values
    are nonnegative). A float sum runs in a fixed order
    (``sortkeys.segment_reduce``), so it gives the same bits on every run;
    max and integer sums are exact in any order."""
    if op not in ("sum", "max"):
        raise ValueError(op)
    segids = torch.where(valid, cols, torch.full_like(cols, tn))
    v = torch.where(valid, vals, torch.zeros_like(vals))
    if op == "sum" and v.is_floating_point():
        out = sortkeys.segment_reduce(v, segids, tn, "sum")
    else:
        out = sr.scatter_reduce(v, segids, tn + 1, op)[:tn]
    if op == "max":
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    combine = grid.psum if op == "sum" else grid.pmax
    for ax in axes:
        out = combine(out, ax)
    return out


def dist_col_reduce(d: DistSparse, grid: Grid, op: str = "sum") -> Tensor:
    """Per-GLOBAL-column reduction of a ``DistSparse`` on the grid: a
    (1, 1, 1, tn) stack whose entry c is the sum or max over the global
    column that local column c of this process's tile belongs to. No host
    transfer."""
    _, tn = d.tile_shape
    t = d.local(*grid.coords)
    out = local_col_reduce(
        t.vals.float(), t.cols, t.valid_mask(), tn, op, col_reduce_axes(d.kind),
        grid=grid,
    )
    return out.reshape(1, 1, 1, tn)


def dist_col_sums(d: DistSparse, grid: Grid) -> Tensor:
    """Distributed column sums — see ``dist_col_reduce``."""
    return dist_col_reduce(d, grid, op="sum")
