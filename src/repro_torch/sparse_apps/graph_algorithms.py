"""SpGEMM applications from paper §V-B: triangle counting and AAᵀ overlap.

Triangle counting: count(G) = Σ (L·U) ⊙ L, with L and U the strict lower
and upper parts of the adjacency matrix — a masked SpGEMM. The mask L is
scattered once as a C-layout operand and applied inside the batched
multiply (``batched_summa3d(spec=PlanSpec(mask=...))``): the symbolic pass
budgets only the surviving entries (smaller capacities, fewer batches) and
the local multiply filters the partial products against the mask before
its compress or insert, so products that close no triangle never take
output capacity, never cross the fiber and never reach the host. Each
batch comes back as one device scalar, summed over the grid.

Overlap detection (BELLA/PASTIS): C = A·Aᵀ over plus-times, A the
(sequences × k-mers) indicator; C[i, j] counts the k-mers sequences i and
j share. The pair filter (i < j, shared ≥ ``min_shared``) runs on the grid
after each batch, so only surviving pairs are transferred. An optional
``candidates`` mask (known candidate pairs) also gates the multiply itself.

``triangle_count_host`` and ``overlap_pairs_host`` pull every unmasked
batch to numpy and filter it there, entry by entry, through
``_host_mask_filter`` / ``_host_pair_filter``: they are the oracles the
tests hold the device paths against, and the tests count calls to those two
filters to show that the device paths never filter on the host.

Every rank of a multi-process grid passes the same input and gets the same
answer: a batch's count is a sum over the grid, and its surviving pairs
are gathered from every rank's tile.

Usage, on one card::

    from repro_torch.core import gen
    from repro_torch.core.grid import make_grid
    from repro_torch.sparse_apps.graph_algorithms import overlap_pairs, triangle_count

    grid = make_grid(1, 1, 1)
    g = gen.symmetrized(gen.rmat(14, edge_factor=16, seed=5))
    triangles = triangle_count(g, grid, per_process_memory=1 << 28)
    pairs = overlap_pairs(gen.kmer_like(1 << 14, 1 << 19, 64, seed=17), grid,
                          min_shared=2, per_process_memory=1 << 28)

A batch's (tm, wb) mask keys must pack into i32, as in the reference: at
n = 2^16 on one card that takes b >= 4, which a tighter budget gives.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import semiring as sr
from ..core.batched import batched_summa3d
from ..core.distsparse import DistSparse, from_tile, scatter_to_grid
from ..core.grid import COL_AX, LAYER_AX, ROW_AX, Grid
from ..core.sparse import SparseCOO, from_numpy_coo
from ..core.specs import PlanSpec
from ..core.summa3d import _squeeze_tile
from ..core.symbolic import rup_pow2
from . import mcl as _mcl
from .mcl import _to_host

Tensor = torch.Tensor


def _charge_mask_planning_transfer(mask: DistSparse) -> None:
    """Masked planning counts the mask's per-tile column structure on the
    device; only the (pr, pc, l, wl) i32 count array crosses to the host.
    Charge those bytes to the transfer accounting."""
    pr, pc, l = mask.grid_shape
    _mcl._TRANSFER_BYTES[0] += pr * pc * l * mask.tile_shape[1] * 4


def _strict_parts(a: SparseCOO) -> Tuple[SparseCOO, SparseCOO]:
    """Strict lower (L) and upper (U) triangular parts as unit-weight COO,
    on ``a``'s device."""
    n = a.shape[0]
    nnz = int(a.nnz)
    rows = a.rows[:nnz].cpu().numpy()
    cols = a.cols[:nnz].cpu().numpy()
    lo = rows > cols
    hi = rows < cols
    L = from_numpy_coo(rows[lo], cols[lo], np.ones(lo.sum(), np.float32), (n, n),
                       cap=max(int(lo.sum()), 8), device=a.device)
    U = from_numpy_coo(rows[hi], cols[hi], np.ones(hi.sum(), np.float32), (n, n),
                       cap=max(int(hi.sum()), 8), device=a.device)
    return L, U


# ---------------------------------------------------------------------------
# per-batch reductions and filters on the grid (the §V-B postprocess hooks)
# ---------------------------------------------------------------------------
def _batch_value_sum(c: DistSparse, grid: Grid) -> Tensor:
    """Σ of one batch's values over the grid, as a device scalar: the only
    thing of a batch the masked triangle count moves to the host. Summed in
    float64 (in a fixed order over the grid), so a count stays an exact
    integer far past f32's 2^24."""
    t = _squeeze_tile(c, grid)
    local = torch.where(t.valid_mask(), t.vals, torch.zeros_like(t.vals)).double().sum()
    return grid.psum_all(local)


def _overlap_filter(c: DistSparse, batch: int, grid: Grid, num_batches: int,
                    min_shared: int):
    """The BELLA pair filter on the grid: keep entries with global row <
    global column and value ≥ ``min_shared``, compacted to the front of
    each tile. Returns (filtered batch, surviving pairs over the grid, the
    most any tile keeps, compact overflow over the grid), the last three as
    device scalars."""
    tm, wbl = c.tile_shape
    w = c.shape[1] * num_batches // grid.pc
    t = _squeeze_tile(c, grid)
    i, j, k = (grid.axis_index(ax) for ax in (ROW_AX, COL_AX, LAYER_AX))
    g_row = i * tm + t.rows
    g_col = j * w + (k * num_batches + batch) * wbl + t.cols
    keep = t.valid_mask() & (t.vals >= min_shared) & (g_row < g_col)
    kept, ovf = t.compact(keep, t.cap)
    local = keep.sum().to(torch.int32)
    filtered = from_tile(kept, c.shape, grid, c.kind)
    return filtered, grid.psum_all(local), grid.pmax_all(local), grid.pmax_all(ovf)


def _shrink_batch(d: DistSparse, max_tile_nnz: int) -> DistSparse:
    """Cut a front-compacted batch to its survivors' capacity before it is
    pulled: lossless, since every tile keeps at most ``max_tile_nnz``
    entries at its front. Powers of two, so batches share shapes."""
    cap = d.rows.shape[-1]
    new_cap = min(cap, rup_pow2(max(int(max_tile_nnz), 8)))
    if new_cap >= cap:
        return d
    return dataclasses.replace(d, rows=d.rows[..., :new_cap], cols=d.cols[..., :new_cap],
                               vals=d.vals[..., :new_cap])


def _sparse_batch_to_global(c: DistSparse, col_map: np.ndarray, grid: Grid):
    """One sparse C batch of the whole grid in global coordinates on the
    host: every rank's tile is gathered, so every rank gets all of it."""
    tm, _ = c.tile_shape
    R, C, V, N = (_to_host(grid.gather_grid(x[0, 0, 0]))
                  for x in (c.rows, c.cols, c.vals, c.nnz))
    valid = np.arange(R.shape[-1])[None, None, None, :] < N[..., None]
    i, j, kk, s = np.nonzero(valid)
    return i * tm + R[i, j, kk, s], col_map[j, kk, C[i, j, kk, s]], V[i, j, kk, s]


# ---------------------------------------------------------------------------
# triangle counting: the masked multiply, on the device
# ---------------------------------------------------------------------------
def triangle_count(a: SparseCOO, grid: Grid, per_process_memory: int = 1 << 26) -> int:
    """Σ_{(i, j) ∈ A, i > j} (L·U)[i, j] through the masked batched multiply:
    the mask L is a C-layout operand applied inside every batch's step, and
    each batch gives one device scalar to the total."""
    L, U = _strict_parts(a)
    A_d = scatter_to_grid(L, grid, "A")
    B_d = scatter_to_grid(U, grid, "B")
    M_d = scatter_to_grid(L, grid, "C")
    _charge_mask_planning_transfer(M_d)
    totals: List[float] = []
    batched_summa3d(
        A_d, B_d, grid, per_process_memory=per_process_memory,
        consumer=lambda bi, s, col_map: totals.append(float(_to_host(s))),
        path="sparse", semiring=sr.PLUS_TIMES, spec=PlanSpec(mask=M_d),
        postprocess=lambda bi, c: _batch_value_sum(c, grid),
    )
    return int(round(sum(totals)))


def _host_mask_filter(rr, cc, vv, mask) -> int:
    """The host oracle's per-entry mask filter (the device path must never
    call it: tests count its calls)."""
    total = 0
    for r, c, v in zip(rr.tolist(), cc.tolist(), vv.tolist()):
        if (r, c) in mask:
            total += int(round(v))
    return total


def triangle_count_host(a: SparseCOO, grid: Grid, per_process_memory: int = 1 << 26) -> int:
    """Host-filter oracle: the unmasked L·U, every batch pulled to numpy and
    masked by a Python set lookup."""
    nnz = int(a.nnz)
    rows = a.rows[:nnz].cpu().numpy()
    cols = a.cols[:nnz].cpu().numpy()
    L, U = _strict_parts(a)
    low = rows > cols
    mask = set(zip(rows[low].tolist(), cols[low].tolist()))
    total = 0

    def consumer(bi, c_batch, col_map):
        nonlocal total
        total += _host_mask_filter(*_sparse_batch_to_global(c_batch, col_map, grid), mask)

    batched_summa3d(
        scatter_to_grid(L, grid, "A"), scatter_to_grid(U, grid, "B"), grid,
        per_process_memory=per_process_memory, consumer=consumer, path="sparse",
        semiring=sr.PLUS_TIMES,
    )
    return total


def triangle_count_reference(a: SparseCOO) -> int:
    """trace(D³)/6 of the symmetric 0/1 pattern without self loops (dense;
    small graphs only)."""
    d = (a.to_dense().cpu().numpy() != 0).astype(np.int64)
    d = d & d.T
    np.fill_diagonal(d, 0)
    return int(np.trace(d @ d @ d)) // 6


# ---------------------------------------------------------------------------
# overlap detection: the pair filter on the grid (+ an optional candidate mask)
# ---------------------------------------------------------------------------
def overlap_pairs(
    a: SparseCOO,
    grid: Grid,
    min_shared: int = 2,
    per_process_memory: int = 1 << 26,
    candidates: Optional[SparseCOO] = None,
) -> List[Tuple[int, int, int]]:
    """A·Aᵀ in batches; returns the (i, j, shared) pairs with i < j and
    shared ≥ ``min_shared``, sorted. Each batch is filtered on the grid and
    then dropped: the host only reassembles the survivors' coordinates.
    ``candidates`` (an nseqs × nseqs structural mask of candidate pairs)
    also gates the multiply itself, through the masked path."""
    at = a.transpose().sort_rowmajor()
    A_d = scatter_to_grid(a, grid, "A")
    B_d = scatter_to_grid(at, grid, "B")
    M_d = scatter_to_grid(candidates, grid, "C") if candidates is not None else None
    if M_d is not None:
        _charge_mask_planning_transfer(M_d)
    pieces = []
    nseqs = a.shape[0]

    def postprocess(bi, c_batch):
        # b is the column count over the batch width: no plan needed here
        return _overlap_filter(c_batch, bi, grid, nseqs // c_batch.shape[1], int(min_shared))

    def consumer(bi, payload, col_map):
        filtered, cnt, maxc, ovf = payload
        assert int(_to_host(ovf)) == 0
        rr, cc, vv = _sparse_batch_to_global(
            _shrink_batch(filtered, int(_to_host(maxc))), col_map, grid)
        assert len(rr) == int(_to_host(cnt)), (len(rr), cnt)
        pieces.append((rr, cc, vv))

    batched_summa3d(
        A_d, B_d, grid, per_process_memory=per_process_memory, consumer=consumer,
        path="sparse", postprocess=postprocess, spec=PlanSpec(mask=M_d),
    )
    rows, cols, vals = (np.concatenate([p[f] for p in pieces]) for f in range(3))
    order = np.lexsort((cols, rows))
    return [(int(r), int(c), int(round(v)))
            for r, c, v in zip(rows[order], cols[order], vals[order])]


def _host_pair_filter(rr, cc, vv, min_shared) -> List[Tuple[int, int, int]]:
    """The host oracle's per-entry pair filter (tests count its calls)."""
    out = []
    for r, c, v in zip(rr.tolist(), cc.tolist(), vv.tolist()):
        if r < c and v >= min_shared:
            out.append((int(r), int(c), int(round(v))))
    return out


def overlap_pairs_host(
    a: SparseCOO, grid: Grid, min_shared: int = 2, per_process_memory: int = 1 << 26,
) -> List[Tuple[int, int, int]]:
    """Host-filter oracle: every whole batch pulled to numpy and filtered
    entry by entry."""
    at = a.transpose().sort_rowmajor()
    pairs: List[Tuple[int, int, int]] = []

    def consumer(bi, c_batch, col_map):
        pairs.extend(_host_pair_filter(*_sparse_batch_to_global(c_batch, col_map, grid),
                                       min_shared))

    batched_summa3d(
        scatter_to_grid(a, grid, "A"), scatter_to_grid(at, grid, "B"), grid,
        per_process_memory=per_process_memory, consumer=consumer, path="sparse",
    )
    return sorted(pairs)


def overlap_pairs_reference(a: SparseCOO, min_shared: int = 2) -> List[Tuple[int, int, int]]:
    """The pairs from a dense A·Aᵀ (small inputs only)."""
    d = a.to_dense().cpu().numpy().astype(np.float64)
    c = d @ d.T
    i, j = np.nonzero(np.triu(c >= min_shared, k=1))
    return sorted((int(r), int(s), int(round(c[r, s]))) for r, s in zip(i, j))
