"""SUMMA3D sparse multiply step on the process grid (paper Alg. 1 + Alg. 2).

One call of ``summa3d_fused_step`` computes one batch of the 3D multiply:

  0. Batch-Select (Alg. 4 line 5): block-cyclic column selection of B.
  1. A-Broadcast / B-Broadcast (Alg. 1 lines 5-6): gathers along the grid
     row/column axes. The contraction ranges of the gathered stage tiles are
     disjoint, so all stages fuse into ONE local multiply over the
     concatenated entry lists (contraction index = stage · (w/l) + local).
  2. Local-Multiply (Alg. 1 line 7): the plan's choice of ESC, the
     hash-accumulator multiply or the k-binned paired multiply.
  3. ColSplit + AllToAll-Fiber + Merge-Fiber (Alg. 2 lines 4-6): one
     partitioned, order-preserving split into all l pieces, the exchange
     along the layer axis, and a merge (not a sort) of the sorted pieces.

The dense path (``path="dense"``) densifies the gathered B once, streams the
gathered A through it (SpMM), and reduce-scatters the dense D tile along the
layer axis. Outside the fused step, ``summa3d_dense_step`` runs that path on
a batch's B block under one of two schedules: "allgather" (the gathers
above) or "ring", Cannon's schedule (a skew of both operands, then per
stage one multiply of the aligned tiles and a unit shift of each along its
grid axis), which holds one densified B tile instead of the gathered
stage tiles (paper §IV-A); ``summa3d_sparse_step`` runs the sparse path.
A mask (paper §V-B) enters the step as a C-layout operand: the
batch's slice of it is gathered along the fiber into the D tile's space,
and the local multiply filters against it (the dense path zeroes D off
it). ``reassemble_operands`` turns one multiply's batched C outputs
into the next iteration's A and B on the grid (MCL, paper §V-C).

Every collective goes through the ``Grid``, and every process runs this
code on its own tile; on the 1×1×1 grid the collectives are the identity.
The reference's ``_pmax_grid`` and ``_psum_grid`` (a reduction over all
three axes) are ``Grid.pmax_all`` and ``Grid.psum_all``.
Padding entries are rewritten to the contraction sentinel (k_tot) before
gathering, so offset arithmetic cannot alias padding onto real
coordinates; values are zero as a second guarantee.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import semiring as sr
from .distsparse import DistSparse, from_tile
from .grid import COL_AX, LAYER_AX, ROW_AX, Grid
from . import sortkeys
from .local_spgemm import (
    mask_indicator, merge_sparse, spgemm_esc, spgemm_hash, spgemm_kbinned, spmm,
)
from .sparse import SparseCOO, concat

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BatchCaps:
    """Static capacities for one batch of the multiply (symbolic-step output)."""

    flops_cap: int  # ESC expansion slots per process
    d_cap: int  # unmerged D tile entries per process (sparse path)
    piece_cap: int  # per-fiber-piece entries (sparse path)
    c_cap: int  # merged C tile entries per process (sparse path)

    def doubled(self) -> "BatchCaps":
        """Next capacity plan for the overflow-retry loop (§IV-A)."""
        return BatchCaps(
            flops_cap=self.flops_cap * 2, d_cap=self.d_cap * 2,
            piece_cap=self.piece_cap * 2, c_cap=self.c_cap * 2,
        )


@dataclasses.dataclass(frozen=True)
class BinnedCaps:
    """Static parameters of the k-binned local multiply. The monotone
    ``bin_of_k`` map travels separately as a tensor."""

    num_bins: int
    bin_cap_a: int  # gathered-A entries per bin, per process
    bin_cap_b: int  # gathered-B entries per bin, per process

    def doubled(self) -> "BinnedCaps":
        return BinnedCaps(
            num_bins=self.num_bins,
            bin_cap_a=self.bin_cap_a * 2,
            bin_cap_b=self.bin_cap_b * 2,
        )


@dataclasses.dataclass(frozen=True)
class HashCaps:
    """Static parameters of the hash-accumulator local multiply.

    ``table_cap`` (power of two) sizes the open-addressing table — the
    O(nnz_out·load_factor) resident scratch the plan budgets instead of
    O(flops). ``chunk_cap`` partial products are enumerated per chunk into a
    single reused buffer; ``num_chunks`` chunks cover the planned flops
    bound. ``max_probes`` linear-probe rounds before an insert is dropped
    and counted (overflow → driver retry).
    """

    table_cap: int
    chunk_cap: int
    num_chunks: int
    max_probes: int = 32

    def doubled(self) -> "HashCaps":
        # chunk_cap is a bandwidth knob, not a soundness cap — growing the
        # chunk *count* (and the table + probe bound) is what clears drops
        return HashCaps(
            table_cap=self.table_cap * 2,
            chunk_cap=self.chunk_cap,
            num_chunks=self.num_chunks * 2,
            max_probes=min(self.max_probes * 2, 256),
        )


def _squeeze_tile(d: DistSparse, grid: Grid) -> SparseCOO:
    """This process's tile of ``d``."""
    return d.local(*grid.coords)


def _gather_A(a: SparseCOO, grid: Grid) -> SparseCOO:
    """A-Broadcast: gather stage tiles along the grid row; re-index columns
    to the per-layer contraction space (stage s occupies [s*wl, (s+1)*wl))."""
    tm, wl = a.shape
    s = grid.axis_index(COL_AX)
    k_tot = grid.axis_size(COL_AX) * wl
    valid = a.valid_mask()
    rows = torch.where(valid, a.rows, torch.full_like(a.rows, tm))
    cols = torch.where(valid, a.cols + s * wl, torch.full_like(a.cols, k_tot))
    vals = torch.where(valid, a.vals, torch.zeros_like(a.vals))
    g_rows = grid.all_gather(rows, COL_AX).reshape(-1)
    g_cols = grid.all_gather(cols, COL_AX).reshape(-1)
    g_vals = grid.all_gather(vals, COL_AX).reshape(-1)
    cap = g_rows.shape[0]
    # padding is self-masking (zero vals + sentinels); declare all slots live
    nnz = torch.tensor(cap, dtype=torch.int32, device=a.device)
    return SparseCOO(g_rows, g_cols, g_vals, nnz, (tm, k_tot))


def _gather_B(b: SparseCOO, grid: Grid) -> SparseCOO:
    """B-Broadcast: gather stage tiles along the grid column; re-index rows
    to the per-layer contraction space (stage i occupies [i*wl, (i+1)*wl))."""
    wl, tn = b.shape
    i = grid.axis_index(ROW_AX)
    k_tot = grid.axis_size(ROW_AX) * wl
    valid = b.valid_mask()
    rows = torch.where(valid, b.rows + i * wl, torch.full_like(b.rows, k_tot))
    cols = torch.where(valid, b.cols, torch.full_like(b.cols, tn))
    vals = torch.where(valid, b.vals, torch.zeros_like(b.vals))
    g_rows = grid.all_gather(rows, ROW_AX).reshape(-1)
    g_cols = grid.all_gather(cols, ROW_AX).reshape(-1)
    g_vals = grid.all_gather(vals, ROW_AX).reshape(-1)
    cap = g_rows.shape[0]
    nnz = torch.tensor(cap, dtype=torch.int32, device=b.device)
    return SparseCOO(g_rows, g_cols, g_vals, nnz, (k_tot, tn))


# ---------------------------------------------------------------------------
# Dense-accumulator path outside the fused step: two broadcast schedules
# ---------------------------------------------------------------------------
def _shift_tile(t: SparseCOO, grid: Grid, axis: str, shift: int) -> SparseCOO:
    """The tile that reaches this process when every process of its line
    along ``axis`` passes its ``t`` on by ``Grid.ppermute(·, axis, shift)``:
    the one held ``shift`` places further along. Every tile of one matrix
    has one capacity, so the four fields travel as one i32 buffer."""
    assert t.vals.dtype == torch.float32, t.vals.dtype
    cap = t.cap
    buf = torch.cat([t.rows, t.cols, t.vals.view(torch.int32), t.nnz.reshape(1)])
    buf = grid.ppermute(buf, axis, shift)
    return SparseCOO(buf[:cap], buf[cap:2 * cap], buf[2 * cap:3 * cap].view(torch.float32),
                     buf[3 * cap], t.shape)


def _skew(d: DistSparse, kind: str, grid: Grid) -> SparseCOO:
    """Cannon's initial alignment as a permutation of tiles across processes:
    A's row i shifts left by i (new[i, j] = old[i, (j + i) mod pc]), B's
    column j up by j (new[i, j] = old[(i + j) mod pr, j]). Returns the
    tile this process holds after it."""
    i, j, _ = grid.coords
    t = _squeeze_tile(d, grid)
    return _shift_tile(t, grid, COL_AX, i) if kind == "A" else _shift_tile(t, grid, ROW_AX, j)


def summa3d_dense_step(
    a: DistSparse, b_batch: DistSparse, grid: Grid,
    semiring: sr.Semiring = sr.PLUS_TIMES, schedule: str = "allgather",
) -> Tensor:
    """One batched-SUMMA3D step on the dense-accumulator path.

    ``b_batch`` is the batch's column block of B (kind "B" layout, tile
    (wl, tn_b)). Returns this process's f32 tile of the C batch as
    (1, 1, 1, tm, tn_b/l), the fiber merge included (``psum_scatter``).

    ``schedule="allgather"`` gathers A along the grid row and B along the
    grid column, densifies the gathered B once and runs one SpMM.
    ``schedule="ring"`` (Cannon; pr == pc) skews both operands, then runs pc
    stages: SpMM of the current A tile against the densified current B tile
    (both from one contraction block), summed into the D tile in stage
    order, with a unit shift of A along the grid row and of B along the
    grid column between stages. It holds one densified (wl × tn_b) B tile
    where allgather holds the gathered (pr·wl × tn_b) one, and it adds
    the stages in another order than allgather's single SpMM.
    """
    assert semiring.add_kind == "sum", "dense path requires a sum monoid"
    assert schedule in ("allgather", "ring"), schedule
    tm_a, wl_a = a.tile_shape
    _, tn_b = b_batch.tile_shape
    assert tn_b % grid.l == 0
    if schedule == "ring":
        assert grid.pr == grid.pc, "Cannon ring needs a square layer grid"
        a_t, b_t = _skew(a, "A", grid), _skew(b_batch, "B", grid)
        d_tile = None
        for stage in range(grid.pc):
            if stage:
                a_t = _shift_tile(a_t, grid, COL_AX, 1)
                b_t = _shift_tile(b_t, grid, ROW_AX, 1)
            # every slot declared live: padding carries the sentinels and
            # zero values
            a_cur = SparseCOO(a_t.rows, a_t.cols,
                              torch.where(a_t.rows < tm_a, a_t.vals, torch.zeros_like(a_t.vals)),
                              torch.tensor(a_t.cap, dtype=torch.int32, device=a_t.device),
                              (tm_a, wl_a))
            b_dense = SparseCOO(b_t.rows, b_t.cols,
                                torch.where(b_t.cols < tn_b, b_t.vals,
                                            torch.zeros_like(b_t.vals)),
                                torch.tensor(b_t.cap, dtype=torch.int32, device=b_t.device),
                                (wl_a, tn_b)).to_dense()
            d_tile = spmm(a_cur, b_dense, semiring, out=d_tile)
            del b_dense
    else:
        d_tile = spmm(_gather_A(_squeeze_tile(a, grid), grid),
                      _gather_B(_squeeze_tile(b_batch, grid), grid).to_dense(), semiring)
    # AllToAll-Fiber + Merge-Fiber == reduce-scatter along the fiber
    c_tile = grid.psum_scatter(d_tile, LAYER_AX, dim=1)  # (tm, tn_b/l)
    return c_tile.reshape(1, 1, 1, *c_tile.shape)


# ---------------------------------------------------------------------------
# Sparse path
# ---------------------------------------------------------------------------
def _sparse_tile_body(
    a_loc: SparseCOO, b_loc: SparseCOO, grid: Grid, caps: BatchCaps,
    semiring: sr.Semiring, sorted_merge: bool = True,
    kbin: BinnedCaps = None, bin_of_k: Tensor = None,
    hashc: HashCaps = None,
    mask: SparseCOO = None, mask_complement: bool = False,
) -> Tuple[SparseCOO, Tensor]:
    """Per-process sparse pipeline: gather → local multiply → partitioned
    ColSplit → AllToAll-Fiber → Merge-Fiber.

    ``kbin``/``hashc`` select the local multiply: None/None runs ESC (any
    semiring); a ``BinnedCaps`` runs the k-binned paired kernel (plus_times
    only); a ``HashCaps`` runs the hash-accumulator multiply (any semiring).
    All produce a row-major-sorted D tile, so the downstream split/merge
    invariants are identical. ``mask`` (a SparseCOO over the D tile's
    (tm, tn_b) space) filters the local multiply's products, so only
    survivors take D, piece and C capacity and cross the fiber.
    ``sorted_merge`` merges the received pieces (they are column splits of
    row-major-sorted D tiles); False coalesces them with one sort.
    """
    assert kbin is None or hashc is None, "kbin and hashc are exclusive"
    l = grid.l
    tm_a, _ = a_loc.shape
    _, tn_b = b_loc.shape
    piece_w = tn_b // l
    a_cat = _gather_A(a_loc, grid)
    b_cat = _gather_B(b_loc, grid)
    mkeys = None
    if mask is not None and kbin is None:
        mkeys = sortkeys.sorted_mask_keys(mask.rows, mask.cols, mask.valid_mask(),
                                          (tm_a, tn_b))
    if kbin is not None:
        d_tile, ovf_mul = spgemm_kbinned(
            a_cat, b_cat, caps.d_cap, kbin.num_bins, kbin.bin_cap_a,
            kbin.bin_cap_b, bin_of_k=bin_of_k, semiring=semiring,
            mask=mask, mask_complement=mask_complement,
        )
    elif hashc is not None:
        d_tile, ovf_mul = spgemm_hash(
            a_cat, b_cat, out_cap=caps.d_cap,
            table_cap=hashc.table_cap, chunk_cap=hashc.chunk_cap,
            num_chunks=hashc.num_chunks, semiring=semiring,
            max_probes=hashc.max_probes,
            mask_keys=mkeys, mask_complement=mask_complement,
        )
    else:
        d_tile, ovf_mul = spgemm_esc(
            a_cat, b_cat, out_cap=caps.d_cap, flops_cap=caps.flops_cap,
            semiring=semiring, mask_keys=mkeys, mask_complement=mask_complement,
        )
    # ColSplit (Alg. 2 line 4): one partitioned split into all l pieces,
    # order-preserving (pieces stay row-major sorted), sized by piece_cap
    pr_, pc_, pv_, pn_, ovf_split = d_tile.split_col_blocks(l, caps.piece_cap)
    # AllToAll-Fiber (Alg. 2 line 5)
    pr_ = grid.all_to_all(pr_, LAYER_AX)
    pc_ = grid.all_to_all(pc_, LAYER_AX)
    pv_ = grid.all_to_all(pv_, LAYER_AX)
    pn_ = grid.all_to_all(pn_, LAYER_AX)
    # Merge-Fiber (Alg. 2 line 6): the l received pieces are column splits
    # of row-major-sorted D tiles, so they are merged, never re-sorted
    parts = [
        SparseCOO(pr_[k], pc_[k], pv_[k], pn_[k], (tm_a, piece_w))
        for k in range(l)
    ]
    c_tile, ovf_merge = merge_sparse(
        parts, caps.c_cap, semiring, assume_sorted=sorted_merge
    )
    return c_tile, ovf_mul + ovf_split + ovf_merge


def summa3d_sparse_step(
    a: DistSparse, b_batch: DistSparse, grid: Grid, caps: BatchCaps,
    semiring: sr.Semiring = sr.PLUS_TIMES, sorted_merge: bool = True,
    kbin: BinnedCaps = None, bin_of_k: Tensor = None, hashc: HashCaps = None,
) -> Tuple[DistSparse, Tensor]:
    """One batched-SUMMA3D step on the sparse path, on a batch's B block
    (kind "B" layout, tile (wl, tn_b)): ``(c, ovf)``.

    ``c`` is a C-kind ``DistSparse`` with tiles (tm, tn_b/l), whose global
    columns follow ``batched.batch_column_map``; ``ovf`` is an i32 scalar,
    maximised over the grid, > 0 when a capacity of ``caps`` (or of
    ``kbin``/``hashc``) was exceeded. ``sorted_merge`` runs Merge-Fiber as
    a merge of the sorted pieces (§IV-D); ``kbin``/``bin_of_k`` select the
    k-binned local multiply, ``hashc`` the hash multiply, neither ESC.
    """
    tn_b = b_batch.tile_shape[1]
    assert tn_b % grid.l == 0
    c_tile, ovf = _sparse_tile_body(
        _squeeze_tile(a, grid), _squeeze_tile(b_batch, grid), grid, caps, semiring,
        sorted_merge, kbin=kbin, bin_of_k=bin_of_k, hashc=hashc,
    )
    c = from_tile(c_tile, (a.shape[0], b_batch.shape[1]), grid, "C")
    return c, grid.pmax_all(ovf).to(torch.int32)


def summa3d_fused_step(
    a: DistSparse,
    b_full: DistSparse,
    batch: int,
    bin_of_k: Tensor = None,
    mask: DistSparse = None,
    *,
    grid: Grid,
    num_batches: int,
    sel_cap: int,
    caps: BatchCaps,
    semiring: sr.Semiring = sr.PLUS_TIMES,
    sorted_merge: bool = True,
    path: str = "sparse",
    kbin: BinnedCaps = None,
    hashc: HashCaps = None,
    mask_cap: int = 0,
    mask_complement: bool = False,
):
    """Batch-select + SUMMA3D multiply for batch ``batch`` (Alg. 4 lines 5-6).

    Returns ``(c_batch, ovf)`` where ``ovf`` is an i32[2] device tensor
    ``[selection_overflow, multiply_overflow]``, maximized over the grid;
    nothing here waits for the device, so the driver can enqueue batch i+1
    before it reads batch i's flags. ``c_batch`` is a C-kind ``DistSparse``
    (``path="sparse"``) or this process's dense f32 tile stacked as
    (1, 1, 1, tm, wb/l) (``path="dense"``, sum monoids only; only the
    selection and the mask slice can overflow).

    ``mask`` is a C-layout ``DistSparse`` over the whole product, laid out
    like C: batch ``batch``'s piece on layer k is local columns
    [batch·wbl, (batch+1)·wbl) of mask tile (i, j, k). The step selects that
    slice (``mask_cap`` entries, exact from the symbolic mask counts) and
    gathers the l layer pieces along the fiber, layer t's at D columns
    [t·wbl, (t+1)·wbl); the local multiply then keeps C ⊙ M, or C ⊙ ¬M with
    ``mask_complement``. ``sorted_merge`` is ``summa3d_sparse_step``'s.
    """
    tm_a = a.tile_shape[0]
    tn_full = b_full.tile_shape[1]
    assert tn_full % num_batches == 0, (tn_full, num_batches)
    wb = tn_full // num_batches
    l = grid.l
    assert wb % l == 0
    if path == "dense":
        assert semiring.add_kind == "sum", "dense path requires a sum monoid"

    a_loc = _squeeze_tile(a, grid)
    b_loc = _squeeze_tile(b_full, grid)
    sel, ovf_sel = b_loc.select_cols_blockcyclic(batch, num_batches, l, new_cap=sel_cap)
    ovf_sel = grid.pmax_all(ovf_sel)
    mask_cat, ovf_mask = None, torch.zeros_like(ovf_sel)
    if mask is not None:
        assert mask.kind in ("A", "C"), mask.kind
        assert mask.tile_shape == (tm_a, tn_full // l), (mask.tile_shape, (tm_a, tn_full // l))
        wbl = mask.tile_shape[1] // num_batches
        assert wbl * num_batches == mask.tile_shape[1], (mask.tile_shape, num_batches)
        msel, ovf_mask = _squeeze_tile(mask, grid).select_col_block(
            batch * wbl, wbl, new_cap=mask_cap)
        ovf_mask = grid.pmax_all(ovf_mask)
        mv = msel.valid_mask()
        k_ax = grid.axis_index(LAYER_AX)
        mrows = torch.where(mv, msel.rows, torch.full_like(msel.rows, tm_a))
        mcols = torch.where(mv, k_ax * wbl + msel.cols, torch.full_like(msel.cols, wb))
        g_mr = grid.all_gather(mrows, LAYER_AX).reshape(-1)
        g_mc = grid.all_gather(mcols, LAYER_AX).reshape(-1)
        gcap = g_mr.shape[0]
        # every slot declared live; padding carries the (tm, wb) sentinels
        mask_cat = SparseCOO(
            g_mr, g_mc, torch.ones((gcap,), dtype=torch.float32, device=g_mr.device),
            torch.tensor(gcap, dtype=torch.int32, device=g_mr.device), (tm_a, wb),
        )
    if path == "dense":
        d_tile = spmm(_gather_A(a_loc, grid), _gather_B(sel, grid).to_dense(), semiring)
        if mask_cat is not None:
            d_tile = torch.where(mask_indicator(mask_cat, mask_complement), d_tile,
                                 torch.zeros_like(d_tile))
        c_tile = grid.psum_scatter(d_tile, LAYER_AX, dim=1)  # (tm, wb/l)
        ovf = torch.stack([ovf_sel, ovf_mask])
        return c_tile.reshape(1, 1, 1, *c_tile.shape), ovf
    c_tile, ovf_mul = _sparse_tile_body(
        a_loc, sel, grid, caps, semiring, sorted_merge,
        kbin=kbin, bin_of_k=bin_of_k, hashc=hashc,
        mask=mask_cat, mask_complement=mask_complement,
    )
    ovf = torch.stack([ovf_sel, grid.pmax_all(ovf_mul).to(torch.int32) + ovf_mask])
    c = from_tile(c_tile, (a.shape[0], b_full.shape[1] // num_batches), grid, "C")
    return c, ovf


# ---------------------------------------------------------------------------
# On-grid operand reassembly (device-resident iteration, paper §V-C)
# ---------------------------------------------------------------------------
def reassemble_operands(
    c_batches, grid: Grid, cap_a: int, cap_b: int
) -> Tuple[DistSparse, DistSparse, Tensor]:
    """Turn the batched C outputs of one multiply into the next iteration's
    A-kind and B-kind operands without leaving the grid.

    ``c_batches`` are the per-batch C ``DistSparse`` results of
    ``batched_summa3d`` (kind "C", tile (tm, wb/l)), e.g. the pruned batches
    of an MCL expansion. Batch bi's local column c of tile (i, j, k) is
    global column j·w + (k·nb + bi)·wbl + c (``batch_column_map``), which
    lands in row block i / column block j of both target distributions, so
    the reassembly is fiber-local: A keeps each entry on its layer (a local
    column remap and one concat), B needs a partitioned split on the row and
    one ``all_to_all`` over the layer axis.

    Requires the square layout MCL uses: m == n, pr == pc. Returns
    ``(a_next, b_next, overflow)``; overflow counts entries dropped because
    ``cap_a``/``cap_b`` were exceeded — 0 at the post-prune hard bound.
    """
    c_batches = tuple(c_batches)
    nb = len(c_batches)
    c0 = c_batches[0]
    pr, pc, l = c0.grid_shape
    tm, wbl = c0.tile_shape
    m = c0.shape[0]
    w = wbl * l * nb  # full column-block width = n/pc
    n = w * pc
    assert m == n and pr == pc, (
        f"on-grid reassembly requires the square layout, got m={m} n={n} "
        f"grid {pr}x{pc}x{l}"
    )
    wl = w // l  # per-layer slice width (A cols / B rows)
    k_ax = grid.axis_index(LAYER_AX)
    tiles = [_squeeze_tile(t, grid) for t in c_batches]

    # A-kind route: layer k's batch offsets span exactly [k·wl, (k+1)·wl),
    # so every entry stays on its layer; only its column moves to bi·wbl + c
    a_parts = [
        SparseCOO(t.rows, bi * wbl + t.cols, t.vals, t.nnz, (tm, wl))
        for bi, t in enumerate(tiles)
    ]
    a_tile, ovf_a = concat(a_parts, cap_a)

    # B-kind route: one entry list over the full local column block [0, w)
    # with padding rewritten to explicit sentinels; the destination layer is
    # row // wl, so split on rows by swapping the roles (split_col_blocks
    # keys on .cols)
    rows_l, offs_l, vals_l = [], [], []
    for bi, t in enumerate(tiles):
        valid = t.valid_mask()
        rows_l.append(torch.where(valid, t.rows, torch.full_like(t.rows, tm)))
        offs_l.append(torch.where(valid, (k_ax * nb + bi) * wbl + t.cols,
                                  torch.full_like(t.cols, w)))
        vals_l.append(torch.where(valid, t.vals, torch.zeros_like(t.vals)))
    offs = torch.cat(offs_l)
    nnz_all = torch.tensor(offs.shape[0], dtype=torch.int32, device=offs.device)
    ent_b = SparseCOO(offs, torch.cat(rows_l), torch.cat(vals_l), nnz_all, (w, tm))
    br, bc, bv, bn, ovf_b = ent_b.split_col_blocks(l, cap_b)
    br = grid.all_to_all(br, LAYER_AX)
    bc = grid.all_to_all(bc, LAYER_AX)
    bv = grid.all_to_all(bv, LAYER_AX)
    bn = grid.all_to_all(bn, LAYER_AX)
    # received pieces carry (rows = column offset in the block, cols = local B row)
    b_parts = [SparseCOO(bc[k], br[k], bv[k], bn[k], (wl, w)) for k in range(l)]
    b_tile, ovf_b2 = concat(b_parts, cap_b)

    ovf = grid.pmax_all(ovf_a + ovf_b + ovf_b2)
    a_next = from_tile(a_tile, (m, n), grid, "A")
    b_next = from_tile(b_tile, (m, n), grid, "B")
    return a_next, b_next, ovf
