"""Fixed-capacity sparse matrix format (padded COO), in PyTorch.

A sparse matrix is padded COO with a fixed *capacity* and a valid count
``nnz`` that stays a 0-dim device tensor, so no operation below has to wait
for the device to learn it:

    rows : i32[cap]   row index of each entry; padding entries hold ``m`` (sentinel)
    cols : i32[cap]   col index;              padding entries hold ``n``
    vals : f32[cap]   value;                  padding entries hold 0

Invariants: entries [0, nnz) are valid, entries [nnz, cap) are padding, and
sentinel indices are exactly (m, n) so scatters route padding into a discard
bucket and sorts push it to the end. Capacity plays the role of the
allocation the symbolic step (Alg. 3) sizes; operations that can overflow it
return an ``overflow`` count instead of raising, so the batched driver can
retry with larger capacities (paper §IV-A).

The format, the sentinels and the overflow contract are the JAX package's:
the planner, the retry ladder and ``PlanFloors`` are built on them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import sortkeys
from ..kernels.densify_kernel import densify as densify_entries

Tensor = torch.Tensor


def _full(cap: int, value, dtype, device) -> Tensor:
    return torch.full((cap,), value, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class SparseCOO:
    rows: Tensor  # i32[cap]
    cols: Tensor  # i32[cap]
    vals: Tensor  # dtype[cap]
    nnz: Tensor  # i32 0-dim — number of valid entries
    shape: Tuple[int, int]  # (m, n)

    # ------------------------------------------------------------------ basics
    @property
    def cap(self) -> int:
        return self.rows.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def valid_mask(self) -> Tensor:
        return torch.arange(self.cap, device=self.device) < self.nnz

    def to_dense(self) -> Tensor:
        """Dense (m, n) matrix, duplicates summed, padding skipped — the
        densify kernel on the card (``kernels.densify_kernel``)."""
        m, n = self.shape
        return densify_entries(self.rows, self.cols, self.vals, m, n)

    def transpose(self) -> "SparseCOO":
        m, n = self.shape
        return SparseCOO(self.cols, self.rows, self.vals, self.nnz, (n, m))

    # ------------------------------------------------------------- reordering
    def _sorted_by(self, pack) -> "SparseCOO":
        m, n = self.shape
        if sortkeys.fits_i32(m, n):
            key = pack(self.rows, self.cols)
        else:
            # stable int64 packed key == the two-key lexsort order
            key = pack(self.rows.long(), self.cols.long())
        _, perm = sortkeys.stable_sort(key)
        return SparseCOO(
            self.rows[perm], self.cols[perm], self.vals[perm], self.nnz, self.shape
        )

    def sort_rowmajor(self) -> "SparseCOO":
        """Sort entries by (row, col), stably. Padding (sentinels) sorts last."""
        n = self.shape[1]
        return self._sorted_by(lambda r, c: sortkeys.pack_rowmajor(r, c, n))

    def sort_colmajor(self) -> "SparseCOO":
        """Sort entries by (col, row) — CSC-like ordering used by local SpGEMM."""
        m = self.shape[0]
        return self._sorted_by(lambda r, c: sortkeys.pack_colmajor(r, c, m))

    # ------------------------------------------------------------- reshaping
    def with_capacity(self, new_cap: int) -> "SparseCOO":
        """Grow (pad with sentinels) or shrink the capacity; shrinking keeps
        the first ``new_cap`` slots, lossless when nnz <= new_cap."""
        m, n = self.shape
        if new_cap >= self.cap:
            pad = new_cap - self.cap
            return SparseCOO(
                torch.cat([self.rows, _full(pad, m, torch.int32, self.device)]),
                torch.cat([self.cols, _full(pad, n, torch.int32, self.device)]),
                torch.cat([self.vals, torch.zeros((pad,), dtype=self.dtype, device=self.device)]),
                self.nnz, self.shape,
            )
        return SparseCOO(self.rows[:new_cap], self.cols[:new_cap], self.vals[:new_cap],
                         torch.clamp(self.nnz, max=new_cap), self.shape)

    def compact(self, keep: Tensor, new_cap: int) -> Tuple["SparseCOO", Tensor]:
        """Keep entries where ``keep`` (bool[cap]) is set, repacked densely.

        Returns (matrix with capacity ``new_cap``, overflow count). Entries that
        do not fit in ``new_cap`` are dropped and counted in overflow.
        """
        m, n = self.shape
        dev = self.device
        keep = keep & self.valid_mask()
        pos = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
        if self.cap > 0:
            total = torch.clamp(pos[-1] + 1, min=0)
        else:
            total = torch.zeros((), dtype=torch.int32, device=dev)
        write = keep & (pos < new_cap)
        dest = torch.where(write, pos, torch.full_like(pos, new_cap)).long()
        rows = _full(new_cap + 1, m, torch.int32, dev)
        cols = _full(new_cap + 1, n, torch.int32, dev)
        vals = torch.zeros((new_cap + 1,), dtype=self.dtype, device=dev)
        rows[dest] = torch.where(write, self.rows, torch.full_like(self.rows, m))
        cols[dest] = torch.where(write, self.cols, torch.full_like(self.cols, n))
        vals[dest] = torch.where(write, self.vals, torch.zeros_like(self.vals))
        # the discard slot may have taken any written value: cut it off
        new_nnz = torch.clamp(total, max=new_cap).to(torch.int32)
        overflow = (total - new_nnz).to(torch.int32)
        out = SparseCOO(rows[:new_cap], cols[:new_cap], vals[:new_cap], new_nnz, (m, n))
        return out, overflow

    # ----------------------------------------------------------- column slicing
    def select_col_block(self, lo, width: int, new_cap: int):
        """Entries with lo <= col < lo + width, columns remapped to [0,
        width), compacted into ``new_cap`` slots. Returns (matrix, overflow)."""
        m, _ = self.shape
        keep = (self.cols >= lo) & (self.cols < lo + width)
        shifted = SparseCOO(
            self.rows, torch.where(keep, self.cols - lo, torch.full_like(self.cols, width)),
            self.vals, self.nnz, (m, width),
        )
        return shifted.compact(keep, new_cap)

    def split_col_blocks(self, num_pieces: int, piece_cap: int):
        """Partitioned ColSplit (Alg. 2 line 4): all ``num_pieces`` column
        pieces in ONE pass.

        Entry e goes to piece ``col // (n/num_pieces)``; its slot within the
        piece is its rank among same-piece entries, so the original entry
        order is preserved per piece — a row-major-sorted input yields
        row-major-sorted pieces, the invariant the segmented Merge-Fiber
        relies on. Columns are remapped to [0, n/num_pieces).

        Returns ``(rows, cols, vals, nnz, overflow)``: the first three are
        (num_pieces, piece_cap) sentinel-padded arrays, ``nnz`` is
        i32[num_pieces], and ``overflow`` counts entries dropped because a
        piece exceeded ``piece_cap``.
        """
        m, n = self.shape
        dev = self.device
        assert n % num_pieces == 0, (n, num_pieces)
        piece_w = n // num_pieces
        valid = self.valid_mask()
        piece = torch.where(valid, self.cols // piece_w,
                            torch.full_like(self.cols, num_pieces))
        onehot = (
            piece[:, None] == torch.arange(num_pieces, device=dev, dtype=torch.int32)[None, :]
        ).to(torch.int32)  # (cap, num_pieces)
        rank_excl = torch.cumsum(onehot, 0, dtype=torch.int32) - onehot
        rank = torch.gather(
            rank_excl, 1, torch.clamp(piece, 0, num_pieces - 1).long()[:, None]
        )[:, 0]
        counts = onehot.sum(0, dtype=torch.int32)  # (num_pieces,)
        ok = valid & (piece < num_pieces) & (rank < piece_cap)
        flat = num_pieces * piece_cap
        dest = torch.where(ok, piece * piece_cap + rank, torch.full_like(rank, flat)).long()
        rows = _full(flat + 1, m, torch.int32, dev)
        cols = _full(flat + 1, piece_w, torch.int32, dev)
        vals = torch.zeros((flat + 1,), dtype=self.dtype, device=dev)
        rows[dest] = torch.where(ok, self.rows, torch.full_like(self.rows, m))
        cols[dest] = torch.where(ok, self.cols - piece * piece_w,
                                 torch.full_like(self.cols, piece_w))
        vals[dest] = torch.where(ok, self.vals, torch.zeros_like(self.vals))
        nnz = torch.clamp(counts, max=piece_cap)
        overflow = torch.clamp(counts - piece_cap, min=0).sum().to(torch.int32)
        shape2 = (num_pieces, piece_cap)
        return (
            rows[:flat].reshape(shape2), cols[:flat].reshape(shape2),
            vals[:flat].reshape(shape2), nnz, overflow,
        )

    def select_cols_blockcyclic(
        self, batch, num_batches: int, num_layers: int, new_cap: int
    ):
        """Paper Fig. 1(i): block-cyclic column selection for batch ``batch``.

        The local column range is divided into ``num_batches * num_layers``
        blocks of width w; batch i owns blocks {i, i+b, i+2b, ...} (l of them),
        remapped contiguously. This balances Merge-Fiber load (§IV-B).
        """
        m, n = self.shape
        nblocks = num_batches * num_layers
        assert n % nblocks == 0, f"ncols {n} must divide into {nblocks} blocks"
        w = n // nblocks
        blk = self.cols // w
        keep = (blk % num_batches) == batch
        new_col = (blk // num_batches) * w + self.cols % w
        width = n // num_batches
        shifted = SparseCOO(
            self.rows,
            torch.where(keep & self.valid_mask(), new_col, torch.full_like(new_col, width)),
            self.vals,
            self.nnz,
            (m, width),
        )
        return shifted.compact(keep, new_cap)

    # ------------------------------------------------------------- statistics
    def col_counts(self) -> Tensor:
        """nnz per column — i32[n]. Used by the symbolic step (Alg. 3)."""
        return self._counts(self.cols, self.shape[1])

    def row_counts(self) -> Tensor:
        return self._counts(self.rows, self.shape[0])

    def _counts(self, idx: Tensor, size: int) -> Tensor:
        out = torch.zeros((size + 1,), dtype=torch.int32, device=self.device)
        out.index_add_(0, idx.long(), self.valid_mask().to(torch.int32))
        return out[:size]

    # -------------------------------------------------------------- pruning
    def prune_threshold(self, thresh, new_cap: int):
        """Drop entries with |val| < thresh (MCL-style pruning)."""
        return self.compact(torch.abs(self.vals) >= thresh, new_cap)

    def scale_cols(self, scale: Tensor) -> "SparseCOO":
        """Multiply each column j by scale[j] (padding's sentinel column by 1)."""
        s = torch.cat([scale, torch.ones((1,), dtype=scale.dtype, device=scale.device)])
        return SparseCOO(self.rows, self.cols, self.vals * s[self.cols.long()], self.nnz,
                         self.shape)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------
def empty(shape: Tuple[int, int], cap: int, dtype=torch.float32, device="cuda") -> SparseCOO:
    m, n = shape
    return SparseCOO(
        _full(cap, m, torch.int32, device),
        _full(cap, n, torch.int32, device),
        torch.zeros((cap,), dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
        shape,
    )


def from_dense(x: Tensor, cap: int) -> SparseCOO:
    """Dense→COO in row-major order; nonzeros beyond ``cap`` are dropped."""
    return from_dense_overflow(x, cap)[0]


def from_dense_overflow(x: Tensor, cap: int) -> Tuple[SparseCOO, Tensor]:
    """Dense→COO in row-major order that also reports how many nonzeros did
    not fit in ``cap``
    — the sparsify step of dense-accumulator local multiplies, which follows
    the same §IV-A overflow-retry discipline as ESC."""
    m, n = x.shape
    dev = x.device
    nz = torch.nonzero(x)  # row-major order
    total = nz.shape[0]
    keep = min(total, cap)
    rows = _full(cap, m, torch.int32, dev)
    cols = _full(cap, n, torch.int32, dev)
    vals = torch.zeros((cap,), dtype=x.dtype, device=dev)
    rows[:keep] = nz[:keep, 0].to(torch.int32)
    cols[:keep] = nz[:keep, 1].to(torch.int32)
    vals[:keep] = x[nz[:keep, 0], nz[:keep, 1]]
    nnz = torch.tensor(keep, dtype=torch.int32, device=dev)
    overflow = torch.tensor(total - keep, dtype=torch.int32, device=dev)
    return SparseCOO(rows, cols, vals, nnz, (m, n)), overflow


def from_numpy_coo(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, shape, cap: int = None,
    device="cuda",
) -> SparseCOO:
    """Host-side constructor (dedups duplicate coordinates by summing, emits
    row-major sorted entries)."""
    m, n = shape
    key = rows.astype(np.int64) * n + cols.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    acc = np.zeros(len(uniq), dtype=vals.dtype)
    np.add.at(acc, inv, vals)
    r, c = (uniq // n).astype(np.int32), (uniq % n).astype(np.int32)
    nnz = len(uniq)
    cap = cap or nnz
    assert cap >= nnz, f"capacity {cap} < nnz {nnz}"
    pr = np.full(cap, m, np.int32)
    pc = np.full(cap, n, np.int32)
    pv = np.zeros(cap, vals.dtype)
    pr[:nnz], pc[:nnz], pv[:nnz] = r, c, acc
    return SparseCOO(
        torch.from_numpy(pr).to(device), torch.from_numpy(pc).to(device),
        torch.from_numpy(pv).to(device),
        torch.tensor(nnz, dtype=torch.int32, device=device), (m, n),
    )


def coalesce(a: SparseCOO, new_cap: int, engine: str = "auto") -> Tuple[SparseCOO, Tensor]:
    """Sum duplicate (row, col) entries; row-major sorted output through the
    packed-key engine (``sortkeys.coalesce_entries``). Returns (merged,
    overflow count)."""
    rows, cols, vals, nnz, overflow = sortkeys.coalesce_entries(
        a.rows, a.cols, a.vals, a.valid_mask(), a.shape, new_cap, add_kind="sum",
        engine=engine,
    )
    return SparseCOO(rows, cols, vals, nnz, a.shape), overflow


def concat(mats, new_cap: int) -> Tuple[SparseCOO, Tensor]:
    """Stack the entry lists of same-shape matrices (no dedup), valid entries
    compacted to the front. Returns (matrix, overflow count)."""
    shape = mats[0].shape
    for x in mats:
        assert x.shape == shape
    rows = torch.cat([x.rows for x in mats])
    stacked = SparseCOO(
        rows,
        torch.cat([x.cols for x in mats]),
        torch.cat([x.vals for x in mats]),
        torch.tensor(rows.shape[0], dtype=torch.int32, device=rows.device),
        shape,
    )
    return stacked.compact(torch.cat([x.valid_mask() for x in mats]), new_cap)


def hstack_remap(mats, widths, new_cap: int):
    """Concatenate matrices side by side: block j's columns shift by
    sum(widths[:j]). Used to merge a degraded batch's sub-batches back."""
    m = mats[0].shape[0]
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)
    total_n = int(offs[-1])
    cols = []
    for x, off in zip(mats, offs[:-1]):
        assert x.shape[0] == m
        cols.append(torch.where(x.valid_mask(), x.cols + int(off),
                                torch.full_like(x.cols, total_n)))
    stacked = SparseCOO(
        torch.cat([x.rows for x in mats]),
        torch.cat(cols),
        torch.cat([x.vals for x in mats]),
        torch.tensor(sum(x.cap for x in mats), dtype=torch.int32, device=mats[0].device),
        (m, total_n),
    )
    return stacked.compact(torch.cat([x.valid_mask() for x in mats]), new_cap)
