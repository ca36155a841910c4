"""Packed-key sort/compress engine — the local SpGEMM hot path (paper §IV-D).

Every ESC compress and duplicate-coordinate merge reduces to one primitive:
*group entries by (row, col) and reduce their values*. The coordinate pair
is packed into one monotonic i32 key

    key(row, col) = row * (n + 1) + col          (row-major; sentinel-aware)

so the grouping runs through one of three engines, picked per shape:

  * ``"bucket"``  — sort-free occupancy scan: scatter a presence bit per key,
    prefix-sum the bucket table to rank the distinct keys, reduce the values.
    Used when the key space (m+1)(n+1) is small next to the entry count.
  * ``"packed"``  — one stable single-key sort carrying the values, then a
    linear boundary scan.
  * ``"lexsort"`` — for shapes whose packed key would overflow i32. It sorts
    a stable int64 packed key, which orders entries exactly as the two-key
    (row, col) lexsort does.

All three emit identical (keys, values, nnz, overflow). Every engine
reduces a slot's values over its contiguous run of sorted entries
(``segment_reduce``, the segment-reduce kernel on the card), in slot
order: no atomics, so a sum gives the same bits on every run, and padding
entries are never read.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import segment_reduce as segkern

Tensor = torch.Tensor

INT32_MAX = (1 << 31) - 1

#: Max bucket-table cells for the sort-free scan (i32 table; 16 MB at 1<<22).
BUCKET_SCAN_MAX = 1 << 22

#: Don't bother scanning a table more than this many times larger than cap.
BUCKET_SCAN_WASTE = 64


# ---------------------------------------------------------------------------
# key packing
# ---------------------------------------------------------------------------
def key_space(m: int, n: int) -> int:
    """Number of distinct packed keys incl. the (m, n) sentinel."""
    return (m + 1) * (n + 1)


def fits_i32(m: int, n: int) -> bool:
    return key_space(m, n) <= INT32_MAX


def pack_rowmajor(rows: Tensor, cols: Tensor, n: int) -> Tensor:
    """(row, col) -> row * (n+1) + col (i32). Sentinel (m, n) maps to the max key."""
    return rows * (n + 1) + cols


def unpack_rowmajor(key: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    return key // (n + 1), key % (n + 1)


def pack_colmajor(rows: Tensor, cols: Tensor, m: int) -> Tensor:
    """(row, col) -> col * (m+1) + row (CSC ordering)."""
    return cols * (m + 1) + rows


def stable_sort(key: Tensor) -> Tuple[Tensor, Tensor]:
    """Ascending stable sort; returns (sorted keys, permutation)."""
    return torch.sort(key, stable=True)


def choose_engine(m: int, n: int, cap: int, engine: str = "auto") -> str:
    """Static engine policy. See module docstring."""
    if engine != "auto":
        assert engine in ("bucket", "packed", "lexsort"), engine
        return engine
    if not fits_i32(m, n):
        return "lexsort"
    ks = key_space(m, n)
    if ks <= BUCKET_SCAN_MAX and ks <= BUCKET_SCAN_WASTE * max(cap, 1):
        return "bucket"
    return "packed"


# ---------------------------------------------------------------------------
# order-fixed reduction into output slots (shared by all engines)
# ---------------------------------------------------------------------------
def segment_offsets(sorted_ids: Tensor, num_segments: int) -> Tensor:
    """int32 run boundaries of non-decreasing segment ids: run s is
    ``[offsets[s], offsets[s + 1])``; ids outside [0, num_segments) fall
    before the first run or past the last."""
    bounds = torch.arange(num_segments + 1, dtype=sorted_ids.dtype, device=sorted_ids.device)
    return torch.searchsorted(sorted_ids, bounds, out_int32=True)


def segment_reduce(vals: Tensor, segids: Tensor, num_segments: int, add_kind: str) -> Tensor:
    """Reduce 1-D ``vals`` by segment id into ``num_segments`` slots (ids
    outside [0, num_segments) are dropped; empty slots hold the identity),
    in a fixed order: entries are grouped by id with a stable sort and each
    slot is reduced over its run by ``kernels.segment_reduce``. The same
    inputs give the same bits on every run, on the card as on the CPU."""
    segids, order = torch.sort(segids, stable=True)
    return segkern.segment_reduce(vals[order], segment_offsets(segids, num_segments), add_kind)


def _run_heads(x: Tensor, offsets: Tensor, fill: int) -> Tensor:
    """``x`` at the first entry of each run, ``fill`` for an empty run: the
    run's minimum when ``x`` ascends within runs."""
    if x.numel() == 0:
        return torch.full((offsets.numel() - 1,), fill, dtype=x.dtype, device=x.device)
    head = x[torch.clamp(offsets[:-1], max=x.numel() - 1).long()]
    return torch.where(offsets[1:] > offsets[:-1], head, torch.full_like(head, fill))


def _scatter_min_keys(fill: int, new_cap: int, seg: Tensor, keys: Tensor) -> Tensor:
    out = torch.full((new_cap + 1,), fill, dtype=torch.int32, device=keys.device)
    out.scatter_reduce_(0, seg.long(), keys.to(torch.int32), reduce="amin")
    return out[:new_cap]


def _finalize(out_key, out_vals, total, new_cap, sent, dtype):
    nnz = torch.clamp(total, max=new_cap).to(torch.int32)
    pad = torch.arange(new_cap, device=out_key.device) >= nnz
    out_key = torch.where(pad, torch.full_like(out_key, sent), out_key)
    out_vals = torch.where(pad, torch.zeros_like(out_vals), out_vals).to(dtype)
    overflow = (total - nnz).to(torch.int32)
    return out_key, out_vals, nnz, overflow


def _segments(new_key: Tensor) -> Tuple[Tensor, Tensor]:
    """Slot id per entry (rank among segment heads) and the segment count."""
    seg = torch.cumsum(new_key.to(torch.int32), 0, dtype=torch.int32) - 1
    if seg.numel() == 0:
        return seg, torch.zeros((), dtype=torch.int32, device=seg.device)
    return seg, torch.clamp(seg[-1] + 1, min=0)


# ---------------------------------------------------------------------------
# engine bodies
# ---------------------------------------------------------------------------
def compress_sorted_keys(
    keys: Tensor, vals: Tensor, sent: int, new_cap: int, add_kind: str = "sum"
):
    """Compress an ascending-sorted key array (duplicates adjacent, sentinels
    last) into unique slots. Returns (out_keys, out_vals, nnz, overflow).

    The shared tail of the packed-sort engine, the hash-table finalize and
    the segmented merge (whose inputs arrive already sorted).
    """
    vmask = keys < sent
    new_key = torch.ones_like(vmask)
    if keys.numel() > 1:
        new_key[1:] = keys[1:] != keys[:-1]
    new_key = new_key & vmask
    seg, total = _segments(new_key)
    # slot ids ascend: sentinels and overflow go to new_cap, which sorts last
    seg = torch.where(vmask & (seg < new_cap), seg, torch.full_like(seg, new_cap))
    offsets = segment_offsets(seg, new_cap)
    out_key = _run_heads(keys, offsets, sent)
    out_vals = segkern.segment_reduce(vals, offsets, add_kind)
    return _finalize(out_key, out_vals, total, new_cap, sent, vals.dtype)


def _coalesce_packed(key, vals, sent, new_cap, add_kind):
    key, perm = stable_sort(key)
    return compress_sorted_keys(key, vals[perm], sent, new_cap, add_kind)


def _coalesce_bucket(key, valid, vals, nbuckets, sent, new_cap, add_kind):
    """Sort-free: presence scatter + bucket-table prefix sum ranks the keys."""
    dev = key.device
    keyc = torch.where(valid, key, torch.full_like(key, nbuckets)).long()
    occ = torch.zeros((nbuckets + 1,), dtype=torch.int32, device=dev)
    occ[keyc] = 1
    occ = occ[:nbuckets]
    slot_of_bucket, total = _segments(occ > 0)
    slot = slot_of_bucket[torch.clamp(keyc, 0, nbuckets - 1)]
    seg = torch.where(valid & (slot < new_cap), slot, torch.full_like(slot, new_cap))
    out_vals = segment_reduce(vals, seg, new_cap, add_kind)  # slots in entry order
    bdest = torch.where(
        (occ > 0) & (slot_of_bucket < new_cap), slot_of_bucket,
        torch.full_like(slot_of_bucket, new_cap),
    )
    out_key = _scatter_min_keys(
        sent, new_cap, bdest, torch.arange(nbuckets, dtype=torch.int32, device=dev)
    )
    return _finalize(out_key, out_vals, total, new_cap, sent, vals.dtype)


def _coalesce_lexsort(rows, cols, vals, valid, m, n, new_cap, add_kind):
    """Two-key (row, col) grouping for key spaces beyond i32, via a stable
    int64 packed key (same order as a stable two-key lexsort)."""
    rows = torch.where(valid, rows, torch.full_like(rows, m))
    cols = torch.where(valid, cols, torch.full_like(cols, n))
    _, order = stable_sort(rows.long() * (n + 1) + cols.long())
    rows, cols, vals = rows[order], cols[order], vals[order]
    vmask = rows < m
    new_key = torch.ones_like(vmask)
    if rows.numel() > 1:
        new_key[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    new_key = new_key & vmask
    seg, total = _segments(new_key)
    seg = torch.where(vmask & (seg < new_cap), seg, torch.full_like(seg, new_cap))
    offsets = segment_offsets(seg, new_cap)
    out_rows = _run_heads(rows, offsets, m)
    out_cols = _run_heads(cols, offsets, n)
    out_vals = segkern.segment_reduce(vals, offsets, add_kind)
    nnz = torch.clamp(total, max=new_cap).to(torch.int32)
    pad = torch.arange(new_cap, device=rows.device) >= nnz
    out_rows = torch.where(pad, torch.full_like(out_rows, m), out_rows)
    out_cols = torch.where(pad, torch.full_like(out_cols, n), out_cols)
    out_vals = torch.where(pad, torch.zeros_like(out_vals), out_vals).to(vals.dtype)
    overflow = (total - nnz).to(torch.int32)
    return out_rows, out_cols, out_vals, nnz, overflow


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def coalesce_entries(
    rows: Tensor,
    cols: Tensor,
    vals: Tensor,
    valid: Tensor,
    shape: Tuple[int, int],
    new_cap: int,
    add_kind: str = "sum",
    engine: str = "auto",
):
    """Group duplicate (row, col) coords among ``valid`` entries, reduce values
    by ``add_kind``, and emit row-major sorted entries with (m, n)-sentinel
    padding. Returns (rows, cols, vals, nnz, overflow)."""
    m, n = shape
    eng = choose_engine(m, n, rows.shape[0], engine)
    if eng == "lexsort":
        return _coalesce_lexsort(rows, cols, vals, valid, m, n, new_cap, add_kind)
    sent = key_space(m, n) - 1  # == pack(m, n)
    key = torch.where(valid, pack_rowmajor(rows, cols, n), torch.full_like(rows, sent))
    if eng == "bucket":
        okey, ovals, nnz, ovf = _coalesce_bucket(
            key, valid, vals, key_space(m, n), sent, new_cap, add_kind
        )
    else:
        okey, ovals, nnz, ovf = _coalesce_packed(key, vals, sent, new_cap, add_kind)
    out_rows, out_cols = unpack_rowmajor(okey, n)
    return out_rows, out_cols, ovals, nnz, ovf


# ---------------------------------------------------------------------------
# segmented merge of already-sorted runs (Merge-Fiber fast path)
# ---------------------------------------------------------------------------
def merge_two_sorted(
    keys_a: Tensor, vals_a: Tensor, keys_b: Tensor, vals_b: Tensor
) -> Tuple[Tensor, Tensor]:
    """Merge two ascending key runs (merge-path via ranks): each element's
    output position is its own index plus its rank in the other run. Stable
    across runs (ties: run A first); no full sort."""
    pa, pb = keys_a.shape[0], keys_b.shape[0]
    dev = keys_a.device
    pos_a = torch.arange(pa, device=dev) + torch.searchsorted(keys_b, keys_a)
    pos_b = torch.arange(pb, device=dev) + torch.searchsorted(keys_a, keys_b, right=True)
    out_k = torch.empty((pa + pb,), dtype=keys_a.dtype, device=dev)
    out_v = torch.empty((pa + pb,), dtype=vals_a.dtype, device=dev)
    out_k[pos_a], out_k[pos_b] = keys_a, keys_b
    out_v[pos_a], out_v[pos_b] = vals_a, vals_b
    return out_k, out_v


def merge_sorted_runs(keys_list, vals_list) -> Tuple[Tensor, Tensor]:
    """k-way merge of sorted runs by pairwise tree reduction (ceil(log2 k)
    rounds). Sentinel keys (max) stay at the tail throughout."""
    runs = list(zip(keys_list, vals_list))
    assert runs, "need at least one run"
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            (ka, va), (kb, vb) = runs[i], runs[i + 1]
            nxt.append(merge_two_sorted(ka, va, kb, vb))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]
