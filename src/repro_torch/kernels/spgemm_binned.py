"""k-binned paired SpGEMM — COO × COO → dense C.

Both operands are first distributed into ``num_bins`` contraction ranges by
a stable counting sort (``bin_entries_by_k``), then only entries of the same
bin are paired, so the pairing work drops from capA × capB to
Σ_g capA_g × capB_g: entries in different bins can never satisfy
``a_k == b_k``. Bin capacities come from the host planner
(``core.symbolic.plan_k_bins``); beaten capacities are counted as overflow.

  * ``spgemm_paired_binned_cuda`` — the Hopper kernel
    (``csrc/spgemm_binned.cu``); replaces the TPU kernel
    ``repro/kernels/spgemm_binned.py::spgemm_paired_binned_pallas``.
  * ``spgemm_paired_binned_ref`` — the plain PyTorch version (the JAX
    package's ``kernels/ref.py::spgemm_paired_binned_ref``): per bin, the
    matching (A entry, B entry) pairs and a scatter-add of their products.
  * ``spgemm_paired_binned`` — the kernel for CUDA tensors, the plain
    version for CPU tensors.

Both add the products of every C[r, c] in one fixed order — bins
ascending, then A slots, then B slots — from 0.0, each product and sum
rounded on its own, so the kernel's C has the plain version's bits (on the
CPU, where ``index_add_`` adds serially in index order).

Padding sentinels: A pads k with -1, B with -2 (never equal), values with 0.

``pairing_counts`` compares the pairing work of the unbinned and the binned
multiply from capacities alone.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

Tensor = torch.Tensor

# spgemm_paired_binned_launch(a_key, a_slot, a_k, a_vals, na, bin_cap_a,
#                             b_key, b_slot, b_cols, b_vals, nb, bin_cap_b, m, n,
#                             row_start, a_rec, b_rec, out, stream)
_LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5)


# ---------------------------------------------------------------------------
# binning (stable counting sort by k-range)
# ---------------------------------------------------------------------------
def bin_entries_by_k(
    k_idx, other, vals, valid, k_dim: int, num_bins: int, bin_cap: int,
    *, fill_k: int, fill_other: int, bin_map=None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Distribute COO entries into ``num_bins`` k-ranges.

    ``bin_map`` is a monotone i32[k_dim] map k → bin; when None,
    equal-width ranges ``k * num_bins // k_dim`` are used. Returns
    (k_binned, other_binned, vals_binned, overflow), the first three of shape
    (num_bins, bin_cap) with sentinel-filled padding; entries keep their
    input order within a bin. Entries beyond a bin's capacity are dropped
    and counted in ``overflow``.
    """
    cap = k_idx.shape[0]
    dev = k_idx.device
    if bin_map is None:
        bucket = torch.where(valid, k_idx * num_bins // k_dim,
                             torch.full_like(k_idx, num_bins))
    else:
        bin_map_pad = torch.cat([
            bin_map.to(device=dev, dtype=torch.int32),
            torch.full((1,), num_bins, dtype=torch.int32, device=dev),
        ])
        bucket = torch.where(
            valid, bin_map_pad[torch.clamp(k_idx, 0, k_dim).long()],
            torch.full_like(k_idx, num_bins),
        )
    bucket = bucket.to(torch.int32)
    bucket_s, perm = torch.sort(bucket, stable=True)
    k_s, o_s, v_s = k_idx[perm], other[perm], vals[perm]
    counts = torch.zeros((num_bins + 1,), dtype=torch.int32, device=dev)
    counts.index_add_(0, bucket.long(), torch.ones_like(bucket))
    counts = counts[:num_bins]
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    bclip = torch.clamp(bucket_s, 0, num_bins - 1)
    within = torch.arange(cap, dtype=torch.int32, device=dev) - starts[bclip.long()]
    ok = (bucket_s < num_bins) & (within < bin_cap)
    flat = num_bins * bin_cap
    dest = torch.where(ok, bclip * bin_cap + within, torch.full_like(within, flat)).long()

    def place(src, fill, dtype):
        out = torch.full((flat + 1,), fill, dtype=dtype, device=dev)
        out[dest] = torch.where(ok, src.to(dtype), torch.full_like(src, fill, dtype=dtype))
        return out[:flat].reshape(num_bins, bin_cap)

    kb = place(k_s, fill_k, torch.int32)
    ob = place(o_s, fill_other, torch.int32)
    vb = place(v_s, 0, vals.dtype)
    overflow = torch.clamp(counts - bin_cap, min=0).sum().to(torch.int32)
    return kb, ob, vb, overflow


# ---------------------------------------------------------------------------
# the paired multiply: plain version, kernel, dispatch
# ---------------------------------------------------------------------------
def _check(a_rows, a_k, a_vals, b_k, b_cols, b_vals):
    if not (a_rows.shape == a_k.shape == a_vals.shape and a_rows.dim() == 2):
        raise ValueError((a_rows.shape, a_k.shape, a_vals.shape))
    if not (b_k.shape == b_cols.shape == b_vals.shape and b_k.dim() == 2):
        raise ValueError((b_k.shape, b_cols.shape, b_vals.shape))
    if a_rows.shape[0] != b_k.shape[0]:
        raise ValueError(f"bin counts differ: {a_rows.shape} vs {b_k.shape}")
    if any(t.dtype != torch.int32 for t in (a_rows, a_k, b_k, b_cols)):
        raise TypeError("binned indices must be int32")
    if a_vals.dtype != torch.float32 or b_vals.dtype != torch.float32:
        raise TypeError("binned values must be float32")


def spgemm_paired_binned_ref(
    a_rows: Tensor, a_k: Tensor, a_vals: Tensor,
    b_k: Tensor, b_cols: Tensor, b_vals: Tensor, m: int, n: int,
) -> Tensor:
    """Plain PyTorch version: dense f32 C (m, n) = Σ over same-bin pairs with
    a_k == b_k of a_val * b_val at (a_row, b_col); rows outside [0, m) and
    columns outside [0, n) go to a discarded slot. The pairs are listed bins
    ascending, then A slots, then B slots (``torch.nonzero`` is row-major),
    and on the CPU ``index_add_`` adds them serially in that order."""
    _check(a_rows, a_k, a_vals, b_k, b_cols, b_vals)
    out = torch.zeros((m + 1) * (n + 1), dtype=torch.float32, device=a_rows.device)
    for g in range(a_rows.shape[0]):
        ia, ib = torch.nonzero(a_k[g][:, None] == b_k[g][None, :], as_tuple=True)
        r, c = a_rows[g][ia].long(), b_cols[g][ib].long()
        r = torch.where((r >= 0) & (r < m), r, m)
        c = torch.where((c >= 0) & (c < n), c, n)
        out.index_add_(0, r * (n + 1) + c, a_vals[g][ia] * b_vals[g][ib])
    return out.reshape(m + 1, n + 1)[:m, :n]


def spgemm_paired_binned_cuda(
    a_rows: Tensor, a_k: Tensor, a_vals: Tensor,
    b_k: Tensor, b_cols: Tensor, b_vals: Tensor, m: int, n: int,
) -> Tensor:
    """Launch the Hopper kernels on the current stream: A's slots sorted
    stably by row and B's by contraction index (``torch.sort``), then the
    order-fixed pull, which writes every element of C once."""
    _check(a_rows, a_k, a_vals, b_k, b_cols, b_vals)
    tensors = (a_rows, a_k, a_vals, b_k, b_cols, b_vals)
    dev = a_rows.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("spgemm_paired_binned_cuda needs all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("spgemm_paired_binned_cuda needs contiguous tensors")
    na, nb = a_rows.numel(), b_k.numel()
    if max(na, nb, m, n) >= 2**31 - 1:
        raise ValueError(f"spgemm_paired_binned_cuda takes sizes below 2^31 - 1: "
                         f"{na} A and {nb} B slots, C ({m}, {n})")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    bin_cap_a, bin_cap_b = max(a_rows.shape[1], 1), max(b_k.shape[1], 1)
    a_key, a_slot = torch.sort(a_rows.reshape(-1), stable=True)
    b_key, b_slot = torch.sort(b_k.reshape(-1), stable=True)
    row_start = torch.empty(m + 1, dtype=torch.int32, device=dev)
    a_rec = torch.empty((na, 4), dtype=torch.int32, device=dev)  # (B start, B count, a_val bits, 0)
    b_rec = torch.empty((nb, 2), dtype=torch.int32, device=dev)  # (column, value bits)
    fn = _build.entry("spgemm_binned", "spgemm_paired_binned_launch", _LAUNCH_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            a_key.data_ptr(), a_slot.data_ptr(), a_k.data_ptr(), a_vals.data_ptr(), na,
            bin_cap_a, b_key.data_ptr(), b_slot.data_ptr(), b_cols.data_ptr(),
            b_vals.data_ptr(), nb, bin_cap_b, m, n, row_start.data_ptr(), a_rec.data_ptr(),
            b_rec.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "spgemm_paired_binned_cuda")
    spgemm_paired_binned_cuda.launches += 1
    return out


spgemm_paired_binned_cuda.launches = 0


def spgemm_paired_binned(
    a_rows: Tensor, a_k: Tensor, a_vals: Tensor,
    b_k: Tensor, b_cols: Tensor, b_vals: Tensor, m: int, n: int,
) -> Tensor:
    """Dense C (m×n, f32) from k-binned COO entry lists of shape
    (num_bins, bin_cap*): the Hopper kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = spgemm_paired_binned_cuda if a_rows.is_cuda else spgemm_paired_binned_ref
    return fn(a_rows, a_k, a_vals, b_k, b_cols, b_vals, m, n)


def spgemm_binned_dense(
    a_rows, a_cols, a_vals, valid_a, b_rows, b_cols, b_vals, valid_b,
    m: int, n: int, k_dim: int, num_bins: int, bin_cap_a: int, bin_cap_b: int,
    bin_map=None,
) -> Tuple[Tensor, Tensor]:
    """Bin both COO operands by contraction index and pair matching bins
    only. A's entries arrive as (row, k=col, val), B's as (k=row, col, val).
    Returns (dense C (m, n) f32, bin-capacity overflow count)."""
    ak_b, ar_b, av_b, ovf_a = bin_entries_by_k(
        a_cols, a_rows, a_vals, valid_a, k_dim, num_bins, bin_cap_a,
        fill_k=-1, fill_other=m, bin_map=bin_map,
    )
    bk_b, bc_b, bv_b, ovf_b = bin_entries_by_k(
        b_rows, b_cols, b_vals, valid_b, k_dim, num_bins, bin_cap_b,
        fill_k=-2, fill_other=n, bin_map=bin_map,
    )
    out = spgemm_paired_binned(ar_b, ak_b, av_b, bk_b, bc_b, bv_b, m, n)
    return out, ovf_a + ovf_b


#: Entry-block size of the pairing grids that ``pairing_counts`` prices: the
#: JAX package's paired kernels pair A and B in blocks of 256 entries.
PAIR_BLOCK = 256


def pairing_counts(
    cap_a: int, cap_b: int, num_bins: int, bin_cap_a: int, bin_cap_b: int
) -> dict:
    """Static pairing-work comparison: unbinned capA × capB against binned
    Σ_g capA_g × capB_g, both rounded up to whole entry blocks."""
    a_blk = min(PAIR_BLOCK, _rup(cap_a, 8))
    b_blk = min(PAIR_BLOCK, _rup(cap_b, 8))
    full = _rup(cap_a, a_blk) * _rup(cap_b, b_blk)
    a_blk_g = min(PAIR_BLOCK, _rup(bin_cap_a, 8))
    b_blk_g = min(PAIR_BLOCK, _rup(bin_cap_b, 8))
    binned = num_bins * _rup(bin_cap_a, a_blk_g) * _rup(bin_cap_b, b_blk_g)
    return {
        "pairings_unbinned": full,
        "pairings_binned": binned,
        "reduction": full / max(binned, 1),
    }


def _rup(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult
