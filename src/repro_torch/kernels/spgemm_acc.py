"""Sort-free paired SpGEMM — padded COO A (m×k) × padded COO B (k×n) → dense
f32 C (m×n).

Every (A entry, B entry) pair is matched on the contraction index, and each
match adds ``a_val · b_val`` at (a_row, b_col) of a dense accumulator: no
ordering of either operand is needed (the paper's sort-free property,
§IV-D), and no partial-product list is ever materialized. The TPU kernel
does capA × capB comparisons, which the narrow B column blocks of batching
(Alg. 4) keep affordable; the Hopper kernel buckets B by contraction index
on the card first, so its work is O(capA + capB + matches).

  * ``spgemm_paired_cuda`` — the Hopper kernel (``csrc/spgemm_acc.cu``: count,
    scan, scatter, match); replaces the TPU kernel
    ``repro/kernels/spgemm_acc.py::spgemm_paired_pallas``.
  * ``spgemm_paired_ref`` — the plain PyTorch version (the JAX package's
    ``kernels/ref.py::spgemm_paired_ref``): the match matrix in chunks of
    A's entries, and a scatter-add of the matching pairs' products.
  * ``spgemm_paired`` — the kernel for CUDA tensors, the plain version for
    CPU tensors.

Entries whose A row lies outside [0, m) or whose B column lies outside
[0, n) are skipped, whatever their values: that is how padding (the
sentinels ``m`` and ``n``) is dropped, even where padding of A meets
padding of B on the contraction sentinel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

Tensor = torch.Tensor

#: Match-matrix elements the plain version forms at once (A chunk × capB).
MATCH_CHUNK_ELEMS = 1 << 26

#: Most buckets the kernel sorts B's entries into (its scan's index range).
MAX_BUCKETS = 1 << 30
#: Bucket counts one block of the kernel's scan covers (``kScanSpanLog`` in
#: ``csrc/spgemm_acc.cu``): the wrapper sizes the blocks' bases by it.
SCAN_SPAN = 1 << 16

# spgemm_paired_launch(a_rows, a_cols, a_vals, cap_a, b_rows, b_cols, b_vals,
#                      cap_b, m, n, out, nb, counts, offsets, block_base, rank,
#                      records, stream)
_LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int]
                    + [ctypes.c_void_p] * 6)


def _check(a_rows, a_cols, a_vals, b_rows, b_cols, b_vals) -> None:
    if not (a_rows.dim() == 1 and a_rows.shape == a_cols.shape == a_vals.shape):
        raise ValueError((a_rows.shape, a_cols.shape, a_vals.shape))
    if not (b_rows.dim() == 1 and b_rows.shape == b_cols.shape == b_vals.shape):
        raise ValueError((b_rows.shape, b_cols.shape, b_vals.shape))
    if any(t.dtype != torch.int32 for t in (a_rows, a_cols, b_rows, b_cols)):
        raise TypeError("paired SpGEMM indices must be int32")
    if a_vals.dtype != torch.float32 or b_vals.dtype != torch.float32:
        raise TypeError("paired SpGEMM values must be float32")


def spgemm_paired_ref(
    a_rows: Tensor, a_cols: Tensor, a_vals: Tensor,
    b_rows: Tensor, b_cols: Tensor, b_vals: Tensor, m: int, n: int,
) -> Tensor:
    """Plain PyTorch version: dense f32 C (m, n) = Σ over pairs with
    a_col == b_row of a_val · b_val at (a_row, b_col)."""
    _check(a_rows, a_cols, a_vals, b_rows, b_cols, b_vals)
    # out-of-range rows and columns land in an extra row and column
    r = torch.where((a_rows >= 0) & (a_rows < m), a_rows, m).long()
    c = torch.where((b_cols >= 0) & (b_cols < n), b_cols, n).long()
    out = torch.zeros((m + 1) * (n + 1), dtype=torch.float32, device=a_rows.device)
    step = max(1, MATCH_CHUNK_ELEMS // max(b_rows.shape[0], 1))
    for s in range(0, a_rows.shape[0], step):
        ia, ib = torch.nonzero(a_cols[s:s + step, None] == b_rows[None, :], as_tuple=True)
        ia = ia + s
        out.index_add_(0, r[ia] * (n + 1) + c[ib], a_vals[ia] * b_vals[ib])
    return out.reshape(m + 1, n + 1)[:m, :n]


def spgemm_paired_cuda(
    a_rows: Tensor, a_cols: Tensor, a_vals: Tensor,
    b_rows: Tensor, b_cols: Tensor, b_vals: Tensor, m: int, n: int,
) -> Tensor:
    """Launch the Hopper kernels on the current stream into a zeroed C: B
    bucketed by contraction index (``nb`` buckets, the power of two >=
    capB), then one pass over A."""
    _check(a_rows, a_cols, a_vals, b_rows, b_cols, b_vals)
    tensors = (a_rows, a_cols, a_vals, b_rows, b_cols, b_vals)
    dev = a_rows.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("spgemm_paired_cuda needs all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("spgemm_paired_cuda needs contiguous tensors")
    cap_a, cap_b = a_rows.shape[0], b_rows.shape[0]
    if max(cap_a, cap_b, m, n) >= 2**31:
        raise ValueError(f"spgemm_paired_cuda takes sizes below 2^31: "
                         f"caps {cap_a}, {cap_b}, C ({m}, {n})")
    out = torch.zeros((m, n), dtype=torch.float32, device=dev)
    if cap_a == 0 or cap_b == 0 or m == 0 or n == 0:
        return out
    nb = min(1 << (cap_b - 1).bit_length(), MAX_BUCKETS)
    counts = torch.zeros(nb, dtype=torch.int32, device=dev)
    offsets = torch.empty(nb, dtype=torch.int32, device=dev)
    block_base = torch.empty(-(-nb // SCAN_SPAN), dtype=torch.int32, device=dev)
    rank = torch.empty(cap_b, dtype=torch.int32, device=dev)
    records = torch.empty((cap_b, 4), dtype=torch.int32, device=dev)  # (row, col, val bits, 0)
    fn = _build.entry("spgemm_acc", "spgemm_paired_launch", _LAUNCH_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(a_rows.data_ptr(), a_cols.data_ptr(), a_vals.data_ptr(), cap_a,
                 b_rows.data_ptr(), b_cols.data_ptr(), b_vals.data_ptr(), cap_b, m, n,
                 out.data_ptr(), nb, counts.data_ptr(), offsets.data_ptr(), block_base.data_ptr(),
                 rank.data_ptr(), records.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "spgemm_paired_cuda")
    spgemm_paired_cuda.launches += 1
    return out


spgemm_paired_cuda.launches = 0


def spgemm_paired(
    a_rows: Tensor, a_cols: Tensor, a_vals: Tensor,
    b_rows: Tensor, b_cols: Tensor, b_vals: Tensor, m: int, n: int,
) -> Tensor:
    """Dense C (m×n, f32) from two padded COO entry lists, in any order: the
    Hopper kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = spgemm_paired_cuda if a_rows.is_cuda else spgemm_paired_ref
    return fn(a_rows, a_cols, a_vals, b_rows, b_cols, b_vals, m, n)
