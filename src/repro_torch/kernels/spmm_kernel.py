"""SpMM — padded-COO sparse A (m×k) times dense B (k×n) → dense f32 C.

The local multiply of the dense-accumulator SUMMA path: the per-batch
column block of B is densified once, then every entry (r, c, v) of A adds
``v · B[c, :]`` into row r of C. Entries whose row is the sentinel ``m``
or whose column is the sentinel ``k`` are skipped (padding). Values and B
are float32 or bfloat16; the sum is float32 and so is C, as the TPU
kernel's.

  * ``spmm_cuda`` — the Hopper kernel (``csrc/spmm.cu``); replaces the TPU
    kernel ``repro/kernels/spmm.py::spmm_pallas``. Around the kernel the
    wrapper orders A's entries by row with a stable sort and builds row
    pointers; the kernel stages the B stripes that a block of 64 rows uses
    more than once in shared memory, and writes every element of C once,
    in an order fixed by the inputs (no atomics).
  * ``spmm_ref`` — the plain PyTorch version: gather B's rows, scale, and
    ``index_add_`` into C's rows, in float32.
  * ``spmm`` — the kernel for CUDA tensors, the plain version for CPU
    tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

Tensor = torch.Tensor

# spmm_launch(rowptr, cols, vals, b, b_dtype, m, n, vec, out, stream)
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2

#: B's dtypes the kernel reads, by the code its entry point takes
_B_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(rows: Tensor, cols: Tensor, vals: Tensor, b: Tensor) -> None:
    if not (rows.dim() == 1 and rows.shape == cols.shape == vals.shape):
        raise ValueError((rows.shape, cols.shape, vals.shape))
    if b.dim() != 2:
        raise ValueError(f"B must be a dense (k, n) matrix, got {tuple(b.shape)}")
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("spmm indices must be int32")
    if vals.dtype not in _B_DTYPES or b.dtype not in _B_DTYPES:
        raise TypeError(f"spmm values must be float32 or bfloat16, got {vals.dtype}, {b.dtype}")


def _live(rows: Tensor, cols: Tensor, m: int, k: int) -> Tensor:
    return (rows >= 0) & (rows < m) & (cols >= 0) & (cols < k)


def spmm_ref(rows: Tensor, cols: Tensor, vals: Tensor, b: Tensor, m: int,
             chunk: int = 1 << 16) -> Tensor:
    """Plain PyTorch version: dense f32 C (m, n), summed in f32, A's entries
    taken ``chunk`` at a time so the (entries, n) products stay small."""
    _check(rows, cols, vals, b)
    k, n = b.shape
    live = _live(rows, cols, m, k)
    seg = torch.where(live, rows, torch.full_like(rows, m)).long()
    src = torch.where(live, cols, torch.zeros_like(cols)).long()
    v = torch.where(live, vals, torch.zeros_like(vals)).float()
    out = torch.zeros((m + 1, n), dtype=torch.float32, device=b.device)
    for e in range(0, rows.shape[0], chunk):
        out.index_add_(0, seg[e:e + chunk], v[e:e + chunk, None] * b[src[e:e + chunk]].float())
    return out[:m]


def spmm_cuda(rows: Tensor, cols: Tensor, vals: Tensor, b: Tensor, m: int) -> Tensor:
    """Order A's entries by row, build row pointers, and launch the Hopper
    kernel on the current stream."""
    _check(rows, cols, vals, b)
    dev = b.device
    if dev.type != "cuda" or any(t.device != dev for t in (rows, cols, vals)):
        raise ValueError("spmm_cuda needs all tensors on one CUDA device")
    if not b.is_contiguous():
        raise ValueError("spmm_cuda needs a contiguous B")
    k, n = b.shape
    seg = torch.where(_live(rows, cols, m, k), rows, torch.full_like(rows, m))
    seg_sorted, perm = torch.sort(seg, stable=True)
    cols_s = cols[perm].contiguous()
    vals_s = vals[perm].float().contiguous()
    rowptr = torch.searchsorted(
        seg_sorted, torch.arange(m + 1, dtype=torch.int32, device=dev), out_int32=True
    )
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    # 4-column vector accesses need B's rows 16-byte (f32) or 8-byte (bf16) aligned
    vec = n % 4 == 0 and b.data_ptr() % (4 * b.element_size()) == 0
    fn = _build.entry("spmm", "spmm_launch", _LAUNCH_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(rowptr.data_ptr(), cols_s.data_ptr(), vals_s.data_ptr(), b.data_ptr(),
                 _B_DTYPES[b.dtype], m, n, int(vec), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "spmm_cuda")
    spmm_cuda.launches += 1
    return out


spmm_cuda.launches = 0


def spmm(rows: Tensor, cols: Tensor, vals: Tensor, b: Tensor, m: int) -> Tensor:
    """C (m×n, f32) = A·B for A's padded COO (rows, cols, vals) and dense B
    (float32 or bfloat16): the Hopper kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = spmm_cuda if b.is_cuda else spmm_ref
    return fn(rows, cols, vals, b, m)
