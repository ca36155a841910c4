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
  * ``SpmmFunction`` — ``spmm`` as a ``torch.autograd.Function`` in A's
    values and B (the MoE's dispatch and combine in training). For C = A·B
    with G = dL/dC: dB = Aᵀ·G is ``spmm`` on the swapped entries (rows ↔
    cols, m ↔ k), so on the card the backward launches the same kernel; an
    old sentinel row m becomes column k' = m, which ``_live`` drops, and an
    old sentinel column k becomes row m' = k, which the row sort drops.
    dvals[e] = ⟨G[row_e], B[col_e]⟩ for a live entry and 0 for padding is
    ``spmm_dvals``, plain PyTorch (the TPU package has no kernel for it
    either: JAX differentiates its jnp gather and segment sum).

Given ``out`` (an f32 (m, n) tile), each of them returns ``out`` with A·B
added to it in place (the kernel's accumulate mode): the Cannon ring's
stages sum into one tile that way, with no second tile for a stage.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

Tensor = torch.Tensor

# spmm_launch(rowptr, cols, vals, b, b_dtype, m, n, vec, accumulate, out, stream)
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2

#: B's dtypes the kernel reads, by the code its entry point takes
_B_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the plain version also sums in float64 (the gradient checks run in it)
_PLAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def _check(rows: Tensor, cols: Tensor, vals: Tensor, b: Tensor,
           dtypes=tuple(_B_DTYPES)) -> None:
    if not (rows.dim() == 1 and rows.shape == cols.shape == vals.shape):
        raise ValueError((rows.shape, cols.shape, vals.shape))
    if b.dim() != 2:
        raise ValueError(f"B must be a dense (k, n) matrix, got {tuple(b.shape)}")
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("spmm indices must be int32")
    if vals.dtype not in dtypes or b.dtype not in dtypes:
        raise TypeError(f"spmm values must be one of {dtypes}, got {vals.dtype}, {b.dtype}")


def _sum_dtype(x: Tensor, y: Tensor) -> torch.dtype:
    """float32, or float64 when an input is (plain version only)."""
    return torch.float64 if torch.float64 in (x.dtype, y.dtype) else torch.float32


def _live(rows: Tensor, cols: Tensor, m: int, k: int) -> Tensor:
    return (rows >= 0) & (rows < m) & (cols >= 0) & (cols < k)


def _check_out(out, m: int, n: int, dev) -> None:
    if out is not None and (out.shape != (m, n) or out.dtype != torch.float32
                            or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 ({m}, {n}) tile on {dev}")


def spmm_ref(rows: Tensor, cols: Tensor, vals: Tensor, b: Tensor, m: int,
             chunk: int = 1 << 16, out: Tensor = None) -> Tensor:
    """Plain PyTorch version: dense f32 C (m, n), summed in f32 (in f64
    when an input is f64), A's entries taken ``chunk`` at a time so the
    (entries, n) products stay small; with ``out``, that C is added to
    ``out``, which is returned."""
    _check(rows, cols, vals, b, _PLAIN_DTYPES)
    k, n = b.shape
    _check_out(out, m, n, b.device)
    if out is not None:
        return out.add_(spmm_ref(rows, cols, vals, b, m, chunk))
    acc = _sum_dtype(vals, b)
    live = _live(rows, cols, m, k)
    seg = torch.where(live, rows, torch.full_like(rows, m)).long()
    src = torch.where(live, cols, torch.zeros_like(cols)).long()
    v = torch.where(live, vals, torch.zeros_like(vals)).to(acc)
    out = torch.zeros((m + 1, n), dtype=acc, device=b.device)
    for e in range(0, rows.shape[0], chunk):
        out.index_add_(0, seg[e:e + chunk], v[e:e + chunk, None] * b[src[e:e + chunk]].to(acc))
    return out[:m]


def spmm_cuda(rows: Tensor, cols: Tensor, vals: Tensor, b: Tensor, m: int,
              out: Tensor = None) -> Tensor:
    """Order A's entries by row, build row pointers, and launch the Hopper
    kernel on the current stream (in its accumulate mode with ``out``)."""
    _check(rows, cols, vals, b)
    dev = b.device
    if dev.type != "cuda" or any(t.device != dev for t in (rows, cols, vals)):
        raise ValueError("spmm_cuda needs all tensors on one CUDA device")
    if not b.is_contiguous():
        raise ValueError("spmm_cuda needs a contiguous B")
    k, n = b.shape
    _check_out(out, m, n, dev)
    accumulate = out is not None
    seg = torch.where(_live(rows, cols, m, k), rows, torch.full_like(rows, m))
    seg_sorted, perm = torch.sort(seg, stable=True)
    cols_s = cols[perm].contiguous()
    vals_s = vals[perm].float().contiguous()
    rowptr = torch.searchsorted(
        seg_sorted, torch.arange(m + 1, dtype=torch.int32, device=dev), out_int32=True
    )
    if out is None:
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    # 4-column vector accesses need B's rows 16-byte (f32) or 8-byte (bf16) aligned
    vec = n % 4 == 0 and b.data_ptr() % (4 * b.element_size()) == 0
    fn = _build.entry("spmm", "spmm_launch", _LAUNCH_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(rowptr.data_ptr(), cols_s.data_ptr(), vals_s.data_ptr(), b.data_ptr(),
                 _B_DTYPES[b.dtype], m, n, int(vec), int(accumulate), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "spmm_cuda")
    spmm_cuda.launches += 1
    return out


spmm_cuda.launches = 0


def spmm(rows: Tensor, cols: Tensor, vals: Tensor, b: Tensor, m: int,
         out: Tensor = None) -> Tensor:
    """C (m×n, f32) = A·B for A's padded COO (rows, cols, vals) and dense B
    (float32 or bfloat16), or ``out`` += A·B: the Hopper kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if b.is_cuda:
        return spmm_cuda(rows, cols, vals, b, m, out=out)
    return spmm_ref(rows, cols, vals, b, m, out=out)


def spmm_dvals(rows: Tensor, cols: Tensor, g: Tensor, b: Tensor, m: int,
               chunk: int = 1 << 15) -> Tensor:
    """dL/dvals of C = A·B (A's padded COO, m rows) given G = dL/dC (m, n):
    ⟨G[row_e], B[col_e]⟩ for each live entry, 0 for padding, summed in f32
    (f64 when an input is). Plain PyTorch on any device, ``chunk`` entries
    at a time so the gathered (entries, n) rows stay small."""
    if rows.shape != cols.shape or b.dim() != 2 or g.shape != (m, b.shape[1]):
        raise ValueError(f"entries {tuple(rows.shape)}, {tuple(cols.shape)}; B "
                         f"{tuple(b.shape)}; G {tuple(g.shape)} for m = {m}")
    k = b.shape[0]
    acc = _sum_dtype(g, b)
    live = _live(rows, cols, m, k)
    r = torch.where(live, rows, torch.zeros_like(rows)).long()
    c = torch.where(live, cols, torch.zeros_like(cols)).long()
    out = torch.empty(rows.shape, dtype=acc, device=b.device)
    for e in range(0, rows.shape[0], chunk):
        out[e:e + chunk] = (g[r[e:e + chunk]].to(acc) * b[c[e:e + chunk]].to(acc)).sum(-1)
    return torch.where(live, out, torch.zeros_like(out))


class SpmmFunction(torch.autograd.Function):
    """``spmm(rows, cols, vals, b, m)`` with gradients for ``vals`` and
    ``b`` (the module docstring gives the backward). Computes only what
    ``needs_input_grad`` asks for, and saves only what that needs: the
    MoE's dispatch has constant values and needs dB alone, its combine
    both. On the card forward and dB launch the SpMM kernel; nothing falls
    back to the plain version there. The callers refuse a semiring other
    than plus_times and the accumulate mode when a gradient is needed
    (``core.local_spgemm.spmm``)."""

    @staticmethod
    def forward(ctx, rows: Tensor, cols: Tensor, vals: Tensor, b: Tensor, m: int) -> Tensor:
        need_vals, need_b = ctx.needs_input_grad[2], ctx.needs_input_grad[3]
        ctx.m, ctx.k = m, b.shape[0]
        ctx.vals_dtype, ctx.b_dtype = vals.dtype, b.dtype
        ctx.save_for_backward(rows, cols, vals if need_b else None, b if need_vals else None)
        return spmm(rows, cols, vals, b, m)

    @staticmethod
    def backward(ctx, g: Tensor):
        rows, cols, vals, b = ctx.saved_tensors
        dvals = db = None
        if ctx.needs_input_grad[3]:  # Aᵀ·G: the swapped entries, k rows
            db = spmm(cols, rows, vals, g.contiguous(), ctx.k).to(ctx.b_dtype)
        if ctx.needs_input_grad[2]:
            dvals = spmm_dvals(rows, cols, g, b, ctx.m).to(ctx.vals_dtype)
        return None, None, dvals, db, None
