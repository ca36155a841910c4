"""Densify — scatter a padded COO entry list into a dense f32 tile.

The dense-accumulator multiply turns the narrow per-batch column block of
B (Alg. 4) into a dense tile once, then the SpMM streams A through it.
Duplicate coordinates are summed; entries whose row or column lies outside
the tile (the padding sentinels ``(m, n)``) are skipped.

  * ``densify_cuda`` — the Hopper kernel (``csrc/densify.cu``); replaces the
    TPU kernel ``repro/kernels/densify.py::densify_pallas``.
  * ``densify_ref`` — the plain PyTorch version: one ``index_add_``.
  * ``densify`` — the kernel for CUDA tensors, the plain version for CPU
    tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

Tensor = torch.Tensor

# densify_launch(rows, cols, vals, cap, m, n, out, stream)
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def _check(rows: Tensor, cols: Tensor, vals: Tensor) -> None:
    if not (rows.dim() == 1 and rows.shape == cols.shape == vals.shape):
        raise ValueError((rows.shape, cols.shape, vals.shape))
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("densify indices must be int32")


def densify_ref(rows: Tensor, cols: Tensor, vals: Tensor, m: int, n: int) -> Tensor:
    """Plain PyTorch version: dense (m, n) tile of ``vals.dtype``."""
    _check(rows, cols, vals)
    ok = (rows >= 0) & (rows < m) & (cols >= 0) & (cols < n)
    # out-of-tile entries land in one discard slot past the tile
    flat = torch.where(ok, rows.long() * n + cols.long(),
                       torch.full_like(rows, m * n, dtype=torch.long))
    out = torch.zeros((m * n + 1,), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, flat, vals)
    return out[: m * n].reshape(m, n)


def densify_cuda(rows: Tensor, cols: Tensor, vals: Tensor, m: int, n: int) -> Tensor:
    """Launch the Hopper kernel on the current stream into a zeroed tile."""
    _check(rows, cols, vals)
    tensors = (rows, cols, vals)
    dev = rows.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("densify_cuda needs all tensors on one CUDA device")
    if vals.dtype != torch.float32:
        raise TypeError(f"densify_cuda needs float32 values, got {vals.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("densify_cuda needs contiguous tensors")
    out = torch.zeros((m, n), dtype=torch.float32, device=dev)
    fn = _build.entry("densify", "densify_launch", _LAUNCH_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), rows.shape[0], m, n,
                 out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "densify_cuda")
    densify_cuda.launches += 1
    return out


densify_cuda.launches = 0


def densify(rows: Tensor, cols: Tensor, vals: Tensor, m: int, n: int) -> Tensor:
    """Dense (m, n) tile of a padded COO entry list, duplicates summed: the
    Hopper kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = densify_cuda if rows.is_cuda else densify_ref
    return fn(rows, cols, vals, m, n)
