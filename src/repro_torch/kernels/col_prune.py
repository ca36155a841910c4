"""Per-column threshold for top-k pruning (the MCL dense-path hot step).

HipMCL keeps the top-k entries of every column of each expansion batch
(paper §V-C). Instead of sorting columns, a per-column bisection on |value|
brackets the k-th largest: ``hi`` is the smallest tested threshold with
``#{|x| >= hi} <= k`` and ``lo`` the largest with ``#{|x| >= lo} > k``.
The caller keeps entries ``>= hi`` and fills the remaining slots from the
``[lo, hi)`` tie band by rank (``sparse_apps.mcl``).

  * ``col_topk_bounds_cuda`` — the Hopper kernel (``csrc/col_prune.cu``);
    replaces the TPU kernel
    ``repro/kernels/col_prune.py::col_topk_bounds_pallas``. One launch: a
    thread block cluster of 8 blocks per 32-column tile reads x 4 times
    (the maxima, then 8 steps a read: each |x| is binned among the 255
    midpoints those steps can test, and the steps are replayed from the
    histogram's exact counts); ``reads_of_x`` asks the built kernel.
  * ``col_topk_bounds_ref`` — the plain PyTorch version, the same
    ``THRESH_ITERS`` f32 steps on exact integer counts.
  * ``col_topk_bounds`` — the kernel for CUDA tensors, the plain version
    for CPU tensors; ``col_topk_threshold`` is its ``hi`` alone, and
    ``col_topk_threshold_ref`` the exact k-th largest |value| by sorting.

Every step is the same correctly rounded f32 operation in all three, so
the brackets are bit-identical.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

Tensor = torch.Tensor

THRESH_ITERS = 24  # bisection steps — resolves ~1e-7 of the value range

# col_topk_bounds_launch(x, m, n, k, out, stream)
_LAUNCH_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def _check(x: Tensor) -> None:
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"col_topk_bounds needs a non-empty (m, n) block, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"col_topk_bounds needs float32, got {x.dtype}")


def col_topk_bounds_ref(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version: the bracket ``(lo, hi)``, f32[n] each."""
    _check(x)
    ax = x.abs()
    hi = ax.amax(dim=0) + 1e-6
    lo = torch.zeros_like(hi)
    for _ in range(THRESH_ITERS):
        mid = 0.5 * (lo + hi)
        cnt = (ax >= mid[None, :]).sum(dim=0)
        take_hi = cnt > k
        lo = torch.where(take_hi, mid, lo)
        hi = torch.where(take_hi, hi, mid)
    return lo, hi


def col_topk_bounds_cuda(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Launch the Hopper kernel on the current stream."""
    _check(x)
    if not x.is_cuda:
        raise ValueError("col_topk_bounds_cuda needs a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError("col_topk_bounds_cuda needs a contiguous tensor")
    m, n = x.shape
    out = torch.empty((2, n), dtype=torch.float32, device=x.device)
    fn = _build.entry("col_prune", "col_topk_bounds_launch", _LAUNCH_ARGTYPES)
    err = fn(x.data_ptr(), m, n, int(k), out.data_ptr(),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "col_topk_bounds_cuda")
    col_topk_bounds_cuda.launches += 1
    return out[0], out[1]


col_topk_bounds_cuda.launches = 0


def reads_of_x() -> int:
    """How many times the card kernel reads x in a call, the maxima's
    read included: a constant of its design, from the built library."""
    return _build.entry("col_prune", "col_topk_bounds_reads_of_x", [])()


def col_topk_bounds(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Per-column bisection bracket ``(lo, hi)`` for top-k |value|
    selection of a dense f32 (m, n) block: the Hopper kernel for CUDA
    tensors, the plain version for CPU tensors."""
    fn = col_topk_bounds_cuda if x.is_cuda else col_topk_bounds_ref
    return fn(x, k)


def col_topk_threshold(x: Tensor, k: int) -> Tensor:
    """Per-column |value| threshold keeping at most k entries of a dense f32
    (m, n) block: the bracket's ``hi``."""
    return col_topk_bounds(x, k)[1]


def col_topk_threshold_ref(x: Tensor, k: int) -> Tensor:
    """Sorted oracle: the exact k-th largest |value| of each column (zeros
    when k > m)."""
    m, n = x.shape
    if k > m:
        return torch.zeros((n,), dtype=torch.float32, device=x.device)
    desc = torch.sort(x.float().abs(), dim=0, descending=True).values
    return desc[k - 1]
