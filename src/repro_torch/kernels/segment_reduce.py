"""Order-fixed segmented reduction of sorted runs — the deterministic sum of
the packed-key engine (``core.sortkeys``) and of the MCL prune's column sums.

``out[s]`` reduces ``vals[offsets[s]:offsets[s + 1]]`` by sum, min or max;
an empty run holds the reduction's identity (0, +inf, -inf), and entries
outside ``[offsets[0], offsets[-1])`` are never read. The reference reduces
with ``jax.ops.segment_sum`` (``repro/core/sortkeys.py``), which has no TPU
kernel behind it; on the card a ``scatter_reduce_`` of atomics would add in
an order that changes from run to run.

  * ``segment_reduce_cuda`` — the Hopper kernel (``csrc/segment_reduce.cu``):
    one thread per run of at most 32 entries, summed serially in entry
    order (so such sums have the plain version's bits on the CPU); longer
    runs go to a warp (lane-strided partials, a fixed butterfly), and runs
    of more than 4096 entries to a whole block (a fixed tree);
    ``path_limits`` asks the built kernel for the two lengths. The path
    depends on a run's length alone, so the same inputs give the same bits
    on every run. float32 values.
  * ``segment_reduce_ref`` — the plain PyTorch version: each entry's run by
    binary search in ``offsets``, then one ``scatter_reduce_`` (serial, so
    deterministic, on the CPU), in the values' own dtype.
  * ``segment_reduce`` — the kernel for CUDA tensors, the plain version for
    CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.semiring import REDUCE_OPS, scatter_reduce_init
from . import _build

Tensor = torch.Tensor

_ADD_KINDS = {"sum": 0, "min": 1, "max": 2}

# segment_reduce_launch(vals, offsets, num_segments, add_kind, out, stream)
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2


def _check(vals: Tensor, offsets: Tensor, add_kind: str) -> None:
    if add_kind not in _ADD_KINDS:
        raise ValueError(f"unknown add_kind {add_kind}")
    if vals.dim() != 1 or offsets.dim() != 1 or offsets.numel() < 1:
        raise ValueError((tuple(vals.shape), tuple(offsets.shape)))
    if offsets.dtype != torch.int32:
        raise TypeError("segment offsets must be int32")


def segment_reduce_ref(vals: Tensor, offsets: Tensor, add_kind: str) -> Tensor:
    """Plain PyTorch version, in ``vals.dtype``."""
    _check(vals, offsets, add_kind)
    num = offsets.numel() - 1
    pos = torch.arange(vals.numel(), dtype=torch.int32, device=vals.device)
    seg = torch.searchsorted(offsets, pos, right=True).long() - 1
    # entries before the first run or past the last go to a discard slot
    seg = torch.where((seg >= 0) & (seg < num), seg, torch.full_like(seg, num))
    out = torch.full((num + 1,), scatter_reduce_init(add_kind), dtype=vals.dtype,
                     device=vals.device)
    out.scatter_reduce_(0, seg, vals, reduce=REDUCE_OPS[add_kind], include_self=True)
    return out[:num]


def segment_reduce_cuda(vals: Tensor, offsets: Tensor, add_kind: str) -> Tensor:
    """Launch the Hopper kernel on the current stream; float32 out."""
    _check(vals, offsets, add_kind)
    dev = vals.device
    if dev.type != "cuda" or offsets.device != dev:
        raise ValueError("segment_reduce_cuda needs all tensors on one CUDA device")
    if vals.dtype != torch.float32:
        raise TypeError(f"segment_reduce_cuda needs float32 values, got {vals.dtype}")
    if not (vals.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("segment_reduce_cuda needs contiguous tensors")
    num = offsets.numel() - 1
    out = torch.empty((num,), dtype=torch.float32, device=dev)
    fn = _build.entry("segment_reduce", "segment_reduce_launch", _LAUNCH_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(vals.data_ptr(), offsets.data_ptr(), num, _ADD_KINDS[add_kind], out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "segment_reduce_cuda")
    segment_reduce_cuda.launches += 1
    return out


segment_reduce_cuda.launches = 0


def path_limits() -> Tuple[int, int]:
    """The card kernel's longest run for one thread and for one warp
    (longer runs take a block), from the built library."""
    return (_build.entry("segment_reduce", "segment_reduce_thread_run", [])(),
            _build.entry("segment_reduce", "segment_reduce_warp_run", [])())


def segment_reduce(vals: Tensor, offsets: Tensor, add_kind: str) -> Tensor:
    """Reduce each run ``vals[offsets[s]:offsets[s + 1]]``: the Hopper kernel
    for CUDA tensors (other float dtypes reduced in float32 and cast back),
    the plain version for CPU tensors."""
    if not vals.is_cuda:
        return segment_reduce_ref(vals, offsets, add_kind)
    return segment_reduce_cuda(vals.float(), offsets, add_kind).to(vals.dtype)
