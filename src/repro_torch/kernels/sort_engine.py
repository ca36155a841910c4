"""Bitonic sort of (key, value) pairs — the packed-key engine's single-key
sort primitive for arrays of up to 2^14 pairs.

A bitonic network runs log²(N)/2 compare-exchange stages over a power-of-two
length N; stage (kk, jj) pairs element i with i ^ jj and orders the pair
ascending when bit kk of i is 0, descending otherwise. The network has no
data-dependent control flow and no atomics, so the kernel, the plain version
and the JAX package's network give bit-identical keys and values.

  * ``bitonic_sort_pairs_cuda`` — the Hopper kernel (``csrc/sort_engine.cu``:
    one thread block cluster, pairs held in registers); replaces the TPU kernel
    ``repro/kernels/sort_engine.py::bitonic_sort_pairs_pallas``.
  * ``bitonic_sort_pairs_ref`` — the plain PyTorch version: the same stages
    as a reshape to (N/2jj, 2, jj) and ``torch.where``.
  * ``bitonic_sort_pairs`` — the kernel for CUDA tensors, the plain version
    for CPU tensors.
  * ``sort_pairs`` — any length: pads to the next power of two with the key
    dtype's max (sentinels sort last) and zero values, and slices back.
    Above ``MAX_BITONIC_ELEMS`` it returns ``torch.sort`` plus the gathered
    values, as the JAX package routes such sizes to ``lax.sort``.

Contract: keys ascending, values carried along. The network is NOT stable:
equal keys may permute their values (the tie rule is fixed, so the
permutation is the same in all three versions). Keys are int32; values are
any 32-bit payload (float32 or int32), moved as raw bits.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

Tensor = torch.Tensor

#: Largest pair count the network sorts (the JAX package's limit): on the card
#: a cluster of 8 blocks of 2048 pairs.
MAX_BITONIC_ELEMS = 1 << 14

# bitonic_sort_pairs_launch(keys, vals, n, keys_out, vals_out, stream)
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3


def _check(keys: Tensor, vals: Tensor) -> None:
    if keys.dim() != 1 or keys.shape != vals.shape:
        raise ValueError(f"keys and vals must be equal-length vectors: "
                         f"{tuple(keys.shape)}, {tuple(vals.shape)}")
    n = keys.shape[0]
    if n & (n - 1):
        raise ValueError(f"length {n} is not a power of two")
    if keys.dtype != torch.int32:
        raise TypeError(f"bitonic sort keys must be int32, got {keys.dtype}")
    if vals.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"bitonic sort values must be a 32-bit payload, got {vals.dtype}")


def _stages(n: int):
    """The network's (kk, jj) stages in order."""
    kk = 2
    while kk <= n:
        jj = kk // 2
        while jj >= 1:
            yield kk, jj
            jj //= 2
        kk *= 2


def bitonic_sort_pairs_ref(keys: Tensor, vals: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version: the network's stages as reshapes and selects."""
    _check(keys, vals)
    n = keys.shape[0]
    for kk, jj in _stages(n):
        k3 = keys.reshape(-1, 2, jj)
        v3 = vals.reshape(-1, 2, jj)
        # the pair's low index is r * 2jj + c with c < jj, so bit kk of it
        # is bit kk of r * 2jj: one direction per row
        r = torch.arange(k3.shape[0], device=keys.device)[:, None]
        asc = ((r * (2 * jj)) & kk) == 0
        a_k, b_k = k3[:, 0], k3[:, 1]
        in_order = a_k <= b_k
        swap = torch.where(asc, ~in_order, in_order)
        keys = torch.stack([torch.where(swap, b_k, a_k), torch.where(swap, a_k, b_k)], 1)
        a_v, b_v = v3[:, 0], v3[:, 1]
        vals = torch.stack([torch.where(swap, b_v, a_v), torch.where(swap, a_v, b_v)], 1)
        keys, vals = keys.reshape(n), vals.reshape(n)
    return keys, vals


def bitonic_sort_pairs_cuda(keys: Tensor, vals: Tensor) -> Tuple[Tensor, Tensor]:
    """Launch the Hopper kernel on the current stream: one cluster of
    n / 2048 blocks (one block below 2048 pairs). Raises if the card
    refuses the launch."""
    _check(keys, vals)
    dev = keys.device
    if dev.type != "cuda" or vals.device != dev:
        raise ValueError("bitonic_sort_pairs_cuda needs both tensors on one CUDA device")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("bitonic_sort_pairs_cuda needs contiguous tensors")
    n = keys.shape[0]
    if n > MAX_BITONIC_ELEMS:
        raise ValueError(f"length {n} exceeds the network's {MAX_BITONIC_ELEMS}")
    keys_out = torch.empty_like(keys)
    vals_out = torch.empty_like(vals)
    if n == 0:
        return keys_out, vals_out
    fn = _build.entry("sort_engine", "bitonic_sort_pairs_launch", _LAUNCH_ARGTYPES)
    err = fn(keys.data_ptr(), vals.data_ptr(), n, keys_out.data_ptr(), vals_out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "bitonic_sort_pairs_cuda")
    bitonic_sort_pairs_cuda.launches += 1
    return keys_out, vals_out


bitonic_sort_pairs_cuda.launches = 0


def bitonic_sort_pairs(keys: Tensor, vals: Tensor) -> Tuple[Tensor, Tensor]:
    """Sort int32 ``keys`` ascending carrying 32-bit ``vals`` (length a power
    of two): the Hopper kernel for CUDA tensors, the plain version for CPU
    tensors."""
    fn = bitonic_sort_pairs_cuda if keys.is_cuda else bitonic_sort_pairs_ref
    return fn(keys, vals)


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length() if x > 1 else 1


def sort_pairs(keys: Tensor, vals: Tensor) -> Tuple[Tensor, Tensor]:
    """Single-key sort of (keys, vals): the bitonic network up to
    ``MAX_BITONIC_ELEMS`` pairs, ``torch.sort`` above. Pads to the next power of
    two with the key dtype's max (sentinels sort last) and slices back.

    On the network's path keys must be strictly below the dtype's max when
    the length is not a power of two: a real max-valued key would tie with
    the padding, and the unstable network could then return a padding zero
    in place of its value. Packed (row, col) keys are below it by
    construction.
    """
    (length,) = keys.shape
    if length > MAX_BITONIC_ELEMS:
        skeys, perm = torch.sort(keys, stable=False)
        return skeys, vals[perm]
    padded = _next_pow2(length)
    if padded != length:
        fill = torch.iinfo(keys.dtype).max
        keys = torch.cat([keys, keys.new_full((padded - length,), fill)])
        vals = torch.cat([vals, vals.new_zeros((padded - length,))])
    skeys, svals = bitonic_sort_pairs(keys, vals)
    return skeys[:length], svals[:length]
