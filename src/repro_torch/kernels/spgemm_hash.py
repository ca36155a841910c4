"""Hash-accumulator insert for SpGEMM — O(output) scratch.

Partial products are consumed on the fly instead of materialized: each
(packed row-major key, value) pair of a chunk is inserted into an
open-addressing table and semiring-accumulated in place (Nagasaka et al.'s
hash SpGEMM, arXiv:1804.01698), so the resident structure is the table,
O(nnz(C) · load_factor), plus one reused chunk buffer.

  * ``hash_insert_cuda`` — the Hopper kernel (``csrc/spgemm_hash.cu``), one
    thread per entry with an atomicCAS claim; replaces the TPU kernel
    ``repro/kernels/spgemm_hash.py::hash_insert_pallas``.
  * ``hash_insert_ref`` — the plain PyTorch version: the TPU kernel's
    vectorized probe rounds (round p: every unplaced entry probes slot
    (h0 + p) & (T - 1), an EMPTY slot is claimed by scatter-min of the key).
  * ``hash_insert`` — launches the kernel for CUDA tensors, runs the plain
    version for CPU tensors.

Both insert in place: the table (``table_key``, ``table_val``) and the
``dropped`` counter are updated, nothing is returned. Keys are
``sortkeys.pack_rowmajor`` i32 keys; ``EMPTY`` is INT32_MAX, which sorts
after every real key and every sentinel, so table → sorted COO is one sort
plus ``compress_sorted_keys``. Slot positions may differ between the two
versions (the kernel's threads claim in no fixed order), but an insert-only
linear-probing table holds the same slots and the same key → value set
whatever the order; entries that find no slot in ``max_probes`` probes are
dropped and counted.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.semiring import REDUCE_OPS, scatter_reduce_init
from ..core.sortkeys import INT32_MAX
from . import _build

Tensor = torch.Tensor

# Fibonacci multiplicative hashing: the golden-ratio constant scrambles the
# packed keys' low-entropy structure before the top-bits cut selects a slot.
_FIB = 2654435769

EMPTY = INT32_MAX

_ADD_KINDS = {"sum": 0, "min": 1, "max": 2}

# hash_insert_launch(table_key, table_val, keys, vals, valid, n, lg_table,
#                    max_probes, add_kind, dropped, stream)
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2


def fib_hash(keys: Tensor, lg_table: int) -> Tensor:
    """Map i32 keys to [0, 2**lg_table) via Fibonacci hashing (top bits).

    PyTorch has no wrapping uint32 multiply, so the product is formed in
    int64 from two 16-bit halves of the multiplier and masked to 32 bits.
    """
    assert 1 <= lg_table <= 31, lg_table
    k = keys.long() & 0xFFFFFFFF
    lo = k * (_FIB & 0xFFFF)
    hi = ((k * (_FIB >> 16)) & 0xFFFF) << 16
    prod = (lo + hi) & 0xFFFFFFFF
    return (prod >> (32 - lg_table)).to(torch.int32)


#: identity of the additive reduce — what EMPTY slots carry until claimed
#: (``compress_sorted_keys`` discards them, so the identity never leaks)
table_init_val = scatter_reduce_init


def _check(table_key, table_val, keys, vals, valid, dropped, add_kind):
    if add_kind not in _ADD_KINDS:
        raise ValueError(f"unknown add_kind {add_kind}")
    table_cap = table_key.shape[0]
    if table_cap < 8 or table_cap & (table_cap - 1):
        raise ValueError(f"table_cap must be a power of two >= 8, got {table_cap}")
    if table_val.shape != table_key.shape:
        raise ValueError((table_key.shape, table_val.shape))
    if not (keys.shape == vals.shape == valid.shape and keys.dim() == 1):
        raise ValueError((keys.shape, vals.shape, valid.shape))
    if table_key.dtype != torch.int32 or keys.dtype != torch.int32:
        raise TypeError("table keys and chunk keys must be int32")
    if table_val.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError("table values and chunk values must be float32")
    if valid.dtype != torch.bool or dropped.dtype != torch.int32 or dropped.numel() != 1:
        raise TypeError("valid must be bool and dropped a one-element int32 tensor")


def hash_insert_ref(
    table_key: Tensor, table_val: Tensor, keys: Tensor, vals: Tensor,
    valid: Tensor, dropped: Tensor, *, add_kind: str, max_probes: int,
) -> None:
    """Plain PyTorch version: insert one chunk by vectorized probe rounds."""
    _check(table_key, table_val, keys, vals, valid, dropped, add_kind)
    table_cap = table_key.shape[0]
    lg = table_cap.bit_length() - 1
    h0 = fib_hash(keys, lg)
    dev = keys.device
    tk = torch.cat([table_key, torch.full((1,), EMPTY, dtype=torch.int32, device=dev)])
    placed = torch.zeros_like(valid)
    slot_of = torch.zeros_like(keys)
    for p in range(max_probes):
        live = valid & ~placed
        if not bool(live.any()):
            break
        slot = (h0 + p) & (table_cap - 1)
        cur = tk[slot.long()]
        match = live & (cur == keys)
        empty = live & (cur == EMPTY)
        # claim EMPTY slots by scatter-min of the key; index table_cap is the
        # discard slot, so occupied slots are untouched
        dest = torch.where(empty, slot, torch.full_like(slot, table_cap)).long()
        tk.scatter_reduce_(0, dest, torch.where(empty, keys, torch.full_like(keys, EMPTY)),
                           reduce="amin")
        tk[table_cap] = EMPTY
        won = empty & (tk[slot.long()] == keys)
        placed_now = match | won
        slot_of = torch.where(placed_now, slot, slot_of)
        placed = placed | placed_now
    seg = torch.where(placed, slot_of, torch.full_like(slot_of, table_cap)).long()
    ident = table_init_val(add_kind)
    contrib = torch.where(placed, vals, torch.full_like(vals, ident))
    tv = torch.cat([table_val, torch.full((1,), ident, dtype=table_val.dtype, device=dev)])
    tv.scatter_reduce_(0, seg, contrib, reduce=REDUCE_OPS[add_kind])
    table_key.copy_(tk[:table_cap])
    table_val.copy_(tv[:table_cap])
    dropped.add_((valid & ~placed).sum().to(torch.int32))


def hash_insert_cuda(
    table_key: Tensor, table_val: Tensor, keys: Tensor, vals: Tensor,
    valid: Tensor, dropped: Tensor, *, add_kind: str, max_probes: int,
) -> None:
    """Launch the Hopper kernel on the current stream (in place, no sync)."""
    _check(table_key, table_val, keys, vals, valid, dropped, add_kind)
    tensors = (table_key, table_val, keys, vals, valid, dropped)
    dev = table_key.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("hash_insert_cuda needs all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("hash_insert_cuda needs contiguous tensors")
    fn = _build.entry("spgemm_hash", "hash_insert_launch", _LAUNCH_ARGTYPES)
    lg = table_key.shape[0].bit_length() - 1
    err = fn(
        table_key.data_ptr(), table_val.data_ptr(), keys.data_ptr(),
        vals.data_ptr(), valid.data_ptr(), keys.shape[0], lg, max_probes,
        _ADD_KINDS[add_kind], dropped.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "hash_insert_cuda")
    hash_insert_cuda.launches += 1


hash_insert_cuda.launches = 0


def hash_insert(
    table_key: Tensor, table_val: Tensor, keys: Tensor, vals: Tensor,
    valid: Tensor, dropped: Tensor, *, add_kind: str, max_probes: int,
) -> None:
    """Insert one chunk: the Hopper kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = hash_insert_cuda if table_key.is_cuda else hash_insert_ref
    fn(table_key, table_val, keys, vals, valid, dropped,
       add_kind=add_kind, max_probes=max_probes)
