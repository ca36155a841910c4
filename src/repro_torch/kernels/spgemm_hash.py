"""Hash-accumulator insert for SpGEMM — O(output) scratch.

Partial products are consumed on the fly instead of materialized: each
(packed row-major key, value) pair is inserted into an open-addressing
table and semiring-accumulated in place (Nagasaka et al.'s hash SpGEMM,
arXiv:1804.01698), so the resident structure is the table,
O(nnz(C) · load_factor).

One chunk of given keys (the TPU kernel's unit of work):

  * ``hash_insert_cuda`` — the Hopper kernel (``csrc/spgemm_hash.cu``), one
    thread per entry with an atomicCAS claim; replaces the TPU kernel
    ``repro/kernels/spgemm_hash.py::hash_insert_pallas``.
  * ``hash_insert_ref`` — the plain PyTorch version: the TPU kernel's
    vectorized probe rounds (round p: every unplaced entry probes slot
    (h0 + p) & (T - 1), an EMPTY slot is claimed by scatter-min of the key).
  * ``hash_insert`` — launches the kernel for CUDA tensors, runs the plain
    version for CPU tensors.

A whole batch's expansion (``Expansion``: A in CSC order, B's entries and
the inclusive prefix ``cum`` of products per B entry), enumerated in
``num_chunks`` chunks of ``chunk_cap`` slots as the reference's chunk loop
does:

  * ``hash_expand_insert_cuda`` — one launch of the Hopper kernel
    ``hash_expand_insert_kernel``, which forms every partial product itself
    (``expand_slots``' arithmetic) and inserts it: no expansion buffer, no
    per-chunk host work.
  * ``hash_expand_insert_ref`` — the plain version: the chunk loop of
    ``expand_slots`` and ``hash_insert_ref``.
  * ``hash_expand_insert`` — the kernel for CUDA tensors, the plain version
    for CPU tensors.

All insert in place: the table (``table_key``, ``table_val``) and the
``dropped`` counter are updated, nothing is returned. Keys are
``sortkeys.pack_rowmajor`` i32 keys; ``EMPTY`` is INT32_MAX, which sorts
after every real key and every sentinel, so table → sorted COO is one sort
plus ``compress_sorted_keys``. Slot positions may differ between the
versions (the kernels' threads claim in no fixed order), but an insert-only
linear-probing table holds the same slots and the same key → value set
whatever the order; entries that find no slot in ``max_probes`` probes are
dropped and counted (a key's displacement, and so a drop, can depend on the
order when the table is nearly full).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..core.semiring import REDUCE_OPS, Semiring, scatter_reduce_init
from ..core.sortkeys import INT32_MAX
from . import _build

Tensor = torch.Tensor

# Fibonacci multiplicative hashing: the golden-ratio constant scrambles the
# packed keys' low-entropy structure before the top-bits cut selects a slot.
_FIB = 2654435769

EMPTY = INT32_MAX

_ADD_KINDS = {"sum": 0, "min": 1, "max": 2}

#: the semiring products the fused kernel forms, by ``Semiring.mul_kind``
MUL_KINDS = {"times": 0, "min": 1, "plus": 2, "pair": 3}

# hash_insert_launch(table_key, table_val, keys, vals, valid, n, lg_table,
#                    max_probes, add_kind, dropped, stream)
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2

# hash_expand_insert_launch(table_key, table_val, a_rows, a_vals, colptr,
#     b_rows, b_cols, b_vals, cum, cap_a, cap_b, n, limit, mul_kind, lg_table,
#     max_probes, add_kind, dropped, stream)
_EXPAND_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)


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
    with torch.cuda.device(dev):
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


# ---------------------------------------------------------------------------
# a whole batch: the expansion enumerated and inserted in one launch
# ---------------------------------------------------------------------------
class Expansion(NamedTuple):
    """The partial products of A·B, enumerable slot by slot: slot e belongs
    to B entry t, the first with ``cum[t] > e``, and multiplies it with A's
    entry ``colptr[b_cols[t]] + e - (cum[t] - cnt[t])``."""

    a_rows: Tensor  # A in column-major (CSC) order
    a_vals: Tensor
    colptr: Tensor  # A's column starts, indexable by every contraction index of B
    b_rows: Tensor  # B's entries as (row = output column j, col = contraction k)
    b_cols: Tensor
    b_vals: Tensor
    cum: Tensor  # int32 inclusive prefix of products per B entry
    n: int  # output columns: keys are a_row * (n + 1) + b_row


def expand_slots(x: Expansion, e: Tensor, mul) -> Tuple[Tensor, Tensor, Tensor]:
    """(packed keys, values ``mul(a, b)``, valid) of expansion slots ``e``
    (int32); slots at or past the total are invalid."""
    cap_b = x.cum.numel()
    if cap_b == 0:
        zero = torch.zeros_like(e)
        return zero, zero.to(x.a_vals.dtype), zero.bool()
    t = torch.clamp(torch.searchsorted(x.cum, e, right=True), 0, cap_b - 1)
    start = torch.where(t > 0, x.cum[torch.clamp(t - 1, min=0)], torch.zeros_like(e))
    bk = torch.clamp(x.b_cols[t], 0, x.colptr.numel() - 1).long()
    ai = torch.clamp(x.colptr[bk] + (e - start), 0, x.a_rows.numel() - 1).long()
    vals = mul(x.a_vals[ai], x.b_vals[t])
    key = x.a_rows[ai] * (x.n + 1) + x.b_rows[t]  # sortkeys.pack_rowmajor
    return key, vals, e < x.cum[-1]


def hash_expand_insert_ref(
    table_key: Tensor, table_val: Tensor, dropped: Tensor, x: Expansion,
    chunk_cap: int, num_chunks: int, *, semiring: Semiring, max_probes: int,
) -> None:
    """Plain PyTorch version: ``num_chunks`` chunks of ``chunk_cap`` slots,
    each enumerated by ``expand_slots`` and inserted by ``hash_insert_ref``."""
    offs = torch.arange(chunk_cap, dtype=torch.int32, device=table_key.device)
    for c in range(num_chunks):
        key, vals, valid = expand_slots(x, c * chunk_cap + offs, semiring.mul)
        hash_insert_ref(table_key, table_val, key, vals, valid, dropped,
                        add_kind=semiring.add_kind, max_probes=max_probes)


def hash_expand_insert_cuda(
    table_key: Tensor, table_val: Tensor, dropped: Tensor, x: Expansion,
    chunk_cap: int, num_chunks: int, *, semiring: Semiring, max_probes: int,
) -> None:
    """One launch of the Hopper kernel over the batch's slots [0,
    min(total, num_chunks · chunk_cap)), on the current stream (in place,
    no sync: the total is read on the device)."""
    table_cap = table_key.shape[0]
    if table_cap < 8 or table_cap & (table_cap - 1):
        raise ValueError(f"table_cap must be a power of two >= 8, got {table_cap}")
    ints = (table_key, x.a_rows, x.colptr, x.b_rows, x.b_cols, x.cum, dropped)
    floats = (table_val, x.a_vals, x.b_vals)
    if any(t.dtype != torch.int32 for t in ints) or any(t.dtype != torch.float32 for t in floats):
        raise TypeError("hash_expand_insert_cuda takes int32 indices and float32 values")
    if table_val.shape != table_key.shape or dropped.numel() != 1:
        raise ValueError((table_key.shape, table_val.shape, dropped.shape))
    if not (x.a_rows.shape == x.a_vals.shape and
            x.b_rows.shape == x.b_cols.shape == x.b_vals.shape == x.cum.shape):
        raise ValueError("expansion operands of mismatched lengths")
    dev = table_key.device
    if dev.type != "cuda" or any(t.device != dev for t in ints + floats):
        raise ValueError("hash_expand_insert_cuda needs all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in ints + floats):
        raise ValueError("hash_expand_insert_cuda needs contiguous tensors")
    if x.a_rows.numel() == 0 or x.cum.numel() == 0 or num_chunks * chunk_cap == 0:
        return
    fn = _build.entry("spgemm_hash", "hash_expand_insert_launch", _EXPAND_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            table_key.data_ptr(), table_val.data_ptr(), x.a_rows.data_ptr(), x.a_vals.data_ptr(),
            x.colptr.data_ptr(), x.b_rows.data_ptr(), x.b_cols.data_ptr(), x.b_vals.data_ptr(),
            x.cum.data_ptr(), x.a_rows.numel(), x.cum.numel(), x.n, num_chunks * chunk_cap,
            MUL_KINDS[semiring.mul_kind], table_cap.bit_length() - 1, max_probes,
            _ADD_KINDS[semiring.add_kind], dropped.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "hash_expand_insert_cuda")
    hash_expand_insert_cuda.launches += 1


hash_expand_insert_cuda.launches = 0


def hash_expand_insert(
    table_key: Tensor, table_val: Tensor, dropped: Tensor, x: Expansion,
    chunk_cap: int, num_chunks: int, *, semiring: Semiring, max_probes: int,
) -> None:
    """Insert a batch's whole expansion under ``semiring``: one launch of
    the Hopper kernel for CUDA tensors, the plain chunk loop for CPU
    tensors."""
    fn = hash_expand_insert_cuda if table_key.is_cuda else hash_expand_insert_ref
    fn(table_key, table_val, dropped, x, chunk_cap, num_chunks, semiring=semiring,
       max_probes=max_probes)
