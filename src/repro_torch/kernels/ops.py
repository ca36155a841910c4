"""Public wrappers around the kernels, taking the port's ``SparseCOO``, so
callers never handle raw entry lists (the JAX package's
``repro/kernels/ops.py``).

Each wrapper zeroes the values of slots past ``nnz`` (``valid_mask()``),
then calls its kernel module, which launches the Hopper kernel for CUDA
tensors and runs the plain PyTorch version for CPU tensors: the tensors'
device decides, there is no other switch.

  spmm                  sparse (m×k) × dense (k×n) → dense, B's dtype
  spgemm_paired         sparse × sparse → dense f32, sort-free pairing
  densify               padded COO → dense tile
  spgemm_paired_binned  sparse × sparse → (dense f32, overflow), k-binned
  sort_pairs            single-key sort carrying one 32-bit payload
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Tuple

import torch

from . import densify_kernel as densifykern
from . import sort_engine
from . import spgemm_acc
from . import spgemm_binned
from . import spmm_kernel as spmmkern

if TYPE_CHECKING:
    from ..core.sparse import SparseCOO

Tensor = torch.Tensor


def _live_vals(a: "SparseCOO") -> Tensor:
    return torch.where(a.valid_mask(), a.vals, torch.zeros_like(a.vals))


def spmm(a: "SparseCOO", b_dense: Tensor) -> Tensor:
    """Sparse (m×k) × dense (k×n) → dense (m×n), summed in f32 and returned
    in B's dtype (float32 or bfloat16), as the reference's ``ops.spmm``."""
    m, _ = a.shape
    return spmmkern.spmm(a.rows, a.cols, _live_vals(a), b_dense, m).to(b_dense.dtype)


def _inner(a: "SparseCOO", b: "SparseCOO") -> Tuple[int, int, int]:
    """(m, k, n) of the product A·B; raises if the inner sizes differ."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner sizes differ: A {a.shape}, B {b.shape}")
    return m, k, n


def spgemm_paired(a: "SparseCOO", b: "SparseCOO") -> Tensor:
    """Sparse (m×k) × sparse (k×n) → dense (m×n) f32 — the sort-free paired
    kernel."""
    m, _, n = _inner(a, b)
    return spgemm_acc.spgemm_paired(
        a.rows, a.cols, _live_vals(a), b.rows, b.cols, _live_vals(b), m, n
    )


def densify(a: "SparseCOO") -> Tensor:
    """Padded COO → dense (m×n), duplicates summed."""
    m, n = a.shape
    return densifykern.densify(a.rows, a.cols, _live_vals(a), m, n)


def spgemm_paired_binned(
    a: "SparseCOO", b: "SparseCOO", num_bins: int, bin_cap_a: int, bin_cap_b: int,
    bin_map: Tensor = None,
) -> Tuple[Tensor, Tensor]:
    """k-binned paired SpGEMM: bucket both operands by contraction range and
    pair only matching bins — O(Σ_g capA_g×capB_g) instead of O(capA×capB).

    The bin parameters (and the monotone ``bin_map`` for skewed contraction
    indices) come from ``core.symbolic.plan_k_bins``. Returns (C dense f32,
    overflow): overflow > 0 means a bin capacity was exceeded and entries
    were dropped (the caller re-plans with larger capacities).
    """
    m, k, n = _inner(a, b)
    return spgemm_binned.spgemm_binned_dense(
        a.rows, a.cols, _live_vals(a), a.valid_mask(),
        b.rows, b.cols, _live_vals(b), b.valid_mask(),
        m, n, k, num_bins, bin_cap_a, bin_cap_b, bin_map=bin_map,
    )


def sort_pairs(keys: Tensor, vals: Tensor) -> Tuple[Tensor, Tensor]:
    """Single-key sort carrying one payload — the packed-key engine's sort
    primitive: the bitonic network up to ``sort_engine.MAX_BITONIC_ELEMS``
    pairs, ``torch.sort`` above."""
    return sort_engine.sort_pairs(keys, vals)
