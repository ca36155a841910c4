"""Symbolic analysis: how many batches b does the multiply need? (Paper §IV-A)

Host-side numpy math over count vectors:

  * ``batch_count_lower_bound`` — Eq. (2): information-theoretic floor from
    mem(C) and aggregate memory M.
  * ``batch_count`` — Alg. 3 line 12: b from the *max per-process* unmerged
    nnz (robust to load imbalance; may exceed the lower bound).
  * ``SymbolicResult`` — the symbolic step's outcome as python ints, with
    the per-batch unmerged capacity it implies.
  * ``plan_k_bins`` — bin boundaries for the k-binned paired multiply.
  * ``host_symbolic_counts`` — the symbolic pass computed from host COO for
    any candidate grid shape (the device pass is ``batched.symbolic3d_counts``).

Every function here returns the same numbers as its namesake in the JAX
package on the same counts, which is what keeps the two planners' plans
identical field by field.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

#: bytes per nonzero: two i32 local indices + an f32 value (the paper's
#: r=24 counts i64 indices and an f64 value)
R_BYTES_DEFAULT = 12

# Open-addressing slot of the hash-accumulator multiply: i32 key + f32 value.
HASH_SLOT_BYTES = 8

# Default table occupancy target (slots per merged output entry). 1/1.75 ≈
# 0.57 occupancy keeps expected linear-probe chains short while the table
# stays within ~2 slots of footprint per survivor.
HASH_LOAD_FACTOR = 1.75


@dataclasses.dataclass(frozen=True)
class SymbolicCounts:
    """Host-side output of the symbolic pass (all numpy).

    Only count *vectors* travel (§IV-A, Fig. 8); the same payload carries
    what the numeric pass needs to size selection buffers and the k-bin plan.
    """

    percol: np.ndarray  # (pr, pc, l, tn_b) flops per local output column
    b_colcounts: np.ndarray  # (pr, pc, l, tn_b) B entries per local column
    a_kcounts: np.ndarray  # (pr, l, k_tot) per-k counts of gathered A
    b_kcounts: np.ndarray  # (pc, l, k_tot) per-k counts of gathered B
    mask_colcounts: Optional[np.ndarray] = None  # (pr, pc, l, wl) mask entries per tile column


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_triplets(a):
    """(rows, cols) of the live entries of a COO with ``rows``/``cols``/``nnz``."""
    nnz = int(a.nnz)
    return (
        _host(a.rows[:nnz]).astype(np.int64),
        _host(a.cols[:nnz]).astype(np.int64),
    )


def _count(shape, *idx) -> np.ndarray:
    """An int64 array of ``shape`` counting the index tuples ``idx`` (what
    ``np.add.at(zeros, idx, 1)`` makes), as one ``bincount``."""
    size = int(np.prod(shape))
    flat = np.ravel_multi_index(idx, shape) if len(idx[0]) else np.zeros(0, np.int64)
    return np.bincount(flat, minlength=size).astype(np.int64).reshape(shape)


def host_tile_counts(a, grid_shape, kind: str) -> np.ndarray:
    """Per-tile nnz of ``a`` laid out as ``kind`` on a candidate grid shape
    — pure host math. Returns (pr, pc, l)."""
    pr, pc, l = grid_shape
    m, n = a.shape
    rows, cols = _host_triplets(a)
    if kind in ("A", "C"):
        assert m % pr == 0 and n % (pc * l) == 0, (a.shape, grid_shape)
        w, wl = n // pc, n // pc // l
        ti = rows // (m // pr)
        tj = cols // w
        tk = (cols % w) // wl
    else:
        assert m % (pr * l) == 0 and n % pc == 0, (a.shape, grid_shape)
        w, wl = m // pr, m // pr // l
        ti = rows // w
        tk = (rows % w) // wl
        tj = cols // (n // pc)
    tile_id = (ti * pc + tj) * l + tk
    return np.bincount(tile_id, minlength=pr * pc * l).reshape(pr, pc, l)


def host_symbolic_counts(a, b, grid_shape, mask=None) -> SymbolicCounts:
    """The symbolic pass as a host oracle: exact per-column flops / count
    vectors for ``a``·``b`` distributed on a candidate ``grid_shape``,
    without scattering anything or touching a device; with ``mask`` (the
    product's shape, laid out as C) also its per-tile column counts. Layer
    grids must be square (pr == pc) or single-layer (l == 1)."""
    pr, pc, l = grid_shape
    assert pr == pc or l == 1, \
        f"square layer grids or l == 1 only, got {grid_shape}"
    m_a, k_dim = a.shape
    k_dim_b, n_b = b.shape
    assert k_dim == k_dim_b, (a.shape, b.shape)
    w_a, wl_a = k_dim // pc, k_dim // pc // l
    assert m_a % pr == 0 and k_dim % (pc * l) == 0, (a.shape, grid_shape)
    assert k_dim % (pr * l) == 0 and n_b % pc == 0, (b.shape, grid_shape)
    tn_b = n_b // pc
    k_tot = pc * wl_a

    # A: per-(row block, layer, stage coordinate) column counts
    ar, ac = _host_triplets(a)
    a_i = ar // (m_a // pr)
    a_k = (ac % w_a) // wl_a
    a_q = (ac // w_a) * wl_a + (ac % wl_a)
    acc = _count((pr, l, k_tot), a_i, a_k, a_q)

    # B: tile coordinates + stage coordinate k_idx = s*wl + local row
    br, bc = _host_triplets(b)
    w_b, wl_b = k_dim // pr, k_dim // pr // l
    b_s = br // w_b
    b_k = (br % w_b) // wl_b
    b_lr = br % wl_b
    b_j = bc // tn_b
    b_lc = bc % tn_b
    b_q = b_s * wl_b + b_lr

    bcc = _count((pr, pc, l, tn_b), b_s, b_j, b_k, b_lc)
    bkc = _count((pc, l, k_tot), b_j, b_k, b_q)

    # percol[i, j, k, c] = Σ over B entries of (grid col j, layer k, local
    # col c): A's stage-k_idx count in row block i
    key = (b_j * l + b_k) * tn_b + b_lc
    percol = np.zeros((pr, pc * l * tn_b), np.int64)
    for i in range(pr):
        percol[i] = np.round(np.bincount(
            key, weights=acc[i, b_k, b_q], minlength=pc * l * tn_b
        )).astype(np.int64)
    percol = percol.reshape(pr, pc, l, tn_b)

    mcc = None
    if mask is not None:
        assert mask.shape == (m_a, n_b), (mask.shape, a.shape, b.shape)
        w_c, wl_c = n_b // pc, n_b // pc // l
        mr, mc = _host_triplets(mask)
        mcc = _count((pr, pc, l, wl_c), mr // (m_a // pr), mc // w_c, (mc % w_c) // wl_c,
                     mc % wl_c)
    return SymbolicCounts(
        percol=percol, b_colcounts=bcc, a_kcounts=acc, b_kcounts=bkc, mask_colcounts=mcc,
    )


@dataclasses.dataclass(frozen=True)
class SymbolicResult:
    """Host-side outcome of the symbolic step (all python ints)."""

    num_batches: int
    max_unmerged_nnz: int  # max over processes of unmerged output nnz (b=1)
    max_nnz_a: int
    max_nnz_b: int
    flops: int  # total multiply count (2*flops = FLOPs)
    lower_bound: int  # Eq. (2)

    def per_batch_capacity(self, slack: float = 1.25) -> int:
        """Static per-process unmerged capacity to allocate for one batch."""
        cap = int(math.ceil(self.max_unmerged_nnz / max(self.num_batches, 1) * slack))
        return max(cap, 8)


def batch_count_lower_bound(
    mem_c_bytes: int, total_memory: int, nnz_a: int, nnz_b: int, r: int = R_BYTES_DEFAULT
) -> int:
    """Paper Eq. (2): b >= ceil(mem(C) / (M - r(nnz(A)+nnz(B))))."""
    denom = total_memory - r * (nnz_a + nnz_b)
    if denom <= 0:
        raise MemoryError(
            f"inputs alone ({r * (nnz_a + nnz_b)}B) exceed aggregate memory "
            f"({total_memory}B) — paper precondition M > r(nnz(A)+nnz(B)) violated"
        )
    return max(1, math.ceil(mem_c_bytes / denom))


def batch_count(
    max_unmerged_nnz: int,
    max_nnz_a: int,
    max_nnz_b: int,
    per_process_memory: int,
    r: int = R_BYTES_DEFAULT,
) -> int:
    """Paper Alg. 3 line 12: b = ceil(r*maxnnzC / (M/p - r(maxnnzA+maxnnzB))).

    Uses per-process *maxima* so no process exhausts memory under load
    imbalance (§IV-A).
    """
    denom = per_process_memory - r * (max_nnz_a + max_nnz_b)
    if denom <= 0:
        raise MemoryError(
            f"per-process inputs ({r * (max_nnz_a + max_nnz_b)}B) exceed "
            f"per-process memory ({per_process_memory}B)"
        )
    return max(1, math.ceil(r * max_unmerged_nnz / denom))


def batching_plan_columns(n: int, num_batches: int, num_layers: int) -> int:
    """Round b up so the block-cyclic split divides the column dimension:
    each batch is l blocks of width n/(b*l), so (b*l) | n."""
    b = num_batches
    b_max = n // num_layers  # finest split: one block-cyclic block per batch
    if b > b_max:
        raise MemoryError(
            f"need {num_batches} batches but only {b_max} column batches exist "
            f"({n} cols / {num_layers} layers) — aggregate memory insufficient "
            f"even at the finest batching granularity (paper precondition)"
        )
    while n % (b * num_layers) != 0:
        b += 1
        if b > b_max:
            raise MemoryError(
                f"cannot split {n} columns into >= {num_batches} batches with "
                f"{num_layers} layers"
            )
    return b


def fold_block_cyclic(
    percol: np.ndarray, num_batches: int, num_layers: int
) -> np.ndarray:
    """Fold per-local-column vectors (..., n) into per-(batch, piece) sums.

    Block t of width w = n/(b·l) belongs to batch ``t % b`` and fiber piece
    ``t // b``. Returns shape (..., num_batches, num_layers).
    """
    *lead, n = percol.shape
    w = n // (num_batches * num_layers)
    assert w * num_batches * num_layers == n, (n, num_batches, num_layers)
    blocks = percol.reshape(*lead, num_layers, num_batches, w).sum(axis=-1)
    return np.swapaxes(blocks, -1, -2)  # (..., batch, piece)


@dataclasses.dataclass(frozen=True)
class KBinPlan:
    """Host-side plan for the k-binned paired kernel (all python ints)."""

    num_bins: int
    bin_cap_a: int
    bin_cap_b: int
    pairings: int  # num_bins * bin_cap_a * bin_cap_b
    pairings_unbinned: int  # cap_a * cap_b
    bin_of_k: np.ndarray  # monotone i32[k_dim] map k -> bin


def plan_k_bins(
    a_col_counts: np.ndarray,
    b_row_counts: np.ndarray,
    cap_a: int,
    cap_b: int,
    candidates=(1, 2, 4, 8, 16, 32, 64),
    slack: float = 1.0,
) -> KBinPlan:
    """Pick bin boundaries + count minimizing Σ_g capA_g × capB_g (host math).

    For each candidate G two boundary families are scored and the cheaper
    wins: equal-width k-ranges and quantile-balanced ranges that cut the
    combined count mass (a+b) into equal slices. Capacities are maxima over
    bins of the exact counts, so ``slack=1.0`` cannot overflow.
    """
    a_cnt = np.asarray(a_col_counts, dtype=np.int64)
    b_cnt = np.asarray(b_row_counts, dtype=np.int64)
    k_dim = a_cnt.shape[0]
    assert b_cnt.shape[0] == k_dim, (a_cnt.shape, b_cnt.shape)

    # every candidate map is monotone in k, so a bin's count is a
    # difference of prefix sums between its first and its last k
    pre_a = np.concatenate([[0], np.cumsum(a_cnt)])
    pre_b = np.concatenate([[0], np.cumsum(b_cnt)])

    def score(bin_of_k, g):
        edges = np.searchsorted(bin_of_k, np.arange(g + 1))
        binned_a = pre_a[edges[1:]] - pre_a[edges[:-1]]
        binned_b = pre_b[edges[1:]] - pre_b[edges[:-1]]
        ca = rup8(max(int(int(binned_a.max()) * slack), 8))
        cb = rup8(max(int(int(binned_b.max()) * slack), 8))
        return g * ca * cb, ca, cb

    weight = a_cnt + b_cnt
    cumw = np.cumsum(weight)
    total = max(int(cumw[-1]), 1)
    best = None
    for g in candidates:
        if g > k_dim:
            break
        equal = (np.arange(k_dim, dtype=np.int64) * g) // k_dim
        balanced = np.minimum((cumw - weight) * g // total, g - 1)
        for bin_of_k in (equal, balanced):
            cost, ca, cb = score(bin_of_k, g)
            if best is None or cost < best[0]:
                best = (cost, g, ca, cb, bin_of_k.astype(np.int32))
    cost, g, ca, cb, bin_of_k = best
    return KBinPlan(
        num_bins=g,
        bin_cap_a=ca,
        bin_cap_b=cb,
        pairings=cost,
        pairings_unbinned=cap_a * cap_b,
        bin_of_k=bin_of_k,
    )


def rup8(x: int) -> int:
    """Round up to a multiple of 8 (static-capacity alignment)."""
    return ((x + 7) // 8) * 8


def rup_pow2(x: int) -> int:
    """Round up to the next power of two (capacity quantization that keeps
    iterated multiplies on one capacity plan as nnz drifts)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def estimate_mem_c_bytes(
    flops: int, compression_factor: float, r: int,
    local_path: str = "esc", load_factor: float = None,
) -> int:
    """mem(C) of one multiply's resident intermediate.

    ESC path: r · flops/cf. Hash path: the open-addressing table over the
    merged output, slot_bytes · load_factor · (flops/cf).
    """
    nnz = flops / max(compression_factor, 1.0)
    if local_path == "hash":
        lf = HASH_LOAD_FACTOR if load_factor is None else load_factor
        return int(math.ceil(nnz * lf * HASH_SLOT_BYTES))
    return int(r * nnz)
