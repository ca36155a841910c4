"""Structure-aware placement: pluggable distributions + permutation passes.

  * ``Distribution`` — the tile→batch column distribution as a pluggable
    object. The planner (``batched.plan_from_symbolic``) folds every count
    vector through ``PlanSpec.distribution`` (None is the ``BLOCK_CYCLIC``
    singleton, the paper's Fig. 1(i) split and the only one the device step,
    ``SparseCOO.select_cols_blockcyclic``, runs; ``batched_summa3d`` refuses
    any other).
  * ``Placement`` — a (row, contraction, column) permutation computed from
    per-row/column counts of the operands: the degree spread or reverse
    Cuthill–McKee. Operands are permuted before planning, so every aligned
    block-cyclic block sees a uniform degree mixture and the
    capacity-padded transfers (the selection gather at ``sel_cap``, the
    fiber exchange at ``piece_cap``) shrink on skewed inputs; the output is
    mapped back through the inverse permutations, so the result is the
    unpermuted run's.

Degree SPREAD, not degree sort: sorting by degree packs the R-MAT hubs into
one aligned block. The heaviest indices are dealt onto bit-reversed
positions (power-of-two sizes) or golden-ratio positions, so consecutive
hubs land in different blocks of every (batch, layer) split.

The permutations are host numpy, computed from host copies of the
operands' triplets; they are the JAX package's, array for array.
``multiply_placed`` is the end-to-end entry: permute → scatter →
``batched_summa3d`` → invert, returning global host triplets.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from .sparse import from_numpy_coo
from .symbolic import batching_plan_columns, fold_block_cyclic


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_triplets(a):
    """(rows, cols, vals) of the live entries of a COO, on the host."""
    nnz = int(a.nnz)
    return (
        _host(a.rows[:nnz]).astype(np.int64),
        _host(a.cols[:nnz]).astype(np.int64),
        _host(a.vals[:nnz]),
    )


# ---------------------------------------------------------------------------
# Pluggable tile→batch distributions
# ---------------------------------------------------------------------------
class Distribution:
    """Contract for a tile→batch column distribution (planner-side math).

    Implementations keep ``fold``/``batch_column_map`` consistent: ``fold``
    sums exactly the columns ``batch_column_map`` reports for each
    (batch, piece).
    """

    name: str = "abstract"

    def round_batches(self, n: int, num_batches: int, num_layers: int) -> int:
        """Smallest feasible batch count >= ``num_batches`` for n columns."""
        raise NotImplementedError

    def fold(
        self, percol: np.ndarray, num_batches: int, num_layers: int
    ) -> np.ndarray:
        """Fold (..., n) per-column vectors into (..., batch, piece) sums."""
        raise NotImplementedError

    def fold_batch_slices(self, colcounts: np.ndarray, num_batches: int) -> np.ndarray:
        """Fold (..., wl) C-layout per-column counts into (..., batch) sums:
        the mask slice each batch selects from a C-layout tile."""
        raise NotImplementedError

    def batch_column_map(
        self, n: int, pc: int, num_layers: int, num_batches: int, batch: int
    ) -> np.ndarray:
        """(pc, l, wb/l) global column of each C-tile local column."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class BlockCyclicDistribution(Distribution):
    """The paper's Fig. 1(i) block-cyclic split: block ``t`` of width
    ``n/(b·l)`` belongs to batch ``t % b`` and fiber piece ``t // b``."""

    name: str = "block_cyclic"

    def round_batches(self, n: int, num_batches: int, num_layers: int) -> int:
        return batching_plan_columns(n, num_batches, num_layers)

    def fold(
        self, percol: np.ndarray, num_batches: int, num_layers: int
    ) -> np.ndarray:
        return fold_block_cyclic(percol, num_batches, num_layers)

    def fold_batch_slices(self, colcounts: np.ndarray, num_batches: int) -> np.ndarray:
        *lead, wl = colcounts.shape
        wbl = wl // num_batches
        assert wbl * num_batches == wl, (wl, num_batches)
        return colcounts.reshape(*lead, num_batches, wbl).sum(axis=-1)

    def batch_column_map(
        self, n: int, pc: int, num_layers: int, num_batches: int, batch: int
    ) -> np.ndarray:
        l = num_layers
        w = n // pc
        wb = w // num_batches
        wbl = w // (num_batches * l)
        # C tile layer k holds fiber piece k = D cols [k·wb/l, (k+1)·wb/l);
        # D batch col d_col sits in block t = d_col // wbl at offset
        # d_col % wbl, and block t is the (t·b + batch)-th original block.
        k = np.arange(l, dtype=np.int64)[:, None]
        c = np.arange(wb // l, dtype=np.int64)[None, :]
        d_col = k * (wb // l) + c
        orig_local = (d_col // wbl * num_batches + batch) * wbl + d_col % wbl
        j = np.arange(pc, dtype=np.int64)[:, None, None]
        return j * w + orig_local[None]


#: the distribution the planner folds through and the device step implements
BLOCK_CYCLIC = BlockCyclicDistribution()


# ---------------------------------------------------------------------------
# Permutation passes
# ---------------------------------------------------------------------------
def _invert(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def _spread_positions(n: int) -> np.ndarray:
    """A low-discrepancy permutation of ``range(n)``: consecutive ranks land
    far apart, so dealing a degree-sorted order onto these positions gives
    every aligned block (any width dividing n) a uniform degree mixture.
    Power-of-two sizes use bit reversal; others the golden-ratio sequence."""
    if n > 0 and n & (n - 1) == 0:
        bits = n.bit_length() - 1
        pos = np.arange(n, dtype=np.int64)
        rev = np.zeros(n, np.int64)
        for i in range(bits):
            rev |= ((pos >> i) & 1) << (bits - 1 - i)
        return rev
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    frac = (np.arange(n, dtype=np.float64) * phi) % 1.0
    rank = np.empty(n, np.int64)
    rank[np.argsort(frac, kind="stable")] = np.arange(n, dtype=np.int64)
    return rank


def _degree_spread_perm(counts: np.ndarray) -> np.ndarray:
    """new_index = perm[old_index]: heaviest indices first, dealt onto
    spread positions (not packed together — see the module docstring)."""
    n = counts.shape[0]
    order = np.argsort(-np.asarray(counts, np.int64), kind="stable")
    perm = np.empty(n, np.int64)
    perm[order] = _spread_positions(n)
    return perm


def _rcm_order(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Reverse Cuthill–McKee over the symmetrized pattern: BFS from a
    minimum-degree vertex, neighbors visited in increasing-degree order,
    result reversed."""
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    keep = r != c
    key = np.unique(r[keep] * n + c[keep])
    r, c = key // n, key % n  # grouped by row, neighbor cols ascending
    deg = np.bincount(r, minlength=n)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    order = np.empty(n, np.int64)
    visited = np.zeros(n, bool)
    pos = 0
    q = deque()
    for s in np.argsort(deg, kind="stable"):
        if visited[s]:
            continue
        visited[s] = True
        q.append(int(s))
        while q:
            v = q.popleft()
            order[pos] = v
            pos += 1
            nbrs = c[indptr[v]:indptr[v + 1]]
            nbrs = nbrs[~visited[nbrs]]
            nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
            visited[nbrs] = True
            q.extend(int(x) for x in nbrs)
    return order[::-1].copy()


@dataclasses.dataclass(eq=False)
class Placement:
    """A (row, contraction, column) permutation triple, ``new = perm[old]``.

    ``apply_a``/``apply_b``/``apply_mask`` permute COO operands into
    placement space on the operand's device (A: rows by ``row_perm``, cols
    by ``k_perm``; B: rows by ``k_perm``, cols by ``col_perm``; mask: C
    layout); ``original_rows``/``original_cols`` map result coordinates
    back. ``eq=False``: the object hashes by identity so it can ride the
    frozen ``PlanSpec``.
    """

    strategy: str
    row_perm: np.ndarray  # (m,)
    k_perm: np.ndarray  # (k,)
    col_perm: np.ndarray  # (n,)

    def __post_init__(self):
        self.row_inv = _invert(np.asarray(self.row_perm, np.int64))
        self.k_inv = _invert(np.asarray(self.k_perm, np.int64))
        self.col_inv = _invert(np.asarray(self.col_perm, np.int64))

    @classmethod
    def identity(cls, m: int, k: int, n: int) -> "Placement":
        ar = np.arange
        return cls("identity", ar(m, dtype=np.int64), ar(k, dtype=np.int64),
                   ar(n, dtype=np.int64))

    @property
    def is_identity(self) -> bool:
        return all(
            np.array_equal(p, np.arange(p.shape[0]))
            for p in (self.row_perm, self.k_perm, self.col_perm)
        )

    @staticmethod
    def _permuted(x, row_perm, col_perm):
        rows, cols, vals = _host_triplets(x)
        return from_numpy_coo(row_perm[rows], col_perm[cols], vals, x.shape, cap=x.cap,
                              device=x.device)

    def apply_a(self, a):
        return self._permuted(a, self.row_perm, self.k_perm)

    def apply_b(self, b):
        return self._permuted(b, self.k_perm, self.col_perm)

    def apply_mask(self, mask):
        return self._permuted(mask, self.row_perm, self.col_perm)

    def original_rows(self, rows) -> np.ndarray:
        """Map permuted global row coordinates back to the original ones."""
        return self.row_inv[np.asarray(rows)]

    def original_cols(self, cols) -> np.ndarray:
        return self.col_inv[np.asarray(cols)]


def compute_placement(a, b, strategy: str = "degree", mask=None) -> Placement:
    """A :class:`Placement` for ``a @ b`` from structure alone.

    ``"identity"`` (no-op); ``"degree"`` (degree-spread each of the three
    index spaces independently from exact per-row/column counts; a
    ``mask``'s column counts join the column degrees, so a masked multiply
    spreads the surviving structure); ``"rcm"`` (reverse Cuthill–McKee
    over A's symmetrized pattern, square operands only, one ordering shared
    by rows, contraction and columns).
    """
    m, k = a.shape
    k_b, n = b.shape
    assert k == k_b, (a.shape, b.shape)
    if strategy == "identity":
        return Placement.identity(m, k, n)
    ar, ac, _ = _host_triplets(a)
    br, bc, _ = _host_triplets(b)
    if strategy == "degree":
        col_deg = np.bincount(bc, minlength=n)
        if mask is not None:
            _, mc, _ = _host_triplets(mask)
            col_deg = col_deg + np.bincount(mc, minlength=n)
        return Placement(
            strategy="degree",
            row_perm=_degree_spread_perm(np.bincount(ar, minlength=m)),
            k_perm=_degree_spread_perm(
                np.bincount(ac, minlength=k) + np.bincount(br, minlength=k)
            ),
            col_perm=_degree_spread_perm(col_deg),
        )
    if strategy == "rcm":
        if not (m == k == n):
            raise ValueError(
                f"rcm placement needs square aligned operands, got "
                f"{a.shape} x {b.shape}"
            )
        order = _rcm_order(n, ar, ac)
        perm = np.empty(n, np.int64)
        perm[order] = np.arange(n, dtype=np.int64)
        return Placement(
            strategy="rcm", row_perm=perm, k_perm=perm.copy(), col_perm=perm.copy(),
        )
    raise ValueError(
        f"unknown placement strategy {strategy!r} "
        f"(known: identity, degree, rcm)"
    )


# ---------------------------------------------------------------------------
# End-to-end placed multiply
# ---------------------------------------------------------------------------
def _batch_to_global(c, col_map, grid) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One sparse C batch of the whole grid in global coordinates on the
    host: every rank's tile is gathered, so every rank gets all of it."""
    tm, _ = c.tile_shape
    R, C, V, N = (_host(grid.gather_grid(x[0, 0, 0]))
                  for x in (c.rows, c.cols, c.vals, c.nnz))
    valid = np.arange(R.shape[-1])[None, None, None, :] < N[..., None]
    i, j, k, s = np.nonzero(valid)
    return i * tm + R[i, j, k, s], col_map[j, k, C[i, j, k, s]], V[i, j, k, s]


@dataclasses.dataclass
class PlacedResult:
    """Global host COO triplets of a placed multiply, row-major sorted, in
    ORIGINAL (unpermuted) coordinates. Coordinates are unique (the driver
    merges within batches; batches and tiles cover disjoint output
    regions), so ``to_dense`` assigns rather than accumulates — exact for
    every semiring."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    shape: Tuple[int, int]
    placement: Placement
    result: object  # the BatchedResult of the underlying driver run

    def to_dense(self, fill: float = 0.0) -> np.ndarray:
        out = np.full(self.shape, fill, dtype=self.vals.dtype)
        out[self.rows, self.cols] = self.vals
        return out


def multiply_placed(
    a,
    b,
    grid,
    per_process_memory: int,
    *,
    strategy: str = "degree",
    placement: Optional[Placement] = None,
    mask=None,
    semiring=None,
    spec=None,
    floors=None,
    exec_spec=None,
) -> PlacedResult:
    """Permute → scatter → ``batched_summa3d`` → invert, in one call.

    ``a``/``b`` (and the optional ``mask``) are global COO matrices, the
    same on every process; ``placement`` overrides the computed ordering
    (``Placement.identity(...)`` is the baseline of an A/B comparison). The
    driver runs on the permuted operands with ``spec.placement`` set, so
    the column maps it hands the consumer are already original columns;
    this wrapper inverts the rows and returns row-major-sorted global
    triplets, the unpermuted multiply's. On a grid of several processes
    every process gathers every tile of each batch, so each returns all
    the triplets.
    """
    from . import semiring as sr  # deferred: batched imports this module
    from .batched import batched_summa3d
    from .distsparse import scatter_to_grid
    from .specs import PlanSpec

    semiring = semiring if semiring is not None else sr.PLUS_TIMES
    if placement is None:
        placement = compute_placement(a, b, strategy=strategy, mask=mask)
    A = scatter_to_grid(placement.apply_a(a), grid, "A")
    B = scatter_to_grid(placement.apply_b(b), grid, "B")
    M = (
        scatter_to_grid(placement.apply_mask(mask), grid, "C")
        if mask is not None else None
    )
    spec = (spec if spec is not None else PlanSpec()).replace(mask=M, placement=placement)

    pieces = []

    def consumer(bi, c_batch, col_map):
        pieces.append(_batch_to_global(c_batch, col_map, grid))

    res = batched_summa3d(
        A, B, grid, per_process_memory, consumer, path="sparse",
        semiring=semiring, spec=spec, floors=floors, exec_spec=exec_spec,
    )
    rows = placement.original_rows(np.concatenate([p[0] for p in pieces]))
    cols = np.concatenate([p[1] for p in pieces])  # the driver already inverted
    vals = np.concatenate([p[2] for p in pieces])
    # coordinates are unique, so one argsort of the row-major key gives the
    # (row, col) lexsort's order, several times faster at 10^8 entries
    order = np.argsort(rows * np.int64(b.shape[1]) + cols)
    return PlacedResult(
        rows=rows[order], cols=cols[order], vals=vals[order],
        shape=(a.shape[0], b.shape[1]), placement=placement, result=res,
    )
