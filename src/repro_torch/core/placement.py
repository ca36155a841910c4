"""Tile→batch column distributions (the planner's pluggable fold).

A ``Distribution`` decides how the ``n`` local B/C columns split into
``num_batches × num_layers`` pieces: every capacity the planner derives is
a fold of per-column count vectors through this object, and every
consumer-facing column map is its inverse. ``BLOCK_CYCLIC`` is the paper's
Fig. 1(i) split, the one the device step (``SparseCOO.select_cols_blockcyclic``)
implements. Placement permutations are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .symbolic import batching_plan_columns, fold_block_cyclic


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
