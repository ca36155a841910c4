"""Analytical cost model + autotuner (paper Table II / §IV cost analysis).

``cost_model`` prices a batch plan — per-batch and end-to-end — from the
Table II α–β communication terms and per-path γ compute terms over the
symbolic counts; ``autotune`` enumerates candidate (grid, local path, batch
count, k-bin pinning, lookahead) configurations from ONE symbolic pass per
candidate grid (host math, no devices, no trial multiplies) and returns a
``TunedConfig`` — exactly a ``PlanSpec`` + ``PlanFloors`` + ``ExecSpec`` +
grid shape, which ``batched_summa3d`` consumes directly. Placement candidates
(``core.placement`` permutations) are priced with ``padded_comm_volume``
— the capacity-padded transfer bytes the permutation-invariant Table II
terms cannot see.
"""
from .cost_model import (  # noqa: F401
    ACCEPT_BAND,
    CostBreakdown,
    CostCoefficients,
    comm_volume,
    fit_overhead,
    padded_comm_volume,
    predict_cost,
)
from .autotune import TunedConfig, autotune, candidate_grids  # noqa: F401
