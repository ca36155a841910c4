"""Autotuner: enumerate (grid, path, batches, bins, lookahead) candidates
from symbolic counts alone and price them with the cost model.

One ``host_symbolic_counts`` pass per candidate grid (host math over the
COO — no scatter, no devices, no trial multiplies), then
``plan_from_symbolic`` turns each (local path, forced batch count, k-bin
pin) combination into a concrete ``BatchPlan`` that ``predict_cost``
prices. The default configuration — the grid ``square_grid_for`` would
pick with ``PlanSpec()``/``ExecSpec()`` defaults — is ALWAYS in the
candidate set, so the argmin is never priced worse than the defaults by
construction (an acceptance criterion, asserted in tests).

The winner is returned as a ``TunedConfig``: exactly the frozen
``PlanSpec`` + ``PlanFloors`` + ``ExecSpec`` + grid shape that
``batched_summa3d`` consumes directly — tuning output IS the spec API, no
translation layer. Every choice is the JAX package's on the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..core.batched import PlanInputs, plan_from_symbolic
from ..core.placement import compute_placement
from ..core.specs import ExecSpec, PlanFloors, PlanSpec
from ..core.symbolic import host_symbolic_counts
from .cost_model import (
    CostBreakdown,
    CostCoefficients,
    padded_comm_volume,
    predict_cost,
)

#: local-multiply paths the tuner prices explicitly ("auto" lets the plan
#: decide — the fixed-heuristic default the tuned pick must not lose to)
PATHS = ("auto", "esc", "binned", "hash")

#: placement strategies the tuner prices. ``None`` (no permutation) comes
#: first and wins ties: a placement is only picked on a STRICT improvement
#: of (predicted ms, padded transfer bytes) — the Table II volumes are
#: permutation-invariant, so the tiebreaker is the capacity-padded volume
#: (``padded_comm_volume``), the quantity a degree spread actually lowers.
PLACEMENTS = (None, "degree")


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """Autotuner output: a priced configuration in spec-API terms.

    ``spec``/``floors``/``exec_spec`` feed ``batched_summa3d`` verbatim; ``spec.mask`` is left ``None`` —
    the caller passes its scattered mask at multiply time. ``floors`` pin
    the priced plan's capacities so the first real multiply compiles the
    signature the model priced.
    """

    grid_shape: Tuple[int, int, int]
    per_process_memory: int
    spec: PlanSpec
    floors: PlanFloors
    exec_spec: ExecSpec
    num_batches: int
    predicted: CostBreakdown
    baseline_grid_shape: Tuple[int, int, int]
    baseline_num_batches: int
    baseline_predicted: CostBreakdown
    # winning placement STRATEGY name (None = unpermuted). Kept off
    # ``spec.placement`` on purpose: the spec field carries a concrete
    # Placement object for already-permuted operands, while the tuned
    # recommendation is "run this multiply through
    # ``placement.multiply_placed(..., strategy=...)``".
    placement: Optional[str] = None

    def to_meta(self) -> dict:
        """JSON-serializable summary."""
        return {
            "grid_shape": list(self.grid_shape),
            "per_process_memory": self.per_process_memory,
            "local_path": self.spec.local_path,
            "lookahead": self.exec_spec.lookahead,
            "num_batches": self.num_batches,
            "placement": self.placement,
            "floors": self.floors.to_meta(),
            "predicted": self.predicted.to_meta(),
            "baseline_grid_shape": list(self.baseline_grid_shape),
            "baseline_num_batches": self.baseline_num_batches,
            "baseline_predicted": self.baseline_predicted.to_meta(),
        }


def candidate_grids(
    a_shape: Tuple[int, int],
    b_shape: Tuple[int, int],
    num_devices: int,
    mask: bool = False,
) -> Tuple[Tuple[int, int, int], ...]:
    """All (s, s, l) layer grids with s²·l ≤ ``num_devices`` — plus every
    RECTANGULAR single-layer (pr, pc, 1) with pr·pc ≤ ``num_devices`` —
    whose tile math divides the operand shapes (the
    ``host_symbolic_counts`` / ``make_grid`` preconditions): m(A) % pr,
    k % (pr·l) and k % (pc·l), n(B) % pc — plus n(B) % (pc·l) when a mask
    will be scattered (C-layout tiles). Rectangular layer grids only align
    the contraction slices at l == 1, hence the single-layer restriction."""
    m_a, k_dim = a_shape
    k_dim_b, n_b = b_shape
    assert k_dim == k_dim_b, (a_shape, b_shape)
    out = []
    s = 1
    while s * s <= num_devices:
        if m_a % s == 0 and n_b % s == 0:
            l = 1
            while s * s * l <= num_devices:
                ok = k_dim % (s * l) == 0
                if mask:
                    ok = ok and n_b % (s * l) == 0
                if ok:
                    out.append((s, s, l))
                l += 1
        s += 1
    for pr in range(1, num_devices + 1):
        if m_a % pr or k_dim % pr:
            continue
        for pc in range(1, num_devices // pr + 1):
            if pc == pr:
                continue  # squares enumerated above (with their layers)
            if n_b % pc or k_dim % pc:
                continue
            out.append((pr, pc, 1))
    return tuple(out)


def _default_grid(
    grids: Sequence[Tuple[int, int, int]],
) -> Tuple[int, int, int]:
    """The grid the fixed heuristics would pick: among the SQUARE layer
    grids (``square_grid_for`` never proposes a rectangle), use all the
    devices you can, prefer the squarest layout among equal process counts,
    then the fewest layers."""
    squares = [g for g in grids if g[0] == g[1]]
    return max(squares, key=lambda g: (g[0] * g[1] * g[2], g[0], -g[2]))


def autotune(
    a,
    b,
    per_process_memory: int,
    *,
    num_devices: Optional[int] = None,
    mask=None,
    coeffs: Optional[CostCoefficients] = None,
    lookaheads: Sequence[int] = (1, 2, 4),
    r_bytes: int = 12,
    max_retries: int = 4,
) -> TunedConfig:
    """Pick the cheapest (grid, path, batches, bins, lookahead) for
    ``a @ b`` under ``per_process_memory`` — by symbolic pricing only.

    ``a``/``b`` (and the optional ``mask``) are global COO matrices (the
    port's ``SparseCOO``, e.g. ``gen.*`` output) — nothing is scattered;
    the pricing is host math. ``num_devices`` defaults to the visible card
    count (``torch.cuda.device_count()``); with no card, pass it. Candidates
    that cannot fit the memory budget (``plan_from_symbolic`` raises
    ``MemoryError``) are skipped; if even the default grid cannot fit, the
    error propagates so the caller learns the budget is infeasible, same as
    ``plan_batches``.
    """
    if num_devices is None:
        num_devices = torch.cuda.device_count()
        if num_devices == 0:
            raise RuntimeError("autotune: no CUDA device visible; pass num_devices")
    grids = candidate_grids(a.shape, b.shape, num_devices,
                            mask=mask is not None)
    if not grids:
        raise ValueError(
            f"no layer grid with ≤{num_devices} devices divides shapes "
            f"{a.shape} × {b.shape}"
        )
    base_grid = _default_grid(grids)

    best = None  # TunedConfig-args tuple for the winning candidate
    best_key = None  # (total_ms, padded transfer bytes) — strict-< compare
    baseline = None  # (grid, plan, CostBreakdown) for the default config

    for strategy in PLACEMENTS:
        if strategy is None:
            pa, pb, pmask = a, b, mask
        else:
            placement = compute_placement(a, b, strategy=strategy, mask=mask)
            pa, pb = placement.apply_a(a), placement.apply_b(b)
            pmask = placement.apply_mask(mask) if mask is not None else None
        for grid in grids:
            counts = host_symbolic_counts(pa, pb, grid, mask=pmask)
            inputs = PlanInputs.from_host(pa, pb, grid, mask=pmask)
            for path in PATHS:
                for kbin_pin in (None, (1,)):
                    spec = PlanSpec(local_path=path, r_bytes=r_bytes,
                                    kbin_candidates=kbin_pin)
                    try:
                        plan = plan_from_symbolic(
                            counts, inputs, per_process_memory, spec,
                            PlanFloors(),
                        )
                    except MemoryError:
                        if strategy is None and grid == base_grid \
                                and path == "auto" and kbin_pin is None:
                            raise  # the default config itself is infeasible
                        continue
                    nb_forced = (None, plan.num_batches * 2)
                    for force in nb_forced:
                        if force is not None:
                            try:
                                plan_f = plan_from_symbolic(
                                    counts, inputs, per_process_memory,
                                    dataclasses.replace(
                                        spec, force_num_batches=force),
                                    PlanFloors(),
                                )
                            except MemoryError:
                                continue
                        else:
                            plan_f = plan
                        for la in lookaheads:
                            cost = predict_cost(
                                plan_f, grid, inputs.nnz_a, inputs.nnz_b,
                                coeffs=coeffs, r_bytes=r_bytes,
                                pipelined=True, lookahead=la,
                            )
                            padded = padded_comm_volume(
                                plan_f, grid, r_bytes=r_bytes
                            )
                            is_default = (
                                strategy is None and grid == base_grid
                                and path == "auto" and kbin_pin is None
                                and force is None
                                and la == ExecSpec().lookahead
                            )
                            if is_default:
                                baseline = (grid, plan_f, cost)
                            cand = (grid, plan_f, cost, path, kbin_pin,
                                    force, la, strategy)
                            # lexicographic, strict: placements iterate
                            # after None, so a permutation only wins when
                            # it strictly lowers the (ms, padded-bytes) key
                            key = (cost.total_ms, padded.total_bytes)
                            if best is None or key < best_key:
                                best, best_key = cand, key

    assert best is not None  # default grid either planned or raised
    if baseline is None:
        # default lookahead absent from `lookaheads`: reprice the default
        # plan at ExecSpec()'s lookahead so the comparison is still the
        # untouched-defaults configuration
        counts = host_symbolic_counts(a, b, base_grid, mask=mask)
        inputs = PlanInputs.from_host(a, b, base_grid, mask=mask)
        plan0 = plan_from_symbolic(
            counts, inputs, per_process_memory,
            PlanSpec(r_bytes=r_bytes), PlanFloors(),
        )
        baseline = (
            base_grid, plan0,
            predict_cost(plan0, base_grid, inputs.nnz_a, inputs.nnz_b,
                         coeffs=coeffs, r_bytes=r_bytes,
                         lookahead=ExecSpec().lookahead),
        )

    grid, plan, cost, path, kbin_pin, force, la, strategy = best
    decided = plan.local_path
    pin = kbin_pin
    if pin is None and decided == "binned" and plan.kbin is not None:
        pin = (plan.kbin.num_bins,)  # reproduce the priced bin structure
    tuned_spec = PlanSpec(
        local_path=decided,
        r_bytes=r_bytes,
        force_num_batches=force,
        kbin_candidates=pin,
    )
    tuned_floors = PlanFloors(
        caps=plan.caps,
        sel_cap=plan.sel_cap,
        num_batches=plan.num_batches,
        hash_caps=plan.hash_caps,
        caps_pow2=True,
    )
    return TunedConfig(
        grid_shape=grid,
        per_process_memory=per_process_memory,
        spec=tuned_spec,
        floors=tuned_floors,
        exec_spec=ExecSpec(lookahead=la, max_retries=max_retries),
        num_batches=plan.num_batches,
        predicted=cost,
        baseline_grid_shape=baseline[0],
        baseline_num_batches=baseline[1].num_batches,
        baseline_predicted=baseline[2],
        placement=strategy,
    )
