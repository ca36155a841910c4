"""Symbolic α–β–γ cost model of the batched SUMMA3D multiply (Table II, §IV).

One multiply at grid (pr, pc, l) with b batches is priced as

  predicted_ms = overhead · (dispatch + sync + comm + compute)

  dispatch = dispatch_ms · b                    per-batch fused-step launch
  sync     = sync_ms · b / lookahead            host flag reads, amortized by
                                                the pipelined window (serial
                                                schedule: lookahead = 1)
  comm     = beta_ms_per_byte · per-process Table II bytes
  compute  = γ_path · per-path compute units

Table II bandwidth terms (per process, r bytes per stored nonzero, totals
over the whole run):

  A-Gather        b · r · nnz(A)/p · (pc − 1)   A is re-gathered every batch
  B-Gather        r · nnz(B)/p · (pr − 1)       each batch gathers 1/b of B
  AllToAll-Fiber  r · flops/p · (l − 1)/l       every partial product crosses
                                                the fiber at most once

Compute units per local-multiply path: ESC and hash pay γ per flop; the
k-binned path pays the ESC merge cost plus γ_binned per PAIRING —
``b · KBinPlan.pairings``, the quantity the symbolic k-bin plan minimizes.

The coefficient defaults are the JAX package's, carried over unchanged so
both tuners price a candidate alike: priors its authors fitted once against
that package's CPU-backend measurements. They are not times taken on the
card. ``fit_overhead`` refits the single multiplicative ``overhead`` as the
geometric mean of measured/raw over measured rows at hand — the one scalar
that calibrates the model to a device — and ``ACCEPT_BAND`` is the fixed
predicted/measured acceptance band.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

#: fixed acceptance band for predicted/measured ratios after the overhead fit
ACCEPT_BAND = (0.25, 4.0)


@dataclasses.dataclass(frozen=True)
class CostCoefficients:
    """α–β–γ coefficients (ms). The defaults are the JAX package's priors,
    fitted to its CPU-backend measurements (not card times); ``overhead``
    is the refittable scalar."""

    dispatch_ms: float = 9.6  # per-batch fused-step launch (α · phases)
    sync_ms: float = 0.2  # per-batch host flag read (amortized by lookahead)
    beta_ms_per_byte: float = 1e-6  # inverse bandwidth (β)
    gamma_esc_ms: float = 8.109 / 61581  # per flop (the CPU fit's ESC row)
    gamma_hash_ms: float = 2.73e-2  # per flop (the CPU fit's per-chunk hash step)
    gamma_binned_ms: float = 4.6e-5  # per pairing (k-binned extra pass)
    overhead: float = 1.0  # fitted measured/raw factor

    def replace(self, **kw) -> "CostCoefficients":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class CommVolume:
    """Per-process Table II bytes for one whole multiply (all batches)."""

    a_gather_bytes: int
    b_gather_bytes: int
    fiber_bytes: int

    @property
    def per_process_bytes(self) -> int:
        return self.a_gather_bytes + self.b_gather_bytes + self.fiber_bytes


def comm_volume(
    grid_shape: Tuple[int, int, int],
    num_batches: int,
    nnz_a: int,
    nnz_b: int,
    total_flops: int,
    r_bytes: int = 12,
) -> CommVolume:
    """Table II α–β volumes (see module docstring) — pure host math."""
    pr, pc, l = grid_shape
    p = pr * pc * l
    a_gather = num_batches * r_bytes * (nnz_a / p) * (pc - 1)
    b_gather = r_bytes * (nnz_b / p) * (pr - 1)
    fiber = r_bytes * (total_flops / p) * (l - 1) / l
    return CommVolume(
        a_gather_bytes=int(math.ceil(a_gather)),
        b_gather_bytes=int(math.ceil(b_gather)),
        fiber_bytes=int(math.ceil(fiber)),
    )


@dataclasses.dataclass(frozen=True)
class PaddedCommVolume:
    """CAPACITY-padded per-process transfer bytes of one planned multiply.

    The Table II ``comm_volume`` terms count exact nonzeros, which are
    permutation-INVARIANT — they cannot see what a placement buys. What the
    fused step actually moves is padded to the plan's static capacities:
    the block-cyclic B selection gathers a ``sel_cap``-sized buffer along
    the grid row every batch, and the fiber all_to_all exchanges
    ``piece_cap``-sized pieces across the layers. Those caps are MAXIMA of
    the distribution's fold — exactly what a degree-spread placement lowers
    on skewed inputs — so this is the volume the autotuner prices a
    placement candidate with.
    """

    all_to_all_bytes: int  # fiber exchange at piece_cap padding, all batches
    gather_bytes: int  # B-selection gather at sel_cap padding, all batches

    @property
    def total_bytes(self) -> int:
        return self.all_to_all_bytes + self.gather_bytes


def padded_comm_volume(
    plan, grid_shape: Tuple[int, int, int], r_bytes: int = 12
) -> PaddedCommVolume:
    """Padded per-process transfer bytes of ``plan`` on ``grid_shape``.

    Per batch the fused step sends its sel_cap-padded B selection to the
    ``pr − 1`` other processes of its grid row and its piece_cap-padded
    D pieces to the ``l − 1`` other layers; both are static shapes, so the
    bytes follow the caps, not the nnz."""
    pr, pc, l = grid_shape
    nb = plan.num_batches
    return PaddedCommVolume(
        all_to_all_bytes=int(nb * r_bytes * plan.caps.piece_cap * (l - 1)),
        gather_bytes=int(nb * r_bytes * plan.sel_cap * (pr - 1)),
    )


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """Priced cost of one candidate configuration (end-to-end multiply)."""

    total_ms: float
    dispatch_ms: float
    sync_ms: float
    comm_ms: float
    compute_ms: float
    comm_bytes: int  # per-process Table II bytes (sum of the three terms)
    a_gather_bytes: int
    b_gather_bytes: int
    fiber_bytes: int
    num_batches: int
    path: str

    def to_meta(self) -> dict:
        return {k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in dataclasses.asdict(self).items()}


def compute_units(plan, path: str) -> Tuple[float, float]:
    """(flop-priced units, pairing-priced units) of one whole multiply.

    ESC/hash: every path pays the merge/compress over ``total_flops``
    partial products. Binned additionally pays the per-batch pairing grid
    the k-bin plan bounds (``pairings`` is a per-batch capacity product).
    """
    pairings = 0.0
    if path == "binned" and plan.kbin is not None:
        pairings = float(plan.kbin.pairings) * plan.num_batches
    return float(plan.total_flops), pairings


def predict_cost(
    plan,
    grid_shape: Tuple[int, int, int],
    nnz_a: int,
    nnz_b: int,
    coeffs: Optional[CostCoefficients] = None,
    r_bytes: int = 12,
    pipelined: bool = True,
    lookahead: int = 2,
    path: Optional[str] = None,
) -> CostBreakdown:
    """Price one ``BatchPlan`` on ``grid_shape`` — per-batch terms × b plus
    the Table II volumes. ``path`` overrides the plan's decided local path
    (the autotuner prices explicit path candidates through here)."""
    c = coeffs or CostCoefficients()
    if path is None or path == "auto":
        path = plan.local_path
    nb = plan.num_batches
    vol = comm_volume(grid_shape, nb, nnz_a, nnz_b, plan.total_flops, r_bytes)
    flop_units, pairing_units = compute_units(plan, path)
    gamma = {
        "esc": c.gamma_esc_ms,
        "binned": c.gamma_esc_ms,  # binned keeps the ESC merge pipeline
        "hash": c.gamma_hash_ms,
    }[path]
    compute_ms = gamma * flop_units + c.gamma_binned_ms * pairing_units
    dispatch_ms = c.dispatch_ms * nb
    window = max(int(lookahead), 1) if pipelined else 1
    sync_ms = c.sync_ms * nb / window
    comm_ms = c.beta_ms_per_byte * vol.per_process_bytes
    total = c.overhead * (dispatch_ms + sync_ms + comm_ms + compute_ms)
    return CostBreakdown(
        total_ms=total,
        dispatch_ms=dispatch_ms,
        sync_ms=sync_ms,
        comm_ms=comm_ms,
        compute_ms=compute_ms,
        comm_bytes=vol.per_process_bytes,
        a_gather_bytes=vol.a_gather_bytes,
        b_gather_bytes=vol.b_gather_bytes,
        fiber_bytes=vol.fiber_bytes,
        num_batches=nb,
        path=path,
    )


def fit_overhead(
    pairs: Sequence[Tuple[float, float]],
    coeffs: Optional[CostCoefficients] = None,
) -> CostCoefficients:
    """Refit the single ``overhead`` scalar from (raw_predicted_ms,
    measured_ms) pairs — geometric mean of measured/raw, the hardware
    calibration step (everything else in the model is symbolic)."""
    c = coeffs or CostCoefficients()
    ratios = [m / max(r, 1e-9) for r, m in pairs if m > 0]
    if not ratios:
        return c
    log_mean = sum(math.log(x) for x in ratios) / len(ratios)
    return c.replace(overhead=math.exp(log_mean))
