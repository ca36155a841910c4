"""Frozen planning/execution specs — the knob surface of the batched driver.

  * ``PlanSpec``   — WHAT to plan: the output mask, local path, slack,
    bytes per entry, reserved output bytes, forced batch count, k-bin
    candidates. Two calls with the same spec and operands give the same
    ``BatchPlan``.
  * ``PlanFloors`` — capacity floors carried ACROSS plans, with a monotonic
    ``merged()`` (elementwise max), so iterated callers keep one capacity
    plan as nnz drifts. JSON round-trips via ``to_meta``/``from_meta``.
  * ``ExecSpec``   — HOW to run: pipelined schedule, lookahead depth, retry
    budget.

Placement permutations are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .distsparse import DistSparse
from .summa3d import BatchCaps, BinnedCaps, HashCaps


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Planning policy for one multiply (see ``plan_batches``).

    ``local_path`` defaults to "auto" — the plan-driven 3-way dispatch.
    ``mask`` (a C-layout ``DistSparse`` over the product's shape) runs the
    masked multiply C = (A·B) ⊙ M, or ⊙ ¬M with ``mask_complement``
    (paper §V-B): a strict mask also shrinks the plan to the survivors.
    """

    mask: Optional[DistSparse] = None
    mask_complement: bool = False
    local_path: str = "auto"  # "auto" | "esc" | "binned" | "hash"
    slack: float = 1.3
    r_bytes: int = 12
    # per-process bytes already committed to the consumed outputs (MCL's
    # pruned batches): subtracted from the budget before batching
    reserved_bytes: int = 0
    force_num_batches: Optional[int] = None
    kbin_candidates: Optional[Tuple[int, ...]] = None

    def replace(self, **kw) -> "PlanSpec":
        return dataclasses.replace(self, **kw)


def _emax(x, y, cls):
    """None-aware elementwise max of two caps dataclasses."""
    if x is None:
        return y
    if y is None:
        return x
    return cls(*(
        max(p, q)
        for p, q in zip(dataclasses.astuple(x), dataclasses.astuple(y))
    ))


@dataclasses.dataclass(frozen=True)
class PlanFloors:
    """Capacity floors carried across plans (iterated-multiply pinning).

    Every field is a FLOOR: the planner takes an elementwise max with its
    own derived value, so floors only grow capacities. ``kbin_caps`` doubles
    as the bin-count pin when the spec leaves ``kbin_candidates`` unset.
    """

    caps: Optional[BatchCaps] = None
    sel_cap: int = 0
    num_batches: int = 0
    kbin_caps: Optional[BinnedCaps] = None
    hash_caps: Optional[HashCaps] = None
    caps_pow2: bool = False

    def replace(self, **kw) -> "PlanFloors":
        return dataclasses.replace(self, **kw)

    def merged(self, other: "PlanFloors") -> "PlanFloors":
        """Monotonic fold: elementwise max. Mixing floors with different
        pinned bin counts is a caller bug and raises."""
        if (
            self.kbin_caps is not None
            and other.kbin_caps is not None
            and self.kbin_caps.num_bins != other.kbin_caps.num_bins
        ):
            raise ValueError(
                f"cannot merge floors with different pinned bin counts "
                f"({self.kbin_caps.num_bins} vs {other.kbin_caps.num_bins})"
            )
        return PlanFloors(
            caps=_emax(self.caps, other.caps, BatchCaps),
            sel_cap=max(self.sel_cap, other.sel_cap),
            num_batches=max(self.num_batches, other.num_batches),
            kbin_caps=_emax(self.kbin_caps, other.kbin_caps, BinnedCaps),
            hash_caps=_emax(self.hash_caps, other.hash_caps, HashCaps),
            caps_pow2=self.caps_pow2 or other.caps_pow2,
        )

    def to_meta(self) -> dict:
        """JSON-safe encoding."""
        enc = lambda x: None if x is None else [
            int(v) for v in dataclasses.astuple(x)
        ]
        return {
            "caps": enc(self.caps),
            "sel_cap": int(self.sel_cap),
            "num_batches": int(self.num_batches),
            "kbin_caps": enc(self.kbin_caps),
            "hash_caps": enc(self.hash_caps),
            "caps_pow2": bool(self.caps_pow2),
        }

    @classmethod
    def from_meta(cls, d: Optional[dict]) -> "PlanFloors":
        if not d:
            return cls()
        dec = lambda v, c: None if v is None else c(*(int(x) for x in v))
        return cls(
            caps=dec(d.get("caps"), BatchCaps),
            sel_cap=int(d.get("sel_cap", 0)),
            num_batches=int(d.get("num_batches", 0)),
            kbin_caps=dec(d.get("kbin_caps"), BinnedCaps),
            hash_caps=dec(d.get("hash_caps"), HashCaps),
            caps_pow2=bool(d.get("caps_pow2", False)),
        )


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """Execution policy for the batched driver (schedule + robustness)."""

    pipelined: bool = True
    lookahead: int = 2
    max_retries: int = 4
