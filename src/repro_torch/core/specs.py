"""Frozen planning/execution specs — the knob surface of the batched driver.

  * ``PlanSpec``   — WHAT to plan: the output mask, local path, slack,
    bytes per entry, reserved output bytes, forced batch count, k-bin
    candidates. Two calls with the same spec and operands give the same
    ``BatchPlan``.
  * ``PlanFloors`` — capacity floors carried ACROSS plans, with a monotonic
    ``merged()`` (elementwise max), so iterated callers keep one capacity
    plan as nnz drifts. JSON round-trips via ``to_meta``/``from_meta``.
  * ``ExecSpec``   — HOW to run: pipelined schedule, lookahead depth, retry
    budget, graceful degradation, the Merge-Fiber kind and the legacy
    two-way k-binned override.

``TunedConfig`` (``repro_torch.tune``) is one of each plus a grid shape.

The old keyword surface is still accepted: ``resolve_specs`` maps legacy
keyword arguments onto the spec objects (overriding any field also set on
a passed spec) under one ``DeprecationWarning``, and an unknown keyword
raises ``TypeError``, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import warnings
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
    # Structure-aware placement (core.placement). ``placement`` says the
    # operands ALREADY carry this Placement's permutations: the driver maps
    # every consumer-facing column map back to original columns
    # (``placement.multiply_placed`` permutes and inverts end to end).
    # ``distribution`` swaps the planner's tile→batch fold (None is
    # placement.BLOCK_CYCLIC, the only one the device step runs).
    placement: Optional[object] = None  # core.placement.Placement
    distribution: Optional[object] = None  # core.placement.Distribution

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
    degrade: bool = True  # False: the unbounded retry ladder, no replans
    sorted_merge: bool = True  # Merge-Fiber merges the sorted pieces
    binned: object = "auto"  # legacy two-way override; prefer PlanSpec.local_path

    def replace(self, **kw) -> "ExecSpec":
        return dataclasses.replace(self, **kw)


# legacy keyword -> spec field, one map per spec object
_PLAN_KEYS = {
    "mask": "mask",
    "mask_complement": "mask_complement",
    "local_path": "local_path",
    "slack": "slack",
    "r_bytes": "r_bytes",
    "reserved_bytes": "reserved_bytes",
    "force_num_batches": "force_num_batches",
    "kbin_candidates": "kbin_candidates",
}
_FLOOR_KEYS = {
    "caps_floor": "caps",
    "sel_cap_floor": "sel_cap",
    "num_batches_floor": "num_batches",
    "kbin_caps_floor": "kbin_caps",
    "hash_caps_floor": "hash_caps",
    "caps_pow2": "caps_pow2",
}
_EXEC_KEYS = {
    "pipelined": "pipelined",
    "lookahead": "lookahead",
    "max_retries": "max_retries",
    "degrade": "degrade",
    "sorted_merge": "sorted_merge",
    "binned": "binned",
}


def resolve_specs(
    spec: Optional[PlanSpec],
    floors: Optional[PlanFloors],
    exec_spec: Optional[ExecSpec],
    legacy: dict,
    *,
    default_local_path: str = "auto",
    where: str = "batched_summa3d",
    allow_exec: bool = True,
) -> Tuple[PlanSpec, PlanFloors, ExecSpec]:
    """Normalize (spec, floors, exec_spec, **legacy) to the three specs.

    Each legacy keyword is mapped onto its spec field (overriding the passed
    spec) under a single ``DeprecationWarning``; an unknown keyword raises
    ``TypeError`` as a real signature would. No spec means
    ``PlanSpec(local_path=default_local_path)``.
    """
    if spec is not None and not isinstance(spec, PlanSpec):
        raise TypeError(
            f"{where}: spec must be a PlanSpec, got {type(spec).__name__} "
            f"(old positional keyword arguments must be passed by name)"
        )
    if floors is not None and not isinstance(floors, PlanFloors):
        raise TypeError(
            f"{where}: floors must be a PlanFloors, got {type(floors).__name__}"
        )
    if spec is None:
        spec = PlanSpec(local_path=default_local_path)
    floors = floors if floors is not None else PlanFloors()
    ex = exec_spec if exec_spec is not None else ExecSpec()
    if legacy:
        known = set(_PLAN_KEYS) | set(_FLOOR_KEYS)
        if allow_exec:
            known |= set(_EXEC_KEYS)
        unknown = set(legacy) - known
        if unknown:
            raise TypeError(
                f"{where}() got unexpected keyword argument(s) "
                f"{sorted(unknown)}"
            )
        warnings.warn(
            f"{where}: keyword argument(s) {sorted(legacy)} are deprecated; "
            f"pass PlanSpec / PlanFloors / ExecSpec instead",
            DeprecationWarning,
            stacklevel=3,
        )
        spec = spec.replace(**{
            _PLAN_KEYS[k]: v for k, v in legacy.items() if k in _PLAN_KEYS
        })
        floors = floors.replace(**{
            _FLOOR_KEYS[k]: v for k, v in legacy.items() if k in _FLOOR_KEYS
        })
        if allow_exec:
            ex = ex.replace(**{
                _EXEC_KEYS[k]: v for k, v in legacy.items() if k in _EXEC_KEYS
            })
    return spec, floors, ex
