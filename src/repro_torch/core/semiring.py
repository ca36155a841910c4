"""Semiring algebra for SpGEMM (paper §II-A), in PyTorch.

The algorithm applies over any semiring S = (add, mul, zero) because it uses
no Strassen-like identities. ``add_kind`` names the additive monoid so the
compress step of ESC SpGEMM can pick the matching scatter reduction:

  plus_times  — numeric SpGEMM (HipMCL / protein similarity)
  or_and      — boolean / symbolic multiply
  min_plus    — shortest paths (tropical)
  max_times   — max-reliability paths
  plus_pair   — pair counting: mul(a, b) = 1 (triangle counting)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Tensor = torch.Tensor


#: torch's ``scatter_reduce_`` name for each additive reduction
REDUCE_OPS = {"sum": "sum", "min": "amin", "max": "amax"}


def scatter_reduce_init(add_kind: str) -> float:
    """Identity of the additive reduction: what an empty segment holds."""
    return {"sum": 0.0, "min": math.inf, "max": -math.inf}[add_kind]


def scatter_reduce(
    vals: Tensor, segids: Tensor, num_segments: int, add_kind: str
) -> Tensor:
    """Reduce ``vals`` into ``num_segments`` slots by ``segids`` (along dim 0).

    Empty segments hold the reduction's identity (0, +inf or -inf), as
    ``jax.ops.segment_{sum,min,max}`` leave them.
    """
    if add_kind not in ("sum", "min", "max"):
        raise ValueError(f"unknown add_kind {add_kind}")
    out = torch.full(
        (num_segments,) + tuple(vals.shape[1:]), scatter_reduce_init(add_kind),
        dtype=vals.dtype, device=vals.device,
    )
    idx = segids.long()
    if vals.dim() > 1:
        idx = idx.view(-1, *([1] * (vals.dim() - 1))).expand_as(vals)
    return out.scatter_reduce_(0, idx, vals, reduce=REDUCE_OPS[add_kind], include_self=True)


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    add_kind: str  # one of: "sum", "min", "max" — selects the reduction
    mul: Callable[[Tensor, Tensor], Tensor]
    zero: float  # additive identity (also the padding value)


PLUS_TIMES = Semiring("plus_times", "sum", lambda a, b: a * b, 0.0)
OR_AND = Semiring("or_and", "max", torch.minimum, 0.0)  # on {0, 1}
MIN_PLUS = Semiring("min_plus", "min", lambda a, b: a + b, math.inf)
MAX_TIMES = Semiring("max_times", "max", lambda a, b: a * b, 0.0)  # nonneg values
PLUS_PAIR = Semiring("plus_pair", "sum", lambda a, b: torch.ones_like(a), 0.0)

REGISTRY = {s.name: s for s in [PLUS_TIMES, OR_AND, MIN_PLUS, MAX_TIMES, PLUS_PAIR]}


def get(name: str) -> Semiring:
    return REGISTRY[name]
