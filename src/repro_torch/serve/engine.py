"""Multiply-as-a-service: a plan-cached SpGEMM serving engine.

Requests (pairs of host COO operands + semiring, optionally masked) enter a
FIFO queue. Admission control prices each request with the same memory
model the batched driver enforces (``batched.plan_footprint`` over the
Alg. 3 plan): a request whose planned footprint does not fit beside the
in-flight work is DEFERRED (FIFO, no overtaking); one that cannot fit the
``per_process_memory`` budget even alone is re-planned at finer batching
(``force_num_batches`` doublings, up to ``max_splits``) and REFUSED only
when no split fits.

The plan cache is keyed by the matrix signature: global shape, pow2 nnz
profile, pow2 scatter capacities, pow2 max per-column count, semiring,
local-path policy and mask id. It stores the pow2/floor capacities of the
last plan with that signature as one ``PlanFloors``. Repeat traffic
re-plans through ``plan_batches(spec=..., floors=...)`` with the cached
floors and lands on the same static dispatch signature, ``(num_batches,
caps, sel_cap, kbin caps, hash caps, mask_cap, A.cap, B.cap)``, so its
batches run at the shapes the first request's ran at. Dispatch goes
straight through ``summa3d.summa3d_fused_step``, which enqueues the step
and returns its overflow flags on the device, unread.

Concurrent in-flight requests interleave round-robin, one batch per engine
tick, through a shared ``runtime.driver.LookaheadWindow``: batch overflow
flags are read ``lookahead`` dispatches late, so one request's host-side
assembly overlaps another's device work. Per-request accounting lands in a
``RunReport`` (retries / selection retries), plus latency and the price
the admission controller charged. The latency includes device time: the
first read of a batch's flags waits for the device.

C is assembled on the grid's device: each finished batch's tiles are
gathered over the grid into global triplets, and a finished request's
triplets are sorted row-major there (the reference builds C on the host
with ``from_numpy_coo``; the triplets are the same, since batches cover
disjoint columns and every batch tile is merged). So on a grid of more
than one process every rank returns the whole product. Every rank runs
the same engine on the same request stream; prices come from tile nnz
gathered over the grid (``distsparse.tile_nnz``), so every rank admits,
defers and refuses alike.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import semiring as sr
from ..core.batched import (
    BatchPlan,
    RunReport,
    batch_column_map,
    plan_batches,
    plan_footprint,
)
from ..core.distsparse import DistSparse, scatter_to_grid, tile_nnz, tile_nnz_counts
from ..core.grid import Grid
from ..core.sparse import SparseCOO
from ..core.specs import PlanFloors, PlanSpec
from ..core.summa3d import BatchCaps, BinnedCaps, HashCaps, summa3d_fused_step
from ..core.symbolic import rup8 as _rup8, rup_pow2 as _rup_pow2
from ..runtime.driver import LookaheadWindow


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclasses.dataclass
class MultiplyRequest:
    """One SpGEMM to serve: C = A·B under ``semiring`` (optionally ⊙ mask).

    ``mask`` (C-layout structure gating the output, §V-B) requires a caller
    ``mask_id``: mask VALUES never matter, so the id stands in for the mask's
    structure in the plan-cache key.
    """

    rid: int
    a: SparseCOO
    b: SparseCOO
    semiring: sr.Semiring = sr.PLUS_TIMES
    mask: Optional[SparseCOO] = None
    mask_id: Optional[str] = None


@dataclasses.dataclass
class ServeConfig:
    per_process_memory: int = 1 << 26
    r_bytes: int = 12
    slack: float = 1.3
    lookahead: int = 2  # in-flight window depth (shared across requests)
    max_retries: int = 4  # per-batch overflow retry bound
    max_splits: int = 3  # admission force_num_batches doublings before refusal
    local_path: str = "auto"  # 3-way local-multiply policy (part of the key)
    # base capacity floors applied to every FIRST plan of a signature (an
    # autotuner warm-start: repeat traffic still folds its own floors on top)
    seed_floors: Optional[PlanFloors] = None

    @classmethod
    def from_tuned(cls, tuned, **overrides) -> "ServeConfig":
        """Admission config from an autotuner ``TunedConfig`` (duck-typed:
        anything with per_process_memory / spec / floors / exec_spec): the
        tuned local path, slack, lookahead and batch-count floor flow
        straight into the pricing path."""
        kw = dict(
            per_process_memory=tuned.per_process_memory,
            r_bytes=tuned.spec.r_bytes,
            slack=tuned.spec.slack,
            lookahead=tuned.exec_spec.lookahead,
            max_retries=tuned.exec_spec.max_retries,
            local_path=tuned.spec.local_path,
            seed_floors=tuned.floors,
        )
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass
class MultiplyResult:
    rid: int
    status: str  # "ok" | "refused"
    c: Optional[SparseCOO]
    report: RunReport
    plan_cached: bool = False
    was_deferred: bool = False
    splits: int = 0
    latency_ms: float = 0.0
    price_bytes: int = 0
    num_batches: int = 0
    reason: str = ""


@dataclasses.dataclass
class PlanCacheEntry:
    """Floors for replanning repeat traffic onto one dispatch signature:
    ONE ``PlanFloors`` holding the pow2 capacities a previous
    same-signature request actually USED (monotone: retry growth folds back
    via ``merged()``), plus the decided local path and admission price."""

    floors: PlanFloors
    local_path: str
    price_bytes: int
    splits: int
    hits: int = 0


@dataclasses.dataclass
class _Active:
    """In-flight request state: scattered operands + the static dispatch
    capacities (grown in place by the per-batch retry ladder)."""

    req: MultiplyRequest
    key: tuple
    plan: BatchPlan
    A: DistSparse
    B: DistSparse
    M: Optional[DistSparse]
    nb: int
    caps: BatchCaps
    sel_cap: int
    kb: Optional[BinnedCaps]
    bin_of_k: Optional[torch.Tensor]
    hc: Optional[HashCaps]
    mask_cap: int
    price: int
    splits: int
    plan_cached: bool
    was_deferred: bool
    t_submit: float
    bi: int = 0  # next batch to dispatch
    done_batches: int = 0
    retries: int = 0
    sel_retries: int = 0
    pieces: List[tuple] = dataclasses.field(default_factory=list)


def matrix_signature(req: MultiplyRequest, grid: Grid, cfg: ServeConfig) -> tuple:
    """Pow2-quantized request signature = the plan-cache key.

    Everything that feeds the fused step's static signature is quantized to
    a power of two here (nnz profile, scatter capacities, max per-column
    counts), so near-identical repeat traffic maps to one key, and the
    scatter capacities are taken FROM the signature, which is what makes two
    same-key requests produce identical operand shapes. Host math over the
    request's global operands: every rank of a grid computes the same key.
    """

    def prof(x: SparseCOO, kind: str):
        nnz = int(x.nnz)
        cols = _host(x.cols[:nnz])
        maxcol = int(np.bincount(cols).max()) if nnz else 0
        counts = tile_nnz_counts(x, grid, kind)
        cap = _rup_pow2(max(int(counts.max() * cfg.slack), 8))
        return (_rup_pow2(max(nnz, 1)), _rup_pow2(max(maxcol, 1)), cap)

    return (
        tuple(req.a.shape), tuple(req.b.shape),
        prof(req.a, "A"), prof(req.b, "B"),
        req.semiring.name, cfg.local_path, req.mask_id,
    )


def _batch_triplets(c: DistSparse, col_map: np.ndarray, grid: Grid):
    """Triplets (rows i64, cols i64, vals) of one sparse C batch in global
    coordinates, on the grid's device: every rank's tile is gathered over
    the grid, so every rank gets all of it. A tile's entries sit at its
    front, so only the fullest tile's prefix travels."""
    tm = c.tile_shape[0]
    N = grid.gather_grid(c.nnz[0, 0, 0])
    live = int(N.max())
    R, C, V = (grid.gather_grid(x[0, 0, 0, :live]) for x in (c.rows, c.cols, c.vals))
    valid = torch.arange(R.shape[-1], device=R.device) < N[..., None]
    i, j, kk, s = valid.nonzero(as_tuple=True)
    cmap = torch.as_tensor(col_map, dtype=torch.int64, device=R.device)
    return i * tm + R[i, j, kk, s].long(), cmap[j, kk, C[i, j, kk, s].long()], V[i, j, kk, s]


def _assemble(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, shape) -> SparseCOO:
    """Row-major ``SparseCOO`` of a product's triplets, on their device
    (``from_numpy_coo``'s layout: capacity max(nnz, 8), padding rows m,
    cols n, values 0). A product's coordinates are distinct; should two
    ever coincide, their values are summed."""
    m, n = shape
    key, order = torch.sort(rows * n + cols)
    vals = vals[order]
    uniq, inv = torch.unique_consecutive(key, return_inverse=True)
    if uniq.numel() < key.numel():
        vals = torch.zeros(uniq.shape, dtype=vals.dtype, device=vals.device).index_add_(
            0, inv, vals)
    nnz = uniq.numel()
    cap = max(nnz, 8)
    dev = uniq.device
    out = (torch.full((cap,), m, dtype=torch.int32, device=dev),
           torch.full((cap,), n, dtype=torch.int32, device=dev),
           torch.zeros((cap,), dtype=vals.dtype, device=dev))
    out[0][:nnz], out[1][:nnz], out[2][:nnz] = uniq // n, uniq % n, vals
    return SparseCOO(*out, torch.tensor(nnz, dtype=torch.int32, device=dev), (m, n))


class SpgemmEngine:
    """Plan-cached SpGEMM serving engine on one process grid.

    ``submit`` enqueues; ``step`` runs one tick (admit → dispatch one batch
    per active request → reap); ``run_to_completion`` drains everything and
    returns the results in completion order. On a grid of more than one
    process every rank submits the same stream and steps in lockstep.
    """

    def __init__(self, grid: Grid, cfg: Optional[ServeConfig] = None):
        self.grid = grid
        self.cfg = cfg or ServeConfig()
        self.queue: Deque[MultiplyRequest] = deque()
        self.active: List[_Active] = []
        self.done: List[MultiplyResult] = []
        self.plan_cache: Dict[tuple, PlanCacheEntry] = {}
        self.in_use = 0  # admitted bytes currently in flight
        self.stats = {"hits": 0, "misses": 0, "deferred": 0, "refused": 0,
                      "splits": 0, "served": 0}
        self._t_submit: Dict[int, float] = {}
        self._deferred_rids: set = set()
        self._head: Optional[_Active] = None  # priced-but-not-admitted head
        self._window = LookaheadWindow(self.cfg.lookahead, self._finish)

    # -- admission ---------------------------------------------------------
    def submit(self, req: MultiplyRequest) -> None:
        if req.mask is not None:
            assert req.mask_id is not None, "masked requests need a mask_id"
        self._t_submit[req.rid] = time.perf_counter()
        self.queue.append(req)

    def _price(self, req: MultiplyRequest) -> Tuple[Optional[_Active], str]:
        """Scatter + plan + price one request (the head of the queue).

        Splits the plan (force_num_batches doublings) while its footprint
        exceeds the budget; returns ``(None, reason)`` when no allowed split
        fits: the request is refused without dispatching anything.
        """
        cfg, grid = self.cfg, self.grid
        key = matrix_signature(req, grid, cfg)
        entry = self.plan_cache.get(key)
        cap_a, cap_b = key[2][2], key[3][2]  # pow2 scatter caps from the key
        A = scatter_to_grid(req.a, grid, "A", cap=cap_a)
        B = scatter_to_grid(req.b, grid, "B", cap=cap_b)
        M = scatter_to_grid(req.mask, grid, "A") if req.mask is not None else None
        floors = entry.floors if entry is not None else (cfg.seed_floors or PlanFloors())
        floors = floors.replace(caps_pow2=True)
        local_path = entry.local_path if entry is not None else cfg.local_path
        # the fullest tile of the whole grid, so every rank charges one price
        max_nnz_a = int(tile_nnz(A, grid).max())
        max_nnz_b = int(tile_nnz(B, grid).max())
        splits = entry.splits if entry is not None else 0
        force = None
        while True:
            try:
                plan = plan_batches(
                    A, B, grid, per_process_memory=cfg.per_process_memory,
                    spec=PlanSpec(
                        mask=M, local_path=local_path, slack=cfg.slack,
                        r_bytes=cfg.r_bytes, force_num_batches=force,
                    ),
                    floors=floors,
                )
            except MemoryError as e:
                return None, str(e)
            price = plan_footprint(
                plan.caps, plan.sel_cap, plan.hash_caps,
                r_bytes=cfg.r_bytes, max_nnz_a=max_nnz_a, max_nnz_b=max_nnz_b,
            )
            if price <= cfg.per_process_memory or splits >= cfg.max_splits:
                break
            splits += 1
            self.stats["splits"] += 1
            force = plan.num_batches * 2
        if price > cfg.per_process_memory:
            return None, (
                f"footprint {price} exceeds budget {cfg.per_process_memory} "
                f"after {splits} splits"
            )
        use_hash = plan.local_path == "hash"
        use_binned = (
            not use_hash and plan.local_path == "binned"
            and req.semiring.name == "plus_times"
        )
        kb = None
        if use_binned:
            kb = BinnedCaps(
                plan.kbin.num_bins, _rup_pow2(plan.kbin.bin_cap_a),
                _rup_pow2(plan.kbin.bin_cap_b),
            )
            prior_kb = entry.floors.kbin_caps if entry is not None else None
            if prior_kb is not None:
                kb = BinnedCaps(
                    kb.num_bins,
                    max(kb.bin_cap_a, prior_kb.bin_cap_a),
                    max(kb.bin_cap_b, prior_kb.bin_cap_b),
                )
        # the cache entry is written at PLAN time (not completion) so repeat
        # traffic hits even while the first request with this signature is
        # still in flight; completion folds any retry growth back in.
        if entry is not None:
            entry.hits += 1
            self.stats["hits"] += 1
        else:
            self.stats["misses"] += 1
            self.plan_cache[key] = PlanCacheEntry(
                floors=PlanFloors(
                    caps=plan.caps, sel_cap=plan.sel_cap,
                    num_batches=plan.num_batches,
                    kbin_caps=kb,
                    hash_caps=(plan.hash_caps if use_hash else None),
                    caps_pow2=True,
                ),
                local_path=plan.local_path,
                price_bytes=price, splits=splits,
            )
        return _Active(
            req=req, key=key, plan=plan, A=A, B=B, M=M,
            nb=plan.num_batches, caps=plan.caps, sel_cap=plan.sel_cap,
            kb=kb, bin_of_k=(torch.as_tensor(plan.kbin.bin_of_k, device=grid.device)
                             if use_binned else None),
            hc=(plan.hash_caps if use_hash else None),
            mask_cap=plan.mask_sel_cap, price=price, splits=splits,
            plan_cached=entry is not None,
            was_deferred=req.rid in self._deferred_rids,
            t_submit=self._t_submit.pop(req.rid, time.perf_counter()),
        ), ""

    def _admit(self) -> None:
        """FIFO admission: price the head, defer it while the in-flight work
        leaves no room (never overtaken), refuse what no split can fit."""
        while self.queue:
            req = self.queue[0]
            if self._head is None or self._head.req.rid != req.rid:
                act, reason = self._price(req)
                if act is None:
                    self.queue.popleft()
                    self.stats["refused"] += 1
                    self.done.append(MultiplyResult(
                        rid=req.rid, status="refused", c=None,
                        report=RunReport(), reason=reason,
                        was_deferred=req.rid in self._deferred_rids,
                    ))
                    self._deferred_rids.discard(req.rid)
                    continue
                self._head = act
            act = self._head
            if self.in_use > 0 and (
                self.in_use + act.price > self.cfg.per_process_memory
            ):
                if req.rid not in self._deferred_rids:
                    self._deferred_rids.add(req.rid)
                    self.stats["deferred"] += 1
                    act.was_deferred = True
                return  # FIFO: nothing behind the head may overtake it
            self.queue.popleft()
            self._deferred_rids.discard(req.rid)
            self._head = None
            self.in_use += act.price
            self.active.append(act)

    # -- dispatch / finish -------------------------------------------------
    def _dispatch(self, act: _Active, bi: int):
        """Enqueue batch ``bi``'s fused step; returns ``(c_batch, ovf)``
        with nothing waiting for the device."""
        return summa3d_fused_step(
            act.A, act.B, bi, act.bin_of_k, act.M,
            grid=self.grid, num_batches=act.nb, sel_cap=act.sel_cap,
            caps=act.caps, semiring=act.req.semiring, sorted_merge=True,
            path="sparse", kbin=act.kb, hashc=act.hc, mask_cap=act.mask_cap,
            mask_complement=False,
        )

    def _finish(self, act: _Active, bi: int, c_batch, ovf) -> None:
        """Window sync point: read batch bi's flags, retry if beaten, then
        gather the batch's triplets."""
        o = _host(ovf)
        for _ in range(self.cfg.max_retries):
            if not o.any():
                break
            act.retries += 1
            if o[0] > 0:
                act.sel_retries += 1
                act.sel_cap = min(
                    _rup8(max(act.sel_cap * 2, 8)), act.B.cap
                )
            elif o[1] > 0:
                act.caps = act.caps.doubled()
                act.hc = act.hc.doubled() if act.hc is not None else None
                act.kb = act.kb.doubled() if act.kb is not None else None
                if act.M is not None:
                    act.mask_cap = min(act.mask_cap * 2, act.M.cap)
            c_batch, ovf = self._dispatch(act, bi)
            o = _host(ovf)
        assert not o.any(), (
            f"rid {act.req.rid} batch {bi}: overflow persisted after "
            f"{self.cfg.max_retries} retries"
        )
        col_map = batch_column_map(
            act.B.shape[1], self.grid, act.nb, bi
        )
        act.pieces.append(_batch_triplets(c_batch, col_map, self.grid))
        act.done_batches += 1

    def _reap(self) -> None:
        for act in [a for a in self.active if a.done_batches == a.nb]:
            self.active.remove(act)
            self.in_use -= act.price
            rows, cols, vals = (torch.cat([p[f] for p in act.pieces]) for f in range(3))
            c = _assemble(rows, cols, vals, (act.A.shape[0], act.B.shape[1]))
            act.pieces.clear()
            # fold retry growth back into the entry (monotone floors)
            entry = self.plan_cache[act.key]
            entry.floors = entry.floors.merged(PlanFloors(
                caps=act.caps, sel_cap=act.sel_cap, num_batches=act.nb,
                kbin_caps=act.kb, hash_caps=act.hc, caps_pow2=True,
            ))
            entry.price_bytes = max(entry.price_bytes, act.price)
            self.stats["served"] += 1
            self.done.append(MultiplyResult(
                rid=act.req.rid, status="ok", c=c,
                report=RunReport(retries=act.retries,
                                 sel_retries=act.sel_retries),
                plan_cached=act.plan_cached, was_deferred=act.was_deferred,
                splits=act.splits,
                latency_ms=(time.perf_counter() - act.t_submit) * 1e3,
                price_bytes=act.price, num_batches=act.nb,
            ))

    # -- scheduling --------------------------------------------------------
    def step(self) -> int:
        """One engine tick. Returns the number of requests still in the
        system (queued + in flight)."""
        self._admit()
        progressed = False
        for act in list(self.active):
            if act.bi < act.nb:
                c_batch, ovf = self._dispatch(act, act.bi)
                self._window.push(act, act.bi, c_batch, ovf)
                act.bi += 1
                progressed = True
        if not progressed:
            self._window.drain()
        self._reap()
        return len(self.active) + len(self.queue)

    def run_to_completion(self, max_ticks: int = 100_000) -> List[MultiplyResult]:
        ticks = 0
        while (self.queue or self.active) and ticks < max_ticks:
            self.step()
            ticks += 1
        assert not (self.queue or self.active), "engine did not drain"
        return self.done

    def cache_hit_rate(self) -> float:
        total = self.stats["hits"] + self.stats["misses"]
        return self.stats["hits"] / total if total else 0.0
