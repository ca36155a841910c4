"""BatchedSUMMA3D (paper Alg. 4) + the distributed symbolic step (Alg. 3).

The driver follows the paper's phase structure:

  1. SYMBOLIC3D (``symbolic3d_counts``): one pass on the device that
     computes per-process flops upper bounds per output column, plus B's
     per-column entry counts (exact selection capacities) and the per-k
     counts of the gathered operands (the k-bin plan's input). Only count
     vectors reach the host, gathered over the whole grid, so every
     process plans the same batches.
  2. Host-side planning (``plan_from_symbolic``): b from Alg. 3 line 12
     (+ the Eq. 2 lower bound), rounded for block-cyclic divisibility;
     capacities for the numeric pass; the ESC / hash / k-binned decision.
  3. Pipelined per-batch schedule: ``summa3d.summa3d_fused_step`` per batch.
     The driver enqueues batch i+1 (and up to ``lookahead`` more) before it
     reads batch i's overflow flags, which stay on the device until the
     ``LookaheadWindow`` drains them.
  4. A ``postprocess`` hook transforms each batch product on the device
     right after its step, before the host ``consumer`` sees it.

Overflow robustness (§IV-A): a nonzero flag sends that batch through the
synchronous retry ladder — selection capacity first, then the multiply
capacities (2× per attempt). A doubling that would pass the memory
ceiling replans the batch at finer batching instead.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import semiring as sr
from .distsparse import DistSparse, from_tile, tile_nnz
from .grid import COL_AX, ROW_AX, Grid
from .placement import BLOCK_CYCLIC
from .sparse import hstack_remap
from .specs import ExecSpec, PlanFloors, PlanSpec
from .summa3d import BatchCaps, BinnedCaps, HashCaps, _squeeze_tile, summa3d_fused_step
from .symbolic import (
    HASH_LOAD_FACTOR,
    HASH_SLOT_BYTES,
    KBinPlan,
    SymbolicCounts,
    batch_count,
    batch_count_lower_bound,
    estimate_mem_c_bytes,
    plan_k_bins,
    rup8 as _rup8,
    rup_pow2 as _rup_pow2,
)
from ..runtime.driver import LookaheadWindow

# auto-dispatch threshold: the hash path pays a per-chunk insert pass, so it
# must buy at least this compression factor (flops per merged survivor)
# before the plan prefers it over ESC/binned.
HASH_CF_THRESHOLD = 2.0

# partial products enumerated per reused chunk buffer of the hash path
HASH_CHUNK_CAP = 4096

Tensor = torch.Tensor


def _host(x: Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Distributed symbolic step (Alg. 3)
# ---------------------------------------------------------------------------
def symbolic3d_counts(a: DistSparse, b: DistSparse, grid: Grid) -> SymbolicCounts:
    """Run the symbolic step on the device; see ``SymbolicCounts``.

    Instead of broadcasting tiles, A's per-column counts travel along the
    grid (gathered over columns and rows) and are contracted against this
    process's B entries — the same communicators as the numeric step with a
    far lighter payload (§IV-A, Fig. 8). Every process's count vectors are
    then gathered over the grid, so each process returns the same global
    arrays.
    """
    _, tn_b = b.tile_shape
    wl_b, _ = b.tile_shape
    dev = grid.device
    a_loc = _squeeze_tile(a, grid)
    b_loc = _squeeze_tile(b, grid)
    # A col counts of OUR row block over the per-layer contraction range,
    # ordered by stage (matches _gather_A indexing)
    cc_full = grid.all_gather(a_loc.col_counts(), COL_AX).reshape(-1)  # (k_tot,)
    cc_all = grid.all_gather(cc_full, ROW_AX)  # (pr, k_tot)
    k_tot = cc_full.shape[0]
    cc_all_pad = torch.cat(
        [cc_all, torch.zeros((cc_all.shape[0], 1), dtype=torch.int32, device=dev)], 1
    )
    # B entries in OUR tile: contraction index = i_own*wl_b + local row
    i_own = grid.axis_index(ROW_AX)
    valid = b_loc.valid_mask()
    k_idx = torch.where(valid, b_loc.rows + i_own * wl_b, torch.full_like(b_loc.rows, k_tot))
    contrib = cc_all_pad[:, k_idx.long()]  # (pr, capB): per target row block
    contrib = torch.where(valid[None, :], contrib, torch.zeros_like(contrib))
    segids = torch.where(valid, b_loc.cols, torch.full_like(b_loc.cols, tn_b)).long()
    percol_all = torch.zeros((tn_b + 1, contrib.shape[0]), dtype=torch.int32, device=dev)
    percol_all.index_add_(0, segids, contrib.T.contiguous())
    # sum over the row group -> each process reads its own row
    percol = grid.psum(percol_all[:tn_b].T, ROW_AX)[i_own]
    # B per-column entry counts and the per-k counts of the gathered B
    bcc = b_loc.col_counts()
    rc_full = grid.all_gather(b_loc.row_counts(), ROW_AX).reshape(-1)  # (k_tot,)
    # cc_full depends on (row block, layer) only, rc_full on (column block,
    # layer) only: slice the redundant grid axis away
    grid_host = lambda x: _host(grid.gather_grid(x)).astype(np.int64)
    return SymbolicCounts(
        percol=grid_host(percol),
        b_colcounts=grid_host(bcc),
        a_kcounts=grid_host(cc_full)[:, 0],  # (pr, l, k_tot)
        b_kcounts=grid_host(rc_full)[0],  # (pc, l, k_tot)
    )


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Host-side plan produced by the symbolic step."""

    num_batches: int
    lower_bound: int  # Eq. (2)
    caps: BatchCaps
    total_flops: int  # Σ multiply ops (global)
    max_unmerged_nnz: int  # max over processes, b=1
    per_batch_flops: np.ndarray  # (num_batches,) global flops per batch
    sel_cap: int = 0  # exact per-batch selection capacity (B entries)
    kbin: Optional[KBinPlan] = None  # k-bin plan for the paired local multiply
    local_path: str = "esc"  # plan-driven local-multiply decision
    hash_caps: Optional[HashCaps] = None  # static hash caps (local_path="hash")
    compression_est: float = 1.0  # flops per merged survivor (b=1, max proc)

    @property
    def binned_profitable(self) -> bool:
        """Does k-binning strictly cut pairing work (with num_bins > 1)?"""
        return (
            self.kbin is not None
            and self.kbin.num_bins > 1
            and self.kbin.pairings < self.kbin.pairings_unbinned
        )


def plan_batches(
    a: DistSparse,
    b: DistSparse,
    grid: Grid,
    per_process_memory: int,
    spec: Optional[PlanSpec] = None,
    floors: Optional[PlanFloors] = None,
) -> BatchPlan:
    """Run the symbolic step and derive b + capacities (host math).

    A bare call (no spec) plans ``local_path="esc"``; a passed spec uses its
    own default ("auto" — the driver's semantics). See
    ``plan_from_symbolic`` for the policy.
    """
    spec = spec if spec is not None else PlanSpec(local_path="esc")
    floors = floors if floors is not None else PlanFloors()
    counts = symbolic3d_counts(a, b, grid)
    nnz_a, nnz_b = tile_nnz(a, grid), tile_nnz(b, grid)
    inputs = PlanInputs(
        tm_a=a.tile_shape[0],
        max_nnz_a=int(nnz_a.max()),
        max_nnz_b=int(nnz_b.max()),
        nnz_a=int(nnz_a.sum()),
        nnz_b=int(nnz_b.sum()),
        cap_a=a.cap,
        cap_b=b.cap,
        p=grid.p,
    )
    return plan_from_symbolic(counts, inputs, per_process_memory, spec, floors)


@dataclasses.dataclass(frozen=True)
class PlanInputs:
    """Scalar operand facts ``plan_from_symbolic`` needs besides the count
    vectors — from scattered operands (``plan_batches``) or from host COO +
    a candidate grid shape (``PlanInputs.from_host``)."""

    tm_a: int  # A/C tile rows (m // pr)
    max_nnz_a: int  # max per-tile nnz of scattered A
    max_nnz_b: int
    nnz_a: int  # global nnz(A)
    nnz_b: int
    cap_a: int  # per-tile capacity of scattered A
    cap_b: int
    p: int  # process count pr*pc*l

    @classmethod
    def from_host(cls, a, b, grid_shape: Tuple[int, int, int],
                  cap_slack: float = 1.3, min_cap: int = 8) -> "PlanInputs":
        """Scalar facts for a candidate grid from host COO, with capacities
        by ``scatter_to_grid``'s default sizing rule."""
        from .symbolic import host_tile_counts

        def _cap(counts):
            return max(int(np.ceil(counts.max() * cap_slack)), min_cap)

        ca = host_tile_counts(a, grid_shape, "A")
        cb = host_tile_counts(b, grid_shape, "B")
        pr, pc, l = grid_shape
        return cls(
            tm_a=a.shape[0] // pr,
            max_nnz_a=int(ca.max()),
            max_nnz_b=int(cb.max()),
            nnz_a=int(a.nnz),
            nnz_b=int(b.nnz),
            cap_a=_cap(ca),
            cap_b=_cap(cb),
            p=pr * pc * l,
        )


def plan_from_symbolic(
    counts: SymbolicCounts,
    inputs: PlanInputs,
    per_process_memory: int,
    spec: PlanSpec,
    floors: PlanFloors,
) -> BatchPlan:
    """Pure host planning math — ``plan_batches`` minus the device pass.

    ``spec.local_path`` drives the 3-way local-multiply decision: "esc" and
    "binned" keep the classic O(flops)-scratch budget; "hash" budgets the
    hash path at O(nnz_out·load_factor) resident bytes; "auto" picks "hash"
    when the estimated compression factor clears ``HASH_CF_THRESHOLD``, else
    binned when binning strictly cuts pairings, else ESC. ``floors``
    pow2-quantize and floor the derived capacities so iterated multiplies
    keep one plan. ``spec.reserved_bytes`` is taken off the budget first
    (output already committed by the caller). Every fold of per-column
    counts into batches goes through the block-cyclic ``Distribution``.
    """
    r_bytes, slack = spec.r_bytes, spec.slack
    local_path = spec.local_path
    kbin_candidates = spec.kbin_candidates
    if kbin_candidates is None and floors.kbin_caps is not None:
        kbin_candidates = (floors.kbin_caps.num_bins,)
    if spec.reserved_bytes >= per_process_memory:
        raise MemoryError(
            f"reserved output bytes ({spec.reserved_bytes}) exceed per-process "
            f"memory ({per_process_memory})"
        )
    per_process_memory = per_process_memory - spec.reserved_bytes
    dist = BLOCK_CYCLIC
    percol = counts.percol  # (pr, pc, l, tn_b)
    pr, pc, l, tn_b = percol.shape
    per_process_flops = percol.sum(axis=-1)  # (pr, pc, l)
    max_unmerged = int(per_process_flops.max())
    total_flops = int(per_process_flops.sum())

    # hash-path resident bound (O(output)): the table holds MERGED
    # survivors, and a D-tile column cannot exceed tm_a distinct rows
    assert local_path in ("auto", "esc", "binned", "hash"), local_path
    tm_a = inputs.tm_a
    max_hash_nnz = int(np.minimum(percol, tm_a).sum(axis=-1).max())
    compression_est = max_unmerged / max(max_hash_nnz, 1)
    budget_hash = local_path == "hash" or (
        local_path == "auto" and compression_est >= HASH_CF_THRESHOLD
    )

    if spec.force_num_batches is not None:
        nb = spec.force_num_batches
    else:
        if budget_hash:
            # the stored intermediate is the table, not the expansion:
            # convert its byte footprint back to r-byte units for Alg. 3
            hash_bytes = estimate_mem_c_bytes(
                max_unmerged, compression_est, r_bytes,
                local_path="hash", load_factor=HASH_LOAD_FACTOR,
            )
            budget_nnz = max(-(-hash_bytes // r_bytes), 1)
        else:
            budget_nnz = max_unmerged
        nb = max(
            batch_count(
                budget_nnz, inputs.max_nnz_a, inputs.max_nnz_b,
                per_process_memory, r=r_bytes,
            ),
            floors.num_batches,
        )
    nb = dist.round_batches(tn_b, nb, l)

    # per-(process, batch, piece) flops via the distribution's fold
    flops_pbp = dist.fold(percol, nb, l)  # (pr,pc,l,nb,l)
    per_batch_proc = flops_pbp.sum(axis=-1)  # (pr,pc,l,nb)
    max_batch_flops = int(per_batch_proc.max())
    max_batch_d = max_batch_flops
    max_piece_flops = int(flops_pbp.max())
    # merged C piece bound: sum over source layers
    merged_piece = dist.fold(percol.sum(axis=2), nb, l).max()

    wb = tn_b // nb
    flops_cap = _rup8(max(int(max_batch_flops * slack), 64))
    d_cap = _rup8(
        min(max(int(max_batch_d * slack), 64), flops_cap, tm_a * wb)
    )
    piece_cap = _rup8(min(max(int(max_piece_flops * slack), 64), tm_a * (wb // l)))
    c_cap = _rup8(min(max(int(merged_piece * slack), 64), tm_a * (wb // l)))
    caps = BatchCaps(flops_cap=flops_cap, d_cap=d_cap, piece_cap=piece_cap, c_cap=c_cap)

    # exact per-batch selection capacity: max over (process, batch) of the
    # number of B entries the selection keeps
    sel_per_batch = dist.fold(counts.b_colcounts, nb, l).sum(axis=-1)
    sel_cap = min(_rup8(max(int(sel_per_batch.max()), 8)), inputs.cap_b)

    if floors.caps_pow2:
        caps = BatchCaps(*(_rup_pow2(x) for x in dataclasses.astuple(caps)))
        sel_cap = min(_rup_pow2(sel_cap), inputs.cap_b)
    if floors.caps is not None:
        caps = BatchCaps(*(
            max(x, y) for x, y in zip(
                dataclasses.astuple(caps), dataclasses.astuple(floors.caps)
            )
        ))
    sel_cap = max(sel_cap, floors.sel_cap)

    # k-bin plan for the gathered pairing: per-k count vectors bounded
    # element-wise over (block, layer); gathered capacities are
    # pc·capA / pr·sel_cap slots
    kbin_kwargs = (
        {"candidates": tuple(kbin_candidates)} if kbin_candidates else {}
    )
    kbin = plan_k_bins(
        counts.a_kcounts.max(axis=(0, 1)),
        counts.b_kcounts.max(axis=(0, 1)),
        pc * inputs.cap_a,
        pr * sel_cap,
        **kbin_kwargs,
    )

    # Eq. (2) lower bound (global memory form) for reporting/validation
    try:
        lb = batch_count_lower_bound(
            r_bytes * total_flops, per_process_memory * inputs.p,
            inputs.nnz_a, inputs.nnz_b, r=r_bytes,
        )
    except MemoryError:
        lb = -1

    if budget_hash:
        decided = "hash"
    elif local_path in ("esc", "binned"):
        decided = local_path
    else:  # auto, hash not profitable: structural binned-vs-ESC preference
        decided = (
            "binned"
            if kbin.num_bins > 1 and kbin.pairings < kbin.pairings_unbinned
            else "esc"
        )
    hash_caps = None
    if decided == "hash":
        chunk = min(caps.flops_cap, _rup8(HASH_CHUNK_CAP))
        num_chunks = -(-caps.flops_cap // chunk)
        table = _rup_pow2(max(int(HASH_LOAD_FACTOR * caps.d_cap), 64))
        hash_caps = HashCaps(table_cap=table, chunk_cap=chunk, num_chunks=num_chunks)
        if floors.hash_caps is not None:
            hash_caps = _emax_hash(hash_caps, floors.hash_caps)

    return BatchPlan(
        num_batches=nb,
        lower_bound=lb,
        caps=caps,
        total_flops=total_flops,
        max_unmerged_nnz=max_unmerged,
        per_batch_flops=per_batch_proc.sum(axis=(0, 1, 2)),
        sel_cap=sel_cap,
        kbin=kbin,
        local_path=decided,
        hash_caps=hash_caps,
        compression_est=float(compression_est),
    )


def _emax_hash(x: HashCaps, y: HashCaps) -> HashCaps:
    return HashCaps(*(max(p, q) for p, q in zip(dataclasses.astuple(x),
                                                 dataclasses.astuple(y))))


def batch_column_map(n: int, grid: Grid, num_batches: int, batch: int) -> np.ndarray:
    """Global columns covered by ``batch``, in C-tile order: g[j, k, c] of
    shape (pc, l, wb/l) is the global column of local column c in C tile
    (:, j, k) for this batch."""
    return BLOCK_CYCLIC.batch_column_map(n, grid.pc, grid.l, num_batches, batch)


# ---------------------------------------------------------------------------
# The batched driver (Alg. 4) — pipelined scheduler
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RunReport:
    """Structured robustness accounting for one driver run."""

    retries: int = 0  # overflow retry dispatches (sync ladder steps)
    sel_retries: int = 0  # selection-capacity retries among those
    replans: int = 0  # batches replanned at finer batching (degradation)
    ladder_blocked: int = 0  # cap doublings refused by the memory ceiling
    degraded_batches: Tuple[Tuple[int, int], ...] = ()  # (batch, split)

    def merged(self, other: "RunReport") -> "RunReport":
        """Field-wise accumulation (counts add, degradations concatenate)."""
        return RunReport(*(
            x + y for x, y in zip(dataclasses.astuple(self), dataclasses.astuple(other))
        ))


def plan_footprint(
    caps: BatchCaps,
    sel_cap: int,
    hash_caps: Optional[HashCaps],
    *,
    r_bytes: int,
    max_nnz_a: int,
    max_nnz_b: int,
    reserved_bytes: int = 0,
) -> int:
    """Per-process bytes a capacity plan commits to, aligned with Alg. 3's
    budget: ``r`` bytes per stored entry of inputs + selection + the batch's
    stored intermediate (ESC/binned expansion scratch, or the hash table +
    merged survivors), plus the caller's reserved output bytes. The retry
    ladder prices cap doublings against it."""
    if hash_caps is not None:
        inter = hash_caps.table_cap * HASH_SLOT_BYTES + r_bytes * caps.d_cap
    else:
        inter = r_bytes * caps.flops_cap
    return r_bytes * (max_nnz_a + max_nnz_b + sel_cap) + inter + reserved_bytes


class _LadderBlocked(Exception):
    """Raised inside the retry ladder when the next cap doubling would pass
    the per-process memory ceiling — caught by the degradation path, which
    replans the batch at finer batching instead."""


def _merge_split_batches(parts: Tuple[DistSparse, ...], grid: Grid) -> DistSparse:
    """Column-concat ``d`` sub-batch products (finer plan ``nb·d``) back into
    ONE batch of the original ``nb``-batch plan.

    Original batch ``bi`` under plan ``nb`` covers the same global columns as
    batches ``{d·bi, …, d·bi+d−1}`` under plan ``nb·d``, and sub-batch
    ``d·bi+q``'s tile holds slice ``q`` (width ``wbl/d``) of every original
    batch block — so the merge is an offset column concat + row-major
    resort, and consumers see the undegraded batch's entry set.
    """
    widths = [parts[0].tile_shape[1]] * len(parts)
    cap = sum(p.cap for p in parts)
    merged, _ = hstack_remap([_squeeze_tile(p, grid) for p in parts], widths, cap)
    shape = (parts[0].shape[0], parts[0].shape[1] * len(parts))
    return from_tile(merged.sort_rowmajor(), shape, grid, "C")


@dataclasses.dataclass
class BatchedResult:
    plan: BatchPlan
    num_retries: int
    consumed: list  # consumer outputs per batch
    binned_caps: Optional[BinnedCaps] = None  # the BinnedCaps used
    local_path: str = "esc"  # local multiply actually executed
    hash_caps: Optional[HashCaps] = None  # the HashCaps used (hash)
    report: RunReport = dataclasses.field(default_factory=RunReport)

    def floors(self) -> PlanFloors:
        """The capacities this run actually used, as the ``PlanFloors`` an
        iterated caller merges into its next plan (pow2 quantization on)."""
        return PlanFloors(
            caps=self.plan.caps,
            sel_cap=self.plan.sel_cap,
            num_batches=self.plan.num_batches,
            kbin_caps=self.binned_caps,
            hash_caps=self.hash_caps,
            caps_pow2=True,
        )


def batched_summa3d(
    a: DistSparse,
    b: DistSparse,
    grid: Grid,
    per_process_memory: int,
    consumer: Callable[[int, object, np.ndarray], object],
    path: str = "sparse",
    semiring: sr.Semiring = sr.PLUS_TIMES,
    spec: Optional[PlanSpec] = None,
    floors: Optional[PlanFloors] = None,
    exec_spec: Optional[ExecSpec] = None,
    postprocess: Optional[Callable[[int, object], object]] = None,
) -> BatchedResult:
    """Multiply A·B in batches; the consumer sees each batch, then it is freed.

    ``consumer(batch_idx, c_batch, global_col_map)`` receives per batch,
    in batch order, a C-kind ``DistSparse`` (``path="sparse"``) or this
    process's dense f32 tile as (1, 1, 1, tm, wb/l) (``path="dense"``: the
    densify + SpMM local multiply, sum monoids only) — or ``postprocess``'s
    output for it. ``spec`` (`PlanSpec`) holds the planning policy,
    ``floors`` (`PlanFloors`) the cross-run capacity pins, ``exec_spec`` (`ExecSpec`)
    the schedule: ``pipelined=True`` enqueues up to ``lookahead`` batches
    ahead of the one whose overflow flags it reads; ``pipelined=False`` is
    the serial schedule, one host sync per batch. Both give identical
    batches.

    ``spec.local_path`` is the sparse path's plan-driven 3-way dispatch
    (the dense path plans the ESC budget): "auto" lets the plan pick (hash
    when the compression factor clears ``HASH_CF_THRESHOLD``, else binned
    when binning strictly cuts pairings and the semiring is plus_times,
    else ESC); "hash"/"binned"/"esc" force a path. One decision is made per
    plan, never per batch.

    The retry ladder is bounded by the memory ceiling
    ``max(per_process_memory, footprint(planned caps))``: a batch whose next
    doubling would pass it is replanned as ``d`` sub-batches under a
    ``nb·d`` plan and merged back, recorded in ``BatchedResult.report``.
    """
    spec = spec if spec is not None else PlanSpec()
    floors = floors if floors is not None else PlanFloors()
    ex = exec_spec if exec_spec is not None else ExecSpec()
    r_bytes = spec.r_bytes
    local_path = spec.local_path
    max_retries = ex.max_retries
    assert local_path in ("auto", "esc", "binned", "hash"), local_path
    assert path in ("sparse", "dense"), path
    dense = path == "dense"
    plan = plan_batches(
        a, b, grid, per_process_memory,
        spec=spec.replace(local_path="esc") if dense and local_path == "auto" else spec,
        floors=floors,
    )
    nb = plan.num_batches
    n_cols = b.shape[1]

    use_hash = not dense and plan.local_path == "hash"
    if use_hash or local_path == "esc" or dense:
        use_binned = False
    elif local_path == "binned":
        use_binned = True
    else:
        use_binned = semiring.name == "plus_times" and plan.binned_profitable
    if use_binned and semiring.name != "plus_times":
        raise ValueError(
            f"k-binned local multiply requires plus_times, got {semiring.name}"
        )
    kb = (
        BinnedCaps(plan.kbin.num_bins, plan.kbin.bin_cap_a, plan.kbin.bin_cap_b)
        if use_binned else None
    )
    if kb is not None and floors.caps_pow2:
        kb = BinnedCaps(kb.num_bins, _rup_pow2(kb.bin_cap_a), _rup_pow2(kb.bin_cap_b))
    if kb is not None and floors.kbin_caps is not None:
        assert kb.num_bins == floors.kbin_caps.num_bins, (
            "a kbin_caps floor requires a pinned bin count"
        )
        kb = BinnedCaps(
            kb.num_bins,
            max(kb.bin_cap_a, floors.kbin_caps.bin_cap_a),
            max(kb.bin_cap_b, floors.kbin_caps.bin_cap_b),
        )
    bin_of_k = (
        torch.as_tensor(plan.kbin.bin_of_k, device=grid.device) if use_binned else None
    )
    hc = plan.hash_caps if use_hash else None

    caps, sel_cap = plan.caps, plan.sel_cap
    retries = 0
    rep = {"sel_retries": 0, "replans": 0, "ladder_blocked": 0, "degraded": []}

    max_nnz_a = int(tile_nnz(a, grid).max())
    max_nnz_b = int(tile_nnz(b, grid).max())

    def _footprint(caps_: BatchCaps, sel_cap_: int, hc_) -> int:
        return plan_footprint(
            caps_, sel_cap_, hc_, r_bytes=r_bytes, max_nnz_a=max_nnz_a,
            max_nnz_b=max_nnz_b, reserved_bytes=spec.reserved_bytes,
        )

    # a plan may exceed the strict budget (slack makes that routine at tight
    # budgets), but the ladder never grows beyond whichever is larger
    ladder_ceiling = max(per_process_memory, _footprint(caps, sel_cap, hc))

    def dispatch(bi: int, caps_: BatchCaps, sel_cap_: int, kb_, hc_,
                 num_batches: int = nb, bok=bin_of_k):
        """Enqueue one fused batch step; nothing waits for the device here."""
        return summa3d_fused_step(
            a, b, bi, bok, grid=grid, num_batches=num_batches, sel_cap=sel_cap_,
            caps=caps_, semiring=semiring, path=path, kbin=kb_, hashc=hc_,
        )

    # capacities actually used, including retry growth — reported on the
    # returned plan so iterated callers floor their next plan on them
    used = {"caps": caps, "sel": sel_cap, "kb": kb, "hashc": hc}

    def grow(o: np.ndarray, caps_: BatchCaps, sel_cap_: int, kb_, hc_,
             record: bool = True):
        """Next capacity plan after an overflow: selection first (a truncated
        selection makes the multiply flags unreliable), multiply second.
        A multiply-cap doubling past the memory ceiling raises
        `_LadderBlocked`. ``record=False`` (degraded sub-batches)
        skips the ``used`` bookkeeping."""
        if o[0] > 0:
            sel_cap_ = min(_rup8(max(sel_cap_ * 2, 8)), b.cap)
            rep["sel_retries"] += 1
        elif o[1] > 0:
            cand_caps = caps_.doubled()
            cand_hc = hc_.doubled() if hc_ is not None else None
            if _footprint(cand_caps, sel_cap_, cand_hc) > ladder_ceiling:
                rep["ladder_blocked"] += 1
                raise _LadderBlocked(
                    f"cap doubling to {cand_caps} exceeds the "
                    f"{ladder_ceiling}-byte ceiling"
                )
            caps_, hc_ = cand_caps, cand_hc
            kb_ = kb_.doubled() if kb_ is not None else None
        if not record:
            return caps_, sel_cap_, kb_, hc_
        used["sel"] = max(used["sel"], sel_cap_)
        used["caps"] = BatchCaps(*(
            max(x, y) for x, y in zip(
                dataclasses.astuple(used["caps"]), dataclasses.astuple(caps_)
            )
        ))
        if kb_ is not None:
            used["kb"] = BinnedCaps(
                kb_.num_bins,
                max(used["kb"].bin_cap_a, kb_.bin_cap_a),
                max(used["kb"].bin_cap_b, kb_.bin_cap_b),
            )
        if hc_ is not None:
            used["hashc"] = _emax_hash(used["hashc"], hc_)
        return caps_, sel_cap_, kb_, hc_

    def run_batch_sync(bi: int, caps_: BatchCaps, sel_cap_: int, kb_, hc_,
                       dispatch_fn=None, record: bool = True):
        """The synchronous retry loop (§IV-A robustness)."""
        nonlocal retries
        dispatch_fn = dispatch_fn or dispatch
        for _ in range(max_retries + 1):
            c_batch, ovf = dispatch_fn(bi, caps_, sel_cap_, kb_, hc_)
            o = _host(ovf)
            if not o.any():
                return c_batch
            retries += 1
            caps_, sel_cap_, kb_, hc_ = grow(o, caps_, sel_cap_, kb_, hc_, record=record)
        raise RuntimeError(
            f"batch {bi}: capacity overflow persisted after {max_retries} retries"
        )

    def run_batch_degraded(bi: int):
        """Graceful degradation: batch ``bi``'s columns rerun as ``d``
        sub-batches under a finer ``nb·d`` plan, then merge back to the
        original batch extent. The split doubles while a sub-batch still hits
        the ceiling; a split finer than the columns allow raises."""
        forced = "hash" if use_hash else ("binned" if use_binned else "esc")
        d = 2
        while True:
            try:
                # a fresh sub-plan: caller floors and bin pins do not apply
                sub = plan_batches(
                    a, b, grid, per_process_memory,
                    spec=spec.replace(
                        local_path=forced, force_num_batches=nb * d,
                        kbin_candidates=None,
                    ),
                )
            except MemoryError as e:
                raise RuntimeError(
                    f"batch {bi}: memory ceiling hit and no finer batching "
                    f"fits (split {d}x): {e}"
                ) from e
            nb_f = sub.num_batches
            if nb_f % nb != 0:
                # divisibility rounding broke sub-batch alignment — go finer
                d = nb_f // nb + 1
                continue
            d_eff = nb_f // nb
            sub_kb = (
                BinnedCaps(sub.kbin.num_bins, sub.kbin.bin_cap_a, sub.kbin.bin_cap_b)
                if use_binned else None
            )
            sub_bin = (
                torch.as_tensor(sub.kbin.bin_of_k, device=grid.device)
                if use_binned else None
            )
            sub_hc = sub.hash_caps if use_hash else None
            sub_dispatch = functools.partial(dispatch, num_batches=nb_f, bok=sub_bin)
            try:
                parts = [
                    run_batch_sync(
                        d_eff * bi + q, sub.caps, sub.sel_cap, sub_kb, sub_hc,
                        dispatch_fn=sub_dispatch, record=False,
                    )
                    for q in range(d_eff)
                ]
            except _LadderBlocked:
                d = d_eff * 2  # a sub-batch still over budget: split finer
                continue
            rep["replans"] += 1
            rep["degraded"].append((bi, d_eff))
            if dense:
                return torch.cat(parts, dim=-1)
            return _merge_split_batches(tuple(parts), grid)

    def run_batch_guarded(bi: int):
        try:
            return run_batch_sync(bi, caps, sel_cap, kb, hc)
        except _LadderBlocked:
            return run_batch_degraded(bi)

    consumed = []

    def post(bi: int, c_batch):
        """Apply the device-side hook (enqueued, nothing waits here)."""
        return postprocess(bi, c_batch) if postprocess is not None else c_batch

    def finish(bi: int, c_post, ovf) -> None:
        """Sync point: read batch bi's flags, retry if beaten, consume."""
        nonlocal retries
        o = _host(ovf)
        if o.any():
            retries += 1
            # the speculatively postprocessed batch was built from a garbage
            # product — recompute synchronously and re-run the hook on it
            try:
                c_batch = run_batch_sync(bi, *grow(o, caps, sel_cap, kb, hc))
            except _LadderBlocked:
                c_batch = run_batch_degraded(bi)
            c_post = post(bi, c_batch)
        consumed.append(consumer(bi, c_post, batch_column_map(n_cols, grid, nb, bi)))

    if not ex.pipelined:
        for bi in range(nb):
            c_batch = post(bi, run_batch_guarded(bi))
            consumed.append(consumer(bi, c_batch, batch_column_map(n_cols, grid, nb, bi)))
    else:
        window = LookaheadWindow.from_exec(ex, finish)
        for bi in range(nb):
            c_batch, ovf = dispatch(bi, caps, sel_cap, kb, hc)
            window.push(bi, post(bi, c_batch), ovf)
        window.drain()
    # report the capacities actually used (incl. any retry growth)
    plan = dataclasses.replace(
        plan, caps=used["caps"], sel_cap=used["sel"], hash_caps=used["hashc"],
    )
    executed = "hash" if use_hash else ("binned" if use_binned else "esc")
    report = RunReport(
        retries=retries, sel_retries=rep["sel_retries"],
        replans=rep["replans"], ladder_blocked=rep["ladder_blocked"],
        degraded_batches=tuple(rep["degraded"]),
    )
    return BatchedResult(
        plan=plan, num_retries=retries, consumed=consumed,
        binned_caps=used["kb"], local_path=executed, hash_caps=used["hashc"],
        report=report,
    )
