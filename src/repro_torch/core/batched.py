"""BatchedSUMMA3D (paper Alg. 4) + the distributed symbolic step (Alg. 3).

The driver follows the paper's phase structure:

  1. SYMBOLIC3D (``symbolic3d_counts``): one pass on the device that
     computes per-process flops upper bounds per output column, plus B's
     per-column entry counts (exact selection capacities) and the per-k
     counts of the gathered operands (the k-bin plan's input), and a
     mask's per-tile column counts for a masked plan. Only count vectors
     reach the host, gathered over the whole grid, so every process plans
     the same batches.
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
ceiling replans the batch at finer batching instead (``ExecSpec.degrade``;
off, the ladder is unbounded).

``plan_batches`` and ``batched_summa3d`` still take the old keyword
surface (``slack=``, ``caps_floor=``, ``lookahead=``, …) through
``specs.resolve_specs``, under a ``DeprecationWarning``.
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
from .placement import BLOCK_CYCLIC, Placement
from .sparse import hstack_remap
from .specs import ExecSpec, PlanFloors, PlanSpec, resolve_specs
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
def symbolic3d_counts(
    a: DistSparse, b: DistSparse, grid: Grid, mask: Optional[DistSparse] = None,
) -> SymbolicCounts:
    """Run the symbolic step on the device; see ``SymbolicCounts``.

    Instead of broadcasting tiles, A's per-column counts travel along the
    grid (gathered over columns and rows) and are contracted against this
    process's B entries — the same communicators as the numeric step with a
    far lighter payload (§IV-A, Fig. 8). Every process's count vectors are
    then gathered over the grid, so each process returns the same global
    arrays. ``mask`` (C-layout, the product's shape) adds its exact
    per-(tile, local column) entry counts, the masked plan's input: only
    that (pr, pc, l, wl) count array reaches the host, never the mask.
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
    mask_cc = None
    if mask is not None:
        assert mask.kind in ("A", "C"), mask.kind
        assert mask.shape == (a.shape[0], b.shape[1]), (mask.shape, a.shape, b.shape)
        mask_cc = grid_host(_squeeze_tile(mask, grid).col_counts())
    return SymbolicCounts(
        percol=grid_host(percol),
        b_colcounts=grid_host(bcc),
        a_kcounts=grid_host(cc_full)[:, 0],  # (pr, l, k_tot)
        b_kcounts=grid_host(rc_full)[0],  # (pc, l, k_tot)
        mask_colcounts=mask_cc,
    )


def symbolic3d(a: DistSparse, b: DistSparse, grid: Grid) -> np.ndarray:
    """Per-(process, local column of B) flops upper bound, (pr, pc, l, tn_b)
    on the host:

      flops[i,j,k,c] = Σ_{t ∈ B(:, block j, layer k), col(t)=c}
                           nnz(A^(k)(row-block i, k_idx(t)))

    the partial products process (i, j, k) forms for output column c in the
    numeric step. ``symbolic3d_counts`` gives the fuller payload."""
    return symbolic3d_counts(a, b, grid).percol


def _mask_tile_colcounts(mask: DistSparse, grid: Grid) -> np.ndarray:
    """Host oracle of the masked counts ``symbolic3d_counts`` makes on the
    device: every tile's entries per local column, (pr, pc, l, wl), from the
    mask's column indices gathered to the host."""
    C = _host(grid.gather_grid(mask.cols[0, 0, 0]))
    N = _host(grid.gather_grid(mask.nnz[0, 0, 0]))
    pr, pc, l, cap = C.shape
    tn = mask.tile_shape[1]
    valid = np.arange(cap)[None, None, None, :] < N[..., None]
    tile = np.arange(pr * pc * l).reshape(pr, pc, l, 1)
    flat = tile * (tn + 1) + np.where(valid, C, tn)
    cnt = np.bincount(flat.ravel(), minlength=pr * pc * l * (tn + 1))
    return cnt.reshape(pr, pc, l, tn + 1)[..., :tn].astype(np.int64)


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Host-side plan produced by the symbolic step."""

    num_batches: int
    lower_bound: int  # Eq. (2)
    caps: BatchCaps
    total_flops: int  # Σ multiply ops (global)
    max_unmerged_nnz: int  # max over processes, b=1 (mask-filtered if masked)
    per_batch_flops: np.ndarray  # (num_batches,) global flops per batch
    sel_cap: int = 0  # exact per-batch selection capacity (B entries)
    kbin: Optional[KBinPlan] = None  # k-bin plan for the paired local multiply
    mask_sel_cap: int = 0  # exact per-batch mask-slice capacity (masked only)
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
    **legacy,
) -> BatchPlan:
    """Run the symbolic step and derive b + capacities (host math).

    A bare call (no spec) plans ``local_path="esc"``; a passed spec uses its
    own default ("auto" — the driver's semantics). The old keyword surface
    (``r_bytes=``, ``slack=``, ``caps_floor=``, …) maps onto the specs
    under a ``DeprecationWarning``. See ``plan_from_symbolic`` for the
    policy.
    """
    spec, floors, _ = resolve_specs(
        spec, floors, None, legacy, default_local_path="esc",
        where="plan_batches", allow_exec=False,
    )
    counts = symbolic3d_counts(a, b, grid, mask=spec.mask)
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
        cap_mask=spec.mask.cap if spec.mask is not None else None,
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
    cap_mask: Optional[int] = None  # per-tile capacity of the scattered mask

    @classmethod
    def from_host(cls, a, b, grid_shape: Tuple[int, int, int], mask=None,
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
            cap_mask=(_cap(host_tile_counts(mask, grid_shape, "C"))
                      if mask is not None else None),
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
    counts into batches goes through ``spec.distribution`` (None: the
    block-cyclic ``Distribution``).

    A strict mask (``counts.mask_colcounts`` without
    ``spec.mask_complement``) bounds the survivors per column c of process
    (i, j, k): unmerged ≤ min(flops[c], mask[c] · nnz(B gathered, c)),
    merged D ≤ min(flops[c], mask[c]), merged C ≤ min(Σ_k flops[k][c],
    mask[c]); so the budget, b and the D/piece/C capacities shrink to the
    survivors. A complement mask cannot tighten them. ``mask_sel_cap``
    sizes the per-batch mask slice from the exact mask counts.
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
    dist = spec.distribution if spec.distribution is not None else BLOCK_CYCLIC
    percol = counts.percol  # (pr, pc, l, tn_b)
    pr, pc, l, tn_b = percol.shape
    masked = counts.mask_colcounts is not None and not spec.mask_complement
    if masked:
        # mcount[i, j, c]: mask entries of block (i, j) at block-local column
        # c — the (l, wl) mask tiles, layer-major, cover the tn_b columns
        mcount = counts.mask_colcounts.reshape(pr, pc, tn_b)
        bcolg = counts.b_colcounts.sum(axis=0, keepdims=True)  # (1, pc, l, tn_b)
        unmerged_percol = np.minimum(percol, mcount[:, :, None, :] * bcolg)
        merged_d_percol = np.minimum(percol, mcount[:, :, None, :])
    else:
        unmerged_percol = merged_d_percol = percol
    per_process_flops = percol.sum(axis=-1)  # (pr, pc, l)
    max_unmerged = int(unmerged_percol.sum(axis=-1).max())
    total_flops = int(per_process_flops.sum())

    # hash-path resident bound (O(output)): the table holds MERGED
    # survivors, and a D-tile column cannot exceed tm_a distinct rows
    assert local_path in ("auto", "esc", "binned", "hash"), local_path
    tm_a = inputs.tm_a
    max_hash_nnz = int(np.minimum(merged_d_percol, tm_a).sum(axis=-1).max())
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
    # D-tile bounds from the mask-filtered counts (the filter runs before
    # the compress, so only survivors take the D buffers)
    d_pbp = dist.fold(merged_d_percol, nb, l)
    max_batch_d = int(d_pbp.sum(axis=-1).max())
    max_piece_flops = int(d_pbp.max())
    # merged C piece bound: sum over source layers, mask-capped per column
    merged_col = percol.sum(axis=2)  # (pr, pc, tn_b)
    if masked:
        merged_col = np.minimum(merged_col, mcount)
    merged_piece = dist.fold(merged_col, nb, l).max()

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

    # exact per-batch mask-slice capacity: batch bi selects the contiguous
    # local columns [bi·wbl, (bi+1)·wbl) of every mask tile
    mask_sel_cap = 0
    if counts.mask_colcounts is not None:
        per_batch_mask = dist.fold_batch_slices(counts.mask_colcounts, nb)
        mask_sel_cap = min(_rup8(max(int(per_batch_mask.max()), 8)), inputs.cap_mask)

    if floors.caps_pow2:
        caps = BatchCaps(*(_rup_pow2(x) for x in dataclasses.astuple(caps)))
        sel_cap = min(_rup_pow2(sel_cap), inputs.cap_b)
        if counts.mask_colcounts is not None:
            mask_sel_cap = min(_rup_pow2(mask_sel_cap), inputs.cap_mask)
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
        mask_sel_cap=mask_sel_cap,
        local_path=decided,
        hash_caps=hash_caps,
        compression_est=float(compression_est),
    )


def _emax_hash(x: HashCaps, y: HashCaps) -> HashCaps:
    return HashCaps(*(max(p, q) for p, q in zip(dataclasses.astuple(x),
                                                 dataclasses.astuple(y))))


def probe_memory_budget(
    a: DistSparse, b: DistSparse, grid: Grid,
    r_bytes: int = 12, fraction: int = 3, floor: int = 256,
) -> int:
    """A per-process budget that makes the unmasked ESC plan batch: inputs
    plus 1/``fraction`` of the fullest process's unmerged output."""
    probe = plan_batches(a, b, grid, per_process_memory=1 << 30,
                         spec=PlanSpec(local_path="esc", r_bytes=r_bytes))
    inputs = r_bytes * (int(tile_nnz(a, grid).max()) + int(tile_nnz(b, grid).max()))
    return inputs + max(r_bytes * probe.max_unmerged_nnz // fraction, floor)


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
    """Structured robustness accounting for one driver run or iterated loop.

    ``batched_summa3d`` fills the ladder fields (retries / replans /
    degradations); the resilient iterated loops merge per-iteration reports
    and add the checkpoint / straggler / restart fields. JSON round-trips
    via ``to_dict``/``from_dict``, so the report survives a checkpoint.
    """

    retries: int = 0  # overflow retry dispatches (sync ladder steps)
    sel_retries: int = 0  # selection-capacity retries among those
    replans: int = 0  # batches replanned at finer batching (degradation)
    ladder_blocked: int = 0  # cap doublings refused by the memory ceiling
    degraded_batches: Tuple[Tuple[int, int], ...] = ()  # (batch, split)
    straggler_events: int = 0  # EWMA watchdog firings (iterated loops)
    restarts: int = 0  # preemption restore-and-continue count
    refused_restores: int = 0  # corrupt checkpoints refused at restore
    checkpoint_stalls: int = 0  # saves that blocked on a prior in-flight write
    checkpoint_stall_s: float = 0.0
    checkpoint_bytes: int = 0  # total checkpoint bytes written

    def merged(self, other: "RunReport") -> "RunReport":
        """Field-wise accumulation (counts add, degradations concatenate)."""
        return RunReport(*(
            x + y for x, y in zip(dataclasses.astuple(self), dataclasses.astuple(other))
        ))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["degraded_batches"] = [list(x) for x in self.degraded_batches]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RunReport":
        d = dict(d)
        d["degraded_batches"] = tuple(
            tuple(int(v) for v in x) for x in d.get("degraded_batches", ())
        )
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


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
    binned: bool = False  # did the sparse local multiply run k-binned?
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
    **legacy,
) -> BatchedResult:
    """Multiply A·B in batches; the consumer sees each batch, then it is freed.

    ``consumer(batch_idx, c_batch, global_col_map)`` receives per batch,
    in batch order, a C-kind ``DistSparse`` (``path="sparse"``) or this
    process's dense f32 tile as (1, 1, 1, tm, wb/l) (``path="dense"``: the
    densify + SpMM local multiply, sum monoids only) — or ``postprocess``'s
    output for it. ``spec`` (`PlanSpec`) holds the planning policy and the mask,
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

    ``spec.mask`` runs the masked multiply (paper §V-B): every batch's step
    selects the batch's slice of the C-layout mask and keeps C ⊙ M (or
    C ⊙ ¬M with ``spec.mask_complement``); the mask never leaves the grid.

    ``exec_spec.binned`` is the legacy two-way override: True forces the
    k-binned multiply, False pins ESC, "auto" (default) leaves the choice
    to ``spec.local_path``. An override also plans the ESC budget, as the
    reference does.

    The retry ladder is bounded by the memory ceiling
    ``max(per_process_memory, footprint(planned caps))``: a batch whose next
    doubling would pass it is replanned as ``d`` sub-batches under a
    ``nb·d`` plan and merged back, recorded in ``BatchedResult.report``.
    ``exec_spec.degrade=False`` lifts the ceiling (the unbounded ladder).
    ``exec_spec.sorted_merge`` is the step's Merge-Fiber kind.

    ``spec.placement`` says the operands already carry a ``Placement``'s
    permutations: the column maps the consumer gets are original columns
    (``placement.multiply_placed`` permutes and inverts end to end).
    Anything but a ``Placement`` there, or a distribution other than the
    block-cyclic one, is refused: the device step runs only that one.
    The old keyword surface (``slack=``, ``lookahead=``, ``caps_floor=``,
    …) maps onto the specs under a ``DeprecationWarning``.
    """
    spec, floors, ex = resolve_specs(
        spec, floors, exec_spec, legacy, default_local_path="auto",
        where="batched_summa3d",
    )
    placement = spec.placement
    if placement is not None and not isinstance(placement, Placement):
        raise ValueError(
            f"spec.placement must be a core.placement.Placement whose "
            f"permutations the operands ALREADY carry, got {placement!r} — "
            f"use placement.multiply_placed (or compute_placement + "
            f"apply_a/apply_b) to permute host operands before scattering"
        )
    if spec.distribution is not None and (
        getattr(spec.distribution, "name", None) != BLOCK_CYCLIC.name
    ):
        raise ValueError(
            f"the device step implements only the block-cyclic "
            f"distribution; got {spec.distribution!r}. Custom Distribution "
            f"objects are planner-side — price them via plan_from_symbolic."
        )
    r_bytes = spec.r_bytes
    local_path = spec.local_path
    mask, mask_complement = spec.mask, spec.mask_complement
    max_retries, degrade = ex.max_retries, ex.degrade
    sorted_merge, binned = ex.sorted_merge, ex.binned
    assert local_path in ("auto", "esc", "binned", "hash"), local_path
    assert path in ("sparse", "dense"), path
    dense = path == "dense"
    # the plan budgets the hash path only when the driver could dispatch it:
    # an explicit binned override pins the classic O(flops) budget
    plan_local_path = local_path
    if local_path == "auto" and (binned != "auto" or dense):
        plan_local_path = "esc"
    plan = plan_batches(
        a, b, grid, per_process_memory,
        spec=spec.replace(local_path=plan_local_path), floors=floors,
    )
    nb = plan.num_batches
    n_cols = b.shape[1]

    use_hash = not dense and plan.local_path == "hash"
    if use_hash or local_path == "esc" or dense:
        use_binned = False
    elif local_path == "binned":
        use_binned = True
    elif binned == "auto":
        use_binned = semiring.name == "plus_times" and plan.binned_profitable
    else:
        use_binned = bool(binned)
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

    caps, sel_cap, mask_cap = plan.caps, plan.sel_cap, plan.mask_sel_cap
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

    def dispatch(bi: int, caps_: BatchCaps, sel_cap_: int, kb_, hc_, mask_cap_: int,
                 num_batches: int = nb, bok=bin_of_k):
        """Enqueue one fused batch step; nothing waits for the device here."""
        return summa3d_fused_step(
            a, b, bi, bok, mask, grid=grid, num_batches=num_batches, sel_cap=sel_cap_,
            caps=caps_, semiring=semiring, sorted_merge=sorted_merge, path=path, kbin=kb_,
            hashc=hc_, mask_cap=mask_cap_, mask_complement=mask_complement,
        )

    # capacities actually used, including retry growth — reported on the
    # returned plan so iterated callers floor their next plan on them
    used = {"caps": caps, "sel": sel_cap, "kb": kb, "hashc": hc, "mask": mask_cap}

    def grow(o: np.ndarray, caps_: BatchCaps, sel_cap_: int, kb_, hc_, mask_cap_: int,
             record: bool = True):
        """Next capacity plan after an overflow: selection first (a truncated
        selection makes the multiply flags unreliable), multiply second; the
        exact mask-slice capacity doubles with the multiply caps, so the
        ladder stays monotone. A multiply-cap doubling past the memory
        ceiling raises `_LadderBlocked` (with ``degrade`` on). ``record=False`` (degraded
        sub-batches) skips the ``used`` bookkeeping."""
        if o[0] > 0:
            sel_cap_ = min(_rup8(max(sel_cap_ * 2, 8)), b.cap)
            rep["sel_retries"] += 1
        elif o[1] > 0:
            cand_caps = caps_.doubled()
            cand_hc = hc_.doubled() if hc_ is not None else None
            if degrade and _footprint(cand_caps, sel_cap_, cand_hc) > ladder_ceiling:
                rep["ladder_blocked"] += 1
                raise _LadderBlocked(
                    f"cap doubling to {cand_caps} exceeds the "
                    f"{ladder_ceiling}-byte ceiling"
                )
            caps_, hc_ = cand_caps, cand_hc
            kb_ = kb_.doubled() if kb_ is not None else None
            if mask is not None:
                mask_cap_ = min(mask_cap_ * 2, mask.cap)
        if not record:
            return caps_, sel_cap_, kb_, hc_, mask_cap_
        used["sel"] = max(used["sel"], sel_cap_)
        used["mask"] = max(used["mask"], mask_cap_)
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
        return caps_, sel_cap_, kb_, hc_, mask_cap_

    def run_batch_sync(bi: int, caps_: BatchCaps, sel_cap_: int, kb_, hc_, mask_cap_: int,
                       dispatch_fn=None, record: bool = True):
        """The synchronous retry loop (§IV-A robustness)."""
        nonlocal retries
        dispatch_fn = dispatch_fn or dispatch
        for _ in range(max_retries + 1):
            c_batch, ovf = dispatch_fn(bi, caps_, sel_cap_, kb_, hc_, mask_cap_)
            o = _host(ovf)
            if not o.any():
                return c_batch
            retries += 1
            caps_, sel_cap_, kb_, hc_, mask_cap_ = grow(
                o, caps_, sel_cap_, kb_, hc_, mask_cap_, record=record)
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
                        sub.mask_sel_cap, dispatch_fn=sub_dispatch, record=False,
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
            return run_batch_sync(bi, caps, sel_cap, kb, hc, mask_cap)
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
                c_batch = run_batch_sync(bi, *grow(o, caps, sel_cap, kb, hc, mask_cap))
            except _LadderBlocked:
                c_batch = run_batch_degraded(bi)
            c_post = post(bi, c_batch)
        consumed.append(consumer(bi, c_post, _col_map(bi)))

    def _col_map(bi: int) -> np.ndarray:
        col_map = batch_column_map(n_cols, grid, nb, bi)
        if placement is not None:
            # permuted operands: consumers get ORIGINAL column ids (rows stay
            # permuted; multiply_placed inverts them after collection)
            col_map = placement.original_cols(col_map)
        return col_map

    if not ex.pipelined:
        for bi in range(nb):
            c_batch = post(bi, run_batch_guarded(bi))
            consumed.append(consumer(bi, c_batch, _col_map(bi)))
    else:
        window = LookaheadWindow.from_exec(ex, finish)
        for bi in range(nb):
            c_batch, ovf = dispatch(bi, caps, sel_cap, kb, hc, mask_cap)
            window.push(bi, post(bi, c_batch), ovf)
        window.drain()
    # report the capacities actually used (incl. any retry growth)
    plan = dataclasses.replace(
        plan, caps=used["caps"], sel_cap=used["sel"], mask_sel_cap=used["mask"],
        hash_caps=used["hashc"],
    )
    executed = "hash" if use_hash else ("binned" if use_binned else "esc")
    report = RunReport(
        retries=retries, sel_retries=rep["sel_retries"],
        replans=rep["replans"], ladder_blocked=rep["ladder_blocked"],
        degraded_batches=tuple(rep["degraded"]),
    )
    return BatchedResult(
        plan=plan, num_retries=retries, consumed=consumed, binned=use_binned,
        binned_caps=used["kb"], local_path=executed, hash_caps=used["hashc"],
        report=report,
    )
