"""HipMCL-style Markov clustering on BatchedSUMMA3D (paper §V-C, Fig. 3).

Each MCL iteration: expansion (A ← A·A, the SpGEMM), inflation (entrywise
power + column normalization), then pruning (threshold + per-column top-k).
The batched multiply lets the expansion run even when nnz(A²) exceeds
memory: each column batch is pruned right after it is produced and only
the pruned entries survive — the paper's integration.

``mcl_iterate`` is the device-resident loop: the per-batch
inflate + normalize + prune runs as a ``batched_summa3d`` postprocess hook
(column sums and maxima are reductions over the grid; top-k is a
distributed threshold bisection on the sparse path and the ``col_prune``
kernel on the dense path), the pruned batches become the next iteration's
A/B operands on the grid (``summa3d.reassemble_operands``), and chaos comes
back as one scalar per batch. The pruned-output capacities are charged to
the multiply's budget through ``PlanSpec.reserved_bytes``, so
``MCLConfig.per_process_memory`` bounds operands + unmerged batch + kept
pruned output together.

``mcl_iterate_host`` is the host-loop reference: it pulls every batch to
numpy, prunes there and re-scatters each iteration.

Usage::

    from repro_torch.core import convert
    from repro_torch.core.grid import make_grid
    from repro_torch.sparse_apps.mcl import MCLConfig, mcl_iterate, clusters_from_matrix

    grid = make_grid(1, 1, 1)            # one card
    a = ...  # column-stochastic SparseCOO adjacency (n x n) on the card
    final, history = mcl_iterate(a, grid, MCLConfig(
        inflation=2.0, max_per_col=64, per_process_memory=1 << 31))
    r, c, _ = convert.triplets(final)
    labels = clusters_from_matrix(r, c, a.shape[0])

On a 2×2×1 grid, one process per card: every rank passes the same ``a``
and gets the same final matrix (``a_on`` makes ``a`` on the rank's card,
at module level so that it pickles)::

    from repro_torch.launch import spawn

    def rank_fn(grid, cfg):
        return convert.triplets(mcl_iterate(a_on(grid.device), grid, cfg)[0])

    per_rank = spawn.run(rank_fn, (2, 2, 1), backend="nccl", device="cuda",
                         args=(cfg,))

Long runs go through ``mcl_iterate_resilient(a, grid, cfg, rc)`` with a
``runtime.resilient.ResilientConfig`` (checkpoint directory and cadence):
a preempted, corrupted or killed run resumes from its newest valid
checkpoint on the uninterrupted run's trajectory, bit for bit.

``history[i]["host_bytes"]`` records the host↔device traffic of iteration
i: a few stat scalars on the device loop, the whole matrix every batch on
the host loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import distsparse
from ..core.batched import RunReport, batched_summa3d
from ..core.distsparse import DistSparse, from_tile, local_col_reduce
from ..core.grid import ROW_AX, Grid
from ..core.sparse import SparseCOO, from_dense_overflow, from_numpy_coo
from ..core.specs import ExecSpec, PlanFloors, PlanSpec
from ..core.summa3d import _squeeze_tile, reassemble_operands
from ..core.symbolic import rup8 as _rup8
from ..kernels.col_prune import THRESH_ITERS, col_topk_bounds
from ..runtime.resilient import ResilientConfig, run_iterated

Tensor = torch.Tensor


@dataclasses.dataclass
class MCLConfig:
    inflation: float = 2.0
    prune_threshold: float = 1e-4
    max_per_col: int = 64  # top-k per column (HipMCL "recovery/selection")
    max_iters: int = 20
    converge_tol: float = 1e-3
    per_process_memory: int = 1 << 26
    path: str = "sparse"  # "sparse" | "dense"
    force_num_batches: Optional[int] = None  # None: symbolic-step planning
    lookahead: int = 2  # pipelined driver window
    r_bytes: int = 12  # bytes per stored nonzero (COO: i32+i32+f32)
    binned: object = "auto"  # sparse local multiply: "auto" | True | False
    # sparse local multiply: "auto" | "esc" | "binned" | "hash"
    local_path: str = "auto"


# ---------------------------------------------------------------------------
# Host<->device transfer accounting
# ---------------------------------------------------------------------------
_TRANSFER_BYTES = [0]


def reset_transfer_bytes() -> None:
    _TRANSFER_BYTES[0] = 0


def transfer_bytes() -> int:
    """Host<->device bytes moved by MCL code since the last reset."""
    return _TRANSFER_BYTES[0]


def _to_host(x: Tensor) -> np.ndarray:
    """Device -> host read with byte accounting."""
    a = x.detach().cpu().numpy()
    _TRANSFER_BYTES[0] += a.nbytes
    return a


def _dist_bytes(d: DistSparse) -> int:
    return sum(t.numel() * t.element_size() for t in (d.rows, d.cols, d.vals, d.nnz))


def _scatter(a: SparseCOO, grid: Grid, kind: str) -> DistSparse:
    """Host -> device scatter with byte accounting."""
    d = distsparse.scatter_to_grid(a, grid, kind)
    _TRANSFER_BYTES[0] += _dist_bytes(d)
    return d


def _gather(d: DistSparse, grid: Grid) -> SparseCOO:
    """Device -> host -> device gather of the final matrix, with accounting."""
    _TRANSFER_BYTES[0] += _dist_bytes(d)
    return distsparse.gather_to_global(d, grid)


# ---------------------------------------------------------------------------
# Host pruning math (the host loop's, and the parity oracle)
# ---------------------------------------------------------------------------
def _col_normalize_np(rows, cols, vals, n):
    sums = np.zeros(n, vals.dtype)
    np.add.at(sums, cols, vals)
    sums[sums == 0] = 1.0
    return vals / sums[cols]


def _prune_topk_np(rows, cols, vals, n, thresh, k):
    keep = vals >= thresh
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    # per-column top-k
    order = np.lexsort((-vals, cols))
    rows, cols, vals = rows[order], cols[order], vals[order]
    # rank within column
    first = np.ones(len(cols), bool)
    first[1:] = cols[1:] != cols[:-1]
    idx_of_first = np.maximum.accumulate(np.where(first, np.arange(len(cols)), 0))
    rank = np.arange(len(cols)) - idx_of_first
    keep = rank < k
    return rows[keep], cols[keep], vals[keep]


def _record_iter(history, it, nnz, chaos, res, t0, t0_bytes, verbose):
    """Per-iteration epilogue: one history row schema for all three loops.
    Every value is a plain Python number or string: the resilient loop
    stores the history in its checkpoint's JSON manifest."""
    history.append({
        "iter": it, "nnz": nnz, "chaos": chaos,
        "batches": int(res.plan.num_batches), "flops": int(res.plan.total_flops),
        "local_path": res.local_path,
        "retries": int(res.num_retries), "replans": int(res.report.replans),
        "host_bytes": transfer_bytes() - t0_bytes,
        "wall_ms": (time.perf_counter() - t0) * 1e3,
    })
    if verbose:
        print(f"[mcl] iter={it} nnz={nnz} chaos={chaos:.5f} "
              f"b={res.plan.num_batches} path={res.local_path} "
              f"retries={res.num_retries}", flush=True)


def _pad(x: Tensor, value) -> Tensor:
    """``x`` with one trailing slot holding ``value`` (the padding segment)."""
    return torch.cat([x, torch.full((1,), value, dtype=x.dtype, device=x.device)])


# ---------------------------------------------------------------------------
# Device-side per-batch postprocess (the fused §V-C consumption step)
# ---------------------------------------------------------------------------
def _mcl_prune_sparse(
    c: DistSparse, grid: Grid, inflation: float, thresh: float, k: int,
    new_cap: int,
):
    """Inflate + column-normalize + prune one sparse C batch on the grid.

      1. inflation: entrywise power (local).
      2. column normalization: column sums over the grid row group (a batch
         column lives in the pr tiles of one (grid column, layer) pair).
      3. top-k: distributed threshold bisection on the COO entries (the
         sparse counterpart of ``kernels.col_prune``, plain torch ops) —
         per-column counts are summed over the row group each step; with
         the absolute ``thresh`` cut, then one ``compact`` to ``new_cap``.
      4. renormalize survivors; chaos (max over columns of col max - col
         sum of squares) and the kept-entry count stay on the device.

    Returns ``(pruned DistSparse, stats)``, stats being 0-dim device tensors
    ``{"chaos", "nnz", "overflow"}``. The step reads the batch's nnz (4
    bytes, counted in ``transfer_bytes``) and works on the live prefix only:
    the batch capacity is sized from flops, and at scale it can be ~20× the
    live entries, which every one of the ~30 column reductions would read.
    """
    tm, tn = c.tile_shape
    t = _squeeze_tile(c, grid)
    live = int(_to_host(t.nnz))
    t = SparseCOO(t.rows[:live], t.cols[:live], t.vals[:live], t.nnz, t.shape)
    dev = t.device

    def col_reduce(x, valid, op):
        return local_col_reduce(x, t.cols, valid, tn, op, (ROW_AX,), grid=grid)

    valid = t.valid_mask()
    v = torch.where(valid, t.vals.float(), torch.zeros_like(t.vals, dtype=torch.float32))
    v = v ** inflation
    # column normalization over the grid row group
    colsum = col_reduce(v, valid, "sum")
    inv = 1.0 / torch.where(colsum > 0, colsum, torch.ones_like(colsum))
    segids = torch.where(valid, t.cols, torch.full_like(t.cols, tn)).long()
    v = v * _pad(inv, 1.0)[segids]
    # distributed per-column top-k threshold (bisection on value)
    hi = col_reduce(v, valid, "max") + 1e-6
    lo = torch.zeros_like(hi)
    for _ in range(THRESH_ITERS):
        mid = 0.5 * (lo + hi)
        over = valid & (v >= _pad(mid, 0.0)[segids])
        take_hi = col_reduce(over.to(torch.int32), valid, "sum") > k  # exact counts
        lo = torch.where(take_hi, mid, lo)
        hi = torch.where(take_hi, hi, mid)
    tcol_pad = _pad(hi, float("inf"))[segids]
    lo_pad = _pad(lo, float("inf"))[segids]
    # k-boundary ties: a value repeated across the k-th position sits in the
    # final bracket [lo, hi) — "v >= hi" alone would drop the whole tied
    # group (annihilating uniform columns). Keep exactly k: every strictly
    # greater entry, then the tie band's first free-slot entries by rank —
    # the rank within the tile plus the tied counts of the row blocks
    # before this one, so the quota is split consistently over the row group.
    greater = valid & (v >= thresh) & (v >= tcol_pad)
    cnt_hi = col_reduce(greater.to(torch.int32), valid, "sum")
    slots = torch.clamp(k - cnt_hi, min=0)  # (tn,) free slots per column
    tied = valid & (v >= thresh) & (v >= lo_pad) & (v < tcol_pad)
    # rank of each tied entry within its column, in slot order, in O(cap)
    # memory: a stable sort groups tied entries by column, the rank is the
    # position within the column's run (its start found by a binary search
    # of the sorted run keys), scattered back to entry slots
    cap = v.shape[0]
    sort_seg = torch.where(tied, segids, torch.full_like(segids, tn))
    seg_sorted, perm = torch.sort(sort_seg, stable=True)
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    rank = torch.empty(cap, dtype=torch.int64, device=dev)
    rank[perm] = pos - torch.searchsorted(seg_sorted, seg_sorted)
    tied_cnt = torch.zeros(tn + 1, dtype=torch.int32, device=dev)
    tied_cnt.index_add_(0, segids, tied.to(torch.int32))
    all_cnt = grid.all_gather(tied_cnt[:tn], ROW_AX)  # (pr, tn)
    before = torch.arange(all_cnt.shape[0], device=dev)[:, None] < grid.axis_index(ROW_AX)
    offset = torch.where(before, all_cnt, torch.zeros_like(all_cnt)).sum(0)
    quota = torch.clamp(slots - offset, min=0)
    keep = greater | (tied & (rank < _pad(quota, 0)[segids]))
    # renormalize the survivors
    vk = torch.where(keep, v, torch.zeros_like(v))
    colsum2 = col_reduce(vk, valid, "sum")
    inv2 = 1.0 / torch.where(colsum2 > 0, colsum2, torch.ones_like(colsum2))
    v2 = vk * _pad(inv2, 1.0)[segids]
    # chaos = max over columns of (col max - col sum of squares)
    colmax2 = col_reduce(v2, keep, "max")
    colsq2 = col_reduce(v2 * v2, keep, "sum")
    chaos = grid.pmax_all((colmax2 - colsq2).max())
    nnz = grid.psum_all(keep.sum(dtype=torch.int32))
    pruned, ovf = SparseCOO(t.rows, t.cols, v2, t.nnz, (tm, tn)).compact(keep, new_cap)
    return (
        from_tile(pruned, c.shape, grid, c.kind),
        {"chaos": chaos, "nnz": nnz, "overflow": grid.pmax_all(ovf)},
    )


def _mcl_prune_dense(c_tiles: Tensor, grid: Grid, inflation: float, thresh: float, k: int):
    """Dense-path batch postprocess: inflate + normalize + top-k prune the
    (1, 1, 1, tm, wbl) C tile of this process on the device. The per-column top-k
    bracket comes from the ``col_prune`` kernel on the row-gathered column
    block (a batch column is split across the pr row tiles, so the kernel
    sees the full column). Returns (pruned tiles, stats)."""
    t = c_tiles.reshape(c_tiles.shape[-2:]).float()  # (tm, wbl)
    tm = t.shape[0]
    t = t ** inflation
    colsum = grid.psum(t.sum(0), ROW_AX)
    t = t / torch.where(colsum > 0, colsum, torch.ones_like(colsum))[None, :]
    full = grid.all_gather(t, ROW_AX).reshape(-1, t.shape[1])
    lo, thr = col_topk_bounds(full, k)
    # keep every strictly-greater entry, then fill the remaining top-k
    # slots from the [lo, thr) tie band by rank (the full column is here,
    # so the rank fill is local: cumulative count down the rows)
    greater = (full >= thr[None, :]) & (full >= thresh)
    tied = (full >= lo[None, :]) & (full < thr[None, :]) & (full >= thresh)
    slots = k - greater.sum(0, dtype=torch.int32)
    tied_i = tied.to(torch.int32)
    rank = torch.cumsum(tied_i, 0, dtype=torch.int32) - tied_i
    keep_full = greater | (tied & (rank < slots[None, :]))
    i_own = grid.axis_index(ROW_AX)
    keep = keep_full[i_own * tm:(i_own + 1) * tm]
    t = torch.where(keep, t, torch.zeros_like(t))
    colsum2 = grid.psum(t.sum(0), ROW_AX)
    t = t / torch.where(colsum2 > 0, colsum2, torch.ones_like(colsum2))[None, :]
    colmax = grid.pmax(t.amax(0), ROW_AX)
    colsq = grid.psum((t * t).sum(0), ROW_AX)
    chaos = grid.pmax_all((colmax - colsq).max())
    nnz = grid.psum_all((t > 0).sum(dtype=torch.int32))
    zero = torch.zeros((), dtype=torch.int32, device=t.device)
    return t.reshape(c_tiles.shape), {"chaos": chaos, "nnz": nnz, "overflow": zero}


def _dense_to_sparse_batch(tiles: Tensor, grid: Grid, shape, cap: int):
    """Sparsify one pruned dense batch on the grid: ``from_dense_overflow``
    of this process's (tm, wbl) tile, laid out as the C batch
    ``reassemble_operands`` consumes. Returns (DistSparse kind "C",
    overflow) — overflow is 0 when ``cap >= min(k, tm) * wbl``, the
    post-prune bound of a tile."""
    s, ovf = from_dense_overflow(tiles.reshape(tiles.shape[-2:]), cap)
    return from_tile(s, shape, grid, "C"), grid.pmax_all(ovf)


def _extract_dense_batch(tiles: np.ndarray, col_map: np.ndarray):
    """Host extraction of one dense batch in global coordinates: one
    ``np.nonzero`` over the stacked tiles."""
    pr, pc, l, tm, wbl = tiles.shape
    i, j, kk, r, c = np.nonzero(tiles)
    return i * tm + r, col_map[j, kk, c], tiles[i, j, kk, r, c]


# ---------------------------------------------------------------------------
# Device-resident MCL loop (explicit-state form: one step = one iteration)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MCLLoopState:
    """Everything one sparse MCL iteration carries to the next: the
    device-resident iterate (A/B operands) and the plan signature — the
    ``PlanFloors`` pinned after the first iteration and the pinned binned
    and local-multiply decisions. The resilient loop checkpoints exactly
    this: the tiles through the content-hashed store, the signature as
    manifest meta, so a restored run plans what the uninterrupted run
    planned."""

    A: DistSparse
    B: DistSparse
    it: int
    chaos: float
    history: List[dict]
    report: RunReport
    floors: PlanFloors = dataclasses.field(default_factory=PlanFloors)
    binned_arg: object = "auto"
    lp_arg: str = "auto"


def _mcl_caps(n: int, grid: Grid, cfg: MCLConfig) -> Tuple[int, int, int]:
    """Post-prune operand capacities (<= min(k, rows-in-tile) per column)
    and the reserved-bytes charge they place on the multiply budget."""
    tm = n // grid.pr
    w = n // grid.pc
    wl = w // grid.l
    k = cfg.max_per_col
    cap_a = _rup8(max(8, min(k, tm) * wl))
    cap_b = _rup8(max(8, min(k, wl) * w))
    return cap_a, cap_b, cfg.r_bytes * (cap_a + cap_b)


def _mcl_cold_state(a: SparseCOO, grid: Grid, cfg: MCLConfig) -> MCLLoopState:
    """Iteration-0 state: input scattered once, plan signature unpinned."""
    return MCLLoopState(
        A=_scatter(a, grid, "A"), B=_scatter(a, grid, "B"),
        it=0, chaos=float("inf"), history=[], report=RunReport(),
        binned_arg=cfg.binned, lp_arg=cfg.local_path,
    )


def _mcl_sparse_step(
    state: MCLLoopState, grid: Grid, cfg: MCLConfig, verbose: bool = False,
    injector=None, slack: Optional[float] = None,
) -> Tuple[MCLLoopState, RunReport, bool]:
    """One device-resident MCL iteration on explicit state.

    Returns ``(state', per-iteration RunReport, converged)``. The plan
    floors and the binned and local-multiply decisions are pinned after the
    first iteration (pow2-quantized, monotone capacities), so every later
    iteration plans onto the same capacities as nnz drifts. ``injector``
    (resilient runs) hooks the consumer: straggler sleeps and
    mid-iteration preemption fire at batch granularity, inside the
    pipelined lookahead window; ``slack`` overrides the planner's capacity
    slack (overflow-storm injection).
    """
    n = state.A.shape[0]
    tm = n // grid.pr
    k = cfg.max_per_col
    cap_a, cap_b, reserved = _mcl_caps(n, grid, cfg)
    it = state.it
    t0_bytes = transfer_bytes()
    t0 = time.perf_counter()
    batches: List[DistSparse] = []
    stats: List[dict] = []

    def postprocess(bi, c_batch):
        tn = c_batch.tile_shape[1]
        new_cap = _rup8(max(8, min(min(k, tm) * tn, c_batch.cap)))
        return _mcl_prune_sparse(
            c_batch, grid=grid, inflation=cfg.inflation,
            thresh=cfg.prune_threshold, k=k, new_cap=new_cap,
        )

    def consumer(bi, payload, col_map):
        if injector is not None:
            injector.maybe_straggle_batch(it, bi)
            injector.maybe_preempt(it, batch=bi)
        pruned, st = payload
        batches.append(pruned)
        stats.append(st)

    res = batched_summa3d(
        state.A, state.B, grid,
        per_process_memory=cfg.per_process_memory,
        consumer=consumer, path="sparse", postprocess=postprocess,
        spec=PlanSpec(
            local_path=state.lp_arg, r_bytes=cfg.r_bytes,
            reserved_bytes=reserved, force_num_batches=cfg.force_num_batches,
            **({"slack": slack} if slack is not None else {}),
        ),
        floors=state.floors.replace(caps_pow2=True),
        exec_spec=ExecSpec(lookahead=cfg.lookahead, binned=state.binned_arg),
    )
    # pin this iteration's decisions and used capacities (monotone fold)
    state.floors = state.floors.merged(res.floors())
    state.binned_arg = bool(res.binned)
    state.lp_arg = res.local_path
    state.A, state.B, ovf = reassemble_operands(tuple(batches), grid, cap_a, cap_b)
    # one host sync per iteration, scalars only (convergence check)
    chaos = max(float(_to_host(st["chaos"])) for st in stats)
    nnz = sum(int(_to_host(st["nnz"])) for st in stats)
    overflow = int(_to_host(ovf)) + sum(int(_to_host(st["overflow"])) for st in stats)
    assert overflow == 0, f"iter {it}: pruned-capacity overflow {overflow}"
    _record_iter(state.history, it, nnz, chaos, res, t0, t0_bytes, verbose)
    state.chaos = chaos
    state.it = it + 1
    state.report = state.report.merged(res.report)
    return state, res.report, chaos < cfg.converge_tol


def mcl_continue(
    state: MCLLoopState, grid: Grid, cfg: MCLConfig, verbose: bool = False
) -> Tuple[SparseCOO, List[dict]]:
    """Run sparse MCL iterations from ``state`` until convergence or
    ``cfg.max_iters``; the final matrix is gathered once."""
    while state.it < cfg.max_iters:
        state, _, done = _mcl_sparse_step(state, grid, cfg, verbose)
        if done:
            break
    return _gather(state.A, grid), state.history


def mcl_iterate(
    a: SparseCOO, grid: Grid, cfg: MCLConfig, verbose: bool = False
) -> Tuple[SparseCOO, List[dict]]:
    """Run MCL until convergence; returns (final matrix, per-iteration stats).

    Device-resident: the input is scattered once, every iteration's
    expansion + inflation + normalization + pruning runs on the grid, the
    pruned batches become the next A/B operands by an on-grid reassembly,
    and only per-batch stat scalars (chaos, nnz) cross to the host until the
    final matrix is gathered. ``cfg.path="dense"`` runs the dense multiply
    (densify + SpMM) with the ``col_prune`` postprocess, sparsified on the
    device and reassembled on the grid like the sparse path.
    """
    if cfg.path == "dense":
        return _mcl_iterate_dense(a, grid, cfg, verbose)
    return mcl_continue(_mcl_cold_state(a, grid, cfg), grid, cfg, verbose)


# ---------------------------------------------------------------------------
# Checkpoint codec + resilient loop (the durability harness)
# ---------------------------------------------------------------------------
def _dist_to_arrays(d: DistSparse, prefix: str, arrays: dict, grid: Grid) -> None:
    """Every tile of ``d`` in the JAX package's checkpoint layout:
    ``{prefix}_rows``/``_cols``/``_vals`` of shape (pr, pc, l, cap) and
    ``{prefix}_nnz`` of shape (pr, pc, l), gathered over the grid (a
    collective on every rank), on the grid's device."""
    for f in ("rows", "cols", "vals", "nnz"):
        arrays[f"{prefix}_{f}"] = grid.gather_grid(getattr(d, f)[0, 0, 0])


def _dist_from_arrays(
    arrays: dict, prefix: str, grid: Grid, shape, tile_shape, kind: str
) -> DistSparse:
    """This rank's tile of checkpointed (pr, pc, l, ...) stacks, bit for
    bit, on the grid's device. The checkpoint must come from a grid of the
    same shape."""
    saved = tuple(arrays[f"{prefix}_nnz"].shape)
    if saved != (grid.pr, grid.pc, grid.l):
        raise ValueError(f"checkpoint of a {saved} grid restored on a "
                         f"{(grid.pr, grid.pc, grid.l)} grid")
    i, j, k = grid.coords

    def tile(f):
        x = np.array(arrays[f"{prefix}_{f}"][i, j, k])  # nnz stays 0-d
        return torch.from_numpy(x).to(grid.device).reshape(1, 1, 1, *x.shape)

    return DistSparse(
        rows=tile("rows"), cols=tile("cols"), vals=tile("vals"), nnz=tile("nnz"),
        shape=tuple(shape), tile_shape=tuple(tile_shape),
        grid_shape=(grid.pr, grid.pc, grid.l), kind=kind, coords=grid.coords,
    )


def _plan_sig_encode(state: MCLLoopState) -> dict:
    """JSON-safe plan signature: the floors (``PlanFloors.to_meta``) and the
    two pinned driver decisions."""
    return {
        "floors": state.floors.to_meta(),
        "binned": state.binned_arg,
        "local_path": state.lp_arg,
    }


def _plan_sig_decode(state: MCLLoopState, sig: dict) -> None:
    """Inverse of ``_plan_sig_encode``; takes the JAX package's signature as
    it stands (its ``binned`` is "auto" before the first iteration, then a
    bool)."""
    state.floors = PlanFloors.from_meta(sig["floors"])
    state.binned_arg = sig["binned"]
    state.lp_arg = sig["local_path"]


def mcl_iterate_resilient(
    a: SparseCOO, grid: Grid, cfg: MCLConfig, rc: ResilientConfig,
    injector=None, verbose: bool = False,
) -> Tuple[SparseCOO, List[dict], RunReport]:
    """``mcl_iterate`` (sparse path) under the durability harness
    (``runtime.resilient.run_iterated``): checkpoint every
    ``rc.ckpt_every`` iterations (the A/B tiles and the plan signature),
    resume from the newest valid checkpoint after a preemption (or on
    launch, unless ``rc.resume=False``), refuse corrupt checkpoints, and
    report retries, replans, restarts, refusals, stalls and stragglers in
    the returned ``RunReport``.

    The tiles round-trip bit for bit and the plan signature restores the
    floors and pinned decisions, so on the order-fixed multiplies (ESC,
    k-binned) a resumed run's trajectory and final matrix are the
    uninterrupted run's, bit for bit. The checkpoint format is the JAX
    package's: either package resumes the other's run. On a grid of more
    than one process every rank calls this with the same arguments; rank 0
    writes.
    """
    assert cfg.path == "sparse", "resilient MCL requires the sparse path"
    n = a.shape[0]
    tile_a = (n // grid.pr, n // grid.pc // grid.l)
    tile_b = (n // grid.pr // grid.l, n // grid.pc)

    def encode(state: MCLLoopState):
        arrays: dict = {}
        _dist_to_arrays(state.A, "A", arrays, grid)
        _dist_to_arrays(state.B, "B", arrays, grid)
        meta = {
            "workload": "mcl",
            "it": state.it,
            "chaos": state.chaos,
            "history": state.history,
            "report": state.report.to_dict(),
            "plan_sig": _plan_sig_encode(state),
        }
        return arrays, meta

    def decode(arrays: dict, meta: dict) -> MCLLoopState:
        state = MCLLoopState(
            A=_dist_from_arrays(arrays, "A", grid, (n, n), tile_a, "A"),
            B=_dist_from_arrays(arrays, "B", grid, (n, n), tile_b, "B"),
            it=int(meta["it"]), chaos=float(meta["chaos"]),
            history=list(meta["history"]),
            report=RunReport.from_dict(meta["report"]),
        )
        _plan_sig_decode(state, meta["plan_sig"])
        return state

    def step_fn(state: MCLLoopState, it: int, inj):
        return _mcl_sparse_step(state, grid, cfg, verbose, injector=inj,
                                slack=inj.capacity_slack(it))

    result = run_iterated(
        rc=rc, max_iters=cfg.max_iters,
        cold_start=lambda: _mcl_cold_state(a, grid, cfg),
        step_fn=step_fn, encode=encode, decode=decode,
        injector=injector, verbose=verbose, grid=grid,
    )
    state = result.state
    # the driver's ladder counts come from the iterate's own report (an
    # abandoned iteration's are dropped); the loop adds the durability ones
    return _gather(state.A, grid), state.history, state.report.merged(dataclasses.replace(
        result.report, retries=0, sel_retries=0, replans=0, ladder_blocked=0,
        degraded_batches=(),
    ))


def _mcl_iterate_dense(
    a: SparseCOO, grid: Grid, cfg: MCLConfig, verbose: bool = False
) -> Tuple[SparseCOO, List[dict]]:
    """Dense-path loop, device-resident like the sparse path: each batch is
    pruned by the ``col_prune`` postprocess, sparsified on the device, and
    the sparse batches feed ``reassemble_operands``."""
    n = a.shape[0]
    tm = n // grid.pr
    k = cfg.max_per_col
    cap_a, cap_b, reserved = _mcl_caps(n, grid, cfg)
    A = _scatter(a, grid, "A")
    B = _scatter(a, grid, "B")
    history: List[dict] = []
    floors = PlanFloors(caps_pow2=True)
    for it in range(cfg.max_iters):
        t0_bytes = transfer_bytes()
        t0 = time.perf_counter()
        batches: List[DistSparse] = []
        stats: List[dict] = []

        def postprocess(bi, c_tiles):
            tiles, st = _mcl_prune_dense(
                c_tiles, grid=grid, inflation=cfg.inflation,
                thresh=cfg.prune_threshold, k=k,
            )
            cap = _rup8(max(8, min(k, tm) * tiles.shape[-1]))
            sparse, conv_ovf = _dense_to_sparse_batch(tiles, grid, (n, n), cap)
            return sparse, dict(st, overflow=st["overflow"] + conv_ovf)

        def consumer(bi, payload, col_map):
            sparse, st = payload
            batches.append(sparse)
            stats.append(st)

        res = batched_summa3d(
            A, B, grid,
            per_process_memory=cfg.per_process_memory,
            consumer=consumer, path="dense", postprocess=postprocess,
            spec=PlanSpec(
                r_bytes=cfg.r_bytes, reserved_bytes=reserved,
                force_num_batches=cfg.force_num_batches,
            ),
            floors=floors,
            exec_spec=ExecSpec(lookahead=cfg.lookahead),
        )
        floors = floors.merged(res.floors())
        A, B, ovf = reassemble_operands(tuple(batches), grid, cap_a, cap_b)
        # one host sync per iteration, scalars only (convergence check)
        chaos = max(float(_to_host(st["chaos"])) for st in stats)
        nnz = sum(int(_to_host(st["nnz"])) for st in stats)
        overflow = int(_to_host(ovf)) + sum(int(_to_host(st["overflow"])) for st in stats)
        assert overflow == 0, f"iter {it}: dense-path overflow {overflow}"
        _record_iter(history, it, nnz, chaos, res, t0, t0_bytes, verbose)
        if chaos < cfg.converge_tol:
            break
    return _gather(A, grid), history


# ---------------------------------------------------------------------------
# Host-loop reference
# ---------------------------------------------------------------------------
def mcl_iterate_host(
    a: SparseCOO, grid: Grid, cfg: MCLConfig, verbose: bool = False
) -> Tuple[SparseCOO, List[dict]]:
    """Host-loop MCL reference: every batch is pulled to numpy, inflation /
    normalization / pruning / chaos all run on the host (float64), and the
    iterate round-trips host<->device each iteration. The multiply is the
    device loop's: same path, same ``cfg.local_path``, same forced batch
    count. On a grid of more than one process every batch is gathered over
    the grid, so every rank holds the whole iterate, runs the same host
    prune and scatters the same next iterate."""
    n = a.shape[0]
    cur = a
    history: List[dict] = []
    for it in range(cfg.max_iters):
        t0_bytes = transfer_bytes()
        t0 = time.perf_counter()
        A = _scatter(cur, grid, "A")
        B = _scatter(cur, grid, "B")
        pieces = []

        def consumer(bi, c_batch, col_map):
            # pull this batch to the host, prune there, discard the product
            if cfg.path == "dense":
                tiles = _to_host(grid.gather_grid(c_batch[0, 0, 0]))
                pieces.append(_extract_dense_batch(tiles, col_map))
            else:
                pieces.append(_sparse_batch_to_global(c_batch, col_map, grid))

        res = batched_summa3d(
            A, B, grid,
            per_process_memory=cfg.per_process_memory,
            consumer=consumer, path=cfg.path,
            spec=PlanSpec(
                local_path=cfg.local_path, r_bytes=cfg.r_bytes,
                force_num_batches=cfg.force_num_batches,
            ),
        )
        rows = np.concatenate([p[0] for p in pieces])
        cols = np.concatenate([p[1] for p in pieces])
        vals = np.concatenate([p[2] for p in pieces]).astype(np.float64)
        vals = vals ** cfg.inflation
        vals = _col_normalize_np(rows, cols, vals, n)
        rows, cols, vals = _prune_topk_np(
            rows, cols, vals, n, cfg.prune_threshold, cfg.max_per_col
        )
        vals = _col_normalize_np(rows, cols, vals, n).astype(np.float32)
        new = from_numpy_coo(rows, cols, vals, (n, n), cap=max(len(rows), 8),
                             device=grid.device)

        # convergence: chaos ~ max col max - col sumsq
        colmax = np.zeros(n, np.float32)
        np.maximum.at(colmax, cols, vals)
        colsq = np.zeros(n, np.float32)
        np.add.at(colsq, cols, vals ** 2)
        chaos = float((colmax - colsq).max())
        _record_iter(history, it, int(len(rows)), chaos, res, t0, t0_bytes, verbose)
        cur = new
        if chaos < cfg.converge_tol:
            break
    return cur, history


def _sparse_batch_to_global(c: DistSparse, col_map: np.ndarray, grid: Grid):
    """One sparse C batch of the whole grid in global coordinates on the
    host: every rank's tile is gathered, so every rank gets all of it."""
    tm, _ = c.tile_shape
    R, C, V, N = (_to_host(grid.gather_grid(x[0, 0, 0]))
                  for x in (c.rows, c.cols, c.vals, c.nnz))
    valid = np.arange(R.shape[-1])[None, None, None, :] < N[..., None]
    i, j, kk, s = np.nonzero(valid)
    return i * tm + R[i, j, kk, s], col_map[j, kk, C[i, j, kk, s]], V[i, j, kk, s]


def clusters_from_matrix(rows, cols, n: int) -> np.ndarray:
    """Connected components of the converged MCL matrix = cluster labels."""
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for r, c in zip(rows, cols):
        pr_, pc_ = find(r), find(c)
        if pr_ != pc_:
            parent[pr_] = pc_
    return np.array([find(i) for i in range(n)])
