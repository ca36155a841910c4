"""SpGEMM applications from paper §V-B: triangle counting and AAᵀ overlap.

Triangle counting: count(G) = Σ (L·U) ⊙ L, with L and U the strict lower
and upper parts of the adjacency matrix — a masked SpGEMM. The mask L is
scattered once as a C-layout operand and applied inside the batched
multiply (``batched_summa3d(spec=PlanSpec(mask=...))``): the symbolic pass
budgets only the surviving entries (smaller capacities, fewer batches) and
the local multiply filters the partial products against the mask before
its compress or insert, so products that close no triangle never take
output capacity, never cross the fiber and never reach the host. Each
batch comes back as one device scalar, summed over the grid.

Overlap detection (BELLA/PASTIS): C = A·Aᵀ over plus-times, A the
(sequences × k-mers) indicator; C[i, j] counts the k-mers sequences i and
j share. The pair filter (i < j, shared ≥ ``min_shared``) runs on the grid
after each batch, so only surviving pairs are transferred. An optional
``candidates`` mask (known candidate pairs) also gates the multiply itself.

``triangle_count_host`` and ``overlap_pairs_host`` pull every unmasked
batch to numpy and filter it there, entry by entry, through
``_host_mask_filter`` / ``_host_pair_filter``: they are the oracles the
tests hold the device paths against, and the tests count calls to those two
filters to show that the device paths never filter on the host.

All-pairs shortest paths (``apsp_iterate``, and ``apsp_iterate_resilient``
under the checkpoint harness): iterated squaring of the distance matrix
over the min-plus semiring until it stops changing, on the grid, with
``apsp_reference`` (dense Floyd–Warshall) as the oracle.

Every rank of a multi-process grid passes the same input and gets the same
answer: a batch's count is a sum over the grid, and its surviving pairs
are gathered from every rank's tile.

Usage, on one card::

    from repro_torch.core import gen
    from repro_torch.core.grid import make_grid
    from repro_torch.sparse_apps.graph_algorithms import overlap_pairs, triangle_count

    grid = make_grid(1, 1, 1)
    g = gen.symmetrized(gen.rmat(14, edge_factor=16, seed=5))
    triangles = triangle_count(g, grid, per_process_memory=1 << 28)
    pairs = overlap_pairs(gen.kmer_like(1 << 14, 1 << 19, 64, seed=17), grid,
                          min_shared=2, per_process_memory=1 << 28)

A batch's (tm, wb) mask keys must pack into i32, as in the reference: at
n = 2^16 on one card that takes b >= 4, which a tighter budget gives.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import semiring as sr
from ..core.batched import RunReport, batched_summa3d
from ..core.distsparse import DistSparse, from_tile, scatter_to_grid
from ..core.grid import COL_AX, LAYER_AX, ROW_AX, Grid
from ..core.sparse import SparseCOO, from_numpy_coo
from ..core.specs import ExecSpec, PlanFloors, PlanSpec
from ..core.summa3d import _squeeze_tile, reassemble_operands
from ..core.symbolic import rup8, rup_pow2
from ..runtime.resilient import ResilientConfig, run_iterated
from . import mcl as _mcl
from .mcl import _sparse_batch_to_global, _to_host

Tensor = torch.Tensor


def _charge_mask_planning_transfer(mask: DistSparse) -> None:
    """Masked planning counts the mask's per-tile column structure on the
    device; only the (pr, pc, l, wl) i32 count array crosses to the host.
    Charge those bytes to the transfer accounting."""
    pr, pc, l = mask.grid_shape
    _mcl._TRANSFER_BYTES[0] += pr * pc * l * mask.tile_shape[1] * 4


def _strict_parts(a: SparseCOO) -> Tuple[SparseCOO, SparseCOO]:
    """Strict lower (L) and upper (U) triangular parts as unit-weight COO,
    on ``a``'s device."""
    n = a.shape[0]
    nnz = int(a.nnz)
    rows = a.rows[:nnz].cpu().numpy()
    cols = a.cols[:nnz].cpu().numpy()
    lo = rows > cols
    hi = rows < cols
    L = from_numpy_coo(rows[lo], cols[lo], np.ones(lo.sum(), np.float32), (n, n),
                       cap=max(int(lo.sum()), 8), device=a.device)
    U = from_numpy_coo(rows[hi], cols[hi], np.ones(hi.sum(), np.float32), (n, n),
                       cap=max(int(hi.sum()), 8), device=a.device)
    return L, U


# ---------------------------------------------------------------------------
# per-batch reductions and filters on the grid (the §V-B postprocess hooks)
# ---------------------------------------------------------------------------
def _batch_value_sum(c: DistSparse, grid: Grid) -> Tensor:
    """Σ of one batch's values over the grid, as a device scalar: the only
    thing of a batch the masked triangle count moves to the host. Summed in
    float64 (in a fixed order over the grid), so a count stays an exact
    integer far past f32's 2^24."""
    t = _squeeze_tile(c, grid)
    local = torch.where(t.valid_mask(), t.vals, torch.zeros_like(t.vals)).double().sum()
    return grid.psum_all(local)


def _overlap_filter(c: DistSparse, batch: int, grid: Grid, num_batches: int,
                    min_shared: int):
    """The BELLA pair filter on the grid: keep entries with global row <
    global column and value ≥ ``min_shared``, compacted to the front of
    each tile. Returns (filtered batch, surviving pairs over the grid, the
    most any tile keeps, compact overflow over the grid), the last three as
    device scalars."""
    tm, wbl = c.tile_shape
    w = c.shape[1] * num_batches // grid.pc
    t = _squeeze_tile(c, grid)
    i, j, k = (grid.axis_index(ax) for ax in (ROW_AX, COL_AX, LAYER_AX))
    g_row = i * tm + t.rows
    g_col = j * w + (k * num_batches + batch) * wbl + t.cols
    keep = t.valid_mask() & (t.vals >= min_shared) & (g_row < g_col)
    kept, ovf = t.compact(keep, t.cap)
    local = keep.sum().to(torch.int32)
    filtered = from_tile(kept, c.shape, grid, c.kind)
    return filtered, grid.psum_all(local), grid.pmax_all(local), grid.pmax_all(ovf)


def _shrink_batch(d: DistSparse, max_tile_nnz: int) -> DistSparse:
    """Cut a front-compacted batch to its survivors' capacity before it is
    pulled: lossless, since every tile keeps at most ``max_tile_nnz``
    entries at its front. Powers of two, so batches share shapes."""
    cap = d.rows.shape[-1]
    new_cap = min(cap, rup_pow2(max(int(max_tile_nnz), 8)))
    if new_cap >= cap:
        return d
    return dataclasses.replace(d, rows=d.rows[..., :new_cap], cols=d.cols[..., :new_cap],
                               vals=d.vals[..., :new_cap])


# ---------------------------------------------------------------------------
# triangle counting: the masked multiply, on the device
# ---------------------------------------------------------------------------
def triangle_count(a: SparseCOO, grid: Grid, per_process_memory: int = 1 << 26) -> int:
    """Σ_{(i, j) ∈ A, i > j} (L·U)[i, j] through the masked batched multiply:
    the mask L is a C-layout operand applied inside every batch's step, and
    each batch gives one device scalar to the total."""
    L, U = _strict_parts(a)
    A_d = scatter_to_grid(L, grid, "A")
    B_d = scatter_to_grid(U, grid, "B")
    M_d = scatter_to_grid(L, grid, "C")
    _charge_mask_planning_transfer(M_d)
    totals: List[float] = []
    batched_summa3d(
        A_d, B_d, grid, per_process_memory=per_process_memory,
        consumer=lambda bi, s, col_map: totals.append(float(_to_host(s))),
        path="sparse", semiring=sr.PLUS_TIMES, spec=PlanSpec(mask=M_d),
        postprocess=lambda bi, c: _batch_value_sum(c, grid),
    )
    return int(round(sum(totals)))


def _host_mask_filter(rr, cc, vv, mask) -> int:
    """The host oracle's per-entry mask filter (the device path must never
    call it: tests count its calls)."""
    total = 0
    for r, c, v in zip(rr.tolist(), cc.tolist(), vv.tolist()):
        if (r, c) in mask:
            total += int(round(v))
    return total


def triangle_count_host(a: SparseCOO, grid: Grid, per_process_memory: int = 1 << 26) -> int:
    """Host-filter oracle: the unmasked L·U, every batch pulled to numpy and
    masked by a Python set lookup."""
    nnz = int(a.nnz)
    rows = a.rows[:nnz].cpu().numpy()
    cols = a.cols[:nnz].cpu().numpy()
    L, U = _strict_parts(a)
    low = rows > cols
    mask = set(zip(rows[low].tolist(), cols[low].tolist()))
    total = 0

    def consumer(bi, c_batch, col_map):
        nonlocal total
        total += _host_mask_filter(*_sparse_batch_to_global(c_batch, col_map, grid), mask)

    batched_summa3d(
        scatter_to_grid(L, grid, "A"), scatter_to_grid(U, grid, "B"), grid,
        per_process_memory=per_process_memory, consumer=consumer, path="sparse",
        semiring=sr.PLUS_TIMES,
    )
    return total


def triangle_count_reference(a: SparseCOO) -> int:
    """trace(D³)/6 of the symmetric 0/1 pattern without self loops (dense;
    small graphs only)."""
    d = (a.to_dense().cpu().numpy() != 0).astype(np.int64)
    d = d & d.T
    np.fill_diagonal(d, 0)
    return int(np.trace(d @ d @ d)) // 6


# ---------------------------------------------------------------------------
# overlap detection: the pair filter on the grid (+ an optional candidate mask)
# ---------------------------------------------------------------------------
def overlap_pairs(
    a: SparseCOO,
    grid: Grid,
    min_shared: int = 2,
    per_process_memory: int = 1 << 26,
    candidates: Optional[SparseCOO] = None,
) -> List[Tuple[int, int, int]]:
    """A·Aᵀ in batches; returns the (i, j, shared) pairs with i < j and
    shared ≥ ``min_shared``, sorted. Each batch is filtered on the grid and
    then dropped: the host only reassembles the survivors' coordinates.
    ``candidates`` (an nseqs × nseqs structural mask of candidate pairs)
    also gates the multiply itself, through the masked path."""
    at = a.transpose().sort_rowmajor()
    A_d = scatter_to_grid(a, grid, "A")
    B_d = scatter_to_grid(at, grid, "B")
    M_d = scatter_to_grid(candidates, grid, "C") if candidates is not None else None
    if M_d is not None:
        _charge_mask_planning_transfer(M_d)
    pieces = []
    nseqs = a.shape[0]

    def postprocess(bi, c_batch):
        # b is the column count over the batch width: no plan needed here
        return _overlap_filter(c_batch, bi, grid, nseqs // c_batch.shape[1], int(min_shared))

    def consumer(bi, payload, col_map):
        filtered, cnt, maxc, ovf = payload
        assert int(_to_host(ovf)) == 0
        rr, cc, vv = _sparse_batch_to_global(
            _shrink_batch(filtered, int(_to_host(maxc))), col_map, grid)
        assert len(rr) == int(_to_host(cnt)), (len(rr), cnt)
        pieces.append((rr, cc, vv))

    batched_summa3d(
        A_d, B_d, grid, per_process_memory=per_process_memory, consumer=consumer,
        path="sparse", postprocess=postprocess, spec=PlanSpec(mask=M_d),
    )
    rows, cols, vals = (np.concatenate([p[f] for p in pieces]) for f in range(3))
    order = np.lexsort((cols, rows))
    return [(int(r), int(c), int(round(v)))
            for r, c, v in zip(rows[order], cols[order], vals[order])]


def _host_pair_filter(rr, cc, vv, min_shared) -> List[Tuple[int, int, int]]:
    """The host oracle's per-entry pair filter (tests count its calls)."""
    out = []
    for r, c, v in zip(rr.tolist(), cc.tolist(), vv.tolist()):
        if r < c and v >= min_shared:
            out.append((int(r), int(c), int(round(v))))
    return out


def overlap_pairs_host(
    a: SparseCOO, grid: Grid, min_shared: int = 2, per_process_memory: int = 1 << 26,
) -> List[Tuple[int, int, int]]:
    """Host-filter oracle: every whole batch pulled to numpy and filtered
    entry by entry."""
    at = a.transpose().sort_rowmajor()
    pairs: List[Tuple[int, int, int]] = []

    def consumer(bi, c_batch, col_map):
        pairs.extend(_host_pair_filter(*_sparse_batch_to_global(c_batch, col_map, grid),
                                       min_shared))

    batched_summa3d(
        scatter_to_grid(a, grid, "A"), scatter_to_grid(at, grid, "B"), grid,
        per_process_memory=per_process_memory, consumer=consumer, path="sparse",
    )
    return sorted(pairs)


def overlap_pairs_reference(a: SparseCOO, min_shared: int = 2) -> List[Tuple[int, int, int]]:
    """The pairs from a dense A·Aᵀ (small inputs only)."""
    d = a.to_dense().cpu().numpy().astype(np.float64)
    c = d @ d.T
    i, j = np.nonzero(np.triu(c >= min_shared, k=1))
    return sorted((int(r), int(s), int(round(c[r, s]))) for r, s in zip(i, j))


# ---------------------------------------------------------------------------
# APSP: min-plus iterated squaring (tropical semiring), resilient-ready
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class APSPConfig:
    """All-pairs shortest paths by iterated squaring over MIN_PLUS.

    D ← D ⊗ D doubles the hop horizon each iteration; with an explicit zero
    diagonal the iterate is entrywise non-increasing, D_k covers all paths
    of ≤ 2^k hops, and the fixpoint (exact triplet equality of successive
    iterates) is the shortest-path matrix: at the fixpoint each entry's min
    over candidates includes D[i,j] + 0 through the diagonal, so equality
    is exact in float. Absent entries are an implicit +inf (unreachable);
    only finite distances are stored.
    """

    max_iters: Optional[int] = None  # None: ceil(log2(n-1)) + 1
    per_process_memory: int = 1 << 26
    force_num_batches: Optional[int] = None
    lookahead: int = 2
    r_bytes: int = 12
    # the local multiply: "auto" | "esc" | "hash" (k-binned is plus_times
    # only and off here; ESC and the hash accumulator take any semiring)
    local_path: str = "auto"


@dataclasses.dataclass
class APSPLoopState:
    """The device-resident iterate (A/B operands of the next squaring) and
    the plan signature (the checkpointed unit; ``mcl.MCLLoopState`` without
    the binned decision, which min-plus never uses)."""

    A: DistSparse
    B: DistSparse
    it: int
    history: List[dict]
    report: RunReport
    floors: PlanFloors = dataclasses.field(default_factory=PlanFloors)
    lp_arg: object = "auto"


def _apsp_triplets(d: SparseCOO):
    k = int(d.nnz)
    return (d.rows[:k].cpu().numpy(), d.cols[:k].cpu().numpy(), d.vals[:k].cpu().numpy())


def apsp_init(a: SparseCOO, device=None) -> SparseCOO:
    """D_0: the edge weights with an explicit zero diagonal (duplicates
    merged by MIN: a self-loop never beats distance 0), built in numpy and
    placed on ``device`` (default ``a``'s)."""
    n = a.shape[0]
    rr, cc, vv = _apsp_triplets(a)
    rows = np.concatenate([rr, np.arange(n, dtype=rr.dtype)])
    cols = np.concatenate([cc, np.arange(n, dtype=cc.dtype)])
    vals = np.concatenate([vv.astype(np.float32), np.zeros(n, np.float32)])
    key = rows.astype(np.int64) * n + cols.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    best = np.full(len(uniq), np.inf, np.float32)
    np.minimum.at(best, inv, vals)
    return from_numpy_coo(
        (uniq // n).astype(np.int32), (uniq % n).astype(np.int32), best, (n, n),
        device=a.device if device is None else device,
    )


def _apsp_cold_state(a: SparseCOO, grid: Grid, cfg: APSPConfig) -> APSPLoopState:
    """Iteration-0 state: D_0 scattered once as both operands (the only
    scatters of a run: the loop stays on the grid after this), the local
    multiply ``cfg.local_path`` until the first iteration pins it. (The
    reference starts every run on "auto" whatever ``cfg.local_path`` says.)"""
    d0 = apsp_init(a, device=grid.device)
    return APSPLoopState(
        A=_mcl._scatter(d0, grid, "A"), B=_mcl._scatter(d0, grid, "B"),
        it=0, history=[], report=RunReport(), lp_arg=cfg.local_path,
    )


def _apsp_caps(n: int, grid: Grid, cfg: APSPConfig) -> Tuple[int, int, int]:
    """Reassembly capacities of the next iterate's operands. APSP never
    prunes, so the only safe static bound is the dense tile (every (row,
    col) of a tile at most once): reassembly cannot overflow, and the
    reserved-bytes charge keeps the multiply honest about the kept
    operands."""
    tm = n // grid.pr
    w = n // grid.pc
    wl = w // grid.l
    cap_a = rup8(max(8, tm * wl))
    cap_b = rup8(max(8, wl * w))
    return cap_a, cap_b, cfg.r_bytes * (cap_a + cap_b)


def _dist_equal_nnz(x: DistSparse, y: DistSparse, grid: Grid) -> Tuple[Tensor, Tensor]:
    """Exact equality of two same-layout iterates on the grid, and the
    first one's total nnz, as two device scalars (one reduction): the APSP
    fixpoint test without a gather. Each tile is put in row-major order
    (its entries are key-unique), so comparing the prefix of the smaller
    capacity plus the nnz is exact."""
    kmin = min(x.cap, y.cap)
    tx = _squeeze_tile(x, grid).sort_rowmajor()
    ty = _squeeze_tile(y, grid).sort_rowmajor()
    neq = (tx.nnz != ty.nnz).to(torch.int32)
    live = torch.arange(kmin, device=tx.device) < torch.minimum(tx.nnz, ty.nnz)
    mism = live & (
        (tx.rows[:kmin] != ty.rows[:kmin])
        | (tx.cols[:kmin] != ty.cols[:kmin])
        | (tx.vals[:kmin] != ty.vals[:kmin])
    )
    bad_nnz = grid.psum_all(torch.stack([neq + mism.sum(dtype=torch.int32),
                                         tx.nnz.to(torch.int32)]))
    return bad_nnz[0], bad_nnz[1]


def _apsp_step(
    state: APSPLoopState, grid: Grid, cfg: APSPConfig, verbose: bool = False,
    injector=None, slack: Optional[float] = None,
) -> Tuple[APSPLoopState, RunReport, bool]:
    """One squaring D ← D ⊗ D on the grid: the batched products reassemble
    into the next iterate's operands (``summa3d.reassemble_operands``, as
    in MCL) and the fixpoint test is an exact comparison on the grid, so
    one host read of three scalars an iteration and no gather or scatter
    inside the loop. ``injector`` and ``slack`` as in
    ``mcl._mcl_sparse_step``."""
    it = state.it
    t0 = time.perf_counter()
    n = state.A.shape[0]
    cap_a, cap_b, reserved = _apsp_caps(n, grid, cfg)
    batches: List[DistSparse] = []

    def consumer(bi, c_batch, col_map):
        if injector is not None:
            injector.maybe_straggle_batch(it, bi)
            injector.maybe_preempt(it, batch=bi)
        batches.append(c_batch)

    res = batched_summa3d(
        state.A, state.B, grid, per_process_memory=cfg.per_process_memory,
        consumer=consumer, path="sparse", semiring=sr.MIN_PLUS,
        spec=PlanSpec(
            local_path=state.lp_arg, r_bytes=cfg.r_bytes, reserved_bytes=reserved,
            force_num_batches=cfg.force_num_batches,
            **({"slack": slack} if slack is not None else {}),
        ),
        floors=state.floors.replace(caps_pow2=True),
        exec_spec=ExecSpec(lookahead=cfg.lookahead, binned=False),
    )
    state.floors = state.floors.merged(res.floors())
    state.lp_arg = res.local_path
    a_next, b_next, ovf = reassemble_operands(tuple(batches), grid, cap_a, cap_b)
    bad, nnz_dev = _dist_equal_nnz(a_next, state.A, grid)
    # one host read an iteration: fixpoint flag, nnz, reassembly overflow
    bad, nnz, overflow = (int(x) for x in _to_host(torch.stack(
        [bad, nnz_dev, ovf.to(torch.int32)])))
    assert overflow == 0, f"iter {it}: reassembly overflow {overflow}"
    state.A, state.B = a_next, b_next
    dt = time.perf_counter() - t0
    state.history.append({
        "iter": it, "nnz": nnz, "wall_ms": dt * 1e3,
        "retries": int(res.num_retries), "replans": int(res.report.replans),
        "batches": int(res.plan.num_batches), "local_path": res.local_path,
    })
    if verbose:
        print(f"[apsp] iter={it} nnz={nnz} wall={dt * 1e3:.1f}ms")
    state.it = it + 1
    state.report = state.report.merged(res.report)
    return state, res.report, bad == 0


def _apsp_max_iters(n: int, cfg: APSPConfig) -> int:
    if cfg.max_iters is not None:
        return cfg.max_iters
    return int(np.ceil(np.log2(max(n - 1, 2)))) + 1


def apsp_iterate(
    a: SparseCOO, grid: Grid, cfg: Optional[APSPConfig] = None, verbose: bool = False,
) -> Tuple[SparseCOO, List[dict]]:
    """All-pairs shortest paths on the batched multiply: the distance matrix
    (absent = unreachable), gathered to every rank, and per-iteration
    stats. ``cfg.local_path`` picks the local multiply; min-plus has no
    rounding order, so ESC and hash give the same bits."""
    cfg = cfg or APSPConfig()
    state = _apsp_cold_state(a, grid, cfg)
    max_iters = _apsp_max_iters(a.shape[0], cfg)
    while state.it < max_iters:
        state, _, done = _apsp_step(state, grid, cfg, verbose)
        if done:
            break
    return _mcl._gather(state.A, grid), state.history


def apsp_iterate_resilient(
    a: SparseCOO, grid: Grid, cfg: Optional[APSPConfig], rc: ResilientConfig,
    injector=None, verbose: bool = False,
) -> Tuple[SparseCOO, List[dict], RunReport]:
    """``apsp_iterate`` under the durability harness, with the contract of
    ``mcl.mcl_iterate_resilient``: the iterate and plan signature are
    checkpointed in the JAX package's format, corrupt restores refused,
    and a resumed run repeats the uninterrupted one bit for bit."""
    cfg = cfg or APSPConfig()
    n = a.shape[0]
    tile_a = (n // grid.pr, n // grid.pc // grid.l)
    tile_b = (n // grid.pr // grid.l, n // grid.pc)

    def encode(state: APSPLoopState):
        arrays: dict = {}
        _mcl._dist_to_arrays(state.A, "A", arrays, grid)
        _mcl._dist_to_arrays(state.B, "B", arrays, grid)
        meta = {
            "workload": "apsp",
            "it": state.it,
            "history": state.history,
            "report": state.report.to_dict(),
            "plan_sig": {"floors": state.floors.to_meta(), "local_path": state.lp_arg},
        }
        return arrays, meta

    def decode(arrays, meta) -> APSPLoopState:
        sig = meta["plan_sig"]
        return APSPLoopState(
            A=_mcl._dist_from_arrays(arrays, "A", grid, (n, n), tile_a, "A"),
            B=_mcl._dist_from_arrays(arrays, "B", grid, (n, n), tile_b, "B"),
            it=int(meta["it"]), history=list(meta["history"]),
            report=RunReport.from_dict(meta["report"]),
            floors=PlanFloors.from_meta(sig["floors"]), lp_arg=sig["local_path"],
        )

    def step_fn(state, it, inj):
        return _apsp_step(state, grid, cfg, verbose, injector=inj,
                          slack=inj.capacity_slack(it))

    result = run_iterated(
        rc=rc, max_iters=_apsp_max_iters(n, cfg),
        cold_start=lambda: _apsp_cold_state(a, grid, cfg),
        step_fn=step_fn, encode=encode, decode=decode,
        injector=injector, verbose=verbose, grid=grid,
    )
    state = result.state
    return _mcl._gather(state.A, grid), state.history, state.report.merged(dataclasses.replace(
        result.report, retries=0, sel_retries=0, replans=0, ladder_blocked=0,
        degraded_batches=(),
    ))


def apsp_reference(a: SparseCOO) -> np.ndarray:
    """Dense numpy Floyd–Warshall (absent = +inf, zero diagonal)."""
    n = a.shape[0]
    d = np.full((n, n), np.inf, np.float64)
    rr, cc, vv = _apsp_triplets(a)
    np.minimum.at(d, (rr, cc), vv.astype(np.float64))
    np.fill_diagonal(d, np.minimum(np.diag(d), 0.0))
    for k in range(n):
        d = np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
    return d
