"""The port on multi-process grids against the JAX package on the same grids.

The port runs one process per grid point (gloo, on the CPU); the JAX
package runs on as many host devices. Grids: 2×2×1 and 1×1×4 for every
case, and 2×2×2 (eight ranks, the reference's own multi-device shape) for
the ESC product. Cases: ``scatter_to_grid`` tiles and the
``gather_to_global`` round trip for kinds A, B and C; ``dist_col_reduce``
(sum and max); ``batched_summa3d`` on the ESC, hash and k-binned local
multiplies, on a starved ESC plan that takes the retry ladder, on the dense
path and on the max_times semiring, and under a budget that blocks the
ladder, so batches are replanned finer and merged back; on 2×2×1 the
sparse and dense MCL device loops; the masked multiply (paper §V-B) at b ∈
{2, 4} × strict/complement × ESC/hash/k-binned on 2×2×1 and 1×1×4, where the
batch's mask slice is gathered along the fiber with per-layer column
offsets; and the masked triangle count (its plan and its count) and the
overlap pairs, without and with a candidate mask, on every shape, 2×2×2
included; the SUMMA3D steps outside the fused step: ``summa3d_dense_step``
under both schedules (the Cannon ring's skew and unit shifts are
``Grid.ppermute``) on every shape, 2×2×2 included, and
``summa3d_sparse_step`` (ESC, and OR_AND on 0/1 values) on 2×2×1 and
1×1×4; and ``multiply_placed`` with the degree placement on 2×2×1. Each
rank's tile is held against the reference's tile at the rank's grid point
(``multiply_placed`` returns the whole product on every rank).

Tolerances (the port's parity rules): structure, padding and min/max values
exact; plus_times values within rtol 1e-5 / atol 1e-6 (sums in another
order); every rank plans the same ``BatchPlan`` (pickles equal), equal to
the reference's field by field; retries and the run report equal, so an
overflow is seen exactly when the reference sees one; MCL nnz trajectories
identical and chaos within rtol 1e-4 / atol 1e-5, as in test_torch_mcl.py.

The JAX side runs once for the module, one subprocess a shape, all started
together, each with 8 host devices:

    python tests/test_torch_grid_parity.py --reference INPUTS.npz OUT.npz 2x2x1

which imports JAX only in that branch. The port's ranks are this file's
module-level functions, and its top imports no JAX, so spawned ranks never
load it.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2, 2, 1), (1, 1, 4))
ESC_SHAPE = (2, 2, 2)
N = 128
N_MCL = 64
R_BYTES = 12
# case -> (path, local path, semiring name, slack, share of the shape's budget)
PRODUCTS = {
    "esc": ("sparse", "esc", "plus_times", 1.3, 1.0),
    "hash": ("sparse", "hash", "plus_times", 1.3, 1.0),
    "binned": ("sparse", "binned", "plus_times", 1.3, 1.0),
    "starved": ("sparse", "esc", "plus_times", 0.25, 1.0),  # the retry ladder
    "blocked": ("sparse", "esc", "plus_times", 0.5, 0.6),  # the ladder blocked: replans
    "dense": ("dense", "auto", "plus_times", 1.3, 1.0),
    "max_times": ("sparse", "esc", "max_times", 1.3, 1.0),
}
# MCL loops on 2x2x1: name -> (path, forced batches, top-k)
MCL_LOOPS = {"sparse_b4_k64": ("sparse", 4, 64), "sparse_b4_k4": ("sparse", 4, 4),
             "dense_b4_k64": ("dense", 4, 64)}
# the steps outside the fused step: the dense step's schedules and the
# sparse step's semirings (its capacities are the one-batch ESC plan's)
SCHEDULES = ("allgather", "ring")
STEP_SEMIRINGS = ("plus_times", "or_and")
# the masked sweep: (complement, forced batches, local path)
MASKED = tuple((comp, nb, lp) for comp in (False, True) for nb in (2, 4)
               for lp in ("esc", "hash", "binned"))
SPAWN_TIMEOUT_S = 240  # a bound for a hung rank, not a run time (~20 s a shape alone)
# likewise, for the reference's subprocesses together, counted from their
# start (~120 s for the slowest shape, 2x2x1, alone)
REFERENCE_TIMEOUT_S = 600

pytestmark = pytest.mark.slow


def _tag(shape):
    return "x".join(map(str, shape))


def _cases(shape):
    return ("esc",) if shape == ESC_SHAPE else tuple(PRODUCTS)


def _masked_case(comp, nb, lp):
    return f"masked_{'complement' if comp else 'strict'}_b{nb}_{lp}"


# ---------------------------------------------------------------------------
# inputs (numpy, made by the parent) and the cases both packages run
# ---------------------------------------------------------------------------
def _inputs():
    """Global triplets, per-shape budgets and the MCL input, from the port's
    numpy generators (the JAX package's give the same matrices)."""
    from repro_torch.core import gen, symbolic
    from repro_torch.core.batched import PlanInputs

    a = gen.protein_similarity_like(N, blocks=4, intra_p=0.2, seed=0, device="cpu")
    nnz = int(a.nnz)
    r, c, v = (x[:nnz].numpy() for x in (a.rows, a.cols, a.vals))
    inp = {"r": r, "c": c, "v": v}
    for shape in SHAPES + (ESC_SHAPE,):
        counts = symbolic.host_symbolic_counts(a, a, shape)
        facts = PlanInputs.from_host(a, a, shape)
        flops = int(counts.percol.sum(axis=-1).max())
        # inputs plus a third of the fullest process's unmerged output: b > 1
        inp[f"budget/{_tag(shape)}"] = np.array(
            R_BYTES * (facts.max_nnz_a + facts.max_nnz_b) + R_BYTES * flops // 3)
    m = gen.protein_similarity_like(N_MCL, blocks=2, intra_p=0.6, seed=3, device="cpu")
    nnz = int(m.nnz)
    r, c, v = (x[:nnz].numpy() for x in (m.rows, m.cols, m.vals))
    sums = np.zeros(N_MCL)
    np.add.at(sums, c, v.astype(np.float64))  # column-stochastic, as the MCL cases
    inp.update(mcl_r=r, mcl_c=c, mcl_v=(v / sums[c]).astype(np.float32))
    mask = np.random.default_rng(41).random((N, N)) < 0.15
    inp["mask_r"], inp["mask_c"] = (x.astype(np.int32) for x in np.nonzero(mask))
    g = gen.symmetrized(gen.rmat(7, edge_factor=8, seed=5, device="cpu"))
    nnz = int(g.nnz)
    inp.update(tri_r=g.rows[:nnz].numpy(), tri_c=g.cols[:nnz].numpy())
    k = gen.kmer_like(32, 64, 5, seed=17, device="cpu")
    nnz = int(k.nnz)
    inp.update(kmer_r=k.rows[:nnz].numpy(), kmer_c=k.cols[:nnz].numpy())
    d = np.zeros((32, 64))
    d[inp["kmer_r"], inp["kmer_c"]] = 1
    i, j = np.nonzero(np.triu(d @ d.T >= 2, k=1))
    extra = np.random.default_rng(3).integers(0, 32, (2, 40))
    inp["cand_r"], inp["cand_c"] = np.concatenate([i, extra[0]]), np.concatenate([j, extra[1]])
    return inp


def _plan_record(p):
    """A ``BatchPlan`` of either package as plain arrays."""
    kb = p.kbin
    return {
        "ints": np.array([p.num_batches, p.lower_bound, p.total_flops, p.max_unmerged_nnz,
                          p.sel_cap, p.mask_sel_cap, *dataclasses.astuple(p.caps),
                          kb.num_bins, kb.bin_cap_a,
                          kb.bin_cap_b, kb.pairings, kb.pairings_unbinned], np.int64),
        "hash": np.array(dataclasses.astuple(p.hash_caps) if p.hash_caps else [], np.int64),
        "per_batch_flops": np.asarray(p.per_batch_flops),
        "bin_of_k": np.asarray(kb.bin_of_k),
        "path": np.array(p.local_path),
        "cf": np.array(p.compression_est),
    }


def _tiles(d):
    return {f: np.asarray(getattr(d, f)) for f in ("rows", "cols", "vals", "nnz")}


def _run(pkg, grid, shape, inp):
    """Every case of ``shape`` through ``pkg`` (either package) on ``grid``.
    Tile arrays keep the package's stacking: the whole grid (JAX) or this
    process's tile as (1, 1, 1, ...) (the port). Returns (arrays, plans)."""
    out, plans = {}, {}
    a = pkg.coo(inp["r"], inp["c"], inp["v"], (N, N))
    ops = {kind: pkg.scatter(a, grid, kind) for kind in ("A", "B", "C")}
    if shape != ESC_SHAPE:
        for kind, d in ops.items():
            for f, x in _tiles(d).items():
                out[f"scatter/{kind}/{f}"] = x
            out[f"roundtrip/{kind}"] = pkg.dense(pkg.gather(d))
        out["col_reduce/A/sum"] = np.asarray(pkg.col_reduce(ops["A"], grid, "sum"))
        out["col_reduce/B/max"] = np.asarray(pkg.col_reduce(ops["B"], grid, "max"))
    for schedule in SCHEDULES:
        out[f"dense_step/{schedule}"] = np.asarray(
            pkg.dense_step(ops["A"], ops["B"], grid=grid, schedule=schedule))
    if shape != ESC_SHAPE:
        ones = pkg.coo(inp["r"], inp["c"], np.ones(len(inp["r"]), np.float32), (N, N))
        for semiring in STEP_SEMIRINGS:
            x = a if semiring == "plus_times" else ones
            xa, xb = pkg.scatter(x, grid, "A"), pkg.scatter(x, grid, "B")
            caps = pkg.plan(xa, xb, grid, 1 << 30, spec=pkg.PlanSpec(local_path="esc")).caps
            c, ovf = pkg.sparse_step(xa, xb, grid=grid, caps=caps,
                                     semiring=pkg.semiring(semiring))
            for f, v in _tiles(c).items():
                out[f"sparse_step/{semiring}/{f}"] = v
            out[f"sparse_step/{semiring}/ovf"] = np.asarray(ovf)
    if shape == (2, 2, 1):
        placed = pkg.multiply_placed(a, a, grid, int(inp[f"budget/{_tag(shape)}"]),
                                     strategy="degree", spec=pkg.PlanSpec(local_path="esc"))
        for f in ("rows", "cols", "vals"):
            out[f"placed/{f}"] = np.asarray(getattr(placed, f))
        out["placed/b"] = np.array(placed.result.plan.num_batches)
        out["placed/row_perm"] = placed.placement.row_perm
    for case in _cases(shape):
        path, local_path, semiring, slack, share = PRODUCTS[case]
        batches = []
        res = pkg.batched(
            ops["A"], ops["B"], grid, int(share * int(inp[f"budget/{_tag(shape)}"])),
            path=path, semiring=pkg.semiring(semiring),
            spec=pkg.PlanSpec(local_path=local_path, slack=slack),
            exec_spec=pkg.ExecSpec(max_retries=12),
            consumer=lambda bi, cb, cm: batches.append(
                {"tile": np.asarray(cb)} if path == "dense" else _tiles(cb)),
        )
        for f in batches[0]:
            out[f"{case}/{f}"] = np.stack([b[f] for b in batches])
        rep = res.report
        out[f"{case}/report"] = np.array([res.num_retries, rep.retries, rep.sel_retries,
                                          rep.replans, rep.ladder_blocked,
                                          *np.ravel(rep.degraded_batches)])
        out[f"{case}/local_path"] = np.array(res.local_path)
        plans[case] = res.plan
    if shape != ESC_SHAPE:
        ones = np.ones(len(inp["mask_r"]), np.float32)
        mask = pkg.scatter(pkg.coo(inp["mask_r"], inp["mask_c"], ones, (N, N)), grid, "C")
        for comp, nb, lp in MASKED:
            case, batches = _masked_case(comp, nb, lp), []
            res = pkg.batched(
                ops["A"], ops["B"], grid, 1 << 26,
                spec=pkg.PlanSpec(mask=mask, mask_complement=comp, local_path=lp,
                                  force_num_batches=nb),
                consumer=lambda bi, cb, cm: batches.append(_tiles(cb)),
            )
            for f in batches[0]:
                out[f"{case}/{f}"] = np.stack([b[f] for b in batches])
            out[f"{case}/retries"] = np.array(res.num_retries)
            out[f"{case}/local_path"] = np.array(res.local_path)
            plans[case] = res.plan
    ones = np.ones(len(inp["tri_r"]), np.float32)
    tri = pkg.coo(inp["tri_r"], inp["tri_c"], ones, (N, N))
    L, U = pkg.ga._strict_parts(tri)
    A, B, M = (pkg.scatter(x, grid, kind) for x, kind in ((L, "A"), (U, "B"), (L, "C")))
    budget = pkg.probe(A, B, grid)
    plans["triangles"] = pkg.plan(A, B, grid, budget, spec=pkg.PlanSpec(mask=M))
    out["triangles"] = np.array(pkg.ga.triangle_count(tri, grid, per_process_memory=budget))
    kmer = pkg.coo(inp["kmer_r"], inp["kmer_c"], np.ones(len(inp["kmer_r"]), np.float32),
                   (32, 64))
    cands = pkg.coo(inp["cand_r"], inp["cand_c"], np.ones(len(inp["cand_r"]), np.float32),
                    (32, 32))
    for label, cand in (("overlap", None), ("overlap_candidates", cands)):
        out[label] = np.array(pkg.ga.overlap_pairs(kmer, grid, min_shared=2, candidates=cand),
                              np.int64).reshape(-1, 3)
    if shape == (2, 2, 1):
        m = pkg.coo(inp["mcl_r"], inp["mcl_c"], inp["mcl_v"], (N_MCL, N_MCL))
        for name, (path, nb, k) in MCL_LOOPS.items():
            cfg = pkg.mcl.MCLConfig(max_iters=12, per_process_memory=1 << 24, path=path,
                                    force_num_batches=nb, max_per_col=k)
            final, hist = pkg.mcl.mcl_iterate(m, grid, cfg)
            out[f"mcl/{name}/final"] = pkg.dense(final)
            out[f"mcl/{name}/nnz"] = np.array([h["nnz"] for h in hist])
            out[f"mcl/{name}/batches"] = np.array([h["batches"] for h in hist])
            out[f"mcl/{name}/chaos"] = np.array([h["chaos"] for h in hist])
    return out, plans


# ---------------------------------------------------------------------------
# the port's ranks (spawned; no JAX)
# ---------------------------------------------------------------------------
def _port_rank(grid, inp):
    from repro_torch.core import distsparse, placement, semiring, sparse, specs, summa3d
    from repro_torch.core.batched import batched_summa3d, plan_batches, probe_memory_budget
    from repro_torch.sparse_apps import graph_algorithms, mcl

    pkg = SimpleNamespace(
        coo=lambda r, c, v, shape: sparse.from_numpy_coo(r, c, v, shape, cap=len(r),
                                                         device=grid.device),
        scatter=distsparse.scatter_to_grid,
        gather=lambda d: distsparse.gather_to_global(d, grid),
        dense=lambda s: s.to_dense().numpy(),
        col_reduce=distsparse.dist_col_reduce,
        batched=batched_summa3d,
        semiring=semiring.get,
        PlanSpec=specs.PlanSpec,
        ExecSpec=specs.ExecSpec,
        mcl=mcl,
        ga=graph_algorithms,
        plan=plan_batches,
        probe=probe_memory_budget,
        dense_step=summa3d.summa3d_dense_step,
        sparse_step=summa3d.summa3d_sparse_step,
        multiply_placed=placement.multiply_placed,
    )
    out, plans = _run(pkg, grid, (grid.pr, grid.pc, grid.l), inp)
    loaded = sorted(m for m in ("jax", "jaxlib", "repro") if m in sys.modules)
    return grid.coords, out, {case: pickle.dumps(p) for case, p in plans.items()}, loaded


# ---------------------------------------------------------------------------
# the JAX side (subprocess only)
# ---------------------------------------------------------------------------
def _reference(inputs_path, out_path, tag):
    import jax

    from repro.core import distsparse, placement, semiring, sparse, summa3d
    from repro.core.batched import batched_summa3d, plan_batches, probe_memory_budget
    from repro.core.grid import make_grid
    from repro.core.specs import ExecSpec, PlanSpec
    from repro.sparse_apps import graph_algorithms, mcl

    pkg = SimpleNamespace(
        coo=lambda r, c, v, shape: sparse.from_numpy_coo(r, c, v, shape, cap=len(r)),
        scatter=distsparse.scatter_to_grid,
        gather=distsparse.gather_to_global,
        dense=lambda s: np.asarray(s.to_dense()),
        col_reduce=distsparse.dist_col_reduce,
        batched=batched_summa3d,
        semiring=semiring.get,
        PlanSpec=PlanSpec,
        ExecSpec=ExecSpec,
        mcl=mcl,
        ga=graph_algorithms,
        plan=plan_batches,
        probe=probe_memory_budget,
        # the steps under jit, as the reference's driver runs them
        dense_step=jax.jit(summa3d.summa3d_dense_step,
                           static_argnames=("grid", "semiring", "schedule")),
        sparse_step=jax.jit(summa3d.summa3d_sparse_step, static_argnames=(
            "grid", "caps", "semiring", "sorted_merge", "kbin", "hashc")),
        multiply_placed=placement.multiply_placed,
    )
    inp = dict(np.load(inputs_path))
    shape = tuple(int(x) for x in tag.split("x"))
    res = {}
    out, plans = _run(pkg, make_grid(*shape), shape, inp)
    for key, x in out.items():
        res[f"{tag}/{key}"] = x
    for case, p in plans.items():
        for key, x in _plan_record(p).items():
            res[f"{tag}/{case}/plan/{key}"] = x
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, reference arrays, {shape: per-rank (coords, arrays, plans)}):
    the reference's subprocesses and the port's ranks run side by side."""
    from repro_torch.launch import spawn

    work = tmp_path_factory.mktemp("grid_parity")
    inp = _inputs()
    np.savez(work / "inputs.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    tags = [_tag(shape) for shape in SHAPES + (ESC_SHAPE,)]
    refs = {}
    deadline = time.monotonic() + REFERENCE_TIMEOUT_S
    try:
        for tag in tags:
            with open(work / f"reference_{tag}.log", "w") as log:
                refs[tag] = subprocess.Popen(
                    [sys.executable, __file__, "--reference", str(work / "inputs.npz"),
                     str(work / f"reference_{tag}.npz"), tag],
                    env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        port = {shape: spawn.run(_port_rank, shape, backend="gloo", device="cpu",
                                 args=(inp,), timeout_s=SPAWN_TIMEOUT_S, workdir=work)
                for shape in SHAPES + (ESC_SHAPE,)}
        for ref in refs.values():
            ref.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for ref in refs.values():
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    ref = {}
    for tag in tags:
        log = (work / f"reference_{tag}.log").read_text()
        assert refs[tag].returncode == 0, f"{tag}: {log[-4000:]}"
        ref.update(np.load(work / f"reference_{tag}.npz"))
    return inp, ref, port


def _ref_tile(x, coords, stacked_from=0):
    """The reference's tile at ``coords`` from an array whose grid axes
    start at axis ``stacked_from``."""
    return x[(slice(None),) * stacked_from + tuple(coords)]


def _assert_tiles(got, want, exact_vals):
    for f in ("rows", "cols", "nnz"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    if exact_vals:
        np.testing.assert_array_equal(got["vals"], want["vals"])
    else:
        np.testing.assert_allclose(got["vals"], want["vals"], rtol=1e-5, atol=1e-6)


def test_ranks_load_no_jax(runs):
    _, _, port = runs
    for shape, ranks in port.items():
        assert sorted(r[0] for r in ranks) == sorted(
            (i, j, k) for i in range(shape[0]) for j in range(shape[1]) for k in range(shape[2]))
        assert all(r[3] == [] for r in ranks), [r[3] for r in ranks]


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
@pytest.mark.parametrize("kind", ["A", "B", "C"])
def test_scatter_and_round_trip_match_jax(runs, shape, kind):
    inp, ref, port = runs
    want = np.zeros((N, N), np.float32)
    want[inp["r"], inp["c"]] = inp["v"]
    for coords, out, *_ in port[shape]:
        got = {f: out[f"scatter/{kind}/{f}"][0, 0, 0] for f in ("rows", "cols", "vals", "nnz")}
        _assert_tiles(got, {f: _ref_tile(ref[f"{_tag(shape)}/scatter/{kind}/{f}"], coords)
                            for f in got}, exact_vals=True)
        np.testing.assert_array_equal(out[f"roundtrip/{kind}"], want)
        np.testing.assert_array_equal(ref[f"{_tag(shape)}/roundtrip/{kind}"], want)


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_dist_col_reduce_matches_jax(runs, shape):
    _, ref, port = runs
    for coords, out, *_ in port[shape]:
        np.testing.assert_allclose(
            out["col_reduce/A/sum"][0, 0, 0],
            _ref_tile(ref[f"{_tag(shape)}/col_reduce/A/sum"], coords), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(
            out["col_reduce/B/max"][0, 0, 0],
            _ref_tile(ref[f"{_tag(shape)}/col_reduce/B/max"], coords))


def _product_ids():
    return [(s, c) for s in SHAPES + (ESC_SHAPE,) for c in _cases(s)]


@pytest.mark.parametrize("shape,case", _product_ids(),
                         ids=[f"{_tag(s)}-{c}" for s, c in _product_ids()])
def test_batched_summa3d_matches_jax(runs, shape, case):
    _, ref, port = runs
    tag = f"{_tag(shape)}/{case}"
    plans = [p[case] for _, _, p, _ in port[shape]]
    assert all(p == plans[0] for p in plans), "ranks planned different batches"
    got_plan = _plan_record(pickle.loads(plans[0]))
    for key, x in got_plan.items():
        np.testing.assert_array_equal(x, ref[f"{tag}/plan/{key}"], err_msg=key)
    assert got_plan["ints"][0] > 1, "the budget must force more than one batch"
    semiring = PRODUCTS[case][2]
    for coords, out, *_ in port[shape]:
        np.testing.assert_array_equal(out[f"{case}/report"], ref[f"{tag}/report"])
        assert out[f"{case}/local_path"] == ref[f"{tag}/local_path"]
        if case == "dense":
            np.testing.assert_allclose(out["dense/tile"][:, 0, 0, 0],
                                       _ref_tile(ref[f"{tag}/tile"], coords, 1),
                                       rtol=1e-5, atol=1e-6)
            continue
        got = {f: out[f"{case}/{f}"][:, 0, 0, 0] for f in ("rows", "cols", "vals", "nnz")}
        want = {f: _ref_tile(ref[f"{tag}/{f}"], coords, 1) for f in got}
        _assert_tiles(got, want, exact_vals=semiring != "plus_times")
    if case == "starved":
        assert ref[f"{tag}/report"][0] > 0, "the starved plan must take the retry ladder"
    if case == "blocked":
        assert ref[f"{tag}/report"][3] > 0, "the blocked ladder must replan batches"


def _masked_ids():
    return [(s, c) for s in SHAPES for c in MASKED]


@pytest.mark.parametrize("shape,masked", _masked_ids(),
                         ids=[f"{_tag(s)}-{_masked_case(*c)}" for s, c in _masked_ids()])
def test_masked_multiply_matches_jax(runs, shape, masked):
    """The masked product at b > 1 on a grid: the mask slice of each batch
    reaches every layer at its columns, so every rank's tiles and plan are
    the reference's and no batch retries (the mask-slice capacity is exact)."""
    _, ref, port = runs
    case = _masked_case(*masked)
    tag = f"{_tag(shape)}/{case}"
    plans = [p[case] for _, _, p, _ in port[shape]]
    assert all(p == plans[0] for p in plans), "ranks planned different batches"
    for key, x in _plan_record(pickle.loads(plans[0])).items():
        np.testing.assert_array_equal(x, ref[f"{tag}/plan/{key}"], err_msg=key)
    for coords, out, *_ in port[shape]:
        assert int(out[f"{case}/retries"]) == int(ref[f"{tag}/retries"]) == 0
        assert out[f"{case}/local_path"] == ref[f"{tag}/local_path"] == masked[2]
        got = {f: out[f"{case}/{f}"][:, 0, 0, 0] for f in ("rows", "cols", "vals", "nnz")}
        _assert_tiles(got, {f: _ref_tile(ref[f"{tag}/{f}"], coords, 1) for f in got},
                      exact_vals=False)


@pytest.mark.parametrize("shape", SHAPES + (ESC_SHAPE,), ids=_tag)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_dense_step_matches_jax(runs, shape, schedule):
    """Every rank's dense C tile is the reference's, under both schedules,
    and the ring's equals allgather's (the stages add in another order)."""
    inp, ref, port = runs
    want = np.zeros((N, N), np.float32)
    want[inp["r"], inp["c"]] = inp["v"]
    want = want @ want
    pr, pc, l = shape
    tm, tn = N // pr, N // pc // l
    for coords, out, *_ in port[shape]:
        got = out[f"dense_step/{schedule}"]
        assert got.shape == (1, 1, 1, tm, tn)
        np.testing.assert_allclose(got[0, 0, 0], _ref_tile(
            ref[f"{_tag(shape)}/dense_step/{schedule}"], coords), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, out["dense_step/allgather"], rtol=1e-5, atol=1e-6)
        i, j, k = coords
        cols = j * (N // pc) + k * tn + np.arange(tn)  # batch_column_map at b = 1
        np.testing.assert_allclose(got[0, 0, 0], want[i * tm:(i + 1) * tm][:, cols],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
@pytest.mark.parametrize("semiring", STEP_SEMIRINGS)
def test_sparse_step_matches_jax(runs, shape, semiring):
    _, ref, port = runs
    tag = f"{_tag(shape)}/sparse_step/{semiring}"
    for coords, out, *_ in port[shape]:
        assert int(out[f"sparse_step/{semiring}/ovf"]) == int(ref[f"{tag}/ovf"]) == 0
        got = {f: out[f"sparse_step/{semiring}/{f}"][0, 0, 0]
               for f in ("rows", "cols", "vals", "nnz")}
        _assert_tiles(got, {f: _ref_tile(ref[f"{tag}/{f}"], coords) for f in got},
                      exact_vals=semiring != "plus_times")


def test_degree_placed_multiply_on_2x2x1_matches_jax(runs):
    """Every rank returns the reference's placed product (the whole of it:
    every tile is gathered), in original coordinates, under the same
    degree permutation and batch count."""
    _, ref, port = runs
    tag = "2x2x1/placed"
    assert int(ref[f"{tag}/b"]) > 1
    for _, out, *_ in port[(2, 2, 1)]:
        np.testing.assert_array_equal(out["placed/row_perm"], ref[f"{tag}/row_perm"])
        assert int(out["placed/b"]) == int(ref[f"{tag}/b"])
        np.testing.assert_array_equal(out["placed/rows"], ref[f"{tag}/rows"])
        np.testing.assert_array_equal(out["placed/cols"], ref[f"{tag}/cols"])
        np.testing.assert_allclose(out["placed/vals"], ref[f"{tag}/vals"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES + (ESC_SHAPE,), ids=_tag)
def test_triangle_count_matches_jax(runs, shape):
    """Every rank counts the reference's triangles and plans the
    reference's masked plan; the count is the dense reference's."""
    inp, ref, port = runs
    d = np.zeros((N, N), np.int64)
    d[inp["tri_r"], inp["tri_c"]] = 1
    want = int(np.trace(d @ d @ d)) // 6
    assert int(ref[f"{_tag(shape)}/triangles"]) == want
    plans = [p["triangles"] for _, _, p, _ in port[shape]]
    assert all(p == plans[0] for p in plans), "ranks planned different batches"
    for key, x in _plan_record(pickle.loads(plans[0])).items():
        np.testing.assert_array_equal(x, ref[f"{_tag(shape)}/triangles/plan/{key}"], err_msg=key)
    assert [int(out["triangles"]) for _, out, *_ in port[shape]] == [want] * len(port[shape])


@pytest.mark.parametrize("shape", SHAPES + (ESC_SHAPE,), ids=_tag)
@pytest.mark.parametrize("case", ["overlap", "overlap_candidates"])
def test_overlap_pairs_match_jax(runs, shape, case):
    """Every rank returns the reference's overlap pairs, which are the
    dense A·Aᵀ's with i < j and shared ≥ 2; the candidate mask (the true
    pairs and 40 random ones) keeps them all."""
    inp, ref, port = runs
    d = np.zeros((32, 64))
    d[inp["kmer_r"], inp["kmer_c"]] = 1
    c = d @ d.T
    i, j = np.nonzero(np.triu(c >= 2, k=1))
    want = np.stack([i, j, np.rint(c[i, j])], axis=1).astype(np.int64)
    assert len(want) > 0
    np.testing.assert_array_equal(ref[f"{_tag(shape)}/{case}"], want)
    for _, out, *_ in port[shape]:
        np.testing.assert_array_equal(out[case], want)


@pytest.mark.parametrize("loop", list(MCL_LOOPS))
def test_mcl_loop_on_2x2x1_matches_jax(runs, loop):
    _, ref, port = runs
    tag = f"2x2x1/mcl/{loop}"
    for _, out, *_ in port[(2, 2, 1)]:
        for f in ("nnz", "batches"):
            np.testing.assert_array_equal(out[f"mcl/{loop}/{f}"], ref[f"{tag}/{f}"])
        np.testing.assert_allclose(out[f"mcl/{loop}/chaos"], ref[f"{tag}/chaos"],
                                   rtol=1e-4, atol=1e-5)
        got, want = out[f"mcl/{loop}/final"], ref[f"{tag}/final"]
        np.testing.assert_array_equal(got != 0, want != 0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert ref[f"{tag}/chaos"][-1] < 1e-3


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(sys.argv[2], sys.argv[3], sys.argv[4])
