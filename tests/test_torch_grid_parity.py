"""The port on multi-process grids against the JAX package on the same grids.

The port runs one process per grid point (gloo, on the CPU); the JAX
package runs on as many host devices. Grids: 2×2×1 and 1×1×4 for every
case, and 2×2×2 (eight ranks, the reference's own multi-device shape) for
the ESC product. Cases: ``scatter_to_grid`` tiles and the
``gather_to_global`` round trip for kinds A, B and C; ``dist_col_reduce``
(sum and max); ``batched_summa3d`` on the ESC, hash and k-binned local
multiplies, on a starved ESC plan that takes the retry ladder, on the dense
path and on the max_times semiring, and under a budget that blocks the
ladder, so batches are replanned finer and merged back; and on 2×2×1 the
sparse and dense MCL device loops. Each rank's tile is held against the
reference's tile at the rank's grid point.

Tolerances (the port's parity rules): structure, padding and min/max values
exact; plus_times values within rtol 1e-5 / atol 1e-6 (sums in another
order); every rank plans the same ``BatchPlan`` (pickles equal), equal to
the reference's field by field; retries and the run report equal, so an
overflow is seen exactly when the reference sees one; MCL nnz trajectories
identical and chaos within rtol 1e-4 / atol 1e-5, as in test_torch_mcl.py.

The JAX side runs once for the module in a subprocess with 8 host devices:

    python tests/test_torch_grid_parity.py --reference INPUTS.npz OUT.npz

which imports JAX only in that branch. The port's ranks are this file's
module-level functions, and its top imports no JAX, so spawned ranks never
load it.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
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
SPAWN_TIMEOUT_S = 240  # a bound for a hung rank, not a run time (~20 s a shape alone)
REFERENCE_TIMEOUT_S = 300  # likewise (~60 s alone)

pytestmark = pytest.mark.slow


def _tag(shape):
    return "x".join(map(str, shape))


def _cases(shape):
    return ("esc",) if shape == ESC_SHAPE else tuple(PRODUCTS)


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
    return inp


def _plan_record(p):
    """A ``BatchPlan`` of either package as plain arrays."""
    kb = p.kbin
    return {
        "ints": np.array([p.num_batches, p.lower_bound, p.total_flops, p.max_unmerged_nnz,
                          p.sel_cap, *dataclasses.astuple(p.caps), kb.num_bins, kb.bin_cap_a,
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
    from repro_torch.core import distsparse, semiring, sparse, specs
    from repro_torch.core.batched import batched_summa3d
    from repro_torch.sparse_apps import mcl

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
    )
    out, plans = _run(pkg, grid, (grid.pr, grid.pc, grid.l), inp)
    loaded = sorted(m for m in ("jax", "jaxlib", "repro") if m in sys.modules)
    return grid.coords, out, {case: pickle.dumps(p) for case, p in plans.items()}, loaded


# ---------------------------------------------------------------------------
# the JAX side (subprocess only)
# ---------------------------------------------------------------------------
def _reference(inputs_path, out_path):
    from repro.core import distsparse, semiring, sparse
    from repro.core.batched import batched_summa3d
    from repro.core.grid import make_grid
    from repro.core.specs import ExecSpec, PlanSpec
    from repro.sparse_apps import mcl

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
    )
    inp = dict(np.load(inputs_path))
    res = {}
    for shape in SHAPES + (ESC_SHAPE,):
        out, plans = _run(pkg, make_grid(*shape), shape, inp)
        for key, x in out.items():
            res[f"{_tag(shape)}/{key}"] = x
        for case, p in plans.items():
            for key, x in _plan_record(p).items():
                res[f"{_tag(shape)}/{case}/plan/{key}"] = x
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, reference arrays, {shape: per-rank (coords, arrays, plans)}):
    the reference subprocess and the port's ranks run side by side."""
    from repro_torch.launch import spawn

    work = tmp_path_factory.mktemp("grid_parity")
    inp = _inputs()
    np.savez(work / "inputs.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen(
        [sys.executable, __file__, "--reference", str(work / "inputs.npz"),
         str(work / "reference.npz")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = {shape: spawn.run(_port_rank, shape, backend="gloo", device="cpu",
                                 args=(inp,), timeout_s=SPAWN_TIMEOUT_S, workdir=work)
                for shape in SHAPES + (ESC_SHAPE,)}
        log, _ = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, log[-4000:]
    return inp, dict(np.load(work / "reference.npz")), port


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
    _reference(sys.argv[2], sys.argv[3])
