"""The port's symbolic pass, planner and batched driver against the JAX
package on a 1×1×1 grid, from the same numpy triplets.

Plans must be equal field by field; per-batch outputs identical in
structure (padded arrays included) with plus_times values within rtol 1e-5
and min/max values exact; the ``RunReport``s equal — also when a starved
plan forces both drivers through the retry ladder, and when the ladder is
blocked and both replan at finer batching.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps

from repro.core import gen as jgen
from repro.core import semiring as jsr
from repro.core import sparse as jsparse
from repro.core.batched import batch_column_map as j_colmap
from repro.core.batched import batched_summa3d as j_batched
from repro.core.batched import plan_batches as j_plan
from repro.core.batched import symbolic3d_counts as j_counts
from repro.core.distsparse import scatter_to_grid as j_scatter
from repro.core.grid import make_grid as j_make_grid
from repro.core.specs import ExecSpec as JExec
from repro.core.specs import PlanFloors as JFloors
from repro.core.specs import PlanSpec as JPlan
from repro.sparse_apps.mcl import _sparse_batch_to_global as j_to_global
from repro_torch.core import convert
from repro_torch.core import semiring as tsr
from repro_torch.core.batched import batch_column_map as t_colmap
from repro_torch.core.batched import batched_summa3d as t_batched
from repro_torch.core.batched import plan_batches as t_plan
from repro_torch.core.batched import symbolic3d_counts as t_counts
from repro_torch.core.distsparse import scatter_to_grid as t_scatter
from repro_torch.core.grid import make_grid as t_make_grid
from repro_torch.core.specs import ExecSpec as TExec
from repro_torch.core.specs import PlanFloors as TFloors
from repro_torch.core.specs import PlanSpec as TPlan


@pytest.fixture(scope="module")
def grids():
    return j_make_grid(1, 1, 1), t_make_grid(1, 1, 1, device="cpu")


def _global(kind):
    """A global JAX SparseCOO: protein-similarity-like or R-MAT, 256 rows."""
    if kind == "protein":
        return jgen.protein_similarity_like(256, blocks=4, intra_p=0.12, seed=0)
    if kind == "rmat":
        return jgen.rmat(8, edge_factor=6, seed=1)
    rng = np.random.default_rng(0)  # "dense": the degradation case's input
    n = 64
    dense = (rng.random((n, n)) < 0.3).astype(np.float32) * rng.random((n, n)).astype(np.float32)
    r, c = np.nonzero(dense)
    return jsparse.from_numpy_coo(r.astype(np.int32), c.astype(np.int32), dense[r, c], (n, n))


@pytest.fixture(scope="module")
def operands(grids):
    """kind -> (JAX A, JAX B, port A, port B), both scattered by their own
    package from the same global triplets."""
    jg, tg = grids
    out = {}
    for kind in ("protein", "rmat", "dense"):
        a = _global(kind)
        ta = convert.from_reference(a, device="cpu")
        out[kind] = (j_scatter(a, jg, "A"), j_scatter(a, jg, "B"),
                     t_scatter(ta, tg, "A"), t_scatter(ta, tg, "B"))
    return out


def _assert_same_dist(t, j, exact_vals=False):
    got = convert.to_numpy(t)
    for f in ("rows", "cols", "nnz"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(j, f)))
    if exact_vals:
        np.testing.assert_array_equal(got["vals"], np.asarray(j.vals))
    else:
        np.testing.assert_allclose(got["vals"], np.asarray(j.vals), rtol=1e-5, atol=1e-6)
    assert (t.shape, t.tile_shape, t.grid_shape, t.kind) == (j.shape, j.tile_shape,
                                                            j.grid_shape, j.kind)


def _assert_same_plan(tp, jp):
    for f in ("num_batches", "lower_bound", "total_flops", "max_unmerged_nnz",
              "sel_cap", "local_path", "compression_est"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert dataclasses.astuple(tp.caps) == dataclasses.astuple(jp.caps)
    assert (tp.hash_caps is None) == (jp.hash_caps is None)
    if tp.hash_caps is not None:
        assert dataclasses.astuple(tp.hash_caps) == dataclasses.astuple(jp.hash_caps)
    np.testing.assert_array_equal(tp.per_batch_flops, jp.per_batch_flops)
    for f in ("num_bins", "bin_cap_a", "bin_cap_b", "pairings", "pairings_unbinned"):
        assert getattr(tp.kbin, f) == getattr(jp.kbin, f), f
    np.testing.assert_array_equal(tp.kbin.bin_of_k, jp.kbin.bin_of_k)


def _budget(A, B, flops, fraction):
    """Inputs plus 1/fraction of the r-byte unmerged output."""
    inputs = 12 * (int(np.asarray(A.nnz).max()) + int(np.asarray(B.nnz).max()))
    return inputs + 12 * flops // fraction


@pytest.mark.parametrize("kind", ["protein", "rmat"])
def test_scatter_and_symbolic_counts_match_jax(grids, operands, kind):
    jA, jB, tA, tB = operands[kind]
    _assert_same_dist(tA, jA, exact_vals=True)
    _assert_same_dist(tB, jB, exact_vals=True)
    jc, tc = j_counts(jA, jB, grids[0]), t_counts(tA, tB, grids[1])
    for f in ("percol", "b_colcounts", "a_kcounts", "b_kcounts"):
        np.testing.assert_array_equal(getattr(tc, f), np.asarray(getattr(jc, f)), err_msg=f)


@pytest.mark.parametrize("kind", ["protein", "rmat"])
@pytest.mark.parametrize("local_path", ["auto", "esc", "hash", "binned"])
@pytest.mark.parametrize("fraction", [0, 3, 40], ids=["loose", "b~3", "b~40"])
def test_plan_matches_jax(grids, operands, kind, local_path, fraction):
    jA, jB, tA, tB = operands[kind]
    loose = j_plan(jA, jB, grids[0], 1 << 40, spec=JPlan(local_path="esc"))
    budget = 1 << 40 if fraction == 0 else _budget(jA, jB, loose.max_unmerged_nnz, fraction)
    jp = j_plan(jA, jB, grids[0], budget, spec=JPlan(local_path=local_path))
    tp = t_plan(tA, tB, grids[1], budget, spec=TPlan(local_path=local_path))
    _assert_same_plan(tp, jp)
    jf = j_plan(jA, jB, grids[0], budget, spec=JPlan(local_path=local_path),
                floors=JFloors(caps_pow2=True, sel_cap=64, num_batches=2))
    tf = t_plan(tA, tB, grids[1], budget, spec=TPlan(local_path=local_path),
                floors=TFloors(caps_pow2=True, sel_cap=64, num_batches=2))
    _assert_same_plan(tf, jf)


def _run_both(grids, operands, kind, budget, local_path, semiring="plus_times",
              pipelined=True, slack=1.3, max_retries=4):
    """Drive both packages; return their results and per-batch outputs."""
    jA, jB, tA, tB = operands[kind]
    outs = {"j": [], "t": []}
    jres = j_batched(
        jA, jB, grids[0], budget,
        consumer=lambda bi, cb, cm: outs["j"].append((bi, cb, cm)),
        semiring=jsr.get(semiring), spec=JPlan(local_path=local_path, slack=slack),
        exec_spec=JExec(pipelined=pipelined, max_retries=max_retries),
    )
    tres = t_batched(
        tA, tB, grids[1], budget,
        consumer=lambda bi, cb, cm: outs["t"].append((bi, cb, cm)),
        semiring=tsr.get(semiring), spec=TPlan(local_path=local_path, slack=slack),
        exec_spec=TExec(pipelined=pipelined, max_retries=max_retries),
    )
    return jres, tres, outs


def _assert_same_run(jres, tres, outs, semiring="plus_times"):
    assert tres.local_path == jres.local_path
    assert tres.num_retries == jres.num_retries
    for f in ("retries", "sel_retries", "replans", "ladder_blocked", "degraded_batches"):
        assert getattr(tres.report, f) == getattr(jres.report, f), f
    for f in ("binned_caps", "hash_caps"):
        jv, tv = getattr(jres, f), getattr(tres, f)
        assert (jv is None and tv is None) or dataclasses.astuple(jv) == dataclasses.astuple(tv)
    assert dataclasses.astuple(tres.plan.caps) == dataclasses.astuple(jres.plan.caps)
    assert tres.plan.sel_cap == jres.plan.sel_cap
    assert len(outs["t"]) == len(outs["j"]) == jres.plan.num_batches
    for (tbi, tcb, tcm), (jbi, jcb, jcm) in zip(outs["t"], outs["j"]):
        assert tbi == jbi
        np.testing.assert_array_equal(tcm, jcm)
        _assert_same_dist(tcb, jcb, exact_vals=semiring != "plus_times")


@pytest.mark.parametrize("local_path,semiring", [
    ("auto", "plus_times"), ("esc", "plus_times"), ("hash", "plus_times"),
    ("binned", "plus_times"), ("esc", "min_plus"), ("hash", "max_times"),
])
@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "serial"])
def test_driver_matches_jax(grids, operands, local_path, semiring, pipelined):
    jA, jB, _, _ = operands["protein"]
    budget = 48 * int(np.asarray(jA.nnz).sum())
    jres, tres, outs = _run_both(grids, operands, "protein", budget, local_path,
                                 semiring, pipelined)
    assert jres.plan.num_batches > 1 and jres.num_retries == 0
    _assert_same_run(jres, tres, outs, semiring)


@pytest.mark.parametrize("local_path", ["esc", "hash"])
def test_starved_plan_retries_like_jax(grids, operands, local_path):
    """slack=0.2 under-sizes every capacity: both drivers overflow, walk
    the same doubling ladder and end with the same batches."""
    jres, tres, outs = _run_both(grids, operands, "rmat", 1 << 30, local_path,
                                 slack=0.2, max_retries=12)
    assert jres.num_retries > 0
    _assert_same_run(jres, tres, outs)


def test_blocked_ladder_replans_like_jax(grids, operands):
    """A budget far below the output footprint blocks the doubling ladder:
    both drivers replan the failing batches at finer batching and merge the
    sub-batches back."""
    jA, jB, _, _ = operands["dense"]
    ref = j_plan(jA, jB, grids[0], 1 << 30, spec=JPlan(slack=1.0, local_path="esc"))
    budget = _budget(jA, jB, ref.caps.flops_cap, 4)
    jres, tres, outs = _run_both(grids, operands, "dense", budget, "esc",
                                 slack=0.5, max_retries=12)
    assert jres.report.ladder_blocked > 0 and jres.report.replans > 0
    _assert_same_run(jres, tres, outs)


def test_product_matches_scipy_and_batch_to_global(grids, operands):
    """The port's assembled product equals scipy's A @ A, its column maps
    equal the JAX package's, and its reassembly of a batch into global
    coordinates equals the JAX package's host helper."""
    jA, jB, tA, tB = operands["rmat"]
    a = _global("rmat")
    n = a.shape[0]
    budget = _budget(jA, jB, j_plan(jA, jB, grids[0], 1 << 40).max_unmerged_nnz, 5)
    nb = j_plan(jA, jB, grids[0], budget, spec=JPlan()).num_batches
    assert nb > 1
    parts = []

    def consumer(bi, cb, cm):
        np.testing.assert_array_equal(cm, j_colmap(n, grids[0], nb, bi))
        np.testing.assert_array_equal(cm, t_colmap(n, grids[1], nb, bi))
        parts.append(tuple(x.numpy() for x in convert.batch_to_global(cb, cm)))

    assert t_batched(tA, tB, grids[1], budget, consumer).plan.num_batches == nb
    r, c, v = (np.concatenate(x) for x in zip(*parts))
    got = sps.coo_matrix((v, (r, c)), shape=(n, n)).toarray()
    nnz = int(a.nnz)
    s = sps.csr_matrix((np.asarray(a.vals[:nnz]),
                        (np.asarray(a.rows[:nnz]), np.asarray(a.cols[:nnz]))), shape=(n, n))
    want = (s @ s).toarray()
    assert np.array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    j_outs = []
    j_batched(jA, jB, grids[0], budget, consumer=lambda bi, cb, cm: j_outs.append((cb, cm)))
    jr, jc, jv = j_to_global(*j_outs[1])
    tr, tc, tv = parts[1]
    order_j, order_t = np.lexsort((jc, jr)), np.lexsort((tc, tr))
    np.testing.assert_array_equal(tr[order_t], jr[order_j])
    np.testing.assert_array_equal(tc[order_t], jc[order_j])
    np.testing.assert_allclose(tv[order_t], jv[order_j], rtol=1e-5)


def test_host_oracle_and_gather_match_jax(grids, operands):
    """The host symbolic oracle and ``PlanInputs.from_host`` plan exactly what
    the device pass plans, in both packages; gather_to_global inverts the
    scatter."""
    from repro.core.batched import PlanInputs as JInputs
    from repro.core.batched import plan_from_symbolic as j_from_symbolic
    from repro.core.symbolic import host_symbolic_counts as j_host_counts
    from repro_torch.core.batched import PlanInputs as TInputs
    from repro_torch.core.batched import plan_from_symbolic as t_from_symbolic
    from repro_torch.core.distsparse import gather_to_global
    from repro_torch.core.symbolic import host_symbolic_counts as t_host_counts

    jA, jB, tA, tB = operands["rmat"]
    a = _global("rmat")
    ta = convert.from_reference(a, device="cpu")
    tc, jc = t_host_counts(ta, ta, (1, 1, 1)), j_host_counts(a, a, (1, 1, 1))
    for f in ("percol", "b_colcounts", "a_kcounts", "b_kcounts"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f), err_msg=f)
    budget = _budget(jA, jB, int(tc.percol.sum()), 6)
    tp = t_from_symbolic(tc, TInputs.from_host(ta, ta, (1, 1, 1)), budget,
                         TPlan(local_path="hash"), TFloors())
    jp = j_from_symbolic(jc, JInputs.from_host(a, a, (1, 1, 1)), budget,
                         JPlan(local_path="hash"), JFloors())
    _assert_same_plan(tp, jp)
    _assert_same_plan(tp, t_plan(tA, tB, grids[1], budget, spec=TPlan(local_path="hash")))
    from repro.core.distsparse import tile_nnz_counts as j_tile_counts
    from repro_torch.core.distsparse import tile_nnz_counts as t_tile_counts

    for kind in ("A", "B"):
        np.testing.assert_array_equal(t_tile_counts(ta, grids[1], kind),
                                      j_tile_counts(a, grids[0], kind))
    back = gather_to_global(tA)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(convert.to_numpy(back)[f], np.asarray(getattr(a, f)))


def test_floors_round_trip_and_grid_scope():
    from repro_torch.core.summa3d import BatchCaps, BinnedCaps, HashCaps

    f1 = TFloors(caps=BatchCaps(64, 32, 16, 16), sel_cap=8,
                 kbin_caps=BinnedCaps(4, 16, 8), hash_caps=HashCaps(128, 64, 2))
    f2 = TFloors(caps=BatchCaps(8, 64, 8, 32), num_batches=3, caps_pow2=True,
                 hash_caps=HashCaps(64, 128, 1, 64))
    merged = f1.merged(f2)
    assert merged == f2.merged(f1)
    assert merged.caps == BatchCaps(64, 64, 16, 32) and merged.hash_caps == HashCaps(128, 128, 2, 64)
    assert TFloors.from_meta(merged.to_meta()) == merged
    jm = JFloors.from_meta(merged.to_meta())
    assert jm.to_meta() == merged.to_meta()
    with pytest.raises(ValueError):
        f1.merged(TFloors(kbin_caps=BinnedCaps(8, 16, 8)))
    # no process group of four ranks here: a multi-process shape is refused
    with pytest.raises(RuntimeError, match="process group of 4 ranks, and there is none"):
        t_make_grid(2, 2, 1, device="cpu")
