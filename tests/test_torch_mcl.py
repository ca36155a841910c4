"""The port's Markov clustering (``sparse_apps/mcl.py``) and the modules it
needs against the JAX package on a 1×1×1 grid, from the same numpy inputs.

On the CPU the port runs its kernels' plain versions (the col_prune
bisection, the SpMM, densify); the JAX package runs its Pallas kernels in
interpret mode and its jnp twins, as its own tests do. Tolerances and why:

  * structure (which (row, col) survive, nnz, batch counts, overflow)
    identical;
  * values within rtol 1e-5: ``v ** inflation`` and the column sums round
    the last ulp differently in torch and XLA;
  * chaos within rtol 1e-4 (atol 1e-5) over a whole loop: it is a
    difference of two O(1) column statistics, so those ulps reach it
    amplified, iteration after iteration;
  * cluster partitions identical, compared by co-membership.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import gen as jgen
from repro.core import sparse as jsparse
from repro.core.batched import batched_summa3d as j_batched
from repro.core.batched import plan_batches as j_plan
from repro.core.distsparse import dist_col_reduce as j_col_reduce
from repro.core.distsparse import gather_to_global as j_gather
from repro.core.distsparse import scatter_to_grid as j_scatter
from repro.core.grid import make_grid as j_make_grid
from repro.core.specs import PlanSpec as JPlan
from repro.core.summa3d import reassemble_operands as j_reassemble
from repro.sparse_apps import mcl as jmcl
from repro_torch.core import convert
from repro_torch.core import sparse as tsparse
from repro_torch.core.batched import RunReport
from repro_torch.core.batched import batched_summa3d as t_batched
from repro_torch.core.batched import plan_batches as t_plan
from repro_torch.core.distsparse import dist_col_reduce as t_col_reduce
from repro_torch.core.distsparse import dist_col_sums as t_col_sums
from repro_torch.core.distsparse import gather_to_global as t_gather
from repro_torch.core.distsparse import scatter_to_grid as t_scatter
from repro_torch.core.grid import make_grid as t_make_grid
from repro_torch.core.specs import PlanSpec as TPlan
from repro_torch.core.summa3d import reassemble_operands as t_reassemble
from repro_torch.sparse_apps import mcl as tmcl


@pytest.fixture(scope="module")
def grids():
    return j_make_grid(1, 1, 1), t_make_grid(1, 1, 1, device="cpu")


def _dense_mat(n, density, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.1, 1.0, (n, n)).astype(np.float32)
    return np.where(rng.random((n, n)) < density, x, 0.0).astype(np.float32)


def _uniform_cols(n=16, deg=5):
    """Every column holds ``deg`` equal values: a tie across any k < deg."""
    x = np.zeros((n, n), np.float32)
    for j in range(n):
        x[(np.arange(deg) + j) % n, j] = 1.0
    return x


def _both(x):
    """A dense numpy matrix as the JAX and the port SparseCOO."""
    r, c = np.nonzero(x)
    r, c, v = r.astype(np.int32), c.astype(np.int32), x[r, c]
    return (jsparse.from_numpy_coo(r, c, v, x.shape),
            tsparse.from_numpy_coo(r, c, v, x.shape, device="cpu"))


def _scatter_both(x, grids, kind):
    ja, ta = _both(x)
    return j_scatter(ja, grids[0], kind), t_scatter(ta, grids[1], kind)


def _planted(n=64, blocks=2, intra_p=0.6, seed=3):
    """The planted-cluster input of the JAX package's MCL cases
    (``tests/app_cases.py``), column-normalized, as both packages' COO."""
    a = jgen.protein_similarity_like(n, blocks=blocks, intra_p=intra_p, seed=seed)
    nnz = int(a.nnz)
    r, c = np.asarray(a.rows[:nnz]), np.asarray(a.cols[:nnz])
    v = jmcl._col_normalize_np(r, c, np.asarray(a.vals[:nnz]).astype(np.float64), n)
    v = v.astype(np.float32)
    return (jsparse.from_numpy_coo(r, c, v, (n, n), cap=nnz),
            tsparse.from_numpy_coo(r, c, v, (n, n), cap=nnz, device="cpu"))


def _assert_dist_equal(t, j, rtol=1e-5):
    """Same padded structure, values within ``rtol``."""
    f = convert.to_numpy(t)
    np.testing.assert_array_equal(f["nnz"], np.asarray(j.nnz))
    np.testing.assert_array_equal(f["rows"], np.asarray(j.rows))
    np.testing.assert_array_equal(f["cols"], np.asarray(j.cols))
    np.testing.assert_allclose(f["vals"], np.asarray(j.vals), rtol=rtol, atol=1e-7)


def _assert_same_partition(lab_t, lab_j):
    for i in range(len(lab_t)):
        np.testing.assert_array_equal(lab_t == lab_t[i], lab_j == lab_j[i])


def _labels_t(final, n):
    r, c, _ = convert.triplets(final)
    return tmcl.clusters_from_matrix(r, c, n)


def _labels_j(final, n):
    nnz = int(final.nnz)
    r, c = np.asarray(final.rows[:nnz]), np.asarray(final.cols[:nnz])
    return jmcl.clusters_from_matrix(r, c, n)


# ---------------------------------------------------------------------------
# distributed column reductions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["A", "B", "C"])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_dist_col_reduce_matches_jax(grids, kind, op):
    x = _dense_mat(24, 0.4, seed=24 + ord(kind))
    jd, td = _scatter_both(x, grids, kind)
    got = t_col_sums(td, grids[1]) if op == "sum" else t_col_reduce(td, grids[1], op="max")
    got = got.numpy()
    want = np.asarray(j_col_reduce(jd, grids[0], op=op))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    ref = x.sum(axis=0) if op == "sum" else x.max(axis=0)
    np.testing.assert_allclose(got[0, 0, 0], ref, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# per-batch prune steps
# ---------------------------------------------------------------------------
PRUNE_CASES = {
    "distinct_k3": (lambda: _dense_mat(16, 0.5, seed=7), 3),
    "dense_k2": (lambda: _dense_mat(16, 0.8, seed=9), 2),
    "unbound_k16": (lambda: _dense_mat(16, 0.5, seed=8), 16),
    "tied_k2": (_uniform_cols, 2),
}


@pytest.mark.parametrize("case", list(PRUNE_CASES))
def test_prune_sparse_matches_jax(grids, case):
    make, k = PRUNE_CASES[case]
    x = make()
    jd, td = _scatter_both(x, grids, "C")
    jp, jst = jmcl._mcl_prune_sparse(jd, grid=grids[0], inflation=2.0, thresh=1e-4, k=k,
                                     new_cap=200)
    tp, tst = tmcl._mcl_prune_sparse(td, grid=grids[1], inflation=2.0, thresh=1e-4, k=k,
                                     new_cap=200)
    _assert_dist_equal(tp, jp)
    assert int(tst["nnz"]) == int(jst["nnz"])
    assert int(tst["overflow"]) == int(jst["overflow"]) == 0
    np.testing.assert_allclose(float(tst["chaos"]), float(jst["chaos"]), rtol=1e-5, atol=1e-6)
    cols = convert.to_numpy(tp)["cols"][0, 0, 0, :int(tp.nnz[0, 0, 0])]
    counts = np.bincount(cols, minlength=x.shape[1])
    assert counts.max() <= k
    if case == "tied_k2":  # every column ties across k: exactly k survive
        np.testing.assert_array_equal(counts, np.full(x.shape[1], k))


@pytest.mark.parametrize("case", list(PRUNE_CASES))
def test_prune_dense_matches_jax(grids, case):
    make, k = PRUNE_CASES[case]
    x = make()[None, None, None]
    jt, jst = jmcl._mcl_prune_dense(x, grid=grids[0], inflation=2.0, thresh=1e-4, k=k)
    tt, tst = tmcl._mcl_prune_dense(torch.as_tensor(x), grid=grids[1], inflation=2.0,
                                    thresh=1e-4, k=k)
    got, want = tt.numpy(), np.asarray(jt)
    np.testing.assert_array_equal(got != 0, want != 0)  # kept set identical
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert int(tst["nnz"]) == int(jst["nnz"])
    np.testing.assert_allclose(float(tst["chaos"]), float(jst["chaos"]), rtol=1e-5, atol=1e-6)
    counts = (got[0, 0, 0] != 0).sum(0)
    assert counts.max() <= k
    if case == "tied_k2":
        np.testing.assert_array_equal(counts, np.full(x.shape[-1], k))


# ---------------------------------------------------------------------------
# driver pieces: reassembly, the dense path, reserved bytes
# ---------------------------------------------------------------------------
def _operands(grids, n=16):
    xa, xb = _dense_mat(n, 0.4, seed=11), _dense_mat(n, 0.4, seed=13)
    ja, ta = _both(xa)
    jb, tb = _both(xb)
    j_ops = (j_scatter(ja, grids[0], "A"), j_scatter(jb, grids[0], "B"))
    t_ops = (t_scatter(ta, grids[1], "A"), t_scatter(tb, grids[1], "B"))
    return xa @ xb, j_ops, t_ops


@pytest.mark.parametrize("nb", [1, 2, 4])
def test_reassemble_operands_matches_jax(grids, nb):
    want, (jA, jB), (tA, tB) = _operands(grids)
    jbat, tbat = [], []
    j_batched(jA, jB, grids[0], 1 << 30, consumer=lambda bi, c, cm: jbat.append(c),
              spec=JPlan(force_num_batches=nb))
    res = t_batched(tA, tB, grids[1], 1 << 30, consumer=lambda bi, c, cm: tbat.append(c),
                    spec=TPlan(force_num_batches=nb))
    assert res.plan.num_batches == nb
    ja2, jb2, jovf = j_reassemble(tuple(jbat), grids[0], 1024, 1024)
    ta2, tb2, tovf = t_reassemble(tbat, grids[1], 1024, 1024)
    assert int(tovf) == int(jovf) == 0
    assert (ta2.kind, tb2.kind) == ("A", "B")
    assert (ta2.tile_shape, tb2.tile_shape) == (tuple(ja2.tile_shape), tuple(jb2.tile_shape))
    _assert_dist_equal(ta2, ja2)
    _assert_dist_equal(tb2, jb2)
    for d in (ta2, tb2):
        np.testing.assert_allclose(t_gather(d).to_dense().numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nb", [1, 2, 4])
def test_dense_batched_tiles_match_jax(grids, nb):
    want, (jA, jB), (tA, tB) = _operands(grids)
    jt, tt = [], []
    jres = j_batched(jA, jB, grids[0], 1 << 30, path="dense",
                     consumer=lambda bi, c, cm: jt.append((np.asarray(c), cm)),
                     spec=JPlan(force_num_batches=nb))
    tres = t_batched(tA, tB, grids[1], 1 << 30, path="dense",
                     consumer=lambda bi, c, cm: tt.append((c.numpy(), cm)),
                     spec=TPlan(force_num_batches=nb))
    assert tres.plan.num_batches == jres.plan.num_batches == nb
    assert dataclasses.astuple(tres.plan.caps) == dataclasses.astuple(jres.plan.caps)
    assert tres.local_path == jres.local_path
    assert tres.floors().to_meta() == jres.floors().to_meta()
    got = np.zeros_like(want)
    for (tiles, cm), (jtiles, jcm) in zip(tt, jt):
        np.testing.assert_array_equal(cm, jcm)
        np.testing.assert_allclose(tiles, jtiles, rtol=1e-5, atol=1e-7)
        got[:, cm[0, 0]] = tiles[0, 0, 0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_reserved_bytes_plan_matches_jax(grids):
    x = _dense_mat(32, 0.5, seed=17)
    jA, tA = _scatter_both(x, grids, "A")
    jB, tB = _scatter_both(x, grids, "B")
    plans = []
    for reserved in (0, 3 << 14):
        jp = j_plan(jA, jB, grids[0], 1 << 16, spec=JPlan(reserved_bytes=reserved))
        tp = t_plan(tA, tB, grids[1], 1 << 16, spec=TPlan(reserved_bytes=reserved))
        assert (tp.num_batches, tp.sel_cap) == (jp.num_batches, jp.sel_cap)
        assert dataclasses.astuple(tp.caps) == dataclasses.astuple(jp.caps)
        plans.append(tp)
    assert plans[1].num_batches > plans[0].num_batches
    with pytest.raises(MemoryError):
        t_plan(tA, tB, grids[1], 1 << 16, spec=TPlan(reserved_bytes=1 << 16))


# ---------------------------------------------------------------------------
# whole loops
# ---------------------------------------------------------------------------
LOOPS = [(None, 64), (4, 64), (4, 4)]


@pytest.mark.parametrize("nb,k", LOOPS, ids=[f"b{b}_k{k}" for b, k in LOOPS])
@pytest.mark.parametrize("path", ["sparse", "dense"])
def test_mcl_iterate_matches_jax(grids, path, nb, k):
    n = 64
    ja, ta = _planted(n)
    kw = dict(max_iters=12, per_process_memory=1 << 24, force_num_batches=nb,
              max_per_col=k, path=path)
    fin_j, hist_j = jmcl.mcl_iterate(ja, grids[0], jmcl.MCLConfig(**kw))
    fin_t, hist_t = tmcl.mcl_iterate(ta, grids[1], tmcl.MCLConfig(**kw))
    assert [h["nnz"] for h in hist_t] == [h["nnz"] for h in hist_j]
    assert [h["batches"] for h in hist_t] == [h["batches"] for h in hist_j]
    np.testing.assert_allclose([h["chaos"] for h in hist_t], [h["chaos"] for h in hist_j],
                               rtol=1e-4, atol=1e-5)
    lab_t, lab_j = _labels_t(fin_t, n), _labels_j(fin_j, n)
    _assert_same_partition(lab_t, lab_j)
    if k == 64:
        assert len(set(lab_t.tolist())) == 2
    assert hist_t[-1]["chaos"] < 1e-3
    assert max(h["host_bytes"] for h in hist_t) < 1024  # stat scalars only


@pytest.mark.parametrize("path", ["sparse", "dense"])
def test_mcl_device_matches_host(grids, path):
    """The port's device loop against its host loop (numpy pruning, the
    same multiply), and the host loop against the JAX package's."""
    n = 64
    ja, ta = _planted(n)
    cfg = dict(max_iters=12, per_process_memory=1 << 24, force_num_batches=4,
               max_per_col=64, path=path)
    fin_d, hist_d = tmcl.mcl_iterate(ta, grids[1], tmcl.MCLConfig(**cfg))
    fin_h, hist_h = tmcl.mcl_iterate_host(ta, grids[1], tmcl.MCLConfig(**cfg))
    _, hist_jh = jmcl.mcl_iterate_host(ja, grids[0], jmcl.MCLConfig(**cfg))
    assert [h["nnz"] for h in hist_d] == [h["nnz"] for h in hist_h]
    assert [h["nnz"] for h in hist_h] == [h["nnz"] for h in hist_jh]
    np.testing.assert_allclose([h["chaos"] for h in hist_d], [h["chaos"] for h in hist_h],
                               rtol=1e-3, atol=1e-5)
    _assert_same_partition(_labels_t(fin_d, n), _labels_t(fin_h, n))
    assert min(h["host_bytes"] for h in hist_h) > 10240  # the matrix, every batch


def test_mcl_continues_from_a_jax_iterate(grids):
    """One JAX iteration, then both loops go on from the same iterate,
    carried across by ``convert.iterate_from_reference``."""
    n = 64
    ja, _ = _planted(n)
    cfg = dict(max_iters=12, per_process_memory=1 << 24, force_num_batches=4, max_per_col=16)
    jcfg, tcfg = jmcl.MCLConfig(**cfg), tmcl.MCLConfig(**cfg)
    jstate = jmcl._mcl_cold_state(ja, grids[0], jcfg)
    jstate, _, _ = jmcl._mcl_sparse_step(jstate, grids[0], jcfg)
    tstate = tmcl.MCLLoopState(**convert.iterate_from_reference(jstate, device="cpu"),
                               history=[], report=RunReport())
    assert tstate.it == 1 and tstate.floors.caps_pow2
    assert tstate.binned_arg == jstate.binned_arg != "auto"  # the pinned decision
    _assert_dist_equal(tstate.A, jstate.A, rtol=0)
    fin_t, hist_t = tmcl.mcl_continue(tstate, grids[1], tcfg)
    hist_j = jstate.history
    while jstate.it < jcfg.max_iters:
        jstate, _, done = jmcl._mcl_sparse_step(jstate, grids[0], jcfg)
        if done:
            break
    fin_j = j_gather(jstate.A)
    assert [h["nnz"] for h in hist_t] == [h["nnz"] for h in hist_j[1:]]
    np.testing.assert_allclose([h["chaos"] for h in hist_t], [h["chaos"] for h in hist_j[1:]],
                               rtol=1e-4, atol=1e-5)
    _assert_same_partition(_labels_t(fin_t, n), _labels_j(fin_j, n))
