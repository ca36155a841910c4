"""The port's SUMMA3D steps outside the fused step, and the rest of the
driver's surface, against the JAX package on a 1×1×1 grid, from the same
numpy triplets.

  * ``summa3d_sparse_step`` on the ESC, hash and k-binned multiplies, on
    OR_AND, on a rectangular A·Aᵀ and with ``sorted_merge=False``;
    ``summa3d_dense_step`` with both schedules (on one process the ring
    has one stage); the SpMM wrappers' accumulate mode.
  * ``symbolic3d`` and ``SymbolicResult.per_batch_capacity``.
  * The driver's ``ExecSpec.binned`` override, ``degrade=False`` (the
    unbounded ladder) and ``sorted_merge=False``; ``RunReport.to_dict`` /
    ``from_dict``; ``resolve_specs``'s ``DeprecationWarning`` and
    ``TypeError``.

Tolerances are the port's rules: structure and padding exact, min/max and
boolean values exact, plus_times values within rtol 1e-5 / atol 1e-6.
"""
import dataclasses
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import gen as jgen
from repro.core import semiring as jsr
from repro.core import sparse as jsparse
from repro.core import summa3d as jsumma
from repro.core import symbolic as jsym
from repro.core.batched import RunReport as JReport
from repro.core.batched import batched_summa3d as j_batched
from repro.core.batched import plan_batches as j_plan
from repro.core.batched import symbolic3d as j_symbolic3d
from repro.core.distsparse import scatter_to_grid as j_scatter
from repro.core.grid import make_grid as j_make_grid
from repro.core.specs import ExecSpec as JExec
from repro.core.specs import PlanSpec as JPlan
from repro.core.specs import resolve_specs as j_resolve
from repro_torch.core import convert
from repro_torch.core import local_spgemm as tlocal
from repro_torch.core import semiring as tsr
from repro_torch.core import summa3d as tsumma
from repro_torch.core import symbolic as tsym
from repro_torch.core.batched import RunReport as TReport
from repro_torch.core.batched import batched_summa3d as t_batched
from repro_torch.core.batched import plan_batches as t_plan
from repro_torch.core.batched import symbolic3d as t_symbolic3d
from repro_torch.core.distsparse import scatter_to_grid as t_scatter
from repro_torch.core.grid import make_grid as t_make_grid
from repro_torch.core.specs import ExecSpec as TExec
from repro_torch.core.specs import PlanFloors as TFloors
from repro_torch.core.specs import PlanSpec as TPlan
from repro_torch.core.specs import resolve_specs as t_resolve
from repro_torch.kernels import spmm_kernel

# the reference's steps under jit, as its driver runs them (eager shard_map
# takes tens of seconds a call)
j_sparse_step = jax.jit(jsumma.summa3d_sparse_step, static_argnames=(
    "grid", "caps", "semiring", "sorted_merge", "kbin", "hashc"))
j_dense_step = jax.jit(jsumma.summa3d_dense_step,
                       static_argnames=("grid", "semiring", "schedule"))


@pytest.fixture(scope="module")
def grids():
    return j_make_grid(1, 1, 1), t_make_grid(1, 1, 1, device="cpu")


def _rand(n, density, seed, m=None, boolean=False):
    """A global JAX SparseCOO of an (m × n) random matrix (m = n by default)."""
    m = n if m is None else m
    rng = np.random.default_rng(seed)
    mask = rng.random((m, n)) < density
    r, c = np.nonzero(mask)
    v = np.ones(len(r), np.float32) if boolean else (rng.random(len(r)) + 0.1).astype(np.float32)
    return jsparse.from_numpy_coo(r.astype(np.int32), c.astype(np.int32), v, (m, n),
                                  cap=2 * len(r) + 8)


def _both(a, grids, kind):
    """``a`` scattered as ``kind`` by each package."""
    jg, tg = grids
    return j_scatter(a, jg, kind), t_scatter(convert.from_reference(a, device="cpu"), tg, kind)


def _assert_same_dist(t, j, exact_vals):
    got = convert.to_numpy(t)
    for f in ("rows", "cols", "nnz"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(j, f)), err_msg=f)
    if exact_vals:
        np.testing.assert_array_equal(got["vals"], np.asarray(j.vals))
    else:
        np.testing.assert_allclose(got["vals"], np.asarray(j.vals), rtol=1e-5, atol=1e-6)
    assert (t.shape, t.tile_shape, t.grid_shape, t.kind) == (j.shape, j.tile_shape,
                                                            j.grid_shape, j.kind)


def _dense(x):
    out = np.zeros(x.shape, np.float32)
    nnz = int(x.nnz)
    out[np.asarray(x.rows[:nnz]), np.asarray(x.cols[:nnz])] = np.asarray(x.vals[:nnz])
    return out


# ---------------------------------------------------------------------------
# the sparse step
# ---------------------------------------------------------------------------
SPARSE_CASES = {
    # case -> (local path, semiring, sorted_merge)
    "esc": ("esc", "plus_times", True),
    "esc_unsorted_merge": ("esc", "plus_times", False),
    "hash": ("hash", "plus_times", True),
    "binned": ("binned", "plus_times", True),
    "or_and": ("esc", "or_and", True),
    "hash_min_plus": ("hash", "min_plus", True),
}


def _step_caps(jA, jB, tA, tB, grids, local_path):
    """(JAX kwargs, port kwargs) of the caps the one-batch plan of
    ``local_path`` gives, its bin map and hash caps included."""
    plan = j_plan(jA, jB, grids[0], 1 << 30, spec=JPlan(local_path=local_path))
    tplan = t_plan(tA, tB, grids[1], 1 << 30, spec=TPlan(local_path=local_path))
    assert plan.num_batches == tplan.num_batches == 1
    jkw = {"caps": plan.caps}
    tkw = {"caps": tsumma.BatchCaps(*dataclasses.astuple(plan.caps))}
    if local_path == "hash":
        jkw["hashc"] = plan.hash_caps
        tkw["hashc"] = tsumma.HashCaps(*dataclasses.astuple(plan.hash_caps))
    if local_path == "binned":
        kb = plan.kbin
        jkw.update(kbin=jsumma.BinnedCaps(kb.num_bins, kb.bin_cap_a, kb.bin_cap_b),
                   bin_of_k=np.asarray(kb.bin_of_k))
        tkw.update(kbin=tsumma.BinnedCaps(kb.num_bins, kb.bin_cap_a, kb.bin_cap_b),
                   bin_of_k=torch.as_tensor(np.asarray(tplan.kbin.bin_of_k)))
    return jkw, tkw


@pytest.mark.parametrize("case", list(SPARSE_CASES))
def test_sparse_step_matches_jax(grids, case):
    local_path, semiring, sorted_merge = SPARSE_CASES[case]
    boolean = semiring == "or_and"
    a, b = _rand(48, 0.15, 1, boolean=boolean), _rand(48, 0.15, 2, boolean=boolean)
    (jA, tA), (jB, tB) = _both(a, grids, "A"), _both(b, grids, "B")
    jkw, tkw = _step_caps(jA, jB, tA, tB, grids, local_path)
    jc, jovf = j_sparse_step(jA, jB, grid=grids[0], semiring=jsr.get(semiring),
                             sorted_merge=sorted_merge, **jkw)
    tc, tovf = tsumma.summa3d_sparse_step(tA, tB, grids[1], semiring=tsr.get(semiring),
                                          sorted_merge=sorted_merge, **tkw)
    assert int(tovf) == int(jovf) == 0
    assert tovf.dtype == torch.int32
    _assert_same_dist(tc, jc, exact_vals=semiring != "plus_times")
    if semiring == "plus_times":
        got = _dense(tc.local(0, 0, 0))
        np.testing.assert_allclose(got, _dense(a) @ _dense(b), rtol=1e-5, atol=1e-6)


def test_sparse_step_overflow_matches_jax(grids):
    """Capacities far below the product: both steps report an overflow."""
    a = _rand(48, 0.2, 3)
    (jA, tA), (jB, tB) = _both(a, grids, "A"), _both(a, grids, "B")
    caps = (64, 64, 64, 64)
    _, jovf = j_sparse_step(jA, jB, grid=grids[0], caps=jsumma.BatchCaps(*caps))
    tc, tovf = tsumma.summa3d_sparse_step(tA, tB, grids[1], tsumma.BatchCaps(*caps))
    assert int(jovf) > 0 and (int(tovf) > 0) == (int(jovf) > 0)


def test_rectangular_aat_sparse_step_matches_jax(grids):
    """A·Aᵀ of a k-mer-like (32 × 64) matrix (the reference's
    ``rectangular_aat`` case, here on one process)."""
    a = jgen.kmer_like(32, 64, 4, seed=71)
    at = a.transpose().sort_rowmajor()
    (jA, tA), (jB, tB) = _both(a, grids, "A"), _both(at, grids, "B")
    jcaps = jsumma.BatchCaps(flops_cap=8192, d_cap=4096, piece_cap=2048, c_cap=2048)
    tcaps = tsumma.BatchCaps(flops_cap=8192, d_cap=4096, piece_cap=2048, c_cap=2048)
    jc, jovf = j_sparse_step(jA, jB, grid=grids[0], caps=jcaps)
    tc, tovf = tsumma.summa3d_sparse_step(tA, tB, grids[1], tcaps)
    assert int(tovf) == int(jovf) == 0
    assert tc.shape == (32, 32)
    _assert_same_dist(tc, jc, exact_vals=False)
    xa = _dense(a)
    np.testing.assert_allclose(_dense(tc.local(0, 0, 0)), xa @ xa.T, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the dense step and SpMM's accumulate mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_dense_step_matches_jax(grids, schedule):
    a, b = _rand(64, 0.1, 5), _rand(64, 0.1, 7)
    (jA, tA), (jB, tB) = _both(a, grids, "A"), _both(b, grids, "B")
    want = np.asarray(j_dense_step(jA, jB, grid=grids[0], schedule=schedule))
    got = tsumma.summa3d_dense_step(tA, tB, grids[1], schedule=schedule)
    assert tuple(got.shape) == want.shape == (1, 1, 1, 64, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy()[0, 0, 0], _dense(a) @ _dense(b),
                               rtol=1e-5, atol=1e-6)


def test_dense_step_rejects_min_monoid_and_unknown_schedule(grids):
    a = _rand(16, 0.2, 9)
    tA, tB = (t_scatter(convert.from_reference(a, device="cpu"), grids[1], k) for k in "AB")
    with pytest.raises(AssertionError, match="sum monoid"):
        tsumma.summa3d_dense_step(tA, tB, grids[1], tsr.MIN_PLUS)
    with pytest.raises(AssertionError):
        tsumma.summa3d_dense_step(tA, tB, grids[1], schedule="tree")


def test_spmm_accumulates_into_out():
    """``out`` takes ``out + A·B`` in place, in both wrappers, with the same
    value as adding the product afterwards."""
    rng = np.random.default_rng(11)
    a = _rand(32, 0.2, 12)
    ta = convert.from_reference(a, device="cpu")
    b = torch.from_numpy(rng.random((32, 24)).astype(np.float32))
    acc = torch.from_numpy(rng.random((32, 24)).astype(np.float32))
    want = acc + tlocal.spmm(ta, b)
    out = acc.clone()
    got = tlocal.spmm(ta, b, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, want)
    out2 = acc.clone()
    spmm_kernel.spmm(ta.rows, ta.cols, ta.vals, b, 32, out=out2)
    assert torch.equal(out2, acc + spmm_kernel.spmm(ta.rows, ta.cols, ta.vals, b, 32))
    with pytest.raises(ValueError, match="out must be"):
        spmm_kernel.spmm(ta.rows, ta.cols, ta.vals, b, 32, out=torch.zeros((32, 23)))
    with pytest.raises(ValueError, match="sum monoids"):
        tlocal.spmm(ta, b, tsr.MIN_PLUS, out=acc.clone())


# ---------------------------------------------------------------------------
# the symbolic step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["protein", "rmat"])
def test_symbolic3d_matches_jax(grids, kind):
    a = (jgen.protein_similarity_like(128, blocks=4, intra_p=0.12, seed=0) if kind == "protein"
         else jgen.rmat(7, edge_factor=6, seed=1))
    (jA, tA), (jB, tB) = _both(a, grids, "A"), _both(a, grids, "B")
    want = np.asarray(j_symbolic3d(jA, jB, grids[0]))
    got = t_symbolic3d(tA, tB, grids[1])
    np.testing.assert_array_equal(got, want)
    x = _dense(a) != 0
    assert int(got.sum()) == int((x.sum(0) * x.sum(1)).sum())


@pytest.mark.parametrize("slack", [1.0, 1.25, 2.0])
def test_symbolic_result_per_batch_capacity_matches_jax(slack):
    for fields in ((4, 1000, 10, 20, 5000, 3), (1, 3, 1, 1, 3, 1), (0, 0, 0, 0, 0, 1),
                   (7, 123457, 99, 98, 10 ** 9, 6)):
        j, t = jsym.SymbolicResult(*fields), tsym.SymbolicResult(*fields)
        assert t.per_batch_capacity(slack) == j.per_batch_capacity(slack)
        assert dataclasses.astuple(t) == dataclasses.astuple(j)


# ---------------------------------------------------------------------------
# the driver's remaining knobs
# ---------------------------------------------------------------------------
def _drive(grids, a, budget, jspec, jexec, tspec, texec, semiring="plus_times"):
    (jA, tA), (jB, tB) = _both(a, grids, "A"), _both(a, grids, "B")
    outs = {"j": [], "t": []}
    jres = j_batched(jA, jB, grids[0], budget, semiring=jsr.get(semiring), spec=jspec,
                     exec_spec=jexec, consumer=lambda bi, cb, cm: outs["j"].append((cb, cm)))
    tres = t_batched(tA, tB, grids[1], budget, semiring=tsr.get(semiring), spec=tspec,
                     exec_spec=texec, consumer=lambda bi, cb, cm: outs["t"].append((cb, cm)))
    assert tres.local_path == jres.local_path and tres.binned == jres.binned
    assert tres.num_retries == jres.num_retries
    assert TReport.from_dict(jres.report.to_dict()) == tres.report
    assert dataclasses.astuple(tres.plan.caps) == dataclasses.astuple(jres.plan.caps)
    assert tres.plan.num_batches == jres.plan.num_batches == len(outs["t"])
    for (tcb, tcm), (jcb, jcm) in zip(outs["t"], outs["j"]):
        np.testing.assert_array_equal(tcm, jcm)
        _assert_same_dist(tcb, jcb, exact_vals=semiring != "plus_times")
    return jres, tres


def _budget(a, fraction):
    nnz = int(a.nnz)
    return 12 * 2 * nnz + 12 * 20 * nnz // fraction


@pytest.mark.parametrize("binned", [True, False])
def test_binned_override_matches_jax(grids, binned):
    """``ExecSpec.binned`` True/False under "auto": both drivers plan the
    ESC budget and force (or pin off) the k-binned multiply alike."""
    a = jgen.protein_similarity_like(128, blocks=4, intra_p=0.12, seed=0)
    jres, tres = _drive(grids, a, _budget(a, 4), JPlan(), JExec(binned=binned),
                        TPlan(), TExec(binned=binned))
    assert tres.binned is binned
    assert tres.plan.local_path == "esc"  # the override plans the ESC budget


def test_unbounded_ladder_matches_jax(grids):
    """``degrade=False`` at a budget whose ladder the default would block:
    both drivers keep doubling and neither replans."""
    rng = np.random.default_rng(0)
    n = 64
    dense = (rng.random((n, n)) < 0.3) * rng.random((n, n)).astype(np.float32)
    r, c = np.nonzero(dense)
    a = jsparse.from_numpy_coo(r.astype(np.int32), c.astype(np.int32),
                               dense[r, c].astype(np.float32), (n, n))
    loose = j_plan(j_scatter(a, grids[0], "A"), j_scatter(a, grids[0], "B"), grids[0], 1 << 30,
                   spec=JPlan(slack=1.0, local_path="esc"))
    budget = 12 * 2 * int(a.nnz) + 12 * loose.caps.flops_cap // 4
    spec_kw = dict(slack=0.5, local_path="esc")
    jblock, tblock = _drive(grids, a, budget, JPlan(**spec_kw), JExec(max_retries=12),
                            TPlan(**spec_kw), TExec(max_retries=12))
    assert tblock.report.replans > 0  # the default ladder is blocked here
    jres, tres = _drive(grids, a, budget, JPlan(**spec_kw),
                        JExec(max_retries=12, degrade=False),
                        TPlan(**spec_kw), TExec(max_retries=12, degrade=False))
    assert tres.report.replans == tres.report.ladder_blocked == 0
    assert tres.num_retries > 0


@pytest.mark.parametrize("local_path", ["esc", "hash"])
def test_unsorted_merge_driver_matches_jax(grids, local_path):
    a = jgen.rmat(7, edge_factor=6, seed=1)
    _drive(grids, a, _budget(a, 3), JPlan(local_path=local_path), JExec(sorted_merge=False),
           TPlan(local_path=local_path), TExec(sorted_merge=False))


def test_run_report_dicts_match_jax():
    fields = dict(retries=3, sel_retries=1, replans=2, ladder_blocked=4,
                  degraded_batches=((0, 2), (3, 4)), straggler_events=5, restarts=1,
                  refused_restores=2, checkpoint_stalls=3, checkpoint_stall_s=0.25,
                  checkpoint_bytes=1 << 20)
    j, t = JReport(**fields), TReport(**fields)
    assert t.to_dict() == j.to_dict()
    assert json.loads(json.dumps(t.to_dict())) == t.to_dict()
    assert TReport.from_dict(j.to_dict()) == t
    assert TReport.from_dict({**t.to_dict(), "unknown": 1}) == t
    assert t.merged(t).to_dict() == j.merged(j).to_dict()
    assert TReport().to_dict() == JReport().to_dict()


# ---------------------------------------------------------------------------
# resolve_specs: the legacy keyword surface
# ---------------------------------------------------------------------------
def test_legacy_keywords_warn_and_plan_like_specs(grids):
    a = jgen.rmat(7, edge_factor=6, seed=2)
    (jA, tA), (jB, tB) = _both(a, grids, "A"), _both(a, grids, "B")
    kw = dict(force_num_batches=2, local_path="esc", slack=1.5, caps_pow2=True)
    with pytest.warns(DeprecationWarning, match="plan_batches"):
        legacy = t_plan(tA, tB, grids[1], 1 << 24, **kw)
    with pytest.warns(DeprecationWarning, match="plan_batches"):
        jlegacy = j_plan(jA, jB, grids[0], 1 << 24, **kw)
    new = t_plan(tA, tB, grids[1], 1 << 24,
                 spec=TPlan(force_num_batches=2, local_path="esc", slack=1.5),
                 floors=TFloors(caps_pow2=True))
    for p in (legacy, new):
        assert (p.num_batches, dataclasses.astuple(p.caps), p.sel_cap, p.local_path) == (
            jlegacy.num_batches, dataclasses.astuple(jlegacy.caps), jlegacy.sel_cap,
            jlegacy.local_path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a bare call must not warn
        assert t_plan(tA, tB, grids[1], 1 << 24).local_path == "esc"
    got = []
    with pytest.warns(DeprecationWarning, match="batched_summa3d"):
        res = t_batched(tA, tB, grids[1], 1 << 24, lambda bi, c, cm: got.append(bi),
                        force_num_batches=2, lookahead=1, pipelined=False)
    assert res.plan.num_batches == 2 and got == [0, 1]


def test_resolve_specs_maps_and_refuses_like_jax():
    legacy = dict(slack=2.0, caps_floor=None, sel_cap_floor=16, lookahead=3, binned=True,
                  degrade=False)
    with pytest.warns(DeprecationWarning):
        tspec, tfloors, tex = t_resolve(None, None, None, dict(legacy))
    with pytest.warns(DeprecationWarning):
        jspec, jfloors, jex = j_resolve(None, None, None, dict(legacy))
    assert (tspec.slack, tspec.local_path, tfloors.sel_cap) == (
        jspec.slack, jspec.local_path, jfloors.sel_cap)
    assert dataclasses.astuple(tex) == dataclasses.astuple(jex)
    for resolve in (t_resolve, j_resolve):
        with pytest.raises(TypeError, match="unexpected keyword"):
            resolve(None, None, None, {"slak": 1.0})
        with pytest.raises(TypeError, match="unexpected keyword"):
            resolve(None, None, None, {"lookahead": 2}, allow_exec=False)
        with pytest.raises(TypeError, match="must be a PlanSpec"):
            resolve(1 << 20, None, None, {})
        with pytest.raises(TypeError, match="must be a PlanFloors"):
            resolve(None, 3, None, {})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        spec, floors, ex = t_resolve(None, None, None, {}, default_local_path="esc")
    assert spec.local_path == "esc" and floors == TFloors() and ex == TExec()
