"""The port's structure-aware placement (``core/placement.py``) against the
JAX package's, from the same numpy triplets, on a 1×1×1 grid.

  * Distribution contract: the port's ``BLOCK_CYCLIC`` folds, rounds and
    maps columns as the reference's and as the port's own
    ``fold_block_cyclic`` math; the driver refuses a distribution the
    device step cannot run and a placement that is not a ``Placement``.
  * Permutations: ``compute_placement`` ("identity", "degree", "rcm") gives
    the reference's arrays, array for array, on R-MAT and Erdős–Rényi
    inputs (power-of-two and other sizes), and the permuted operands are
    the reference's; "rcm" on non-square operands and an unknown strategy
    raise ``ValueError``.
  * Permutation invariance: permute → multiply → unpermute equals the
    identity run and the reference's ``multiply_placed`` EXACTLY across
    {plus_times, min_plus, max_times} × {unmasked, strict mask} × {esc,
    binned, hash} (binned is plus_times only). Values are small integers,
    so every f32 sum is exact in any order.
  * Plan ordering on R-MAT skew (host oracle): the degree plan needs no more
    batches and no more padded transfer bytes than block-cyclic, strictly
    fewer in total, and both packages plan the same.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import gen as jgen
from repro.core import placement as jplace
from repro.core import semiring as jsr
from repro.core import sparse as jsparse
from repro.core.batched import PlanInputs as JInputs
from repro.core.batched import batch_column_map as j_colmap
from repro.core.batched import plan_from_symbolic as j_from_symbolic
from repro.core.grid import make_grid as j_make_grid
from repro.core.specs import PlanFloors as JFloors
from repro.core.specs import PlanSpec as JPlan
from repro.core.symbolic import host_symbolic_counts as j_host_counts
from repro.tune import padded_comm_volume as j_padded
from repro_torch.core import convert
from repro_torch.core import placement as tplace
from repro_torch.core import semiring as tsr
from repro_torch.core.batched import PlanInputs as TInputs
from repro_torch.core.batched import batch_column_map as t_colmap
from repro_torch.core.batched import batched_summa3d as t_batched
from repro_torch.core.batched import plan_from_symbolic as t_from_symbolic
from repro_torch.core.distsparse import scatter_to_grid as t_scatter
from repro_torch.core.grid import make_grid as t_make_grid
from repro_torch.core.specs import PlanFloors as TFloors
from repro_torch.core.specs import PlanSpec as TPlan
from repro_torch.core.symbolic import batching_plan_columns, fold_block_cyclic
from repro_torch.core.symbolic import host_symbolic_counts as t_host_counts
from repro_torch.tune import padded_comm_volume as t_padded


@pytest.fixture(scope="module")
def grids():
    return j_make_grid(1, 1, 1), t_make_grid(1, 1, 1, device="cpu")


def _port(a):
    return convert.from_reference(a, device="cpu")


def _rand_int(n, density, rng, cap=512):
    """A JAX COO with small-INTEGER f32 values (1..4): any summation order
    is exact in f32, so permuted plus_times products compare bit for bit."""
    m = rng.random((n, n)) < density
    rr, cc = np.nonzero(m)
    vals = rng.integers(1, 5, size=rr.shape[0]).astype(np.float32)
    return jsparse.from_numpy_coo(rr, cc, vals, (n, n), cap=cap)


# ---------------------------------------------------------------------------
# the distribution contract
# ---------------------------------------------------------------------------
GRID_SWEEP = [(1, 1, 1), (2, 2, 1), (2, 2, 2), (3, 3, 3), (4, 2, 1), (2, 4, 1), (1, 4, 1)]


@pytest.mark.parametrize("shape", GRID_SWEEP, ids=lambda s: "x".join(map(str, s)))
def test_fold_matches_jax_and_fold_block_cyclic(shape):
    pr, pc, l = shape
    rng = np.random.default_rng(0)
    for nb in (1, 2, 3, 4):
        x = rng.integers(0, 100, size=(pr, pc, l, nb * l * 3))
        got = tplace.BLOCK_CYCLIC.fold(x, nb, l)
        np.testing.assert_array_equal(got, fold_block_cyclic(x, nb, l))
        np.testing.assert_array_equal(got, jplace.BLOCK_CYCLIC.fold(x, nb, l))
        wl = nb * 5
        y = rng.integers(0, 9, size=(pr, pc, l, wl))
        np.testing.assert_array_equal(tplace.BLOCK_CYCLIC.fold_batch_slices(y, nb),
                                      jplace.BLOCK_CYCLIC.fold_batch_slices(y, nb))


def test_round_batches_matches_jax():
    for n in (12, 24, 48, 64, 96):
        for l in (1, 2, 4):
            if n % l:
                continue
            for nb in (1, 2, 3, 5, 7):
                if nb > n // l:
                    for dist in (tplace.BLOCK_CYCLIC, jplace.BLOCK_CYCLIC):
                        with pytest.raises(MemoryError):
                            dist.round_batches(n, nb, l)
                    continue
                got = tplace.BLOCK_CYCLIC.round_batches(n, nb, l)
                assert got == batching_plan_columns(n, nb, l)
                assert got == jplace.BLOCK_CYCLIC.round_batches(n, nb, l)


def test_batch_column_map_matches_jax():
    for n, pc, l, nb in [(64, 2, 2, 2), (48, 2, 1, 4), (96, 4, 1, 2), (32, 1, 1, 4),
                         (64, 1, 2, 2)]:
        grid = SimpleNamespace(pc=pc, l=l)
        for batch in range(nb):
            got = t_colmap(n, grid, nb, batch)
            np.testing.assert_array_equal(got, j_colmap(n, grid, nb, batch))
            assert len(set(got.ravel().tolist())) == got.size


def test_explicit_block_cyclic_spec_plans_identically():
    a = _port(jgen.erdos_renyi(64, 4.0, seed=2))
    b = _port(jgen.erdos_renyi(64, 4.0, seed=3))
    counts = t_host_counts(a, b, (2, 2, 2))
    inputs = TInputs.from_host(a, b, (2, 2, 2))
    p0 = t_from_symbolic(counts, inputs, 1 << 30, TPlan(local_path="esc"), TFloors())
    p1 = t_from_symbolic(counts, inputs, 1 << 30,
                         TPlan(local_path="esc", distribution=tplace.BLOCK_CYCLIC), TFloors())
    for f in ("num_batches", "caps", "sel_cap", "mask_sel_cap", "local_path", "total_flops",
              "max_unmerged_nnz"):
        assert getattr(p0, f) == getattr(p1, f), f
    np.testing.assert_array_equal(p0.per_batch_flops, p1.per_batch_flops)


def test_driver_refuses_what_the_device_step_cannot_run(grids):
    class RowwiseDistribution(tplace.Distribution):
        name = "rowwise"

    a = _port(_rand_int(16, 0.2, np.random.default_rng(4)))
    A, B = t_scatter(a, grids[1], "A"), t_scatter(a, grids[1], "B")
    with pytest.raises(ValueError, match="block-cyclic"):
        t_batched(A, B, grids[1], 1 << 22, lambda bi, c, cm: None,
                  spec=TPlan(distribution=RowwiseDistribution()))
    with pytest.raises(ValueError, match="multiply_placed"):
        t_batched(A, B, grids[1], 1 << 22, lambda bi, c, cm: None,
                  spec=TPlan(placement="degree"))


# ---------------------------------------------------------------------------
# the permutations
# ---------------------------------------------------------------------------
INPUTS = {
    "rmat5": lambda: (jgen.symmetrized(jgen.rmat(5, edge_factor=4, seed=1)),) * 2,
    "rmat7": lambda: (jgen.symmetrized(jgen.rmat(7, edge_factor=8, seed=5)),) * 2,
    "er48": lambda: (jgen.erdos_renyi(48, 3.0, seed=2), jgen.erdos_renyi(48, 3.0, seed=3)),
    "er100": lambda: (jgen.erdos_renyi(100, 2.5, seed=4), jgen.erdos_renyi(100, 2.5, seed=5)),
}


@pytest.mark.parametrize("strategy", ["identity", "degree", "rcm"])
@pytest.mark.parametrize("inputs", list(INPUTS))
def test_permutations_equal_jax(inputs, strategy):
    a, b = INPUTS[inputs]()
    mask = jgen.erdos_renyi(a.shape[0], 2.0, seed=9)
    for m in (None, mask):
        j = jplace.compute_placement(a, b, strategy, mask=m)
        t = tplace.compute_placement(_port(a), _port(b), strategy,
                                     mask=None if m is None else _port(m))
        assert t.strategy == j.strategy == strategy
        assert t.is_identity == j.is_identity == (strategy == "identity")
        for f in ("row_perm", "k_perm", "col_perm", "row_inv", "k_inv", "col_inv"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
        for apply in ("apply_a", "apply_b", "apply_mask"):
            x = {"apply_a": a, "apply_b": b, "apply_mask": mask}[apply]
            got = convert.to_numpy(getattr(t, apply)(_port(x)))
            want = getattr(j, apply)(x)
            for f in ("rows", "cols", "vals", "nnz"):
                np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                              err_msg=f"{apply} {f}")
        idx = np.arange(a.shape[0])
        np.testing.assert_array_equal(t.original_rows(idx), j.original_rows(idx))
        np.testing.assert_array_equal(t.original_cols(idx), j.original_cols(idx))


def test_spread_positions_match_jax():
    for n in (1, 2, 7, 16, 48, 100, 1 << 10):
        got = tplace._spread_positions(n)
        np.testing.assert_array_equal(got, jplace._spread_positions(n))
        assert sorted(got.tolist()) == list(range(n))


def test_rcm_needs_square_operands_and_unknown_strategy_raises():
    a = _port(jgen.erdos_renyi(16, 2.0, seed=0, square=False, ncols=32))
    with pytest.raises(ValueError, match="square"):
        tplace.compute_placement(a, _port(jgen.erdos_renyi(32, 2.0, seed=1)), "rcm")
    b = _port(jgen.erdos_renyi(16, 2.0, seed=0))
    with pytest.raises(ValueError, match="unknown placement strategy"):
        tplace.compute_placement(b, b, "hypergraph")


# ---------------------------------------------------------------------------
# permute → multiply → unpermute
# ---------------------------------------------------------------------------
SEMIRINGS = ("plus_times", "min_plus", "max_times")
SWEEP = [(s, masked, path) for s in SEMIRINGS for masked in (False, True)
         for path in ("esc", "binned", "hash") if path != "binned" or s == "plus_times"]


@pytest.mark.parametrize("semiring,masked,path", SWEEP,
                         ids=[f"{s}-{'mask' if m else 'nomask'}-{p}" for s, m, p in SWEEP])
def test_permute_multiply_unpermute_is_exact_and_matches_jax(grids, semiring, masked, path):
    rng = np.random.default_rng(SWEEP.index((semiring, masked, path)))
    n = 16
    a, b = _rand_int(n, 0.25, rng), _rand_int(n, 0.25, rng)
    mask = _rand_int(n, 0.3, rng) if masked else None
    fill = np.inf if semiring == "min_plus" else 0.0
    tkw = dict(semiring=tsr.get(semiring), spec=TPlan(local_path=path, force_num_batches=2),
               mask=None if mask is None else _port(mask))
    base = tplace.multiply_placed(_port(a), _port(b), grids[1], 1 << 22,
                                  placement=tplace.Placement.identity(n, n, n), **tkw)
    assert base.result.local_path == path and base.result.plan.num_batches == 2
    placed = {}
    for strategy in ("degree", "rcm"):
        placed[strategy] = p = tplace.multiply_placed(_port(a), _port(b), grids[1], 1 << 22,
                                                      strategy=strategy, **tkw)
        assert p.placement.strategy == strategy
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(p, f), getattr(base, f),
                                          err_msg=f"{strategy} {f}")
        np.testing.assert_array_equal(p.to_dense(fill), base.to_dense(fill))
    want = jplace.multiply_placed(
        a, b, grids[0], 1 << 22, strategy="degree", semiring=jsr.get(semiring),
        spec=JPlan(local_path=path, force_num_batches=2), mask=mask)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(placed["degree"], f), getattr(want, f),
                                      err_msg=f)
    assert placed["degree"].shape == want.shape
    assert placed["degree"].result.plan.num_batches == want.result.plan.num_batches


def test_placed_plus_times_matches_dense_product(grids):
    rng = np.random.default_rng(7)
    n = 16
    a, b = _rand_int(n, 0.25, rng), _rand_int(n, 0.25, rng)
    placed = tplace.multiply_placed(_port(a), _port(b), grids[1], 1 << 22, strategy="degree",
                                    spec=TPlan(local_path="esc", force_num_batches=2))

    def dense(x):
        out = np.zeros((n, n), np.float32)
        out[np.asarray(x.rows[: x.nnz]), np.asarray(x.cols[: x.nnz])] = np.asarray(
            x.vals[: x.nnz])
        return out

    np.testing.assert_array_equal(placed.to_dense(), dense(a) @ dense(b))


# ---------------------------------------------------------------------------
# plan ordering on R-MAT skew (host oracle)
# ---------------------------------------------------------------------------
GRID_SHAPE = (2, 2, 2)
R_BYTES = 12


def _plans(a, b, ppm):
    """The port's plan of a·b on GRID_SHAPE from the host oracle and its
    padded volume, both checked equal to the reference's."""
    ta, tb = _port(a), _port(b)
    tp = t_from_symbolic(t_host_counts(ta, tb, GRID_SHAPE), TInputs.from_host(ta, tb, GRID_SHAPE),
                         ppm, TPlan(local_path="esc"), TFloors())
    jp = j_from_symbolic(j_host_counts(a, b, GRID_SHAPE), JInputs.from_host(a, b, GRID_SHAPE),
                         ppm, JPlan(local_path="esc"), JFloors())
    for f in ("num_batches", "sel_cap", "total_flops", "max_unmerged_nnz", "local_path"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert dataclasses.astuple(tp.caps) == dataclasses.astuple(jp.caps)
    tv, jv = t_padded(tp, GRID_SHAPE, R_BYTES), j_padded(jp, GRID_SHAPE, R_BYTES)
    assert (tv.all_to_all_bytes, tv.gather_bytes, tv.total_bytes) == (
        jv.all_to_all_bytes, jv.gather_bytes, jv.total_bytes)
    return tp, tv


def test_degree_rmat_plan_never_worse_and_strictly_fewer_padded_bytes():
    a = jgen.symmetrized(jgen.rmat(7, edge_factor=8, seed=5))
    probe, _ = _plans(a, a, 1 << 30)
    ppm = R_BYTES * 2 * int(a.nnz) + max(R_BYTES * probe.max_unmerged_nnz // 3, 256)
    base, v_base = _plans(a, a, ppm)
    placement = jplace.compute_placement(a, a, "degree")
    placed, v_placed = _plans(placement.apply_a(a), placement.apply_b(a), ppm)
    assert base.num_batches > 1  # the budget forces batching
    assert placed.num_batches <= base.num_batches
    assert v_placed.all_to_all_bytes <= v_base.all_to_all_bytes
    assert v_placed.gather_bytes <= v_base.gather_bytes
    assert v_placed.total_bytes < v_base.total_bytes
