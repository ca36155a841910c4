"""The port's masked multiply (paper §V-B) against the JAX package, layer by
layer, on the same numpy triplets: mask keys and membership, the mask-slice
selection and the sparse helpers, the masked ESC, hash (the plain version of
the fused masked insert) and k-binned multiplies under a strict and a
complement mask, the dense mask indicator, the masked symbolic counts and
the masked plans.

Tolerances: structure, overflow counts, plans and min/max values exact;
plus_times values within rtol 1e-5 / atol 1e-6 (sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gen as jgen
from repro.core import local_spgemm as jlocal
from repro.core import semiring as jsr
from repro.core import sortkeys as jsort
from repro.core import sparse as jsparse
from repro.core.batched import _mask_tile_colcounts as j_mask_counts
from repro.core.batched import batched_summa3d as j_batched
from repro.core.batched import plan_batches as j_plan
from repro.core.batched import symbolic3d_counts as j_counts
from repro.core.distsparse import scatter_to_grid as j_scatter
from repro.core.grid import make_grid as j_make_grid
from repro.core.specs import PlanFloors as JFloors
from repro.core.specs import PlanSpec as JPlan
from repro_torch.core import convert
from repro_torch.core import local_spgemm as tlocal
from repro_torch.core import semiring as tsr
from repro_torch.core import sortkeys as tsort
from repro_torch.core import sparse as tsparse
from repro_torch.core.batched import _mask_tile_colcounts as t_mask_counts
from repro_torch.core.batched import batched_summa3d as t_batched
from repro_torch.core.batched import plan_batches as t_plan
from repro_torch.core.batched import symbolic3d_counts as t_counts
from repro_torch.core.distsparse import scatter_to_grid as t_scatter
from repro_torch.core.grid import make_grid as t_make_grid
from repro_torch.core.specs import PlanFloors as TFloors
from repro_torch.core.specs import PlanSpec as TPlan
from repro_torch.kernels import spgemm_hash as thash

SEMIRINGS = ["plus_times", "min_plus", "max_times"]
MODES = [False, True]
MODE_IDS = ["strict", "complement"]
FLOPS = 8192

_jit = lambda fn, *static: jax.jit(fn, static_argnames=static)
J_ESC = _jit(jlocal.spgemm_esc, "out_cap", "flops_cap", "semiring", "mask_complement")
J_HASH = _jit(jlocal.spgemm_hash, "out_cap", "table_cap", "chunk_cap", "num_chunks",
              "semiring", "max_probes", "mask_complement")
J_KBIN = _jit(jlocal.spgemm_kbinned, "out_cap", "num_bins", "bin_cap_a", "bin_cap_b",
              "mask_complement")


def _port(x):
    return convert.from_reference(x, device="cpu")


def _operands(kind):
    if kind == "er":
        return jgen.erdos_renyi(128, 5, seed=1, cap=700), jgen.erdos_renyi(128, 5, seed=2, cap=660)
    return jgen.rmat(7, edge_factor=4, seed=3, cap=700), jgen.rmat(7, edge_factor=4, seed=4, cap=660)


def _mask(shape, density, seed, cap_slack=40):
    """A JAX SparseCOO mask of ``shape`` with unit values and padding."""
    m, n = shape
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random(shape) < density)
    return jsparse.from_numpy_coo(r, c, np.ones(len(r), np.float32), shape,
                                  cap=len(r) + cap_slack)


def _assert_same(t, j, semiring, overflow=None):
    got = convert.to_numpy(t)
    for f in ("rows", "cols", "nnz"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(j, f)), err_msg=f)
    if semiring == "plus_times":
        np.testing.assert_allclose(got["vals"], np.asarray(j.vals), rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got["vals"], np.asarray(j.vals))
    if overflow is not None:
        assert int(overflow[0]) == int(overflow[1])


def _mask_keys(mask):
    """(JAX keys, port keys) of ``mask``'s sorted packed keys."""
    jk = jsort.sorted_mask_keys(mask.rows, mask.cols, mask.valid_mask(), mask.shape)
    t = _port(mask)
    tk = tsort.sorted_mask_keys(t.rows, t.cols, t.valid_mask(), t.shape)
    return jk, tk


# ---------------------------------------------------------------------------
# keys, membership and sparse helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("density", [0.0, 0.15, 1.0], ids=["empty", "sparse", "full"])
def test_mask_keys_and_membership_match_jax(density):
    mask = _mask((40, 30), density, seed=7)
    jk, tk = _mask_keys(mask)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    rng = np.random.default_rng(8)
    queries = rng.integers(0, tsort.key_space(40, 30), 500).astype(np.int32)
    np.testing.assert_array_equal(
        tsort.keys_in_sorted(torch.as_tensor(queries), tk).numpy(),
        np.asarray(jsort.keys_in_sorted(jnp.asarray(queries), jk)))
    r, c = tsort.unpack_colmajor(tsort.pack_colmajor(tk, tk % 7, 40), 40)
    jr, jc = jsort.unpack_colmajor(jsort.pack_colmajor(jk, jk % 7, 40), 40)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_mask_keys_refuse_a_key_space_past_i32():
    r = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(AssertionError, match="i32"):
        tsort.sorted_mask_keys(r, r, r >= 0, (1 << 18, 1 << 15))


@pytest.mark.parametrize("engine", ["auto", "bucket", "packed", "lexsort"])
def test_count_unique_and_exact_symbolic_match_jax(engine):
    a, b = _operands("rmat")
    rng = np.random.default_rng(9)
    m, n, cap = 30, 25, 400
    rows = rng.integers(0, m, cap).astype(np.int32)
    cols = rng.integers(0, n, cap).astype(np.int32)
    valid = rng.random(cap) < 0.8
    got = tsort.count_unique(*map(torch.as_tensor, (rows, cols, valid)), (m, n), engine=engine)
    want = jsort.count_unique(*map(jnp.asarray, (rows, cols, valid)), (m, n), engine=engine)
    assert int(got) == int(want)
    assert int(tlocal.local_symbolic_exact(_port(a), _port(b), FLOPS, engine=engine)) == int(
        jlocal.local_symbolic_exact(a, b, FLOPS, engine=engine))


def test_sparse_helpers_match_jax():
    """select_col_block (the mask slice of a batch), coalesce,
    with_capacity, prune_threshold and scale_cols."""
    a, _ = _operands("er")
    t = _port(a)
    for lo, width, cap in ((0, 32, 400), (32, 32, 400), (96, 32, 40), (17, 50, 200)):
        jc, jo = a.select_col_block(lo, width, cap)
        tc, to = t.select_col_block(lo, width, cap)
        _assert_same(tc, jc, "min_plus", (to, jo))
    rng = np.random.default_rng(10)
    r = rng.integers(0, 20, 300)
    c = rng.integers(0, 20, 300)
    v = rng.uniform(0.5, 1.0, 300).astype(np.float32)
    dup = jsparse.SparseCOO(*(jnp.asarray(x) for x in (r.astype(np.int32), c.astype(np.int32), v)),
                            jnp.int32(280), (20, 20))
    for new_cap in (400, 50):
        jc, jo = jsparse.coalesce(dup, new_cap)
        tc, to = tsparse.coalesce(_port(dup), new_cap)
        _assert_same(tc, jc, "plus_times", (to, jo))
    for cap in (900, 700, int(a.nnz)):
        _assert_same(t.with_capacity(cap), a.with_capacity(cap), "min_plus")
    for thresh, cap in ((0.75, 700), (0.6, 64)):
        jc, jo = a.prune_threshold(thresh, cap)
        tc, to = t.prune_threshold(thresh, cap)
        _assert_same(tc, jc, "min_plus", (to, jo))
    scale = rng.uniform(0.5, 2.0, a.shape[1]).astype(np.float32)
    _assert_same(t.scale_cols(torch.as_tensor(scale)), a.scale_cols(jnp.asarray(scale)),
                 "min_plus")


# ---------------------------------------------------------------------------
# the masked local multiplies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("complement", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("kind", ["er", "rmat"])
def test_masked_esc_matches_jax(kind, semiring, complement):
    a, b = _operands(kind)
    jk, tk = _mask_keys(_mask((128, 128), 0.1, seed=11))
    for out_cap in (FLOPS, 64):
        jc, jo = J_ESC(a, b, out_cap=out_cap, flops_cap=FLOPS, semiring=jsr.get(semiring),
                       mask_keys=jk, mask_complement=complement)
        tc, to = tlocal.spgemm_esc(_port(a), _port(b), out_cap=out_cap, flops_cap=FLOPS,
                                   semiring=tsr.get(semiring), mask_keys=tk,
                                   mask_complement=complement)
        assert (int(jo) > 0) == (out_cap == 64)
        _assert_same(tc, jc, semiring, (to, jo))


@pytest.mark.parametrize("complement", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("case", ["planned", "small_table", "flops_beyond"])
def test_masked_hash_matches_jax(case, semiring, complement):
    """The port's CPU hash path is the plain version of the masked fused
    insert (``expand_slots`` filters each chunk's keys). A strict mask's
    table sized from the survivors holds them all; filtered products are
    not drops, while the flop overflow counts the unmasked total."""
    a, b = _operands("rmat")
    jk, tk = _mask_keys(_mask((128, 128), 0.1, seed=12))
    kw = dict(out_cap=FLOPS, table_cap=4096, chunk_cap=512, num_chunks=FLOPS // 512,
              max_probes=32)
    if case == "small_table":
        kw["table_cap"] = 64
    elif case == "flops_beyond":
        kw["num_chunks"] = 3
    jc, jo = J_HASH(a, b, semiring=jsr.get(semiring), mask_keys=jk, mask_complement=complement,
                    **kw)
    tc, to = tlocal.spgemm_hash(_port(a), _port(b), semiring=tsr.get(semiring), mask_keys=tk,
                                mask_complement=complement, **kw)
    assert (int(jo) > 0) == (case != "planned")
    _assert_same(tc, jc, semiring, (to, jo))


def test_masked_hash_chunks_are_the_reference_filter():
    """Each chunk of the masked expansion marks valid exactly the products
    the unmasked chunk marks valid and the mask keeps."""
    a, b = _operands("er")
    _, tk = _mask_keys(_mask((128, 128), 0.2, seed=13))
    ta, tb = _port(a), _port(b)
    plain = list(tlocal.hash_chunks(ta, tb, 1024, 4)[1])
    for complement in MODES:
        _, masked = tlocal.hash_chunks(ta, tb, 1024, 4, mask_keys=tk, mask_complement=complement)
        for (k0, v0, ok0), (k1, v1, ok1) in zip(plain, masked):
            hit = tsort.keys_in_sorted(k0, tk)
            assert torch.equal(ok1, ok0 & (~hit if complement else hit))
            assert torch.equal(k0, k1) and torch.equal(v0, v1)


@pytest.mark.parametrize("complement", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("kind", ["er", "rmat"])
def test_masked_kbinned_and_indicator_match_jax(kind, complement):
    from repro.core import symbolic as jsym

    a, b = _operands(kind)
    mask = _mask((128, 128), 0.1, seed=14)
    np.testing.assert_array_equal(tlocal.mask_indicator(_port(mask), complement).numpy(),
                                  np.asarray(jlocal.mask_indicator(mask, complement)))
    plan = jsym.plan_k_bins(np.asarray(a.col_counts()), np.asarray(b.row_counts()),
                            a.cap, b.cap, candidates=(8,))
    kw = dict(num_bins=plan.num_bins, bin_cap_a=plan.bin_cap_a, bin_cap_b=plan.bin_cap_b)
    for out_cap in (FLOPS, 64):
        jc, jo = J_KBIN(a, b, out_cap=out_cap, bin_of_k=jnp.asarray(plan.bin_of_k), mask=mask,
                        mask_complement=complement, **kw)
        tc, to = tlocal.spgemm_kbinned(_port(a), _port(b), out_cap=out_cap,
                                       bin_of_k=torch.as_tensor(plan.bin_of_k),
                                       mask=_port(mask), mask_complement=complement, **kw)
        _assert_same(tc, jc, "plus_times", (to, jo))


def test_masked_expansion_keeps_its_mode():
    """``hash_expansion`` carries the mask keys and the mode the fused kernel
    reads; an unknown mode or a mask without keys is refused by the card
    wrapper before any launch."""
    a, b = _operands("er")
    _, tk = _mask_keys(_mask((128, 128), 0.1, seed=15))
    x, _ = tlocal.hash_expansion(_port(a), _port(b))
    assert x.mask_mode == "none" and x.mask_keys is None
    for complement, mode in ((False, "strict"), (True, "complement")):
        x, _ = tlocal.hash_expansion(_port(a), _port(b), tk, complement)
        assert x.mask_mode == mode and x.mask_keys is tk
    tkey = torch.full((64,), thash.EMPTY, dtype=torch.int32)
    tval = torch.zeros(64)
    dropped = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="mask mode"):
        thash.hash_expand_insert_cuda(tkey, tval, dropped, x._replace(mask_mode="both"), 8, 1,
                                      semiring=tsr.PLUS_TIMES, max_probes=8)
    with pytest.raises(ValueError, match="mask keys"):
        thash.hash_expand_insert_cuda(tkey, tval, dropped, x._replace(mask_keys=None), 8, 1,
                                      semiring=tsr.PLUS_TIMES, max_probes=8)


# ---------------------------------------------------------------------------
# masked symbolic counts, plans and driver on a 1x1x1 grid
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def grids():
    return j_make_grid(1, 1, 1), t_make_grid(1, 1, 1, device="cpu")


@pytest.fixture(scope="module")
def masked_operands(grids):
    """(JAX A, B, M; port A, B, M): R-MAT, n = 128, and a mask of ~12 % of
    the output space, each scattered by its own package."""
    jg, tg = grids
    a = jgen.rmat(7, edge_factor=6, seed=1)
    m = _mask((128, 128), 0.12, seed=16)
    ta, tm = _port(a), _port(m)
    return (j_scatter(a, jg, "A"), j_scatter(a, jg, "B"), j_scatter(m, jg, "C"),
            t_scatter(ta, tg, "A"), t_scatter(ta, tg, "B"), t_scatter(tm, tg, "C"))


def test_masked_symbolic_counts_match_jax_and_oracle(grids, masked_operands):
    jA, jB, jM, tA, tB, tM = masked_operands
    jc, tc = j_counts(jA, jB, grids[0], mask=jM), t_counts(tA, tB, grids[1], mask=tM)
    for f in ("percol", "b_colcounts", "a_kcounts", "b_kcounts", "mask_colcounts"):
        np.testing.assert_array_equal(getattr(tc, f), np.asarray(getattr(jc, f)), err_msg=f)
    np.testing.assert_array_equal(t_mask_counts(tM, grids[1]), tc.mask_colcounts)
    np.testing.assert_array_equal(t_mask_counts(tM, grids[1]), j_mask_counts(jM))
    assert t_counts(tA, tB, grids[1]).mask_colcounts is None


def test_masked_host_oracle_plans_as_the_device_pass(grids, masked_operands):
    """``host_symbolic_counts(mask=)`` and ``PlanInputs.from_host(mask=)``
    plan the masked multiply exactly as the device pass, in both packages."""
    from repro.core.batched import PlanInputs as JInputs
    from repro.core.batched import plan_from_symbolic as j_from_symbolic
    from repro.core.symbolic import host_symbolic_counts as j_host_counts
    from repro_torch.core.batched import PlanInputs as TInputs
    from repro_torch.core.batched import plan_from_symbolic as t_from_symbolic
    from repro_torch.core.symbolic import host_symbolic_counts as t_host_counts

    jA, jB, jM, tA, tB, tM = masked_operands
    a, m = jgen.rmat(7, edge_factor=6, seed=1), _mask((128, 128), 0.12, seed=16)
    ta, tm = _port(a), _port(m)
    tc, jc = t_host_counts(ta, ta, (1, 1, 1), mask=tm), j_host_counts(a, a, (1, 1, 1), mask=m)
    np.testing.assert_array_equal(tc.mask_colcounts, jc.mask_colcounts)
    budget = 12 * 4 * int(a.nnz)
    tp = t_from_symbolic(tc, TInputs.from_host(ta, ta, (1, 1, 1), mask=tm), budget,
                         TPlan(mask=tM), TFloors())
    _assert_same_plan(tp, j_from_symbolic(jc, JInputs.from_host(a, a, (1, 1, 1), mask=m),
                                          budget, JPlan(mask=jM), JFloors()))
    _assert_same_plan(tp, t_plan(tA, tB, grids[1], budget, spec=TPlan(mask=tM)))


def _assert_same_plan(tp, jp):
    for f in ("num_batches", "lower_bound", "total_flops", "max_unmerged_nnz", "sel_cap",
              "mask_sel_cap", "local_path", "compression_est"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert dataclasses.astuple(tp.caps) == dataclasses.astuple(jp.caps)
    assert (tp.hash_caps is None) == (jp.hash_caps is None)
    if tp.hash_caps is not None:
        assert dataclasses.astuple(tp.hash_caps) == dataclasses.astuple(jp.hash_caps)
    np.testing.assert_array_equal(tp.per_batch_flops, jp.per_batch_flops)
    for f in ("num_bins", "bin_cap_a", "bin_cap_b", "pairings", "pairings_unbinned"):
        assert getattr(tp.kbin, f) == getattr(jp.kbin, f), f


@pytest.mark.parametrize("complement", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("local_path", ["auto", "esc", "hash", "binned"])
@pytest.mark.parametrize("fraction", [0, 3, 12], ids=["loose", "b~3", "b~12"])
def test_masked_plan_matches_jax(grids, masked_operands, local_path, complement, fraction):
    jA, jB, jM, tA, tB, tM = masked_operands
    loose = j_plan(jA, jB, grids[0], 1 << 40, spec=JPlan(local_path="esc"))
    inputs = 12 * (int(jA.nnz.max()) + int(jB.nnz.max()))
    budget = 1 << 40 if fraction == 0 else inputs + 12 * loose.max_unmerged_nnz // fraction
    kw = dict(local_path=local_path, mask_complement=complement)
    jp = j_plan(jA, jB, grids[0], budget, spec=JPlan(mask=jM, **kw))
    tp = t_plan(tA, tB, grids[1], budget, spec=TPlan(mask=tM, **kw))
    _assert_same_plan(tp, jp)
    assert tp.mask_sel_cap > 0
    floors = dict(caps_pow2=True, sel_cap=64, num_batches=2)
    _assert_same_plan(t_plan(tA, tB, grids[1], budget, spec=TPlan(mask=tM, **kw),
                             floors=TFloors(**floors)),
                      j_plan(jA, jB, grids[0], budget, spec=JPlan(mask=jM, **kw),
                             floors=JFloors(**floors)))
    if fraction and not complement and local_path == "esc":
        unmasked = t_plan(tA, tB, grids[1], budget, spec=TPlan(local_path="esc"))
        assert tp.num_batches <= unmasked.num_batches
        assert tp.caps.d_cap < unmasked.caps.d_cap and tp.caps.c_cap < unmasked.caps.c_cap


@pytest.mark.parametrize("complement", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("local_path", ["esc", "hash", "binned"])
def test_masked_driver_matches_jax(grids, masked_operands, local_path, complement):
    """Both drivers, four forced batches, every batch's tile identical (sums
    to tolerance) and the capacities actually used equal."""
    jA, jB, jM, tA, tB, tM = masked_operands
    outs = {"j": [], "t": []}
    kw = dict(local_path=local_path, mask_complement=complement, force_num_batches=4)
    jres = j_batched(jA, jB, grids[0], 1 << 26, spec=JPlan(mask=jM, **kw),
                     consumer=lambda bi, cb, cm: outs["j"].append(cb))
    tres = t_batched(tA, tB, grids[1], 1 << 26, spec=TPlan(mask=tM, **kw),
                     consumer=lambda bi, cb, cm: outs["t"].append(cb))
    assert tres.local_path == jres.local_path == local_path
    assert tres.num_retries == jres.num_retries == 0
    assert tres.plan.mask_sel_cap == jres.plan.mask_sel_cap
    assert len(outs["t"]) == len(outs["j"]) == 4
    for t, j in zip(outs["t"], outs["j"]):
        got = convert.to_numpy(t)
        for f in ("rows", "cols", "nnz"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(j, f)), err_msg=f)
        np.testing.assert_allclose(got["vals"], np.asarray(j.vals), rtol=1e-5, atol=1e-6)
