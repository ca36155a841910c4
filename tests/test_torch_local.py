"""The port's local multiplies, merge and packed-key engine against the JAX
package, on the same numpy triplets (Erdős–Rényi and R-MAT, a few hundred
rows).

Structure, overflow counts and min/max values must match exactly;
plus_times values within rtol 1e-5 (sums may run in another order).
"""
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
from repro.core import symbolic as jsym
from repro_torch.core import convert
from repro_torch.core import local_spgemm as tlocal
from repro_torch.core import semiring as tsr
from repro_torch.core import sortkeys as tsort
from repro_torch.core import sparse as tsparse
from repro_torch.kernels import segment_reduce as tsegk

SEMIRINGS = ["plus_times", "min_plus", "max_times"]

# the JAX side runs jitted, so each (shape, capacity, semiring) compiles once
_jit = lambda fn, *static: jax.jit(fn, static_argnames=static)
J_ESC = _jit(jlocal.spgemm_esc, "out_cap", "flops_cap", "semiring")
J_HASH = _jit(jlocal.spgemm_hash, "out_cap", "table_cap", "chunk_cap", "num_chunks",
              "semiring", "max_probes")
J_KBIN = _jit(jlocal.spgemm_kbinned, "out_cap", "num_bins", "bin_cap_a", "bin_cap_b")
J_MERGE = _jit(jlocal.merge_sparse, "out_cap", "semiring", "assume_sorted")
J_COALESCE = _jit(jsort.coalesce_entries, "shape", "new_cap", "add_kind", "engine")

# static capacities shared by both input kinds: "fits" holds every product
# of either pair, "tight" overflows both
FLOPS_FITS = 8192


def _inputs(kind):
    """Two square operands as JAX SparseCOO with slack capacity."""
    if kind == "er":
        a = jgen.erdos_renyi(128, 5, seed=1, cap=700)
        b = jgen.erdos_renyi(128, 5, seed=2, cap=660)
    else:
        a = jgen.rmat(7, edge_factor=4, seed=3, cap=700)
        b = jgen.rmat(7, edge_factor=4, seed=4, cap=660)
    return a, b


def _port(x):
    return convert.from_reference(x, device="cpu")


def _assert_same(t, j, semiring, overflow=None):
    """Padded fields identical (values to tolerance for sums)."""
    got = convert.to_numpy(t)
    np.testing.assert_array_equal(got["rows"], np.asarray(j.rows))
    np.testing.assert_array_equal(got["cols"], np.asarray(j.cols))
    assert int(got["nnz"]) == int(j.nnz)
    if semiring == "plus_times":
        np.testing.assert_allclose(got["vals"], np.asarray(j.vals), rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got["vals"], np.asarray(j.vals))
    if overflow is not None:
        assert int(overflow[0]) == int(overflow[1])


def _flops(a, b):
    return int(jlocal.local_symbolic_flops(a, b))


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("kind", ["er", "rmat"])
@pytest.mark.parametrize("tight", [False, True], ids=["fits", "overflow"])
def test_spgemm_esc_matches_jax(kind, semiring, tight):
    a, b = _inputs(kind)
    assert _flops(a, b) <= FLOPS_FITS
    out_cap, flops_cap = (FLOPS_FITS, FLOPS_FITS) if not tight else (256, 1024)
    jc, jo = J_ESC(a, b, out_cap=out_cap, flops_cap=flops_cap, semiring=jsr.get(semiring))
    tc, to = tlocal.spgemm_esc(_port(a), _port(b), out_cap=out_cap, flops_cap=flops_cap,
                               semiring=tsr.get(semiring))
    assert (int(jo) > 0) == tight
    _assert_same(tc, jc, semiring, (to, jo))


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("kind", ["er", "rmat"])
@pytest.mark.parametrize("table_cap", [16384, 128], ids=["fits", "overflow"])
def test_spgemm_hash_matches_jax(kind, semiring, table_cap):
    a, b = _inputs(kind)
    assert _flops(a, b) <= FLOPS_FITS
    kw = dict(out_cap=FLOPS_FITS, table_cap=table_cap, chunk_cap=1024,
              num_chunks=FLOPS_FITS // 1024, max_probes=32)
    jc, jo = J_HASH(a, b, semiring=jsr.get(semiring), **kw)
    tc, to = tlocal.spgemm_hash(_port(a), _port(b), semiring=tsr.get(semiring), **kw)
    assert (int(jo) > 0) == (table_cap == 128)
    _assert_same(tc, jc, semiring, (to, jo))


ALL_SEMIRINGS = ["plus_times", "or_and", "min_plus", "max_times", "plus_pair"]


def _ones(x):
    """``x`` with every live value 1 (or_and's {0, 1} domain)."""
    return jsparse.SparseCOO(x.rows, x.cols, jnp.where(x.valid_mask(), 1.0, 0.0).astype(x.vals.dtype),
                             x.nnz, x.shape)


@pytest.mark.parametrize("semiring", ALL_SEMIRINGS)
@pytest.mark.parametrize("case", ["planned", "small_table", "flops_beyond", "outside_k"])
def test_spgemm_hash_plain_matches_jax(semiring, case):
    """The port's CPU hash path (the plain chunk loop of the fused kernel)
    for every semiring product: a planned table (no drops), a table far too
    small (both drop), flops beyond ``num_chunks · chunk_cap`` (both count
    the same flop overflow) and B entries whose contraction index is k + 3
    (no products on either side)."""
    a, b = _inputs("rmat")
    if semiring == "or_and":
        a, b = _ones(a), _ones(b)
    k = a.shape[1]
    if case == "outside_k":
        rows = np.asarray(b.rows).copy()
        rows[: int(b.nnz)][::9] = k + 3
        b = jsparse.SparseCOO(jnp.asarray(rows), b.cols, b.vals, b.nnz, b.shape)
    kw = dict(out_cap=FLOPS_FITS, table_cap=16384, chunk_cap=512, num_chunks=FLOPS_FITS // 512,
              max_probes=32)
    if case == "small_table":
        kw["table_cap"] = 128
    elif case == "flops_beyond":
        kw["num_chunks"] = 3
    jc, jo = J_HASH(a, b, semiring=jsr.get(semiring), **kw)
    tc, to = tlocal.spgemm_hash(_port(a), _port(b), semiring=tsr.get(semiring), **kw)
    assert (int(jo) > 0) == (case in ("small_table", "flops_beyond"))
    _assert_same(tc, jc, "plus_times" if semiring.startswith("plus") else semiring, (to, jo))


@pytest.mark.parametrize("add_kind", ["sum", "min", "max"])
@pytest.mark.parametrize("ids_sorted", [True, False], ids=["sorted", "unsorted"])
def test_segment_reduce_matches_jax(add_kind, ids_sorted):
    """The order-fixed reduction behind every engine's sum against
    ``jax.ops.segment_{sum,min,max}``: ids past the last slot (the engines'
    overflow and padding) and below 0 are dropped, empty slots hold the
    identity."""
    rng = np.random.default_rng(8)
    num, cap = 40, 600
    ids = rng.integers(-2, num + 5, cap).astype(np.int32)
    ids[:50] = 7  # one long run
    if ids_sorted:
        ids = np.sort(ids)
    vals = rng.uniform(-1.0, 1.0, cap).astype(np.float32)
    got = tsort.segment_reduce(torch.as_tensor(vals), torch.as_tensor(ids), num, add_kind)
    keep = (ids >= 0) & (ids < num)
    seg = getattr(jax.ops, f"segment_{add_kind}")
    want = seg(jnp.asarray(vals[keep]), jnp.asarray(ids[keep]), num_segments=num)
    if add_kind == "sum":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    else:
        empty = np.bincount(ids[keep], minlength=num) == 0
        assert np.all(np.isinf(got.numpy()[empty]))
        np.testing.assert_array_equal(got.numpy()[~empty], np.asarray(want)[~empty])


@pytest.mark.parametrize("longest", [32, 12288], ids=["thread_runs", "long_runs"])
def test_segment_reduce_plain_adds_in_entry_order(longest):
    """The plain version adds each run's entries one at a time in entry
    order, the order in which the card kernel's thread adds a short run
    (the card test holds those sums to these bits): its sums equal an f32
    running sum, bit for bit, for runs of up to 32 entries and for runs
    long enough that the card gives them to a warp or a block."""
    rng = np.random.default_rng(9)
    lengths = rng.integers(0, longest + 1, 300)
    offsets = np.concatenate([[4], 4 + np.cumsum(lengths)]).astype(np.int32)
    vals = (rng.standard_normal(int(offsets[-1]) + 6)
            * np.exp(rng.uniform(-9, 9, int(offsets[-1]) + 6))).astype(np.float32)
    got = tsegk.segment_reduce(torch.as_tensor(vals), torch.as_tensor(offsets), "sum").numpy()
    want = np.zeros(lengths.size, np.float32)
    for j in range(int(lengths.max())):
        live = lengths > j
        want[live] = want[live] + vals[offsets[:-1][live] + j]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("kind", ["er", "rmat"])
@pytest.mark.parametrize("num_bins", [1, 8])
def test_spgemm_kbinned_matches_jax(kind, num_bins):
    a, b = _inputs(kind)
    k = a.shape[1]
    plan = jsym.plan_k_bins(
        np.asarray(a.col_counts()), np.asarray(b.row_counts()), a.cap, b.cap,
        candidates=(num_bins,),
    )
    kw = dict(out_cap=FLOPS_FITS, num_bins=plan.num_bins, bin_cap_a=plan.bin_cap_a,
              bin_cap_b=plan.bin_cap_b)
    jc, jo = J_KBIN(a, b, bin_of_k=jnp.asarray(plan.bin_of_k), **kw)
    tc, to = tlocal.spgemm_kbinned(_port(a), _port(b),
                                   bin_of_k=torch.as_tensor(plan.bin_of_k), **kw)
    assert plan.bin_of_k.shape == (k,)
    _assert_same(tc, jc, "plus_times", (to, jo))


def _sorted_parts(seed, parts=3, m=40, n=32, cap=80):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(parts):
        nnz = int(rng.integers(cap // 2, cap))
        r = rng.integers(0, m, nnz)
        c = rng.integers(0, n, nnz)
        v = rng.uniform(0.5, 1.0, nnz).astype(np.float32)
        out.append(jsparse.from_numpy_coo(r, c, v, (m, n), cap=cap))  # row-major sorted
    return out


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("assume_sorted", [True, False])
@pytest.mark.parametrize("out_cap", [240, 40], ids=["fits", "overflow"])
def test_merge_sparse_matches_jax(semiring, assume_sorted, out_cap):
    parts = _sorted_parts(seed=9)
    jc, jo = J_MERGE(parts, out_cap=out_cap, semiring=jsr.get(semiring),
                     assume_sorted=assume_sorted)
    tc, to = tlocal.merge_sparse([_port(p) for p in parts], out_cap, tsr.get(semiring),
                                 assume_sorted=assume_sorted)
    assert (int(jo) > 0) == (out_cap == 40)
    _assert_same(tc, jc, semiring, (to, jo))


@pytest.mark.parametrize("engine", ["bucket", "packed", "lexsort"])
@pytest.mark.parametrize("add_kind", ["sum", "min", "max"])
def test_coalesce_engines_match_jax(engine, add_kind):
    rng = np.random.default_rng(4)
    m, n, cap = 30, 25, 400
    rows = rng.integers(0, m, cap).astype(np.int32)
    cols = rng.integers(0, n, cap).astype(np.int32)
    vals = rng.uniform(0.5, 1.0, cap).astype(np.float32)
    valid = rng.random(cap) < 0.8
    for new_cap in (500, 64):
        want = J_COALESCE(*map(jnp.asarray, (rows, cols, vals, valid)), shape=(m, n),
                          new_cap=new_cap, add_kind=add_kind, engine=engine)
        got = tsort.coalesce_entries(*map(torch.as_tensor, (rows, cols, vals, valid)), (m, n),
                                     new_cap, add_kind=add_kind, engine=engine)
        for g, w in zip(got, want):
            if g.dtype == torch.float32 and add_kind == "sum":
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape", [(50, 40), (1 << 16, 1 << 16)], ids=["packed", "int64_key"])
def test_sorts_match_jax(shape):
    """Row/column-major sorts; the large shape takes the two-key path, which
    the port runs as a stable int64 packed key."""
    m, n = shape
    rng = np.random.default_rng(5)
    r = rng.integers(0, m, 300)
    c = rng.integers(0, n, 300)
    v = rng.uniform(0.5, 1.0, 300).astype(np.float32)
    j = jsparse.from_numpy_coo(r, c, v, shape, cap=360)
    # scramble the entry order (keeping padding last) so the sorts do work
    perm = np.concatenate([rng.permutation(int(j.nnz)), np.arange(int(j.nnz), 360)])
    j = jsparse.SparseCOO(j.rows[perm], j.cols[perm], j.vals[perm], j.nnz, j.shape)
    t = _port(j)
    _assert_same(t.sort_rowmajor(), j.sort_rowmajor(), "min_plus")
    _assert_same(t.sort_colmajor(), j.sort_colmajor(), "min_plus")


def test_sparse_ops_match_jax():
    """compact, block-cyclic selection, ColSplit and dense→COO."""
    a, _ = _inputs("er")
    t = _port(a)
    keep = np.random.default_rng(6).random(a.cap) < 0.5
    for new_cap in (400, 100):
        jc, jo = a.compact(jnp.asarray(keep), new_cap)
        tc, to = t.compact(torch.as_tensor(keep), new_cap)
        _assert_same(tc, jc, "min_plus", (to, jo))
        for batch in range(4):
            jc, jo = a.select_cols_blockcyclic(batch, 4, 2, new_cap)
            tc, to = t.select_cols_blockcyclic(batch, 4, 2, new_cap)
            _assert_same(tc, jc, "min_plus", (to, jo))
    for pieces, piece_cap in ((4, 200), (2, 40)):
        for g, w in zip(t.split_col_blocks(pieces, piece_cap), a.split_col_blocks(pieces, piece_cap)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dense = np.array(a.to_dense())
    for cap in (700, 50):
        jc, jo = jsparse.from_dense_overflow(jnp.asarray(dense), cap)
        tc, to = tsparse.from_dense_overflow(torch.as_tensor(dense), cap)
        _assert_same(tc, jc, "min_plus", (to, jo))


def test_symbolic_helpers_match_jax():
    a, b = _inputs("rmat")
    ta, tb = _port(a), _port(b)
    assert int(tlocal.local_symbolic_flops(ta, tb)) == _flops(a, b)
    np.testing.assert_array_equal(
        tlocal.nnz_per_col_upper(ta.col_counts(), tb).numpy(),
        np.asarray(jlocal.nnz_per_col_upper(a.col_counts(), b)),
    )
