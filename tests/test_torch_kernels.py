"""The port's kernels against the JAX package's oracles.

On the CPU the port runs each kernel's plain PyTorch version; those are
held against the JAX package's jnp oracles on the same numpy inputs
(``spgemm_hash.hash_insert_ref``, ``ref.spgemm_paired_binned_ref``,
``spgemm_binned.bin_entries_by_k``) or against the Pallas kernels run in
interpret mode, as the JAX package's own tests run them on the CPU
(``col_topk_bounds_pallas``, ``spmm_pallas``, ``densify_pallas``). The
plain hash insert runs the same probe rounds as the JAX oracle, so its
table matches slot for slot, and so does its drop count, with or without
overflow.

The Hopper kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py``. Tolerances: sums within rtol 1e-5
(scatters add in another order; densify's sums of duplicates within rtol
1e-6), min/max and structure exact, and the column top-k bracket
bit-identical (every bisection step is one correctly rounded f32 operation
on exact counts).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import local_spgemm as jlocal
from repro.core import semiring as jsr
from repro.core import sparse as jsparse
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import spgemm_binned as jbinned
from repro.kernels import spgemm_hash as jhash
from repro.kernels import col_prune as jprune
from repro.kernels.col_prune import col_topk_bounds_pallas
from repro.kernels.densify import densify_pallas
from repro.kernels.sort_engine import bitonic_sort_pairs_pallas
from repro.kernels.spgemm_acc import spgemm_paired_pallas
from repro.kernels.spmm import spmm_pallas
from repro_torch.core import local_spgemm as tlocal
from repro_torch.core import semiring as tsr
from repro_torch.core import sparse as tsparse
from repro_torch.kernels import col_prune as tprune
from repro_torch.kernels import ops as tops
from repro_torch.kernels.densify_kernel import densify, densify_cuda
from repro_torch.kernels import spgemm_binned as tbinned
from repro_torch.kernels import sort_engine as tsort
from repro_torch.kernels import spgemm_acc as tacc
from repro_torch.kernels import spgemm_hash as thash
from repro_torch.kernels.spmm_kernel import spmm, spmm_cuda
from test_torch_cases import (
    assert_vals, bin_both, binned_inputs, binned_layout, binned_serial_sum, coo_entries,
    dense_random, dup_keys, meet_outside_k, paired_entries, prune_block, random_chunks, sort_keys,
    torch_tables,
)

ADD_KINDS = ["sum", "min", "max"]


def _jax_tables(chunks, table_cap, add_kind, max_probes):
    tk = jnp.full((table_cap,), jhash.EMPTY, jnp.int32)
    tv = jnp.full((table_cap,), jhash.table_init_val(add_kind), jnp.float32)
    dropped = 0
    for keys, vals, valid in chunks:
        tk, tv, d = jhash.hash_insert_ref(
            tk, tv, jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid),
            add_kind=add_kind, max_probes=max_probes,
        )
        dropped += int(d)
    return np.asarray(tk), np.asarray(tv), dropped


@pytest.mark.parametrize("lg", [3, 10, 20, 31])
def test_fib_hash_matches_jax(lg):
    keys = np.random.default_rng(lg).integers(0, 2**31 - 1, 4096).astype(np.int32)
    keys[:3] = [0, 1, 2**31 - 2]
    got = thash.fib_hash(torch.as_tensor(keys), lg).numpy()
    np.testing.assert_array_equal(got, np.asarray(jhash.fib_hash(jnp.asarray(keys), lg)))


@pytest.mark.parametrize("add_kind", ADD_KINDS)
@pytest.mark.parametrize("table_cap,overflow", [(2048, False), (64, True)],
                         ids=["fits", "overflow"])
def test_hash_insert_plain_matches_jax(add_kind, table_cap, overflow):
    chunks = random_chunks(seed=7)
    jk, jv, jd = _jax_tables(chunks, table_cap, add_kind, max_probes=32)
    tk, tv, td = torch_tables(chunks, table_cap, add_kind, 32, thash.hash_insert)
    assert (td > 0) == overflow and (jd > 0) == overflow
    assert td == jd
    np.testing.assert_array_equal(tk, jk)  # same rounds: slot for slot
    assert_vals(add_kind, tv, jv)


def test_hash_insert_cuda_refuses_cpu_tensors():
    """No fallback: the kernel wrapper raises for tensors off the card."""
    chunks = random_chunks(seed=8, num_chunks=1)
    with pytest.raises(ValueError, match="CUDA"):
        torch_tables(chunks, 64, "sum", 32, thash.hash_insert_cuda)


@pytest.mark.parametrize("bin_map", [False, True], ids=["equal_width", "bin_map"])
@pytest.mark.parametrize("bin_cap", [None, 24], ids=["fits", "overflow"])
def test_bin_entries_by_k_matches_jax(bin_map, bin_cap):
    inp = binned_inputs(seed=3, bin_cap=bin_cap, bin_map=bin_map)
    got = bin_both(inp, tbinned, torch.as_tensor)
    want = bin_both(inp, jbinned, jnp.asarray)
    for g_side, w_side in zip(got, want):
        for g, w in zip(g_side, w_side):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (int(got[0][3]) > 0) == (bin_cap is not None)


@pytest.mark.parametrize("bin_map", [False, True], ids=["equal_width", "bin_map"])
def test_paired_binned_plain_matches_jax(bin_map):
    inp = binned_inputs(seed=5, bin_map=bin_map)
    (tak, tar, tav, _), (tbk, tbc, tbv, _) = bin_both(inp, tbinned, torch.as_tensor)
    got = tbinned.spgemm_paired_binned(tar, tak, tav, tbk, tbc, tbv, inp["m"], inp["n"])
    (jak, jar, jav, _), (jbk, jbc, jbv, _) = bin_both(inp, jbinned, jnp.asarray)
    want = jref.spgemm_paired_binned_ref(jar, jak, jav, jbk, jbc, jbv, inp["m"], inp["n"])
    assert np.count_nonzero(np.asarray(want)) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["dup_bk", "dup_ak", "empty_bins", "padding", "heavy_row"])
def test_paired_binned_plain_is_serial_sum(kind):
    """The plain version's C has the bits of a serial f32 sum in (bin, A
    slot, B slot) order, the order the Hopper kernel keeps."""
    arrays, (m, n) = binned_layout(kind, seed=71)
    got = tbinned.spgemm_paired_binned_ref(*(torch.as_tensor(x) for x in arrays), m, n)
    want = binned_serial_sum(arrays, m, n)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_paired_binned_cuda_refuses_cpu_tensors():
    inp = binned_inputs(seed=6)
    (tak, tar, tav, _), (tbk, tbc, tbv, _) = bin_both(inp, tbinned, torch.as_tensor)
    with pytest.raises(ValueError, match="CUDA"):
        tbinned.spgemm_paired_binned_cuda(tar, tak, tav, tbk, tbc, tbv, inp["m"], inp["n"])


@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("kind", ["random", "tied", "uniform", "narrow", "sparse_col"])
def test_col_topk_bounds_plain_matches_pallas(kind, k):
    x = prune_block(seed=21 + k, kind=kind)
    lo, hi = tprune.col_topk_bounds(torch.as_tensor(x), k)
    jlo, jhi = col_topk_bounds_pallas(jnp.asarray(x), k, interpret=True)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    # the bracket's contract: count(>= hi) <= k < count(>= lo) where ties allow
    ax = np.abs(x)
    assert ((ax >= hi.numpy()[None, :]).sum(0) <= k).all()


def test_col_topk_bounds_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tprune.col_topk_bounds_cuda(torch.as_tensor(prune_block(seed=1)), 3)


@pytest.mark.parametrize("cap,nnz", [(512, 400), (64, 64)], ids=["padded", "full"])
def test_spmm_plain_matches_pallas_and_local(cap, nnz):
    m, k, n = 48, 56, 72
    rows, cols, vals = coo_entries(seed=cap, m=m, n=k, cap=cap, nnz=nnz)
    b = np.random.default_rng(cap + 1).uniform(-1, 1, (k, n)).astype(np.float32)
    got = spmm(*(torch.as_tensor(x) for x in (rows, cols, vals, b)), m).numpy()
    want = np.asarray(spmm_pallas(*(jnp.asarray(x) for x in (rows, cols, vals, b)), m,
                                        interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    a_j = jsparse.SparseCOO(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                            jnp.int32(nnz), (m, k))
    want_local = np.asarray(jlocal.spmm(a_j, jnp.asarray(b)))
    np.testing.assert_allclose(got, want_local, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "max_times"])
def test_local_spmm_matches_jax(name):
    """The port's ``local_spgemm.spmm`` on the CPU: semiring-generic, with
    slots past ``nnz`` ignored."""
    m, k, n = 30, 40, 20
    rows, cols, vals = coo_entries(seed=4, m=m, n=k, cap=300, nnz=250)
    rows[250:260], cols[250:260] = 1, 2  # stale slots past nnz: not entries
    b = np.random.default_rng(5).uniform(0.1, 1, (k, n)).astype(np.float32)
    a_t = tsparse.SparseCOO(*(torch.as_tensor(x) for x in (rows, cols, vals)),
                            torch.tensor(250, dtype=torch.int32), (m, k))
    a_j = jsparse.SparseCOO(*(jnp.asarray(x) for x in (rows, cols, vals)), jnp.int32(250), (m, k))
    got = tlocal.spmm(a_t, torch.as_tensor(b), tsr.get(name)).numpy()
    want = np.asarray(jlocal.spmm(a_j, jnp.asarray(b), jsr.get(name)))
    assert_vals("sum" if name == "plus_times" else "min", got, want)


# the JAX package's SpMM sweep (tests/test_kernels.py): shapes and dtypes
SPMM_SHAPES = [(8, 8, 8), (16, 24, 8), (33, 17, 9), (64, 40, 128), (128, 128, 130)]


@pytest.mark.parametrize("m,k,n", SPMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_dtypes_match_jax(m, k, n, dtype):
    """bf16 or f32 values and B, summed in f32: the plain version returns
    f32 as ``spmm_pallas`` does, ``ops.spmm`` B's dtype as the reference's
    ``ops.spmm`` (``ref.spmm_ref``), and ``local_spgemm.spmm`` the promoted
    dtype as the reference's. Tolerance as the reference's own sweep: 1e-5
    in f32, 2e-2 in bf16 (the output is rounded to 8 bits)."""
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a_x = np.where(rng.random((m, k)) < 0.3, rng.standard_normal((m, k)), 0).astype(np.float32)
    b_x = np.where(rng.random((k, n)) < 0.8, rng.standard_normal((k, n)), 0).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    a_j = jsparse.from_dense(jnp.asarray(a_x), cap=m * k // 2 + m)
    a_t = tsparse.from_dense(torch.as_tensor(a_x), cap=m * k // 2 + m)
    vals_j = jnp.where(a_j.valid_mask(), a_j.vals, 0).astype(jdt)
    vals_t = torch.where(a_t.valid_mask(), a_t.vals, 0.0).to(tdt)
    b_j, b_t = jnp.asarray(b_x).astype(jdt), torch.as_tensor(b_x).to(tdt)
    tol = 1e-5 if dtype == "float32" else 2e-2

    got = spmm(a_t.rows, a_t.cols, vals_t, b_t, m)
    want = spmm_pallas(a_j.rows, a_j.cols, vals_j, b_j, m,
                       m_blk=16, n_blk=128, k_blk=16, nnz_blk=32, interpret=True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    a_tv = tsparse.SparseCOO(a_t.rows, a_t.cols, vals_t, a_t.nnz, a_t.shape)
    a_jv = jsparse.SparseCOO(a_j.rows, a_j.cols, vals_j, a_j.nnz, a_j.shape)
    got = tops.spmm(a_tv, b_t)
    want = jops.spmm(a_jv, b_j)
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    assert tlocal.spmm(a_tv, b_t).dtype == tdt
    assert jlocal.spmm(a_jv, b_j).dtype == jdt


def test_spmm_cuda_refuses_cpu_tensors():
    rows, cols, vals = coo_entries(seed=2, m=8, n=8, cap=16, nnz=10)
    b = torch.ones((8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        spmm_cuda(*(torch.as_tensor(x) for x in (rows, cols, vals)), b, 8)


@pytest.mark.parametrize("m,n", [(40, 130), (129, 8)])
def test_densify_plain_matches_pallas(m, n):
    rows, cols, vals = coo_entries(seed=m, m=m, n=n, cap=700, nnz=600)
    got = densify(*(torch.as_tensor(x) for x in (rows, cols, vals)), m, n).numpy()
    want = np.asarray(densify_pallas(*(jnp.asarray(x) for x in (rows, cols, vals)),
                                              m, n, interpret=True))
    assert (got[rows[0], cols[0]] > 1.0) and np.count_nonzero(want) > 0  # duplicates summed
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    a_j = jsparse.SparseCOO(*(jnp.asarray(x) for x in (rows, cols, vals)), jnp.int32(600), (m, n))
    a_t = tsparse.SparseCOO(*(torch.as_tensor(x) for x in (rows, cols, vals)),
                            torch.tensor(600, dtype=torch.int32), (m, n))
    np.testing.assert_allclose(a_t.to_dense().numpy(), np.asarray(a_j.to_dense()),
                               rtol=1e-6, atol=1e-7)


def test_densify_cuda_refuses_cpu_tensors():
    rows, cols, vals = coo_entries(seed=3, m=8, n=8, cap=16, nnz=10)
    with pytest.raises(ValueError, match="CUDA"):
        densify_cuda(*(torch.as_tensor(x) for x in (rows, cols, vals)), 8, 8)


@pytest.mark.parametrize("k", [1, 5, 64])
def test_col_topk_threshold_matches_jax(k):
    x = prune_block(seed=51 + k, kind="tied")
    got = tprune.col_topk_threshold(torch.as_tensor(x), k).numpy()
    want = jprune.col_topk_threshold_pallas(jnp.asarray(x), k)
    np.testing.assert_array_equal(got, np.asarray(want))
    got = tprune.col_topk_threshold_ref(torch.as_tensor(x), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jprune.col_topk_threshold_ref(jnp.asarray(x), k)))


@pytest.mark.parametrize("caps", [(300, 280, 4, 90, 80), (5000, 64, 16, 400, 8), (7, 9, 1, 7, 9)])
def test_pairing_counts_match_jax(caps):
    assert tbinned.pairing_counts(*caps) == jbinned.pairing_counts(*caps)


@pytest.mark.parametrize("n,kind", [(8, "dup"), (128, "dup"), (2048, "dup"), (128, "equal"),
                                    (128, "two")],
                         ids=["8", "128", "2048", "128-equal", "128-two"])
def test_bitonic_plain_matches_pallas(n, kind):
    """Same stages and tie rule: keys and values bit-identical, also where
    every key ties (each stage's direction alone decides the swap)."""
    keys, vals = sort_keys(seed=n, n=n, kind=kind)
    got_k, got_v = tsort.bitonic_sort_pairs(torch.as_tensor(keys), torch.as_tensor(vals))
    want_k, want_v = bitonic_sort_pairs_pallas(jnp.asarray(keys), jnp.asarray(vals),
                                               interpret=True)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))
    assert (np.diff(got_k.numpy()) >= 0).all()


def test_bitonic_refuses_other_types():
    keys, vals = dup_keys(seed=1, n=16)
    with pytest.raises(TypeError, match="int32"):
        tsort.bitonic_sort_pairs(torch.as_tensor(keys).long(), torch.as_tensor(vals))
    with pytest.raises(TypeError, match="32-bit"):
        tsort.bitonic_sort_pairs(torch.as_tensor(keys), torch.as_tensor(vals).double())
    with pytest.raises(ValueError, match="power of two"):
        tsort.bitonic_sort_pairs(torch.as_tensor(keys[:12]), torch.as_tensor(vals[:12]))


def test_bitonic_cuda_refuses_cpu_tensors():
    keys, vals = dup_keys(seed=2, n=16)
    with pytest.raises(ValueError, match="CUDA"):
        tsort.bitonic_sort_pairs_cuda(torch.as_tensor(keys), torch.as_tensor(vals))


# the JAX package's paired-kernel test shapes (m, k, n), with blocks that cut
# its grid to at most 8 steps: two row tiles, two A blocks, two B blocks
PAIRED_SHAPES = [(8, 8, 8), (16, 24, 8), (33, 17, 9), (64, 40, 128)]


def _paired_operands(seed, m, k, n, density=0.3):
    a_x, b_x = dense_random(seed, m, k, density), dense_random(seed + 1, k, n, density)
    a = jsparse.from_dense(jnp.asarray(a_x), cap=m * k // 2 + m)
    b = jsparse.from_dense(jnp.asarray(b_x), cap=k * n // 2 + n)
    av = np.where(np.asarray(a.valid_mask()), np.asarray(a.vals), 0).astype(np.float32)
    bv = np.where(np.asarray(b.valid_mask()), np.asarray(b.vals), 0).astype(np.float32)
    entries = [np.array(x) for x in (a.rows, a.cols)] + [av]
    entries += [np.array(x) for x in (b.rows, b.cols)] + [bv]
    return entries, a_x @ b_x


def _half(x):
    """A block size, a multiple of 8, that cuts ``x`` into two blocks."""
    return max(8, -(-x // 16) * 8)


def _blocks(m, cap_a, cap_b):
    return dict(m_blk=_half(m), n_blk=128, a_blk=_half(cap_a), b_blk=_half(cap_b))


@pytest.mark.parametrize("m,k,n", PAIRED_SHAPES)
def test_paired_plain_matches_pallas(m, k, n):
    entries, dense = _paired_operands(m + k + n, m, k, n)
    got = tacc.spgemm_paired(*(torch.as_tensor(x) for x in entries), m, n).numpy()
    want = spgemm_paired_pallas(*(jnp.asarray(x) for x in entries), m, n, interpret=True,
                                **_blocks(m, len(entries[0]), len(entries[3])))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)


def test_paired_plain_unsorted_and_out_of_range():
    """Sort-free: entries in any order give the same C, and live-valued
    entries outside the output are skipped, as the Pallas kernel's one-hot
    selectors skip them."""
    m, k, n = 24, 16, 24
    (ar, ac, av), (br, bc, bv) = paired_entries(seed=11, m=m, k=k, n=n, cap_a=200, nnz_a=150,
                                                cap_b=200, nnz_b=150)
    perm = np.random.default_rng(12).permutation(200)
    entries = (ar[perm], ac[perm], av[perm], br, bc, bv)
    got = tacc.spgemm_paired(*(torch.as_tensor(x) for x in entries), m, n).numpy()
    want = spgemm_paired_pallas(*(jnp.asarray(x) for x in entries), m, n, interpret=True,
                                **_blocks(m, 200, 200))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    unperm = tacc.spgemm_paired(*(torch.as_tensor(x) for x in (ar, ac, av, br, bc, bv)), m, n)
    np.testing.assert_allclose(got, unperm.numpy(), rtol=1e-5, atol=1e-6)


def test_paired_plain_matches_pallas_outside_k():
    """Live entries whose contraction index lies outside [0, k) (-7 and
    k + 3 on both sides) meet and contribute, in the Pallas kernel as in the
    plain version: matching is integer equality, with no k to bound it."""
    m, k, n = 24, 16, 24
    a, b = paired_entries(seed=13, m=m, k=k, n=n, cap_a=200, nnz_a=150, cap_b=200, nnz_b=150)
    meet_outside_k(a, b, m, k, n, seed=14)
    entries = (*a, *b)
    got = tacc.spgemm_paired(*(torch.as_tensor(x) for x in entries), m, n).numpy()
    want = spgemm_paired_pallas(*(jnp.asarray(x) for x in entries), m, n, interpret=True,
                                **_blocks(m, 200, 200))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    # the same sums written out: every (A, B) pair that agrees on the index
    (ar, ac, av), (br, bc, bv) = a, b
    dense = np.zeros((m, n), np.float64)
    for i in np.flatnonzero((ar >= 0) & (ar < m)):
        for j in np.flatnonzero((ac[i] == br) & (bc >= 0) & (bc < n)):
            dense[ar[i], bc[j]] += float(av[i]) * float(bv[j])
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-6)
    outside = (ac[:, None] == br[None, :]) & ((ac < 0) | (ac >= k))[:, None]
    assert outside.sum() >= 100  # the out-of-range indices really meet


def test_paired_cuda_refuses_cpu_tensors():
    (ar, ac, av), (br, bc, bv) = paired_entries(seed=3, m=8, k=8, n=8, cap_a=16, nnz_a=10,
                                                cap_b=16, nnz_b=10)
    with pytest.raises(ValueError, match="CUDA"):
        tacc.spgemm_paired_cuda(*(torch.as_tensor(x) for x in (ar, ac, av, br, bc, bv)), 8, 8)
