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
from repro.kernels import ref as jref
from repro.kernels import spgemm_binned as jbinned
from repro.kernels import spgemm_hash as jhash
from repro.kernels.col_prune import col_topk_bounds_pallas
from repro.kernels.densify import densify_pallas
from repro.kernels.spmm import spmm_pallas
from repro_torch.core import local_spgemm as tlocal
from repro_torch.core import semiring as tsr
from repro_torch.core import sparse as tsparse
from repro_torch.kernels import col_prune as tprune
from repro_torch.kernels import densify as tdensify
from repro_torch.kernels import spgemm_binned as tbinned
from repro_torch.kernels import spgemm_hash as thash
from repro_torch.kernels import spmm as tspmm
from test_torch_cases import (
    assert_vals, bin_both, binned_inputs, coo_entries, prune_block, random_chunks, torch_tables,
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


def test_paired_binned_cuda_refuses_cpu_tensors():
    inp = binned_inputs(seed=6)
    (tak, tar, tav, _), (tbk, tbc, tbv, _) = bin_both(inp, tbinned, torch.as_tensor)
    with pytest.raises(ValueError, match="CUDA"):
        tbinned.spgemm_paired_binned_cuda(tar, tak, tav, tbk, tbc, tbv, inp["m"], inp["n"])


@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("kind", ["random", "tied", "uniform"])
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
    got = tspmm.spmm(*(torch.as_tensor(x) for x in (rows, cols, vals, b)), m).numpy()
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


def test_spmm_cuda_refuses_cpu_tensors():
    rows, cols, vals = coo_entries(seed=2, m=8, n=8, cap=16, nnz=10)
    b = torch.ones((8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tspmm.spmm_cuda(*(torch.as_tensor(x) for x in (rows, cols, vals)), b, 8)


@pytest.mark.parametrize("m,n", [(40, 130), (129, 8)])
def test_densify_plain_matches_pallas(m, n):
    rows, cols, vals = coo_entries(seed=m, m=m, n=n, cap=700, nnz=600)
    got = tdensify.densify(*(torch.as_tensor(x) for x in (rows, cols, vals)), m, n).numpy()
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
        tdensify.densify_cuda(*(torch.as_tensor(x) for x in (rows, cols, vals)), 8, 8)
