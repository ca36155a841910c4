"""The port's kernel API (``repro_torch.kernels.ops``) against the JAX
package's (``repro.kernels.ops``), on the same operands.

Operands are made from a seed with numpy and built on both sides with the
packages' own ``from_dense`` (which must agree field by field), or made by
the JAX package's generator and carried over with
``core.convert.from_reference``. The JAX wrappers run their jnp oracles
(``use_pallas=False``), or the Pallas network in interpret mode for
``sort_pairs``; the port runs its kernels' plain versions on the CPU.

Tolerances: sums within rtol 1e-5 (scatters add in another order),
min/max values exact, overflow counts equal, sorted keys identical, and the
values of a padded bitonic sort bit-identical (same network, same padding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gen as jgen
from repro.core import local_spgemm as jlocal
from repro.core import semiring as jsr
from repro.core import sparse as jsparse
from repro.core import symbolic as jsym
from repro.kernels import ops as jops
from repro.kernels import sort_engine as jsort
from repro_torch import kernels as tkernels
from repro_torch.core import convert
from repro_torch.core import local_spgemm as tlocal
from repro_torch.core import semiring as tsr
from repro_torch.core import sparse as tsparse
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sort_engine as tsort
from test_torch_cases import dense_random, dup_keys

SEMIRINGS = ["plus_times", "min_plus", "max_times"]


def _both(x, cap):
    """``x`` as padded COO of both packages, through their ``from_dense``."""
    return jsparse.from_dense(jnp.asarray(x), cap), tsparse.from_dense(torch.as_tensor(x), cap)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("cap", [40, 300], ids=["truncated", "padded"])
def test_from_dense_matches_jax(cap):
    x = dense_random(seed=1, m=17, n=23, density=0.3)
    a_j, a_t = _both(x, cap)
    for f in ("rows", "cols", "vals", "nnz"):
        np.testing.assert_array_equal(getattr(a_t, f).numpy(), np.asarray(getattr(a_j, f)))
    assert a_t.shape == a_j.shape


def test_package_exports_the_wrappers():
    for name in ("spmm", "spgemm_paired", "densify", "spgemm_paired_binned", "sort_pairs"):
        assert getattr(tkernels, name) is getattr(tops, name)
    assert tkernels.ref.spgemm_paired_ref.__module__ == "repro_torch.kernels.spgemm_acc"


@pytest.mark.parametrize("m,k,n", [(20, 30, 16), (33, 17, 9)])
def test_spmm_densify_paired_match_jax(m, k, n):
    a_x = dense_random(seed=m, m=m, n=k, density=0.3)
    b_x = dense_random(seed=n, m=k, n=n, density=0.4)
    a_j, a_t = _both(a_x, cap=m * k // 2)
    b_j, b_t = _both(b_x, cap=k * n // 2)
    _close(tops.spmm(a_t, torch.as_tensor(b_x)), jops.spmm(a_j, jnp.asarray(b_x)))
    _close(tops.densify(b_t), jops.densify(b_j))
    got = tops.spgemm_paired(a_t, b_t)
    _close(got, jops.spgemm_paired(a_j, b_j))
    np.testing.assert_allclose(got.numpy(), a_x @ b_x, rtol=1e-4, atol=1e-4)


def test_wrappers_ignore_slots_past_nnz():
    """Stale entries past ``nnz`` carry live indices and values: every
    wrapper zeroes them, as the reference's does."""
    a_x = dense_random(seed=5, m=12, n=10, density=0.5)
    b_x = dense_random(seed=6, m=10, n=8, density=0.5)
    a_j, a_t = _both(a_x, cap=100)
    b_j, b_t = _both(b_x, cap=60)
    nnz = int(a_t.nnz)
    rows, cols, vals = a_t.rows.clone(), a_t.cols.clone(), a_t.vals.clone()
    rows[nnz:], cols[nnz:], vals[nnz:] = 1, 2, 5.0
    a_t = tsparse.SparseCOO(rows, cols, vals, a_t.nnz, a_t.shape)
    a_j = jsparse.SparseCOO(jnp.asarray(rows.numpy()), jnp.asarray(cols.numpy()),
                            jnp.asarray(vals.numpy()), a_j.nnz, a_j.shape)
    _close(tops.densify(a_t), jops.densify(a_j))
    _close(tops.spgemm_paired(a_t, b_t), jops.spgemm_paired(a_j, b_j))
    np.testing.assert_allclose(tops.densify(a_t).numpy(), a_x, rtol=1e-6)


@pytest.mark.parametrize("seeds,caps,overflow", [
    ((5, 6), None, False),
    ((7, 8), (4, 8, 8), True),  # the JAX package's bin-overflow case
], ids=["planned", "overflow"])
def test_spgemm_paired_binned_matches_jax(seeds, caps, overflow):
    n = 48 if caps is None else 64
    avg = 4 if caps is None else 5
    a_j = jgen.erdos_renyi(n, avg, seed=seeds[0])
    b_j = jgen.erdos_renyi(n, avg, seed=seeds[1])
    a_t, b_t = convert.from_reference(a_j, "cpu"), convert.from_reference(b_j, "cpu")
    bin_map = None
    if caps is None:
        plan = jsym.plan_k_bins(np.asarray(a_j.col_counts()), np.asarray(b_j.row_counts()),
                                a_j.cap, b_j.cap)
        caps = (plan.num_bins, plan.bin_cap_a, plan.bin_cap_b)
        bin_map = np.asarray(plan.bin_of_k)
    c_j, ovf_j = jops.spgemm_paired_binned(
        a_j, b_j, *caps, bin_map=None if bin_map is None else jnp.asarray(bin_map))
    c_t, ovf_t = tops.spgemm_paired_binned(
        a_t, b_t, *caps, bin_map=None if bin_map is None else torch.as_tensor(bin_map))
    assert int(ovf_t) == int(ovf_j)
    assert (int(ovf_t) > 0) == overflow
    _close(c_t, c_j)
    if not overflow:
        _close(c_t, jops.spgemm_paired(a_j, b_j))


@pytest.mark.parametrize("length", [500, tsort.MAX_BITONIC_ELEMS + 8],
                         ids=["padded", "routed_to_torch_sort"])
def test_sort_pairs_matches_jax(length):
    keys, vals = dup_keys(seed=length, n=length)
    got_k, got_v = tops.sort_pairs(torch.as_tensor(keys), torch.as_tensor(vals))
    want_k, want_v = jsort.sort_pairs(jnp.asarray(keys), jnp.asarray(vals),
                                      use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    # per-key value sums: the sorts permute equal keys' values differently
    _, inv = np.unique(got_k.numpy(), return_inverse=True)
    sums_t = np.bincount(inv, weights=got_v.numpy().astype(np.float64))
    sums_j = np.bincount(inv, weights=np.asarray(want_v).astype(np.float64))
    np.testing.assert_allclose(sums_t, sums_j, atol=1e-5)
    if length <= tsort.MAX_BITONIC_ELEMS:  # the same network on the same padding
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_k.numpy(), np.sort(keys))


@pytest.mark.parametrize("name", SEMIRINGS)
def test_spgemm_dense_acc_matches_jax(name):
    m, k, n = 24, 20, 12
    a_x = np.abs(dense_random(seed=31, m=m, n=k, density=0.3))
    b_x = np.abs(dense_random(seed=32, m=k, n=n, density=0.3))
    a_j, a_t = _both(a_x, cap=200)
    b_j, b_t = _both(b_x, cap=120)
    got, ovf_t = tlocal.spgemm_dense_acc(a_t, b_t, tsr.get(name), return_overflow=True)
    want, ovf_j = jlocal.spgemm_dense_acc(a_j, b_j, jsr.get(name), return_overflow=True)
    assert int(ovf_t) == int(ovf_j) == 0
    if name == "plus_times":
        _close(got, want)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a tighter output cap than the product needs: both report the overflow
    if name == "min_plus":
        _, ovf_t = tlocal.spgemm_dense_acc(a_t, b_t, tsr.get(name), out_cap=8,
                                           return_overflow=True)
        _, ovf_j = jlocal.spgemm_dense_acc(a_j, b_j, jsr.get(name), out_cap=8,
                                           return_overflow=True)
        assert int(ovf_t) == int(ovf_j) > 0


def test_dense_acc_spgemm_via_kernels():
    """densify(B) then SpMM == the paired kernel == the dense product: the
    two kernel realizations of the batched local multiply agree (the JAX
    package's ``TestKernelIntegration``)."""
    m, k, n = 32, 24, 16
    a_x = dense_random(seed=21, m=m, n=k, density=0.3)
    b_x = dense_random(seed=22, m=k, n=n, density=0.3)
    a_t = tsparse.from_dense(torch.as_tensor(a_x), cap=300)
    b_t = tsparse.from_dense(torch.as_tensor(b_x), cap=200)
    c1 = tops.spmm(a_t, tops.densify(b_t))
    c2 = tops.spgemm_paired(a_t, b_t)
    c3 = tlocal.spgemm_dense_acc(a_t, b_t)
    np.testing.assert_allclose(c1.numpy(), c2.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c3.numpy(), c1.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c1.numpy(), a_x @ b_x, rtol=1e-4, atol=1e-4)
