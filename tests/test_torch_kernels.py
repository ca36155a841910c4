"""The port's kernels against the JAX package's oracles.

On the CPU the port runs each kernel's plain PyTorch version; those are
held against the JAX package's jnp oracles on the same numpy inputs
(``spgemm_hash.hash_insert_ref``, ``ref.spgemm_paired_binned_ref``,
``spgemm_binned.bin_entries_by_k``). The plain hash insert runs the same
probe rounds as the JAX oracle, so its table matches slot for slot, and
so does its drop count, with or without overflow.

The Hopper kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py``. Tolerances: sums within rtol 1e-5
(scatters add in another order), min/max and structure exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import spgemm_binned as jbinned
from repro.kernels import spgemm_hash as jhash
from repro_torch.kernels import spgemm_binned as tbinned
from repro_torch.kernels import spgemm_hash as thash
from test_torch_cases import assert_vals, bin_both, binned_inputs, random_chunks, torch_tables

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
