"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and nvcc and skips without them;
this file imports no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: sums within rtol 1e-5 (atomics add in a run-dependent order;
densify's sums of duplicates within rtol 1e-6), key sets, min/max values
and drop/no-drop exact, the column top-k bracket bit-identical.
"""
import numpy as np
import pytest
import torch

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

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("add_kind", ["sum", "min", "max"])
def test_hash_insert_cuda_matches_plain(cuda_device, add_kind):
    chunks = random_chunks(seed=11, num_chunks=3, chunk_cap=4096, key_space=3000)
    for table_cap in (8192, 512):
        kt = torch_tables(chunks, table_cap, add_kind, 32, thash.hash_insert_cuda, cuda_device)
        pt = torch_tables(chunks, table_cap, add_kind, 32, thash.hash_insert_ref, cuda_device)
        if table_cap == 512:  # far fewer slots than distinct keys: both drop
            assert kt[2] > 0 and pt[2] > 0
            continue
        assert kt[2] == pt[2] == 0
        ko, po = np.argsort(kt[0]), np.argsort(pt[0])
        np.testing.assert_array_equal(kt[0][ko], pt[0][po])  # same key set
        live = kt[0][ko] != thash.EMPTY
        assert_vals(add_kind, kt[1][ko][live], pt[1][po][live])


def test_paired_binned_cuda_matches_plain(cuda_device):
    inp = binned_inputs(seed=12, m=300, n=260, k_dim=400, cap_a=5000, cap_b=4000,
                        num_bins=8, bin_map=True)
    (ak, ar, av, _), (bk, bc, bv, _) = bin_both(
        inp, tbinned, lambda x: torch.as_tensor(x, device=cuda_device))
    args = (ar, ak, av, bk, bc, bv, inp["m"], inp["n"])
    got = tbinned.spgemm_paired_binned_cuda(*args)
    want = tbinned.spgemm_paired_binned_ref(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["random", "tied", "uniform"])
def test_col_topk_bounds_cuda_matches_plain(cuda_device, kind):
    x = torch.as_tensor(prune_block(seed=31, m=3000, n=333, kind=kind), device=cuda_device)
    for k in (1, 7, 64):
        got = tprune.col_topk_bounds_cuda(x, k)
        want = tprune.col_topk_bounds_ref(x, k)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_spmm_cuda_matches_plain(cuda_device):
    m, k, n = 700, 900, 600  # n spans three 256-column tiles, the last ragged
    rows, cols, vals = coo_entries(seed=41, m=m, n=k, cap=30000, nnz=25000)
    b = np.random.default_rng(42).uniform(-1, 1, (k, n)).astype(np.float32)
    args = [torch.as_tensor(x, device=cuda_device) for x in (rows, cols, vals, b)]
    got = tspmm.spmm_cuda(*args, m)
    want = tspmm.spmm_ref(*args, m)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_densify_cuda_matches_plain(cuda_device):
    m, n = 500, 700
    rows, cols, vals = coo_entries(seed=43, m=m, n=n, cap=40000, nnz=35000)
    args = [torch.as_tensor(x, device=cuda_device) for x in (rows, cols, vals)]
    got = tdensify.densify_cuda(*args, m, n)
    want = tdensify.densify_ref(*args, m, n)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_local_spmm_on_the_card_sums_only(cuda_device):
    """On the card the local SpMM is the kernel: plus_times launches it,
    any other semiring raises instead of falling back."""
    rows, cols, vals = coo_entries(seed=44, m=40, n=50, cap=600, nnz=500)
    a = tsparse.SparseCOO(*(torch.as_tensor(x, device=cuda_device) for x in (rows, cols, vals)),
                          torch.tensor(500, dtype=torch.int32, device=cuda_device), (40, 50))
    b = torch.rand((50, 30), device=cuda_device)
    before = tspmm.spmm_cuda.launches
    got = tlocal.spmm(a, b, tsr.PLUS_TIMES)
    assert tspmm.spmm_cuda.launches == before + 1
    a_cpu = tsparse.SparseCOO(*(getattr(a, f).cpu() for f in ("rows", "cols", "vals", "nnz")),
                              a.shape)
    want = tlocal.spmm(a_cpu, b.cpu(), tsr.PLUS_TIMES)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="plus_times"):
        tlocal.spmm(a, b, tsr.MIN_PLUS)
