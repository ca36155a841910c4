"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and nvcc and skips without them;
this file imports no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: sums within rtol 1e-5 (atomics add in a run-dependent order;
densify's sums of duplicates within rtol 1e-6), key sets, min/max values
and drop/no-drop exact, the column top-k bracket and the bitonic sort's
keys and values bit-identical. The paired multiply's rtol 1e-5 / atol 1e-6
allows for the order of its atomic sums.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import local_spgemm as tlocal
from repro_torch.core import semiring as tsr
from repro_torch.core import sparse as tsparse
from repro_torch.kernels import col_prune as tprune
from repro_torch.kernels.densify_kernel import densify_cuda, densify_ref
from repro_torch.kernels import sort_engine as tsort
from repro_torch.kernels import spgemm_acc as tacc
from repro_torch.kernels import spgemm_binned as tbinned
from repro_torch.kernels import spgemm_hash as thash
from repro_torch.kernels.spmm_kernel import spmm_cuda, spmm_ref
from test_torch_cases import (
    SORT_KINDS, assert_vals, bin_both, binned_inputs, coo_entries, dup_keys, paired_case,
    prune_block, random_chunks, sort_keys, torch_tables,
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
    got = spmm_cuda(*args, m)
    want = spmm_ref(*args, m)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_densify_cuda_matches_plain(cuda_device):
    m, n = 500, 700
    rows, cols, vals = coo_entries(seed=43, m=m, n=n, cap=40000, nnz=35000)
    args = [torch.as_tensor(x, device=cuda_device) for x in (rows, cols, vals)]
    got = densify_cuda(*args, m, n)
    want = densify_ref(*args, m, n)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_local_spmm_on_the_card_sums_only(cuda_device):
    """On the card the local SpMM is the kernel: plus_times launches it,
    any other semiring raises instead of falling back."""
    rows, cols, vals = coo_entries(seed=44, m=40, n=50, cap=600, nnz=500)
    a = tsparse.SparseCOO(*(torch.as_tensor(x, device=cuda_device) for x in (rows, cols, vals)),
                          torch.tensor(500, dtype=torch.int32, device=cuda_device), (40, 50))
    b = torch.rand((50, 30), device=cuda_device)
    before = spmm_cuda.launches
    got = tlocal.spmm(a, b, tsr.PLUS_TIMES)
    assert spmm_cuda.launches == before + 1
    a_cpu = tsparse.SparseCOO(*(getattr(a, f).cpu() for f in ("rows", "cols", "vals", "nnz")),
                              a.shape)
    want = tlocal.spmm(a_cpu, b.cpu(), tsr.PLUS_TIMES)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="plus_times"):
        tlocal.spmm(a, b, tsr.MIN_PLUS)


@pytest.mark.parametrize("kind", SORT_KINDS)
@pytest.mark.parametrize("n", [1 << i for i in range(15)])
def test_bitonic_cuda_matches_plain(cuda_device, n, kind):
    """Every power of two up to 2^14: one block up to 2048 pairs, a cluster
    of n / 2048 blocks above, whose cross-block stages push their pairs
    into the partner block through distributed shared memory. Ties swap by the reference's
    rule, so equal and two-valued keys pin the values' order too."""
    keys, vals = sort_keys(seed=n, n=n, kind=kind)
    k, v = torch.as_tensor(keys, device=cuda_device), torch.as_tensor(vals, device=cuda_device)
    before = tsort.bitonic_sort_pairs_cuda.launches
    got_k, got_v = tsort.bitonic_sort_pairs(k, v)
    assert tsort.bitonic_sort_pairs_cuda.launches == before + 1
    want_k, want_v = tsort.bitonic_sort_pairs_ref(k, v)
    assert torch.equal(got_k, want_k)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_k, torch.sort(k).values)
    # an int32 payload moves as the same bits
    iv = v.view(torch.int32)
    assert torch.equal(tsort.bitonic_sort_pairs_cuda(k, iv)[1], want_v.view(torch.int32))
    assert tsort.bitonic_sort_pairs_cuda.launches == before + 2


def test_sort_pairs_cuda_pads_and_routes(cuda_device):
    for length in (12345, tsort.MAX_BITONIC_ELEMS + 8):
        keys, vals = dup_keys(seed=length, n=length)
        k, v = torch.as_tensor(keys, device=cuda_device), torch.as_tensor(vals, device=cuda_device)
        got_k, got_v = tsort.sort_pairs(k, v)
        assert torch.equal(got_k, torch.sort(k).values)
        uniq, inv = torch.unique(got_k, return_inverse=True)
        sums = torch.zeros(uniq.numel(), dtype=torch.float64, device=cuda_device)
        ref_sums = torch.zeros_like(sums)
        sums.index_add_(0, inv, got_v.double())
        _, perm = torch.sort(k)
        ref_sums.index_add_(0, inv, v[perm].double())
        torch.testing.assert_close(sums, ref_sums, rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "kind", ["mixed", "skew", "outside_k", "b_padding", "odd_cap_b", "large_cap_b"])
def test_paired_cuda_matches_plain(cuda_device, kind):
    """Padding on both sides (meeting on the contraction sentinel) and
    live-valued entries outside the output are skipped; a heavy contraction
    index (4096 B entries: its bucket is walked by whole warps), contraction
    indices outside [0, k), an all-padding B, and capB not a power of two or
    above 2^17 (the two-level scan of the bucket counts) all match the plain
    version."""
    a, b, m, n = paired_case(kind)
    args = [torch.as_tensor(x, device=cuda_device) for x in (*a, *b)]
    before = tacc.spgemm_paired_cuda.launches
    got = tacc.spgemm_paired(*args, m, n)
    assert tacc.spgemm_paired_cuda.launches == before + 1
    want = tacc.spgemm_paired_ref(*args, m, n)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert (int((want != 0).sum()) == 0) == (kind == "b_padding")
