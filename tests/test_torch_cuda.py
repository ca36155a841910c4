"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and nvcc and skips without them;
this file imports no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: sums within rtol 1e-5 (atomics add in a run-dependent order),
key sets, min/max values and drop/no-drop exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import spgemm_binned as tbinned
from repro_torch.kernels import spgemm_hash as thash
from test_torch_cases import assert_vals, bin_both, binned_inputs, random_chunks, torch_tables

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
