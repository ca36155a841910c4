"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and nvcc and skips without them;
this file imports no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: sums within rtol 1e-5 (atomics, or the plain versions'
scatters, add in another order; densify's sums of duplicates within rtol
1e-6), key sets, min/max values and drop/no-drop exact, the column top-k
bracket and the bitonic sort's keys and values bit-identical. The paired
multiply's rtol 1e-5 / atol 1e-6 allows for the order of its atomic sums.
The SpMM, the segment reduction and the ESC multiply use no atomics: two
calls on the same inputs must give the same bits.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import local_spgemm as tlocal
from repro_torch.core import semiring as tsr
from repro_torch.core import sparse as tsparse
from repro_torch.core import sortkeys as tsortkeys
from repro_torch.kernels import col_prune as tprune
from repro_torch.kernels import segment_reduce as tseg
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["ragged", "odd_n", "empty_rows", "long_row", "sentinels"])
def test_spmm_cuda_matches_plain(cuda_device, case, dtype):
    """n not a multiple of the 128-column tile (and odd: no 4-column
    vector access), rows with no entries, one row with 10^4 entries (split
    over the block's warps), live-valued entries on sentinel rows and
    columns (skipped); two calls give the same bits."""
    m, k, n = 700, 900, 600
    cap, nnz = 30000, 25000
    if case == "odd_n":
        n = 301
    rows, cols, vals = coo_entries(seed=41, m=m, n=k, cap=cap, nnz=nnz)
    rng = np.random.default_rng(45)
    if case == "empty_rows":
        rows[:nnz] = rng.choice(np.arange(0, m, 3), nnz)  # two rows in three are empty
    elif case == "long_row":
        rows[:10000] = 123
    elif case == "sentinels":
        rows[:nnz:11], vals[:nnz:11] = m, 5.0
        cols[1:nnz:13], vals[1:nnz:13] = k, 5.0
    b = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    tdt = getattr(torch, dtype)
    args = [torch.as_tensor(x, device=cuda_device) for x in (rows, cols)]
    args += [torch.as_tensor(x, device=cuda_device).to(tdt) for x in (vals, b)]
    before = spmm_cuda.launches
    got = spmm_cuda(*args, m)
    again = spmm_cuda(*args, m)
    assert spmm_cuda.launches == before + 2
    want = spmm_ref(*args, m)
    assert got.dtype == want.dtype == torch.float32
    if case == "long_row":
        # 10^4 terms of both signs: an f32 sum in another order may differ
        # by ~1e-5 of the sum of |terms| (|A|·|B|), not of the result
        scale = spmm_ref(args[0], args[1], args[2].abs(), args[3].abs(), m)
        assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)  # both sum in f32
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


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
    """Padded to the network, or routed to a stable torch.sort, whose tied
    keys keep their values in input order."""
    for length in (12345, tsort.MAX_BITONIC_ELEMS + 8):
        keys, vals = dup_keys(seed=length, n=length)
        k, v = torch.as_tensor(keys, device=cuda_device), torch.as_tensor(vals, device=cuda_device)
        got_k, got_v = tsort.sort_pairs(k, v)
        assert torch.equal(got_k, torch.sort(k).values)
        uniq, inv = torch.unique(got_k, return_inverse=True)
        sums = torch.zeros(uniq.numel(), dtype=torch.float64, device=cuda_device)
        ref_sums = torch.zeros_like(sums)
        sums.index_add_(0, inv, got_v.double())
        _, perm = torch.sort(k, stable=True)
        ref_sums.index_add_(0, inv, v[perm].double())
        torch.testing.assert_close(sums, ref_sums, rtol=0, atol=1e-5)
        if length > tsort.MAX_BITONIC_ELEMS:
            assert torch.equal(got_v, v[perm])


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


@pytest.mark.parametrize("add_kind", ["sum", "min", "max"])
def test_segment_reduce_cuda_matches_plain(cuda_device, add_kind):
    """Runs of 0 to 10^5 entries (one warp each), entries before the first
    run and past the last never read; two calls give the same bits."""
    rng = np.random.default_rng(71)
    lengths = rng.integers(0, 12, 20000)
    lengths[[5, 700]] = (100000, 3000)
    offsets = np.concatenate([[17], 17 + np.cumsum(lengths)]).astype(np.int32)
    vals = rng.uniform(-1, 1, int(offsets[-1]) + 29).astype(np.float32)
    v = torch.as_tensor(vals, device=cuda_device)
    off = torch.as_tensor(offsets, device=cuda_device)
    before = tseg.segment_reduce_cuda.launches
    got = tseg.segment_reduce(v, off, add_kind)
    again = tseg.segment_reduce(v, off, add_kind)
    assert tseg.segment_reduce_cuda.launches == before + 2
    want = tseg.segment_reduce_ref(v, off, add_kind)
    if add_kind == "sum":  # 10^5 terms of both signs: bound by the sum of |terms|
        scale = tseg.segment_reduce_ref(v.abs(), off, "sum")
        assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
    else:
        assert torch.equal(got, want)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def _hash_operands(device, outside_k=False):
    """A (300 × 400) and B (400 × 260) as the port's SparseCOO, in no order,
    with padding; with ``outside_k`` some of B's contraction indices are
    k + 3 and -7 (no products)."""
    m, k, n = 300, 400, 260
    a = coo_entries(seed=81, m=m, n=k, cap=5000, nnz=4500)
    b = coo_entries(seed=82, m=k, n=n, cap=4000, nnz=3600)
    if outside_k:
        b[0][:3600:17], b[0][5:3600:23] = k + 3, -7

    def coo(x, nnz, shape):
        return tsparse.SparseCOO(*(torch.as_tensor(t, device=device) for t in x),
                                 torch.tensor(nnz, dtype=torch.int32, device=device), shape)

    return coo(a, 4500, (m, k)), coo(b, 3600, (k, n))


def _expand_insert(fn, x, table_cap, chunk_cap, num_chunks, semi, device):
    tk = torch.full((table_cap,), thash.EMPTY, dtype=torch.int32, device=device)
    tv = torch.full((table_cap,), thash.table_init_val(semi.add_kind), device=device)
    dropped = torch.zeros((), dtype=torch.int32, device=device)
    fn(tk, tv, dropped, x, chunk_cap, num_chunks, semiring=semi, max_probes=32)
    skey, perm = torch.sort(tk)
    return skey.cpu().numpy(), tv[perm].cpu().numpy(), int(dropped)


@pytest.mark.parametrize("semiring", ["plus_times", "or_and", "min_plus", "max_times",
                                      "plus_pair"])
@pytest.mark.parametrize("case", ["planned", "flops_beyond", "small_table", "outside_k"])
def test_hash_expand_insert_cuda_matches_plain(cuda_device, semiring, case):
    """The fused kernel (one launch) against the plain chunk loop: every add
    kind and product, the enumeration cut at num_chunks · chunk_cap, a table
    far too small (both drop) and out-of-range contraction indices."""
    semi = tsr.get(semiring)
    a, b = _hash_operands(cuda_device, outside_k=case == "outside_k")
    x, total = tlocal.hash_expansion(a, b)
    chunk_cap, num_chunks = 4096, -(-int(total) // 4096)
    table_cap = 1 << 16
    if case == "flops_beyond":
        num_chunks //= 2
    elif case == "small_table":
        table_cap = 1024
    before = thash.hash_expand_insert_cuda.launches
    kt = _expand_insert(thash.hash_expand_insert_cuda, x, table_cap, chunk_cap, num_chunks,
                        semi, cuda_device)
    assert thash.hash_expand_insert_cuda.launches == before + 1
    pt = _expand_insert(thash.hash_expand_insert_ref, x, table_cap, chunk_cap, num_chunks,
                        semi, cuda_device)
    if case == "small_table":
        assert kt[2] > 0 and pt[2] > 0
        return
    assert kt[2] == pt[2] == 0
    np.testing.assert_array_equal(kt[0], pt[0])  # same key set
    live = kt[0] != thash.EMPTY
    assert_vals(semi.add_kind, kt[1][live], pt[1][live])


def test_spgemm_hash_cuda_launches_once(cuda_device):
    """On the card the hash multiply inserts a batch in one launch, with no
    one-chunk launches, and matches the CPU path (the reference's loop)."""
    a, b = _hash_operands(cuda_device)
    kw = dict(out_cap=60000, table_cap=1 << 16, chunk_cap=1024, num_chunks=64)
    fused, chunked = thash.hash_expand_insert_cuda.launches, thash.hash_insert_cuda.launches
    c, ovf = tlocal.spgemm_hash(a, b, **kw)
    assert thash.hash_expand_insert_cuda.launches == fused + 1
    assert thash.hash_insert_cuda.launches == chunked
    cpu = [tsparse.SparseCOO(*(getattr(t, f).cpu() for f in ("rows", "cols", "vals", "nnz")),
                             t.shape) for t in (a, b)]
    want, ovf_w = tlocal.spgemm_hash(*cpu, **kw)
    assert int(ovf) == int(ovf_w) == 0
    assert torch.equal(c.rows.cpu(), want.rows) and torch.equal(c.cols.cpu(), want.cols)
    torch.testing.assert_close(c.vals.cpu(), want.vals, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("engine", ["bucket", "packed", "lexsort"])
def test_esc_sums_repeat_bits(cuda_device, engine):
    """The ESC multiply, and each engine's sum, give the same bits on every
    run (no atomics): twice on the card, and against the CPU within rtol
    1e-5."""
    a, b = _hash_operands(cuda_device)
    c1, o1 = tlocal.spgemm_esc(a, b, out_cap=60000, flops_cap=1 << 17)
    c2, o2 = tlocal.spgemm_esc(a, b, out_cap=60000, flops_cap=1 << 17)
    assert int(o1) == int(o2) == 0
    for f in ("rows", "cols", "nnz"):
        assert torch.equal(getattr(c1, f), getattr(c2, f))
    assert torch.equal(c1.vals.view(torch.int32), c2.vals.view(torch.int32))
    rows, cols, vals = coo_entries(seed=91, m=300, n=260, cap=200000, nnz=190000)
    args = [torch.as_tensor(x, device=cuda_device) for x in (rows, cols, vals)]
    valid = torch.ones(rows.shape, dtype=torch.bool, device=cuda_device)
    for new_cap in (80000, 5000):  # fits; overflows
        runs = [tsortkeys.coalesce_entries(*args, valid, (300, 260), new_cap, engine=engine)
                for _ in range(2)]
        assert torch.equal(runs[0][2].view(torch.int32), runs[1][2].view(torch.int32))
        want = tsortkeys.coalesce_entries(*(t.cpu() for t in args), valid.cpu(), (300, 260),
                                          new_cap, engine=engine)
        for g, w in zip(runs[0], want):
            if g.dtype == torch.float32:
                torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-6)
            else:
                assert torch.equal(g.cpu(), w)
