"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and nvcc and skips without them;
this file imports no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: sums within rtol 1e-5 (atomics, or the plain versions'
scatters, add in another order; densify's sums of duplicates within rtol
1e-6), key sets, min/max values and drop/no-drop exact, the column top-k
bracket and the bitonic sort's keys and values bit-identical. The paired
multiply's rtol 1e-5 / atol 1e-6 allows for the order of its atomic sums.
The k-binned multiply adds in a fixed order: bit-identical to its plain
version run on the CPU. It, the SpMM, the segment reduction and the ESC
multiply use no atomics on their sums: two calls on the same inputs must
give the same bits.
"""
import pickle

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
    BINNED_LAYOUTS, SORT_KINDS, assert_vals, bin_both, binned_inputs, binned_layout, coo_entries,
    dup_keys, paired_case, prune_block, random_chunks, sort_keys, torch_tables,
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


def assert_binned_order_fixed(arrays, m, n, device):
    """The kernel's C is bit-identical to the plain version's on the CPU
    (a serial f32 sum in bin, A slot, B slot order), in each of two calls;
    one launch a call."""
    args = [torch.as_tensor(x, device=device) for x in arrays]
    before = tbinned.spgemm_paired_binned_cuda.launches
    got = tbinned.spgemm_paired_binned_cuda(*args, m, n)
    again = tbinned.spgemm_paired_binned_cuda(*args, m, n)
    assert tbinned.spgemm_paired_binned_cuda.launches == before + 2
    want = tbinned.spgemm_paired_binned_ref(*(a.cpu() for a in args), m, n)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_paired_binned_cuda_matches_plain(cuda_device):
    inp = binned_inputs(seed=12, m=300, n=260, k_dim=400, cap_a=5000, cap_b=4000,
                        num_bins=8, bin_map=True)
    (ak, ar, av, _), (bk, bc, bv, _) = bin_both(inp, tbinned, torch.as_tensor)
    assert_binned_order_fixed((ar, ak, av, bk, bc, bv), inp["m"], inp["n"], cuda_device)


@pytest.mark.parametrize("kind", BINNED_LAYOUTS)
def test_paired_binned_cuda_order_fixed(cuda_device, kind):
    """Repeated (k, column) pairs in one 32-entry chunk of a B bucket,
    repeated (row, k) pairs, empty bins, live values outside [0, m) x
    [0, n), a row of ~3700 A entries, a B bucket of 160 entries, n % 4 != 0,
    three column tiles, and nothing live (see binned_layout)."""
    arrays, (m, n) = binned_layout(kind, seed=72, scale=4)
    assert_binned_order_fixed(arrays, m, n, cuda_device)


# kind -> (prune_block kind, m, n, ks): m = 3000 splits evenly over the
# kernel's 8-block cluster, 3001 does not; n = 333 is not a multiple of its
# 32-column tile; "k_ge_m" has k >= m (and a cluster block with no rows);
# "mcl_block" is the dense MCL phase's 16384 x 4096 block at k = 64
_PRUNE_CASES = {
    "random": ("random", 3000, 333, (1, 7, 64)),
    "tied": ("tied", 3000, 333, (1, 7, 64)),
    "uniform": ("uniform", 3000, 333, (1, 7, 64)),
    "narrow": ("narrow", 3001, 333, (1, 7, 64)),
    "sparse_col": ("sparse_col", 3001, 333, (1, 7, 64)),
    "k_ge_m": ("random", 7, 70, (7, 8, 64)),
    "mcl_block": ("random", 16384, 4096, (64,)),
}


@pytest.mark.parametrize("kind", list(_PRUNE_CASES))
def test_col_topk_bounds_cuda_matches_plain(cuda_device, kind):
    """The bracket is bit-identical to the plain version's, one launch a call."""
    block_kind, m, n, ks = _PRUNE_CASES[kind]
    x = torch.as_tensor(prune_block(seed=31, m=m, n=n, kind=block_kind), device=cuda_device)
    for k in ks:
        before = tprune.col_topk_bounds_cuda.launches
        got = tprune.col_topk_bounds_cuda(x, k)
        assert tprune.col_topk_bounds_cuda.launches == before + 1
        want = tprune.col_topk_bounds_ref(x, k)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


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


@pytest.mark.parametrize("case", ["ragged", "odd_n", "empty_rows", "long_row"])
def test_spmm_cuda_accumulates_into_out(cuda_device, case):
    """The accumulate mode (the Cannon ring's stages after the first): C
    += A·B into the ``out`` it is given, one launch, within rtol 1e-5 of
    the plain version's ``out + A·B``, the same bits from two calls."""
    m, k, n = 700, 900, 301 if case == "odd_n" else 600
    rows, cols, vals = coo_entries(seed=46, m=m, n=k, cap=30000, nnz=25000)
    rng = np.random.default_rng(47)
    if case == "empty_rows":
        rows[:25000] = rng.choice(np.arange(0, m, 3), 25000)
    elif case == "long_row":
        rows[:10000] = 5
    args = [torch.as_tensor(x, device=cuda_device) for x in (rows, cols, vals)]
    b = torch.as_tensor(rng.uniform(0, 1, (k, n)).astype(np.float32), device=cuda_device)
    args[2] = args[2].abs()  # nonnegative terms: the sums' order moves only rounding
    c0 = torch.as_tensor(rng.uniform(0, 1, (m, n)).astype(np.float32), device=cuda_device)
    out = c0.clone()
    before = spmm_cuda.launches
    got = spmm_cuda(*args, b, m, out=out)
    assert got.data_ptr() == out.data_ptr() and spmm_cuda.launches == before + 1
    again = spmm_cuda(*args, b, m, out=c0.clone())
    want = spmm_ref(*args, b, m, out=c0.clone())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    # rows with no entries are left as they were, bit for bit (padding's row is m)
    idle = torch.ones(m + 1, dtype=torch.bool, device=cuda_device)
    idle[args[0].long()] = False
    idle = idle[:m]
    assert torch.equal(got[idle].view(torch.int32), c0[idle].view(torch.int32))
    with pytest.raises(ValueError, match="out must be"):
        spmm_cuda(*args, b, m, out=c0[:, 1:])


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


def _segment_lengths(layout, rng):
    """Run lengths and the first run's offset for one segment layout."""
    t, w = tseg.path_limits()
    if layout == "mixed":  # 0 to 11 entries, one run of 10^5 and one of 3000
        lengths = rng.integers(0, 12, 20000)
        lengths[[5, 700]] = (100000, 3000)
        return lengths, 17
    if layout == "thresholds":  # each length at and just past a path's limit
        edges = np.array([0, 1, t - 1, t, t + 1, w - 1, w, w + 1, 3 * w])
        return np.tile(rng.permutation(edges), 40), 5
    if layout == "all_empty":
        return np.zeros(5000, np.int64), 3
    # "esc": the packed-key engine's compress, 1 to 3 entries a live run,
    # then an empty tail of slots past nnz
    return np.concatenate([rng.integers(1, 4, 30000), np.zeros(20000, np.int64)]), 0


@pytest.mark.parametrize("add_kind", ["sum", "min", "max"])
@pytest.mark.parametrize("layout", ["mixed", "thresholds", "all_empty", "esc"])
def test_segment_reduce_cuda_matches_plain(cuda_device, layout, add_kind):
    """Runs of every path (one thread up to the kernel's thread limit, a
    warp up to its warp limit, a block beyond: ``path_limits``), empty runs
    and an empty tail, entries before the first run and past the last never
    read; two calls give the same bits, and a run a thread sums has the
    bits of the plain version on the CPU (both add serially in entry
    order)."""
    rng = np.random.default_rng(71)
    lengths, first = _segment_lengths(layout, rng)
    offsets = np.concatenate([[first], first + np.cumsum(lengths)]).astype(np.int32)
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
    short = torch.as_tensor(lengths <= tseg.path_limits()[0])
    cpu = tseg.segment_reduce_ref(v.cpu(), off.cpu(), add_kind)
    assert torch.equal(got.cpu()[short].view(torch.int32), cpu[short].view(torch.int32))
    if layout == "all_empty":
        assert bool((got == tsr.scatter_reduce_init(add_kind)).all())


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


def _hash_mask(kind, device, shape=(300, 260)):
    """Sorted packed mask keys over the hash operands' output space, with
    sentinel padding: "random" (~20 % of the space), "empty" (padding
    only) or "every" (every coordinate)."""
    m, n = shape
    rng = np.random.default_rng(83)
    keep = {"random": rng.random(shape) < 0.2, "empty": np.zeros(shape, bool),
            "every": np.ones(shape, bool)}[kind]
    r, c = (torch.as_tensor(x.astype(np.int32), device=device) for x in np.nonzero(keep))
    pad = torch.full((37,), m, dtype=torch.int32, device=device)
    rows, cols = torch.cat([r, pad]), torch.cat([c, torch.full_like(pad, n)])
    return tsortkeys.sorted_mask_keys(rows, cols, rows < m, shape)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "max_times"])
@pytest.mark.parametrize("mode", ["strict", "complement"])
@pytest.mark.parametrize("mask", ["random", "empty", "every"])
def test_masked_hash_expand_insert_cuda_matches_plain(cuda_device, semiring, mode,
                                                      mask):
    """The masked fused kernel (one launch) against its plain version (the
    chunk loop filtering each chunk by ``keys_in_sorted``): the same key set,
    sums within rtol 1e-5, min/max exact, no drops. A mask of every key
    keeps the unmasked table under "strict" and nothing under "complement";
    an empty mask the other way round."""
    semi = tsr.get(semiring)
    a, b = _hash_operands(cuda_device)
    x, total = tlocal.hash_expansion(a, b)
    xm = x._replace(mask_keys=_hash_mask(mask, cuda_device), mask_mode=mode)
    num_chunks = -(-int(total) // 4096)
    before = thash.hash_expand_insert_cuda.launches
    kt = _expand_insert(thash.hash_expand_insert_cuda, xm, 1 << 16, 4096, num_chunks, semi,
                        cuda_device)
    assert thash.hash_expand_insert_cuda.launches == before + 1
    pt = _expand_insert(thash.hash_expand_insert_ref, xm, 1 << 16, 4096, num_chunks, semi,
                        cuda_device)
    assert kt[2] == pt[2] == 0
    np.testing.assert_array_equal(kt[0], pt[0])
    live = kt[0] != thash.EMPTY
    assert_vals(semi.add_kind, kt[1][live], pt[1][live])
    keeps_all = (mask == "every") == (mode == "strict")
    if mask != "random":
        full = _expand_insert(thash.hash_expand_insert_cuda, x, 1 << 16, 4096, num_chunks, semi,
                              cuda_device)
        np.testing.assert_array_equal(kt[0], full[0] if keeps_all else
                                      np.full_like(kt[0], thash.EMPTY))


def test_masked_hash_wrapper_refuses_bad_mask_keys(cuda_device):
    """No fallback: mask keys that are not int32, not contiguous or not on
    the table's device raise before any launch."""
    a, b = _hash_operands(cuda_device)
    keys = _hash_mask("random", cuda_device)
    x, _ = tlocal.hash_expansion(a, b, keys)
    tk = torch.full((1 << 16,), thash.EMPTY, dtype=torch.int32, device=cuda_device)
    tv = torch.zeros(1 << 16, device=cuda_device)
    dropped = torch.zeros((), dtype=torch.int32, device=cuda_device)
    before = thash.hash_expand_insert_cuda.launches
    for bad, err in ((keys.long(), TypeError), (keys[::2], ValueError), (keys.cpu(), ValueError)):
        with pytest.raises(err):
            thash.hash_expand_insert_cuda(tk, tv, dropped, x._replace(mask_keys=bad), 4096, 8,
                                          semiring=tsr.PLUS_TIMES, max_probes=32)
    assert thash.hash_expand_insert_cuda.launches == before


@pytest.mark.parametrize("complement", [False, True], ids=["strict", "complement"])
def test_masked_spgemm_hash_cuda_launches_once(cuda_device, complement):
    """The masked hash multiply on the card: one fused launch, the CPU
    path's structure, values within rtol 1e-5, no overflow."""
    a, b = _hash_operands(cuda_device)
    keys = _hash_mask("random", cuda_device)
    kw = dict(out_cap=60000, table_cap=1 << 16, chunk_cap=1024, num_chunks=64)
    before = thash.hash_expand_insert_cuda.launches
    c, ovf = tlocal.spgemm_hash(a, b, mask_keys=keys, mask_complement=complement, **kw)
    assert thash.hash_expand_insert_cuda.launches == before + 1
    cpu = [tsparse.SparseCOO(*(getattr(t, f).cpu() for f in ("rows", "cols", "vals", "nnz")),
                             t.shape) for t in (a, b)]
    want, ovf_w = tlocal.spgemm_hash(*cpu, mask_keys=keys.cpu(), mask_complement=complement,
                                     **kw)
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


# ---------------------------------------------------------------------------
# a card other than the current one, and the grid's ranks on one card
# ---------------------------------------------------------------------------
@pytest.fixture
def second_card():
    """cuda:1, with cuda:0 the current card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


def _on(dev, *arrays):
    return [torch.as_tensor(x, device=dev) for x in arrays]


def _second_card_case(name, dev):
    """(wrapper, its calls' results on ``dev``, the plain version's, exact)."""
    if name == "hash_insert":
        chunks = random_chunks(seed=11, num_chunks=2, chunk_cap=4096, key_space=3000)
        got = torch_tables(chunks, 8192, "sum", 32, thash.hash_insert_cuda, dev)
        want = torch_tables(chunks, 8192, "sum", 32, thash.hash_insert_ref, dev)
        ko, po = np.argsort(got[0]), np.argsort(want[0])
        return thash.hash_insert_cuda, (got[0][ko], got[1][ko]), (want[0][po], want[1][po]), False
    if name == "hash_expand_insert":
        x, total = tlocal.hash_expansion(*_hash_operands(dev))
        args = (x, 1 << 16, 4096, -(-int(total) // 4096), tsr.PLUS_TIMES, dev)
        return (thash.hash_expand_insert_cuda, _expand_insert(thash.hash_expand_insert_cuda, *args),
                _expand_insert(thash.hash_expand_insert_ref, *args), False)
    if name == "spgemm_paired_binned":
        inp = binned_inputs(seed=12, m=300, n=260, k_dim=400, cap_a=5000, cap_b=4000,
                            num_bins=8, bin_map=True)
        (ak, ar, av, _), (bk, bc, bv, _) = bin_both(inp, tbinned, torch.as_tensor)
        args = _on(dev, ar, ak, av, bk, bc, bv)
        m, n = inp["m"], inp["n"]
        return (tbinned.spgemm_paired_binned_cuda, tbinned.spgemm_paired_binned_cuda(*args, m, n),
                tbinned.spgemm_paired_binned_ref(*(a.cpu() for a in args), m, n), True)
    if name == "col_topk_bounds":
        x = torch.as_tensor(prune_block(seed=31, m=3000, n=333, kind="random"), device=dev)
        return (tprune.col_topk_bounds_cuda, tprune.col_topk_bounds_cuda(x, 7),
                tprune.col_topk_bounds_ref(x, 7), True)
    if name in ("spmm", "densify"):
        rows, cols, vals = coo_entries(seed=41, m=700, n=900, cap=30000, nnz=25000)
        args = _on(dev, rows, cols, vals)
        if name == "densify":
            return (densify_cuda, densify_cuda(*args, 700, 900), densify_ref(*args, 700, 900),
                    False)
        b = torch.as_tensor(np.random.default_rng(45).uniform(-1, 1, (900, 600)),
                            dtype=torch.float32, device=dev)
        return spmm_cuda, spmm_cuda(*args, b, 700), spmm_ref(*args, b, 700), False
    if name == "bitonic_sort_pairs":
        k, v = _on(dev, *sort_keys(seed=5, n=1 << 13, kind="dup"))
        return (tsort.bitonic_sort_pairs_cuda, tsort.bitonic_sort_pairs_cuda(k, v),
                tsort.bitonic_sort_pairs_ref(k, v), True)
    if name == "spgemm_paired":
        a, b, m, n = paired_case("mixed")
        args = _on(dev, *a, *b)
        return (tacc.spgemm_paired_cuda, tacc.spgemm_paired_cuda(*args, m, n),
                tacc.spgemm_paired_ref(*args, m, n), False)
    lengths = np.random.default_rng(71).integers(0, 40, 5000)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    v, off = _on(dev, np.random.default_rng(72).uniform(-1, 1, int(offsets[-1])).astype(
        np.float32), offsets)
    return (tseg.segment_reduce_cuda, tseg.segment_reduce_cuda(v, off, "sum"),
            tseg.segment_reduce_ref(v.cpu(), off.cpu(), "sum"), False)


@pytest.mark.parametrize("name", [
    "hash_insert", "hash_expand_insert", "spgemm_paired_binned", "col_topk_bounds", "spmm",
    "densify", "bitonic_sort_pairs", "spgemm_paired", "segment_reduce"])
def test_kernel_on_a_card_that_is_not_current(second_card, name):
    """Each wrapper launches on its tensors' card, not the current one: on
    cuda:1 while cuda:0 is current, each matches its plain version (the
    tolerances of the tests above) and counts one more launch."""
    wrappers = (thash.hash_insert_cuda, thash.hash_expand_insert_cuda,
                tbinned.spgemm_paired_binned_cuda, tprune.col_topk_bounds_cuda, spmm_cuda,
                densify_cuda, tsort.bitonic_sort_pairs_cuda, tacc.spgemm_paired_cuda,
                tseg.segment_reduce_cuda)
    before = {w: w.launches for w in wrappers}
    wrapper, got, want, exact = _second_card_case(name, second_card)
    torch.cuda.synchronize(second_card)
    assert torch.cuda.current_device() == 0
    assert wrapper.launches > before[wrapper]
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert g.device == second_card
            g, w = g.cpu().numpy(), w.cpu().numpy()
        if exact:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5, atol=1e-5)


def _gloo_product_rank(grid, n):
    """One rank of a 4-rank product on one card: its tile of every batch of
    C = A·A in global coordinates, and its pickled plan."""
    from repro_torch.core import convert, gen
    from repro_torch.core.batched import batched_summa3d
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.specs import PlanSpec

    a = gen.protein_similarity_like(n, blocks=n // 64, intra_p=0.12, seed=0, device=grid.device)
    A, B = scatter_to_grid(a, grid, "A"), scatter_to_grid(a, grid, "B")
    parts = []
    res = batched_summa3d(A, B, grid, 12 * (A.cap + B.cap) + 12 * 4 * n,
                          consumer=lambda bi, c, cm: parts.append(convert.batch_to_global(c, cm)),
                          spec=PlanSpec(local_path="esc"))
    rows, cols, vals = (torch.cat(x).cpu().numpy() for x in zip(*parts))
    return rows, cols, vals, pickle.dumps(res.plan)


@pytest.mark.parametrize("shape", [(2, 2, 1), (1, 1, 4)], ids=["2x2x1", "1x1x4"])
def test_four_gloo_ranks_on_one_card_match_scipy(cuda_device, tmp_path, shape):
    """Four ranks share one card over gloo with CUDA tensors: the batched
    ESC product matches scipy (structure exact, values within rtol 1e-4),
    and every rank planned the same batches."""
    import scipy.sparse as sps

    from repro_torch.core import gen
    from repro_torch.launch import spawn

    n = 4096
    ranks = spawn.run(_gloo_product_rank, shape, backend="gloo", device="cuda", args=(n,),
                      timeout_s=300, workdir=tmp_path)
    assert all(r[3] == ranks[0][3] for r in ranks)
    assert pickle.loads(ranks[0][3]).num_batches > 1
    rows, cols, vals = (np.concatenate(x) for x in list(zip(*ranks))[:3])
    a = gen.protein_similarity_like(n, blocks=n // 64, intra_p=0.12, seed=0, device="cpu")
    nnz = int(a.nnz)
    x = sps.csr_matrix((a.vals[:nnz].numpy(), (a.rows[:nnz].numpy(), a.cols[:nnz].numpy())),
                       shape=(n, n))
    want = (x @ x).tocoo()
    got = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    assert got.nnz == len(rows) == want.nnz  # each entry once, on one rank
    np.testing.assert_allclose(got[want.row, want.col].A1, want.data, rtol=1e-4)


def _gloo_dense_rank(grid, n):
    """One rank of the dense step on one card over gloo: its C tile under
    both schedules, launches of densify and SpMM per schedule, and a
    ``Grid.ppermute`` of a CUDA tensor along each axis."""
    from repro_torch.core import gen
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.grid import COL_AX, ROW_AX
    from repro_torch.core.summa3d import summa3d_dense_step

    a = gen.protein_similarity_like(n, blocks=n // 64, intra_p=0.12, seed=0, device=grid.device)
    A, B = scatter_to_grid(a, grid, "A"), scatter_to_grid(a, grid, "B")
    out = {}
    for schedule in ("allgather", "ring"):
        before = (densify_cuda.launches, spmm_cuda.launches)
        c = summa3d_dense_step(A, B, grid, schedule=schedule)
        out[schedule] = (c.cpu().numpy(), densify_cuda.launches - before[0],
                         spmm_cuda.launches - before[1], c.device.type)
    x = torch.full((5,), float(grid.rank), device=grid.device)
    out["shift"] = [grid.ppermute(x, ax, 1).cpu().numpy() for ax in (ROW_AX, COL_AX)]
    return grid.coords, out


def test_dense_step_schedules_on_four_gloo_ranks_of_one_card(cuda_device, tmp_path):
    """2x2x1 over gloo with CUDA tensors: the Cannon ring's shifts
    (``Grid.ppermute``) run on the card; its tiles equal allgather's within
    rtol 1e-5 and scipy's product; the ring launches densify and SpMM
    twice (pc stages), allgather once."""
    import scipy.sparse as sps

    from repro_torch.core import gen
    from repro_torch.launch import spawn

    n = 2048
    ranks = spawn.run(_gloo_dense_rank, (2, 2, 1), backend="gloo", device="cuda", args=(n,),
                      timeout_s=300, workdir=tmp_path)
    a = gen.protein_similarity_like(n, blocks=n // 64, intra_p=0.12, seed=0, device="cpu")
    nnz = int(a.nnz)
    x = sps.csr_matrix((a.vals[:nnz].numpy(), (a.rows[:nnz].numpy(), a.cols[:nnz].numpy())),
                       shape=(n, n))
    want = (x @ x).toarray()
    h = n // 2
    for (i, j, _), out in ranks:
        ag, ring = out["allgather"], out["ring"]
        assert ag[1:] == (1, 1, "cuda") and ring[1:] == (2, 2, "cuda")
        np.testing.assert_allclose(ring[0], ag[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ring[0][0, 0, 0], want[i * h:(i + 1) * h, j * h:(j + 1) * h],
                                   rtol=1e-4, atol=1e-5)
        # rank (i, j) gets the tile of (i + 1, j) along the rows, (i, j + 1) along the columns
        np.testing.assert_array_equal(out["shift"][0], np.full(5, (i + 1) % 2 * 2 + j))
        np.testing.assert_array_equal(out["shift"][1], np.full(5, i * 2 + (j + 1) % 2))


@pytest.mark.parametrize("local_path", ["esc", "binned", "hash"])
def test_serving_engine_on_the_card_matches_cpu(cuda_device, local_path):
    """The serving engine on the card against the same engine on the CPU
    (the kernels' plain versions), over one stream with repeats and a
    novel pair: the same ordered results, stats and cache keys, the same
    structure and values within rtol 1e-5; the binned kernel launches once
    a batch, the fused hash kernel once a batch and the one-chunk kernel
    never."""
    from repro_torch.core import gen, grid as tgrid
    from repro_torch.serve import MultiplyRequest, ServeConfig, SpgemmEngine

    pairs = [(gen.erdos_renyi(512, 8.0, seed=s, device="cpu"),
              gen.erdos_renyi(512, 8.0, seed=s + 1, device="cpu")) for s in (70, 72)]
    stream = [(0, 0), (1, 0), (2, 1), (3, 0)]
    engines, launches = {}, {}
    for dev in ("cpu", cuda_device):
        counted = (tbinned.spgemm_paired_binned_cuda, thash.hash_expand_insert_cuda,
                   thash.hash_insert_cuda)
        before = [w.launches for w in counted]
        eng = SpgemmEngine(tgrid.make_grid(1, 1, 1, device=dev),
                           ServeConfig(per_process_memory=1 << 20, local_path=local_path))
        for rid, p in stream:
            eng.submit(MultiplyRequest(rid=rid, a=pairs[p][0], b=pairs[p][1]))
        eng.run_to_completion()
        engines[str(dev)] = eng
        launches[str(dev)] = [w.launches - n for w, n in zip(counted, before)]
    cpu, card = engines["cpu"], engines[str(cuda_device)]
    assert card.stats == cpu.stats and list(card.plan_cache) == list(cpu.plan_cache)
    assert card.stats["hits"] == 2
    batches = sum(r.num_batches + r.report.retries for r in card.done)
    assert launches["cpu"] == [0, 0, 0]
    want = {"esc": [0, 0, 0], "binned": [batches, 0, 0], "hash": [0, batches, 0]}[local_path]
    assert launches[str(cuda_device)] == want
    for t, c in zip(card.done, cpu.done):
        assert (t.rid, t.status, t.plan_cached, t.num_batches, t.price_bytes) == (
            c.rid, c.status, c.plan_cached, c.num_batches, c.price_bytes)
        assert t.c.rows.is_cuda
        assert torch.equal(t.c.rows.cpu(), c.c.rows) and torch.equal(t.c.cols.cpu(), c.c.cols)
        torch.testing.assert_close(t.c.vals.cpu(), c.c.vals, rtol=1e-5, atol=1e-6)
