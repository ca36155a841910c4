"""Inputs and helpers shared by the port's kernel tests; no tests here.

Plain numpy/torch only (no JAX), so the tests that need the card
(``tests/test_torch_cuda.py``) run where JAX is not installed.
"""
import numpy as np
import torch

from repro_torch.kernels import spgemm_hash as thash


def random_chunks(seed, num_chunks=2, chunk_cap=384, key_space=500):
    """(keys i32, vals f32, valid bool) chunks of hash-insert input."""
    rng = np.random.default_rng(seed)
    return [
        (
            rng.integers(0, key_space, chunk_cap).astype(np.int32),
            rng.uniform(0.5, 1.0, chunk_cap).astype(np.float32),
            rng.random(chunk_cap) < 0.85,
        )
        for _ in range(num_chunks)
    ]


def torch_tables(chunks, table_cap, add_kind, max_probes, insert, device="cpu"):
    """Insert ``chunks`` with ``insert`` into a fresh table; returns (keys,
    values, dropped) on the host."""
    tk = torch.full((table_cap,), thash.EMPTY, dtype=torch.int32, device=device)
    tv = torch.full((table_cap,), thash.table_init_val(add_kind), device=device)
    dropped = torch.zeros((), dtype=torch.int32, device=device)
    for keys, vals, valid in chunks:
        insert(
            tk, tv, torch.as_tensor(keys, device=device), torch.as_tensor(vals, device=device),
            torch.as_tensor(valid, device=device), dropped,
            add_kind=add_kind, max_probes=max_probes,
        )
    return tk.cpu().numpy(), tv.cpu().numpy(), int(dropped)


def assert_vals(add_kind, got, want):
    """Sums within rtol 1e-5 (another summation order), min/max exact."""
    if add_kind == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def binned_inputs(seed, m=40, n=36, k_dim=50, cap_a=300, cap_b=280, num_bins=4,
                  bin_cap=None, bin_map=False):
    """Random COO operands (k, other, vals, valid) for the k-binned multiply."""
    rng = np.random.default_rng(seed)
    a_rows = rng.integers(0, m, cap_a).astype(np.int32)
    a_k = rng.integers(0, k_dim, cap_a).astype(np.int32)
    a_vals = rng.uniform(0.5, 1.0, cap_a).astype(np.float32)
    a_valid = rng.random(cap_a) < 0.9
    b_k = rng.integers(0, k_dim, cap_b).astype(np.int32)
    b_cols = rng.integers(0, n, cap_b).astype(np.int32)
    b_vals = rng.uniform(0.5, 1.0, cap_b).astype(np.float32)
    b_valid = rng.random(cap_b) < 0.9
    bmap = None
    if bin_map:
        bmap = np.minimum(np.sort(rng.integers(0, num_bins, k_dim)), num_bins - 1).astype(np.int32)
    cap_bin = bin_cap or max(cap_a, cap_b)
    return dict(m=m, n=n, k_dim=k_dim, num_bins=num_bins, cap_bin=cap_bin, bmap=bmap,
                a=(a_k, a_rows, a_vals, a_valid), b=(b_k, b_cols, b_vals, b_valid))


def bin_both(inp, lib, asarray):
    """Both operands through ``lib.bin_entries_by_k`` (the port's or JAX's)."""
    out = []
    for side, fill_k, fill_other in (("a", -1, inp["m"]), ("b", -2, inp["n"])):
        k, other, vals, valid = (asarray(x) for x in inp[side])
        out.append(lib.bin_entries_by_k(
            k, other, vals, valid, inp["k_dim"], inp["num_bins"], inp["cap_bin"],
            fill_k=fill_k, fill_other=fill_other,
            bin_map=None if inp["bmap"] is None else asarray(inp["bmap"]),
        ))
    return out


BINNED_LAYOUTS = ("dup_bk", "dup_ak", "empty_bins", "padding", "heavy_row", "heavy_k",
                  "odd_n", "wide_n", "all_padding")


def binned_layout(kind, seed, scale=1):
    """Binned operands (a_rows, a_k, a_vals, b_k, b_cols, b_vals) as
    (num_bins, bin_cap) numpy arrays, and (m, n), for the paired multiply's
    order of sums. Bin g holds contraction indices [8g, 8g + 8); padding
    (A: k -1, row m; B: k -2, column n; value 0) is scattered among the
    live slots. Values are signed, so a sum in another order shows.

      * "dup_bk": B entries repeat (k, column) pairs, neighbours in a bin;
      * "dup_ak": A entries repeat (row, k) pairs;
      * "empty_bins": A's bins 1 and 3 and B's bin 2 are all padding;
      * "padding": live-valued entries on rows and columns outside [0, m)
        and [0, n) (m, -1, m + 5; n, -3), which contribute nothing;
      * "heavy_row": row 0 holds most of A's entries (300 * scale a bin);
      * "heavy_k": one k of bin 1 holds 40 * scale B entries on 5 columns;
      * "odd_n": n = 37; "wide_n": n = 2500 (more than one 1024-column tile);
      * "all_padding": nothing live.
    """
    rng = np.random.default_rng(seed)
    num_bins, kb = 4, 8
    cap_a, cap_b, m, n = 96 * scale, 80 * scale, 30, 44
    if kind == "heavy_row":
        cap_a = 300 * scale
    elif kind == "odd_n":
        n = 37
    elif kind == "wide_n":
        n = 2500
    shape_a, shape_b = (num_bins, cap_a), (num_bins, cap_b)
    kbase_a = (np.arange(num_bins) * kb)[:, None]
    a_k = (kbase_a + rng.integers(0, kb, shape_a)).astype(np.int32)
    a_rows = rng.integers(0, m, shape_a).astype(np.int32)
    a_vals = rng.uniform(-1.0, 1.0, shape_a).astype(np.float32)
    b_k = ((np.arange(num_bins) * kb)[:, None] + rng.integers(0, kb, shape_b)).astype(np.int32)
    b_cols = rng.integers(0, n, shape_b).astype(np.int32)
    b_vals = rng.uniform(-1.0, 1.0, shape_b).astype(np.float32)
    a_live = rng.random(shape_a) < 0.85
    b_live = rng.random(shape_b) < 0.85
    if kind == "dup_bk":
        b_k = ((np.arange(num_bins) * kb)[:, None] + rng.integers(0, 2, shape_b)).astype(np.int32)
        b_cols = rng.integers(0, 3, shape_b).astype(np.int32)
    elif kind == "dup_ak":
        a_k = (kbase_a + rng.integers(0, 2, shape_a)).astype(np.int32)
        a_rows = rng.integers(0, 3, shape_a).astype(np.int32)
    elif kind == "empty_bins":
        a_live[[1, 3]] = False
        b_live[2] = False
    elif kind == "padding":
        off_a = rng.random(shape_a) < 0.2
        a_rows[off_a] = rng.choice(np.int32([m, -1, m + 5]), int(off_a.sum()))
        off_b = rng.random(shape_b) < 0.2
        b_cols[off_b] = rng.choice(np.int32([n, -3]), int(off_b.sum()))
    elif kind == "heavy_row":
        a_rows[rng.random(shape_a) < 0.9] = 0
    elif kind == "heavy_k":
        heavy = np.flatnonzero(rng.random(cap_b) < 0.5)[:40 * scale]
        b_k[1, heavy] = kb + 3
        b_cols[1, heavy] = rng.integers(0, 5, heavy.size)
        b_live[1, heavy] = True
    elif kind == "all_padding":
        a_live[:] = False
        b_live[:] = False
    a_k[~a_live], a_rows[~a_live], a_vals[~a_live] = -1, m, 0.0
    b_k[~b_live], b_cols[~b_live], b_vals[~b_live] = -2, n, 0.0
    return (a_rows, a_k, a_vals, b_k, b_cols, b_vals), (m, n)


def binned_serial_sum(arrays, m, n):
    """C (m, n) f32 as a serial f32 sum from 0.0: bins ascending, then A
    slots, then B slots; each product and each sum rounded to f32 on its
    own. Rows outside [0, m) and columns outside [0, n) are skipped."""
    a_rows, a_k, a_vals, b_k, b_cols, b_vals = arrays
    out = np.zeros((m, n), np.float32)
    for g in range(a_rows.shape[0]):
        for ia, ib in zip(*np.nonzero(a_k[g][:, None] == b_k[g][None, :])):
            r, c = int(a_rows[g, ia]), int(b_cols[g, ib])
            if 0 <= r < m and 0 <= c < n:
                out[r, c] = np.float32(out[r, c] + np.float32(a_vals[g, ia] * b_vals[g, ib]))
    return out


def prune_block(seed, m=96, n=40, kind="random"):
    """A dense f32 (m, n) block for the per-column top-k bisection:
    "random" (distinct values, some zeros), "tied" (a few values repeated
    across the k boundary), "uniform" (every column one value), "narrow"
    (each column's values within 4 ulps of one another, both signs, so the
    bisection's interval shrinks to an ulp and midpoints fall on lo or hi)
    or "sparse_col" (0 to 4 nonzeros a column, column 0 all zero: fewer
    than k nonzeros for most k)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (m, n)).astype(np.float32)
    x[rng.random((m, n)) < 0.3] = 0.0
    if kind == "tied":
        x = np.round(x * 4) / 4
    elif kind == "uniform":
        x = np.broadcast_to(rng.uniform(0.1, 1.0, n).astype(np.float32), (m, n)).copy()
        x[:, 0] = 0.0  # an all-zero column
    elif kind == "narrow":
        base = rng.uniform(0.1, 1.0, n).astype(np.float32).view(np.int32)
        bits = base[None, :] + rng.integers(0, 5, (m, n)).astype(np.int32)
        x = bits.view(np.float32) * rng.choice(np.float32([-1.0, 1.0]), (m, n))
    elif kind == "sparse_col":
        x = np.zeros((m, n), np.float32)
        for c in range(1, n):
            idx = rng.choice(m, int(rng.integers(0, 5)), replace=False)
            x[idx, c] = rng.uniform(-1.0, 1.0, idx.size)
    return x


def coo_entries(seed, m, n, cap, nnz, dup=True):
    """Padded COO (rows, cols, vals) i32/i32/f32 with ``nnz`` live entries
    and sentinel (m, n) padding with zero values up to ``cap``. With
    ``dup`` every 7th entry repeats its predecessor's coordinate, so a few
    cells sum two or three entries."""
    rng = np.random.default_rng(seed)
    rows = np.full(cap, m, np.int32)
    cols = np.full(cap, n, np.int32)
    vals = np.zeros(cap, np.float32)
    rows[:nnz] = rng.integers(0, m, nnz)
    cols[:nnz] = rng.integers(0, n, nnz)
    vals[:nnz] = rng.uniform(0.5, 1.0, nnz)
    if dup:
        rows[1:nnz:7], cols[1:nnz:7] = rows[0:nnz - 1:7], cols[0:nnz - 1:7]
    return rows, cols, vals


def dup_keys(seed, n):
    """Duplicate-heavy int32 keys (about n/8 distinct, a few negative) and
    f32 values, both of length ``n``: the packed-key engine's sort input."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-3, max(2, n // 8), n).astype(np.int32)
    vals = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    return keys, vals


def dense_random(seed, m, n, density):
    """A dense f32 (m, n) matrix with about ``density`` of it nonzero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n)).astype(np.float32)
    return np.where(rng.random((m, n)) < density, x, 0.0).astype(np.float32)


def paired_entries(seed, m, k, n, cap_a, nnz_a, cap_b, nnz_b):
    """Padded COO operands of the paired multiply, A (m×k) and B (k×n), in
    no order: sentinel padding (A: row m, col k; B: row k, col n; values
    0), plus a few live-valued entries whose A row or B column lies outside
    the output (negative, or the sentinel) and must be skipped. Returns
    ((a_rows, a_cols, a_vals), (b_rows, b_cols, b_vals))."""
    rng = np.random.default_rng(seed)
    a_rows, a_cols, a_vals = coo_entries(seed, m, k, cap_a, nnz_a, dup=False)
    b_rows, b_cols, b_vals = coo_entries(seed + 1, k, n, cap_b, nnz_b, dup=False)
    for out_idx, vals, bad in ((a_rows, a_vals, (-1, m, m + 5)), (b_cols, b_vals, (-2, n, n + 3))):
        slots = rng.choice(min(len(out_idx), 64), size=3, replace=False)
        out_idx[slots] = bad
        vals[slots] = 7.0  # nonzero: only the index range drops them
    return (a_rows, a_cols, a_vals), (b_rows, b_cols, b_vals)


#: Key patterns of the bitonic tests: the packed-key engine's duplicate-heavy
#: keys, keys over the whole int32 range, one key, and two distinct keys.
SORT_KINDS = ("dup", "random", "equal", "two")


def sort_keys(seed, n, kind):
    """int32 keys of one of ``SORT_KINDS`` and f32 values, both of length n."""
    keys, vals = dup_keys(seed, n)
    rng = np.random.default_rng(seed + 1)
    if kind == "random":
        keys = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    elif kind == "equal":
        keys = np.full(n, 5, np.int32)
    elif kind == "two":
        keys = rng.choice(np.array([-1, 3], np.int32), n)
    return keys, vals


def meet_outside_k(a, b, m, k, n, seed, count=40):
    """Give ``count`` live A entries and ``count`` live B entries (row in
    [0, m), column in [0, n)) the contraction indices -7 and k + 3, half
    each, so that they meet outside [0, k): the paired multiply matches any
    int32 contraction value. Changes ``a`` and ``b`` in place."""
    rng = np.random.default_rng(seed)
    for idx, out_idx, bound in ((a[1], a[0], m), (b[0], b[1], n)):
        live = np.flatnonzero((out_idx >= 0) & (out_idx < bound))
        slots = rng.choice(live, size=count, replace=False)
        idx[slots[: count // 2]] = -7
        idx[slots[count // 2:]] = k + 3


def paired_case(kind, seed=61):
    """Operands ``(a, b, m, n)`` of the paired multiply's card tests:
    "mixed" (padding on both sides, live entries outside the output),
    "skew" (one contraction index holds 4096 of B's entries), "outside_k"
    (entries meet on contraction indices -7 and k + 3), "b_padding" (B is
    all padding), "odd_cap_b" (capB not a power of two) and "large_cap_b"
    (capB above 2^17, contraction indices past the bucket count)."""
    m, k, n = 700, 900, 600
    cap_a, nnz_a, cap_b, nnz_b = 20000, 18000, 5000, 4500
    if kind == "odd_cap_b":
        cap_b, nnz_b = 4999, 4321
    elif kind == "large_cap_b":
        k, cap_b, nnz_b = (1 << 18) + 5000, (1 << 17) + 3, 120000
    a, b = paired_entries(seed, m, k, n, cap_a, nnz_a, cap_b, nnz_b)
    if kind == "skew":
        b[0][:4096] = 17
        a[1][:300] = 17
    elif kind == "outside_k":
        meet_outside_k(a, b, m, k, n, seed)
    elif kind == "b_padding":
        b[0][:], b[1][:], b[2][:] = k, n, 0.0
    return a, b, m, n
