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


def prune_block(seed, m=96, n=40, kind="random"):
    """A dense f32 (m, n) block for the per-column top-k bisection:
    "random" (distinct values, some zeros), "tied" (a few values repeated
    across the k boundary) or "uniform" (every column one value)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (m, n)).astype(np.float32)
    x[rng.random((m, n)) < 0.3] = 0.0
    if kind == "tied":
        x = np.round(x * 4) / 4
    elif kind == "uniform":
        x = np.broadcast_to(rng.uniform(0.1, 1.0, n).astype(np.float32), (m, n)).copy()
        x[:, 0] = 0.0  # an all-zero column
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
