"""Synthetic sparse matrix generators matching the paper's workload regimes.

The paper's matrices (protein-similarity networks, Friendster, k-mer
matrices; Table V) are matched in *statistics*: nnz/row, skew (R-MAT power
law vs uniform Erdős–Rényi), and compression factor cf = flops / nnz(C).

The generators draw on the host with numpy from an explicit seed, so the
same seed gives the same matrix as the JAX package's generators; the result
is moved to ``device`` once. ``symmetrized`` and ``kmer_like`` make the
inputs of the §V-B applications (triangle counting, overlap detection).
"""
from __future__ import annotations

import numpy as np

from .sparse import SparseCOO, from_numpy_coo


def erdos_renyi(
    n: int,
    avg_nnz_per_row: float,
    seed: int = 0,
    square: bool = True,
    ncols: int = None,
    dtype=np.float32,
    cap: int = None,
    device="cuda",
) -> SparseCOO:
    """Uniform random sparse matrix (the paper's ER comparison regime)."""
    rng = np.random.default_rng(seed)
    ncols = n if square else (ncols or n)
    nnz_target = int(n * avg_nnz_per_row)
    rows = rng.integers(0, n, nnz_target)
    cols = rng.integers(0, ncols, nnz_target)
    vals = rng.uniform(0.5, 1.0, nnz_target).astype(dtype)
    return from_numpy_coo(rows, cols, vals, (n, ncols), cap=cap, device=device)


def rmat(
    scale: int,
    edge_factor: int = 8,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    dtype=np.float32,
    cap: int = None,
    device="cuda",
) -> SparseCOO:
    """R-MAT power-law graph (Friendster/protein-network-like skew).

    n = 2**scale vertices, ~edge_factor*n edges, Graph500 (a,b,c,d) params.
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    nedges = edge_factor * n
    rows = np.zeros(nedges, np.int64)
    cols = np.zeros(nedges, np.int64)
    ab, abc = a + b, a + b + c
    for lvl in range(scale):
        r = rng.random(nedges)
        go_right = ((r >= a) & (r < ab)) | (r >= abc)
        go_down = r >= ab
        rows |= go_down.astype(np.int64) << lvl
        cols |= go_right.astype(np.int64) << lvl
    vals = rng.uniform(0.5, 1.0, nedges).astype(dtype)
    return from_numpy_coo(rows, cols, vals, (n, n), cap=cap, device=device)


def protein_similarity_like(
    n: int, blocks: int, intra_p: float, seed: int = 0, dtype=np.float32,
    cap: int = None, device="cuda",
) -> SparseCOO:
    """Stochastic block structure mimicking protein-similarity networks
    (dense-ish clusters, sparse background) — the HipMCL input regime where
    nnz(A^2) >> nnz(A)."""
    rng = np.random.default_rng(seed)
    bs = n // blocks
    rows_l, cols_l = [], []
    for bi in range(blocks):
        size = bs if bi < blocks - 1 else n - bs * (blocks - 1)
        cnt = rng.binomial(size * size, intra_p)
        rows_l.append(rng.integers(0, size, cnt) + bi * bs)
        cols_l.append(rng.integers(0, size, cnt) + bi * bs)
    # sparse background
    bg = max(n // 2, 1)
    rows_l.append(rng.integers(0, n, bg))
    cols_l.append(rng.integers(0, n, bg))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    # symmetrize + self loops (MCL requires them)
    rows, cols = np.concatenate([rows, cols, np.arange(n)]), np.concatenate(
        [cols, rows, np.arange(n)]
    )
    vals = np.random.default_rng(seed + 1).uniform(0.3, 1.0, len(rows)).astype(dtype)
    return from_numpy_coo(rows, cols, vals, (n, n), cap=cap, device=device)


def symmetrized(a: SparseCOO) -> SparseCOO:
    """Undirected unit-weight graph from any square pattern: symmetrize and
    drop self loops (the triangle-counting input, §V-B). On ``a``'s device."""
    n = a.shape[0]
    nnz = int(a.nnz)
    rows = a.rows[:nnz].cpu().numpy()
    cols = a.cols[:nnz].cpu().numpy()
    r2 = np.concatenate([rows, cols])
    c2 = np.concatenate([cols, rows])
    keep = r2 != c2
    return from_numpy_coo(r2[keep], c2[keep], np.ones(int(keep.sum()), np.float32), (n, n),
                          device=a.device)


def kmer_like(
    nseqs: int, nkmers: int, kmers_per_seq: int, seed: int = 0, dtype=np.float32,
    cap: int = None, device="cuda",
) -> SparseCOO:
    """Rice-k-mers-like rectangular indicator (rows = sequences, columns =
    k-mers, ~nseqs·kmers_per_seq/nkmers entries per column) for the AAᵀ
    overlap detection of §V-B."""
    rng = np.random.default_rng(seed)
    nnz = nseqs * kmers_per_seq
    rows = np.repeat(np.arange(nseqs), kmers_per_seq)
    cols = rng.integers(0, nkmers, nnz)
    vals = np.ones(nnz, dtype)
    return from_numpy_coo(rows, cols, vals, (nseqs, nkmers), cap=cap, device=device)
