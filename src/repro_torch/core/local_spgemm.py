"""Local (per-process) SpGEMM — the paper's §IV-D layer, in PyTorch.

Three interchangeable local multiplies with one contract — (row-major
sorted C, overflow count) — so the batch plan can pick between them:

  * ``spgemm_esc`` — expand–sort–compress: every partial product is
    materialized (O(flops) scratch), then one packed-key sort + compress.
    Any semiring.
  * ``spgemm_hash`` — every partial product is inserted into an
    open-addressing table as it is formed (``kernels.spgemm_hash``: one
    launch per batch on the card, chunk by chunk on the CPU): O(table)
    scratch on the card, O(table + chunk) on the CPU. Any semiring.
  * ``spgemm_kbinned`` — both operands counting-sorted into contraction
    bins, only matching bins paired into a dense f32 block
    (``kernels.spgemm_binned``), then sparsified. plus_times only.

Each takes a mask (paper §V-B): C = (A·B) ⊙ M, or ⊙ ¬M with
``mask_complement``. ESC and hash filter the partial products against the
mask's ascending packed keys (``sortkeys.sorted_mask_keys``) before the
compress or the insert, so products off the mask take no output slot; the
k-binned multiply filters its dense block (``mask_indicator``).

``merge_sparse`` is Merge-Layer / Merge-Fiber for the sparse path;
``spmm`` (sparse × dense → dense) is the dense path's local multiply, and
``spgemm_dense_acc`` (sparse × sparse → dense block) the dense-accumulator
multiply that the kernel API's paired multiply is held against.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import torch

from . import semiring as sr
from . import sortkeys
from . import sparse as sparse_mod
from .sparse import SparseCOO
from ..kernels import spgemm_binned as binnedkern
from ..kernels import spgemm_hash as hashkern
from ..kernels.spmm_kernel import SpmmFunction
from ..kernels.spmm_kernel import spmm as spmm_entries

Tensor = torch.Tensor


def _colptr(a_csc: SparseCOO) -> Tuple[Tensor, Tensor]:
    """(per-column counts padded by one 0, column starts padded by one 0)
    of a column-major sorted COO — A's CSC view."""
    colcount = a_csc.col_counts()
    zero = torch.zeros((1,), dtype=torch.int32, device=a_csc.device)
    colptr = torch.cat([zero, torch.cumsum(colcount, 0, dtype=torch.int32)])
    return torch.cat([colcount, zero]), torch.cat([colptr, zero])


# ---------------------------------------------------------------------------
# SpMM: sparse A (m×k) times dense B (k×n) -> dense (m×n)
# ---------------------------------------------------------------------------
def spmm(a: SparseCOO, b_dense: Tensor, semiring: sr.Semiring = sr.PLUS_TIMES,
         out: Tensor = None) -> Tensor:
    """Sparse A times dense B.

    On the card this is the SpMM kernel (``kernels.spmm_kernel``), which sums
    in f32: any other semiring raises there. CPU tensors take the
    semiring-generic plain version: gather B's rows by A's column index,
    multiply, and segment-reduce by A's row. Either way C has the dtype of
    A's values times B's (bfloat16 when both are), as the reference's.

    ``out`` (an f32 (m, n) tile; sum monoids only) takes the product added
    in place, ``out + A·B``, and is returned: on the card the kernel's
    accumulate mode, so no second tile is made.

    When autograd needs a gradient (grad enabled, and A's values or B
    require one) the product goes through ``kernels.spmm_kernel.
    SpmmFunction`` on either device: the kernel forward and for dB on the
    card, the plain version on the CPU. That path computes plus_times
    without ``out`` and raises for anything else.
    """
    m, k = a.shape
    assert b_dense.shape[0] == k, (a.shape, tuple(b_dense.shape))
    valid = a.valid_mask()
    if out is not None and semiring.add_kind != "sum":
        raise ValueError(f"spmm into out adds: sum monoids only, got {semiring.name}")
    if torch.is_grad_enabled() and (a.vals.requires_grad or b_dense.requires_grad):
        if semiring.name != "plus_times" or out is not None:
            raise ValueError(f"a differentiable spmm computes plus_times without out, got "
                             f"{semiring.name}{' into out' if out is not None else ''}")
        rows = torch.where(valid, a.rows, torch.full_like(a.rows, m))
        vals = torch.where(valid, a.vals, torch.zeros_like(a.vals))
        out = SpmmFunction.apply(rows, a.cols, vals, b_dense, m)
        return out.to(torch.result_type(a.vals, b_dense))
    if b_dense.is_cuda:
        if semiring.name != "plus_times":
            raise ValueError(f"the SpMM kernel computes plus_times, got {semiring.name}")
        rows = torch.where(valid, a.rows, torch.full_like(a.rows, m))
        vals = torch.where(valid, a.vals, torch.zeros_like(a.vals))
        if out is not None:
            return spmm_entries(rows, a.cols, vals, b_dense, m, out=out)
        out = spmm_entries(rows, a.cols, vals, b_dense, m)
        return out.to(torch.result_type(a.vals, b_dense))
    if out is not None:
        return out.add_(spmm(a, b_dense, semiring))
    n = b_dense.shape[1]
    # pad B with a zero row for sentinel column indices
    b_pad = torch.cat([b_dense, torch.zeros((1, n), dtype=b_dense.dtype)], 0)
    prods = semiring.mul(a.vals[:, None], b_pad[torch.clamp(a.cols, 0, k).long()])
    prods = torch.where(valid[:, None], prods, torch.full_like(prods, semiring.zero))
    out = sr.scatter_reduce(prods, torch.clamp(a.rows, 0, m), m + 1, semiring.add_kind)[:m]
    if semiring.add_kind != "sum":
        out = torch.where(torch.isfinite(out), out, torch.full_like(out, semiring.zero))
    return out


# ---------------------------------------------------------------------------
# Dense-accumulator SpGEMM: sparse × sparse -> dense block
# ---------------------------------------------------------------------------
def spgemm_dense_acc(
    a: SparseCOO,
    b: SparseCOO,
    semiring: sr.Semiring = sr.PLUS_TIMES,
    *,
    out_cap: int = None,
    flops_cap: int = None,
    return_overflow: bool = False,
):
    """C = A·B into a dense (m × n_b) accumulator; ``b`` is a narrow column
    block (batching keeps n_b small).

    Sum semirings densify B once (the densify kernel on the card) and stream
    A's entries through it with ``spmm`` (the SpMM kernel on the card, which
    computes plus_times only). min/max semirings cannot use a zero-filled
    dense B, whose structural zeros would take part, so they run
    ``spgemm_esc`` and reduce its sparse result onto a ``semiring.zero``
    background. ``out_cap``/``flops_cap`` size that ESC run; the defaults
    (m·n_b and cap_A·cap_B) cannot overflow. Callers passing tighter caps
    set ``return_overflow=True`` (returns ``(dense, overflow)``) and check
    it; for sum semirings overflow is always 0.
    """
    m, k = a.shape
    k2, nb = b.shape
    assert k == k2, (a.shape, b.shape)
    if semiring.add_kind == "sum":
        out = spmm(a, b.to_dense(), semiring)
        zero = torch.zeros((), dtype=torch.int32, device=a.device)
        return (out, zero) if return_overflow else out
    out_cap = out_cap if out_cap is not None else m * nb
    flops_cap = flops_cap if flops_cap is not None else max(a.cap * b.cap, 1)
    c, overflow = spgemm_esc(a, b, out_cap=out_cap, flops_cap=flops_cap, semiring=semiring)
    safe_vals = torch.where(c.valid_mask(), c.vals, torch.full_like(c.vals, semiring.zero))
    # padding carries the sentinels (m, n_b): the extra row and column
    dense = torch.full(((m + 1) * (nb + 1),), semiring.zero, dtype=c.vals.dtype,
                       device=a.device)
    dense.scatter_reduce_(0, c.rows.long() * (nb + 1) + c.cols.long(), safe_vals,
                          reduce=sr.REDUCE_OPS[semiring.add_kind], include_self=True)
    out = dense.reshape(m + 1, nb + 1)[:m, :nb]
    return (out, overflow) if return_overflow else out


# ---------------------------------------------------------------------------
# ESC SpGEMM: expand - sort - compress (sparse × sparse -> sparse)
# ---------------------------------------------------------------------------
def _expand(a_csc: SparseCOO, b: SparseCOO, flops_cap: int, semiring: sr.Semiring):
    """Enumerate all partial products of A·B into ``flops_cap`` slots.

    ``a_csc`` must be column-major sorted; ``b`` holds B's entries as
    (row=j, col=k). For each valid B entry t the products are A's column-k
    entries scaled by B's value, laid out contiguously in B-entry order.
    Returns (rows, cols, vals, valid, total_flops).
    """
    m, _ = a_csc.shape
    _, n = b.shape
    dev = a_csc.device
    ccount_pad, colptr_pad = _colptr(a_csc)
    bm = b.valid_mask()
    cnt = torch.where(bm, ccount_pad[b.cols.long()], torch.zeros_like(b.cols))
    starts = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt  # exclusive prefix
    if b.cap > 0:
        total = starts[-1] + cnt[-1]
    else:
        total = torch.zeros((), dtype=torch.int32, device=dev)

    # B-entry index per expanded slot e: scatter t at each non-empty segment
    # start, then running max (segments tile [starts[t], starts[t]+cnt[t]))
    e = torch.arange(flops_cap, dtype=torch.int32, device=dev)
    starts_clip = torch.where((cnt > 0) & (starts < flops_cap), starts,
                              torch.full_like(starts, flops_cap)).long()
    tvals = torch.arange(b.cap, dtype=torch.int32, device=dev)
    buf = torch.zeros((flops_cap + 1,), dtype=torch.int32, device=dev)
    buf.scatter_reduce_(0, starts_clip, tvals, reduce="amax")
    t_of_e = torch.cummax(buf[:flops_cap], 0).values
    t_of_e = torch.clamp(t_of_e, 0, max(b.cap - 1, 0)).long()
    within = e - starts[t_of_e]
    valid = (e < torch.clamp(total, max=flops_cap)) & (within >= 0)

    bk = b.cols[t_of_e].long()  # contraction index k
    ai = torch.clamp(colptr_pad[bk] + within, 0, a_csc.cap - 1).long()
    out_rows = torch.where(valid, a_csc.rows[ai], torch.full_like(within, m))
    out_cols = torch.where(valid, b.rows[t_of_e], torch.full_like(within, n))
    vals = semiring.mul(a_csc.vals[ai], b.vals[t_of_e])
    vals = torch.where(valid, vals, torch.full_like(vals, semiring.zero))
    return out_rows, out_cols, vals, valid, total


def spgemm_esc(
    a: SparseCOO,
    b: SparseCOO,
    out_cap: int,
    flops_cap: int,
    semiring: sr.Semiring = sr.PLUS_TIMES,
    mask_keys: Tensor = None,
    mask_complement: bool = False,
) -> Tuple[SparseCOO, Tensor]:
    """Sparse × sparse → sparse via expand–sort–compress.

    Inputs need not be sorted (paper §IV-D); only the output is row-major
    sorted. Returns (C, overflow) where overflow > 0 means ``out_cap`` or
    ``flops_cap`` was too small (the caller grows capacities).

    ``mask_keys`` (ascending packed row-major keys of the output space)
    keeps only the expanded products whose key is one of them (or, with
    ``mask_complement``, is not), before the compress: exact for every
    semiring, since the filter commutes with the coordinate-wise merge.
    """
    m, k = a.shape
    k2, n = b.shape
    assert k == k2
    bt = b.transpose()  # B entry (row=k, col=j) -> (row=j, col=k)
    rows, cols, vals, valid, total = _expand(a.sort_colmajor(), bt, flops_cap, semiring)
    flop_overflow = torch.clamp(total - flops_cap, min=0)
    if mask_keys is not None:
        hit = sortkeys.keys_in_sorted(sortkeys.pack_rowmajor(rows, cols, n), mask_keys)
        valid = valid & (~hit if mask_complement else hit)
    nnz_all = torch.tensor(flops_cap, dtype=torch.int32, device=a.device)
    expanded = SparseCOO(rows, cols, vals, nnz_all, (m, n))
    merged, overflow = _coalesce_semiring(expanded, valid, out_cap, semiring)
    return merged, overflow + flop_overflow


def _coalesce_semiring(x: SparseCOO, valid: Tensor, new_cap: int, semiring: sr.Semiring):
    """Duplicate-coordinate merge under ``semiring``; ``valid`` marks live entries."""
    m, n = x.shape
    rows, cols, vals, nnz, overflow = sortkeys.coalesce_entries(
        x.rows, x.cols, x.vals, valid, (m, n), new_cap, add_kind=semiring.add_kind,
    )
    return SparseCOO(rows, cols, vals, nnz, (m, n)), overflow


# ---------------------------------------------------------------------------
# Hash-accumulator SpGEMM
# ---------------------------------------------------------------------------
def hash_expansion(
    a: SparseCOO, b: SparseCOO, mask_keys: Tensor = None, mask_complement: bool = False,
) -> Tuple[hashkern.Expansion, Tensor]:
    """A·B's expansion as ``kernels.spgemm_hash.Expansion`` (A in CSC
    order, B's entries as (j, k), the inclusive prefix of products per B
    entry, the mask's keys and mode) and its total flops, unmasked. B
    entries whose contraction index lies outside [0, k) have no products
    (the reference's clamped gathers give the same for indices at or above
    k)."""
    k = a.shape[1]
    _, n = b.shape
    a_csc = a.sort_colmajor()
    bt = b.transpose()  # entries (j, k): rows=j, cols=k
    ccount_pad, colptr_pad = _colptr(a_csc)
    in_k = bt.valid_mask() & (bt.cols >= 0) & (bt.cols < k)
    bk = torch.where(in_k, bt.cols, torch.full_like(bt.cols, k)).long()
    cnt = torch.where(in_k, ccount_pad[bk], torch.zeros_like(bt.cols))
    cum = torch.cumsum(cnt, 0, dtype=torch.int32)  # inclusive prefix
    total = cum[-1] if bt.cap > 0 else torch.zeros((), dtype=torch.int32, device=a.device)
    mode = "none" if mask_keys is None else ("complement" if mask_complement else "strict")
    x = hashkern.Expansion(a_csc.rows, a_csc.vals, colptr_pad, bt.rows, bt.cols, bt.vals,
                           cum, n, mask_keys, mode)
    return x, total


def hash_chunks(
    a: SparseCOO,
    b: SparseCOO,
    chunk_cap: int,
    num_chunks: int,
    semiring: sr.Semiring = sr.PLUS_TIMES,
    mask_keys: Tensor = None,
    mask_complement: bool = False,
) -> Tuple[Tensor, Iterator[Tuple[Tensor, Tensor, Tensor]]]:
    """The expansion of A·B in ``num_chunks`` chunks of ``chunk_cap``
    partial products: returns (total flops, iterator over chunks), a chunk
    being (packed row-major keys i32, values, valid) — what the reference's
    chunk loop inserts, one ``hash_insert`` at a time; under a mask,
    ``valid`` is already filtered."""
    x, total = hash_expansion(a, b, mask_keys, mask_complement)
    offs = torch.arange(chunk_cap, dtype=torch.int32, device=a.device)

    def chunks():
        for c in range(num_chunks):
            yield hashkern.expand_slots(x, c * chunk_cap + offs, semiring.mul)

    return total, chunks()


def spgemm_hash(
    a: SparseCOO,
    b: SparseCOO,
    out_cap: int,
    table_cap: int,
    chunk_cap: int,
    num_chunks: int,
    semiring: sr.Semiring = sr.PLUS_TIMES,
    max_probes: int = 32,
    mask_keys: Tensor = None,
    mask_complement: bool = False,
) -> Tuple[SparseCOO, Tensor]:
    """Sparse × sparse → sparse via a hash accumulator — O(output) scratch.

    The expansion's ``num_chunks · chunk_cap`` slots are inserted into an
    open-addressing table of ``table_cap`` slots, semiring-accumulating on
    probe hits (``kernels.spgemm_hash.hash_expand_insert``): on the card
    one kernel launch forms and inserts every partial product of the
    batch, with the table as the only scratch; on the CPU the plain
    version inserts one chunk of ``chunk_cap`` at a time, as the reference.

    Output contract matches ``spgemm_esc``: (row-major-sorted C, overflow)
    where overflow counts dropped inserts, enumeration beyond
    ``num_chunks·chunk_cap`` flops (unmasked, as the reference counts
    them), and ``out_cap`` violations. ``mask_keys``/``mask_complement``
    as in ``spgemm_esc``: filtered products are never inserted (on the
    card the fused kernel filters them itself).
    """
    m, k = a.shape
    k2, n = b.shape
    assert k == k2
    assert table_cap >= 8 and table_cap & (table_cap - 1) == 0, table_cap
    assert sortkeys.fits_i32(m, n), (m, n)
    dev = a.device
    add_kind = semiring.add_kind
    table_key = torch.full((table_cap,), hashkern.EMPTY, dtype=torch.int32, device=dev)
    table_val = torch.full((table_cap,), hashkern.table_init_val(add_kind),
                           dtype=a.vals.dtype, device=dev)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    x, total = hash_expansion(a, b, mask_keys, mask_complement)
    hashkern.hash_expand_insert(table_key, table_val, dropped, x, chunk_cap, num_chunks,
                                semiring=semiring, max_probes=max_probes)
    flop_overflow = torch.clamp(total - num_chunks * chunk_cap, min=0)

    # table → sorted COO: EMPTY (INT32_MAX) sorts after every real key and
    # the row-major sentinel, so one sort + sentinel compress finalizes
    skey, perm = sortkeys.stable_sort(table_key)
    sent = sortkeys.key_space(m, n) - 1
    okey, ovals, nnz, ovf_out = sortkeys.compress_sorted_keys(
        skey, table_val[perm], sent, out_cap, add_kind=add_kind
    )
    orows, ocols = sortkeys.unpack_rowmajor(okey, n)
    return SparseCOO(orows, ocols, ovals, nnz, (m, n)), ovf_out + flop_overflow + dropped


# ---------------------------------------------------------------------------
# k-binned paired SpGEMM
# ---------------------------------------------------------------------------
def spgemm_kbinned(
    a: SparseCOO,
    b: SparseCOO,
    out_cap: int,
    num_bins: int,
    bin_cap_a: int,
    bin_cap_b: int,
    bin_of_k: Tensor = None,
    semiring: sr.Semiring = sr.PLUS_TIMES,
    mask: SparseCOO = None,
    mask_complement: bool = False,
) -> Tuple[SparseCOO, Tensor]:
    """Sparse × sparse → sparse via the k-binned paired kernel.

    Both operands are counting-sorted into ``num_bins`` contraction ranges
    (``bin_of_k``, a monotone map from ``symbolic.plan_k_bins``) and only
    matching bins are paired into a dense (m, n) f32 block, which is then
    sparsified to ``out_cap`` entries, row-major sorted — the same output
    contract as ``spgemm_esc``. Requires plus_times. Overflow counts both
    bin-capacity and ``out_cap`` violations. ``mask`` (a SparseCOO over the
    output space) zeroes the dense block off the mask (on it, with
    ``mask_complement``) before the sparsify.
    """
    assert semiring.name == "plus_times", (
        f"k-binned paired multiply requires plus_times, got {semiring.name}"
    )
    m, k = a.shape
    k2, n = b.shape
    assert k == k2, (a.shape, b.shape)
    # gathered operands declare every slot live and rely on sentinel-k
    # padding — mask on the contraction index, not just nnz
    a_valid = a.valid_mask() & (a.cols < k)
    b_valid = b.valid_mask() & (b.rows < k)
    av = torch.where(a_valid, a.vals, torch.zeros_like(a.vals))
    bv = torch.where(b_valid, b.vals, torch.zeros_like(b.vals))
    dense, ovf_bin = binnedkern.spgemm_binned_dense(
        a.rows, a.cols, av, a_valid, b.rows, b.cols, bv, b_valid,
        m, n, k, num_bins, bin_cap_a, bin_cap_b, bin_map=bin_of_k,
    )
    if mask is not None:
        dense = torch.where(mask_indicator(mask, mask_complement), dense,
                            torch.zeros_like(dense))
    # the pairing kernel accumulates f32; restore the input dtype so the
    # binned and ESC paths stay interchangeable behind the plan switch
    c, ovf_out = sparse_mod.from_dense_overflow(dense.to(a.dtype), out_cap)
    return c, ovf_bin + ovf_out


def mask_indicator(mask: SparseCOO, complement: bool = False) -> Tensor:
    """bool (m, n): mask membership as a dense indicator, the complement's
    when ``complement``. Entries past nnz and sentinel coordinates mark
    nothing."""
    m, n = mask.shape
    valid = mask.valid_mask()
    rows = torch.where(valid, mask.rows, torch.full_like(mask.rows, m)).long()
    cols = torch.where(valid, mask.cols, torch.full_like(mask.cols, n)).long()
    ind = torch.zeros((m + 1, n + 1), dtype=torch.bool, device=mask.device)
    ind[rows, cols] = True
    ind = ind[:m, :n]
    return ~ind if complement else ind


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------
def merge_sparse(
    parts,
    out_cap: int,
    semiring: sr.Semiring = sr.PLUS_TIMES,
    assume_sorted: bool = False,
):
    """Merge-Layer / Merge-Fiber for the sparse path: reduce duplicate coords.

      * ``assume_sorted=False`` — inputs unsorted; one packed-key coalesce
        over the concatenated entry lists.
      * ``assume_sorted=True`` — every part is already row-major sorted (true
        for the local multiplies' outputs and their column-split pieces), so
        the parts are *merged*, not re-sorted: a k-way merge-path over packed
        keys, then a linear compress.

    Returns (merged, overflow).
    """
    shape = parts[0].shape
    for x in parts:
        assert x.shape == shape
    m, n = shape
    if assume_sorted and sortkeys.fits_i32(m, n):
        # padding carries (m, n) sentinels == max key, so each part's packed
        # key array is ascending end-to-end and merges keep sentinels last
        keys = [sortkeys.pack_rowmajor(x.rows, x.cols, n) for x in parts]
        mkey, mvals = sortkeys.merge_sorted_runs(keys, [x.vals for x in parts])
        sent = sortkeys.key_space(m, n) - 1
        okey, ovals, nnz, overflow = sortkeys.compress_sorted_keys(
            mkey, mvals, sent, out_cap, add_kind=semiring.add_kind
        )
        orows, ocols = sortkeys.unpack_rowmajor(okey, n)
        return SparseCOO(orows, ocols, ovals, nnz, (m, n)), overflow
    rows = torch.cat([x.rows for x in parts])
    cols = torch.cat([x.cols for x in parts])
    vals = torch.cat([x.vals for x in parts])
    valid = torch.cat([x.valid_mask() for x in parts])
    nnz_all = torch.tensor(rows.shape[0], dtype=torch.int32, device=rows.device)
    stacked = SparseCOO(rows, cols, vals, nnz_all, shape)
    return _coalesce_semiring(stacked, valid, out_cap, semiring)


# ---------------------------------------------------------------------------
# Symbolic local multiply (Alg. 3 LocalSymbolic)
# ---------------------------------------------------------------------------
def local_symbolic_flops(a: SparseCOO, b: SparseCOO) -> Tensor:
    """Number of partial products of A·B = Σ_t nnz(A(:, B.row_t)) — the
    per-process unmerged D bound Alg. 3 accumulates per stage."""
    ccount_pad, _ = _colptr(a)
    contrib = torch.where(b.valid_mask(), ccount_pad[b.rows.long()], torch.zeros_like(b.rows))
    return contrib.sum()


def local_symbolic_exact(a: SparseCOO, b: SparseCOO, flops_cap: int,
                         engine: str = "auto") -> Tensor:
    """Exact nnz(A·B): a structure-only ESC whose distinct coordinates are
    counted by ``sortkeys.count_unique``."""
    m, _ = a.shape
    _, n = b.shape
    rows, cols, _, valid, _ = _expand(a.sort_colmajor(), b.transpose(), flops_cap,
                                      sr.PLUS_TIMES)
    return sortkeys.count_unique(rows, cols, valid, (m, n), engine=engine)


def nnz_per_col_upper(a_colcounts: Tensor, b: SparseCOO) -> Tensor:
    """Per-output-column flops upper bound: ub[j] = Σ_{k in B(:,j)} nnz(A(:,k))."""
    _, n = b.shape
    cc = torch.cat([a_colcounts, torch.zeros((1,), dtype=a_colcounts.dtype,
                                             device=a_colcounts.device)])
    contrib = torch.where(b.valid_mask(), cc[b.rows.long()], torch.zeros_like(b.rows))
    out = torch.zeros((n + 1,), dtype=contrib.dtype, device=contrib.device)
    out.index_add_(0, b.cols.long(), contrib)
    return out[:n]
