"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):

  1. Card: name and power limit (nvidia-smi), torch / CUDA versions.
  2. Build: the Hopper kernels in src/repro_torch/csrc/, compiled with nvcc
     for sm_90a, one nvcc per source, all started together.
  3. Main path, through the user's entry points (scatter_to_grid ->
     batched_summa3d), with every kernel launch count set to 0 just before
     each run and read just after it:
       a. full size, memory-constrained, hash path: C = A·A for a
          protein-similarity-like A with n = 2^20 (the repo's
          spgemm_eukarya_like size), a budget that forces b >= 1024 batches;
       b. the same product on the ESC path, same budget;
       c. the default path: n = 2^14, budget 48 B x nnz(A), local_path
          "auto", which plans the k-binned multiply with b = 16.
     Each product is checked against scipy's A @ A on the host: identical
     structure, values within rtol 1e-4 (fp32 sums in another order).
  4. Each kernel against its plain PyTorch version on the card, on the
     operands of batch 0 of the run above that uses it: the hash insert for
     sum/min/max in a table that fits (same key set, sums within rtol 1e-5
     since atomics add in a run-dependent order, min/max exact, no drops)
     and in one that is far too small (both drop); the binned multiply
     within rtol 1e-5 / atol 1e-6 (atomic f32 adds). A kernel's time is the
     device time of its wrapper per call (every kernel and memset the
     wrapper puts on the card, from torch.profiler); it raises if the
     profiler records none. A library call's time (the yardstick) is its
     device time, measured the same way; plain times are CUDA-event times.
     A kernel's bound counts the bytes its wrapper must move on this run's
     data (inputs read once, outputs written once) against the card's
     memory rate, or its f32 operations against the f32 peak.
  5. The kernel API (kernels.ops), through its wrappers, on the binned
     kernel's operands of 4 (batch 0 of the n = 2^14 default product:
     A's tile against a 1024-column block of B), with every launch count
     set to 0 just before and read just after: spgemm_paired, the same
     product by spgemm_paired_binned (the run's bin plan) and by
     spmm(densify(B)), and sort_pairs on the packed keys and values of
     batch 0's first partial products at 2^14 pairs (the bitonic kernel),
     12345 (padded, the bitonic kernel) and 2^14 + 8 (routed to
     torch.sort). The paired kernel must agree with its plain version and
     both counterparts within rtol 1e-5 / atol 1e-6; the sorted keys must
     equal torch.sort's, the values be bit-identical to the plain network
     on the same padding, and per-key value sums equal torch.sort +
     gather's. Both kernels timed as in 4, beside torch.sparse.mm and
     torch.sort + gather as yardsticks; the bitonic kernel also on one
     block of 2048 pairs (no cluster).
  6. The three dense-path kernels against their plain versions on batch 0
     of the dense MCL run's second multiply (the run of 8): col_prune
     bit-identical, SpMM within rtol 1e-5, densify within rtol 1e-6
     (atomic sums of duplicates), each timed as in 4, beside one PyTorch
     call that computes the same function (torch.topk, torch.sparse.mm,
     index_put_), timed only as a yardstick.
  7. Markov clustering (sparse_apps.mcl.mcl_iterate), sparse path, n = 2^18:
     a column-stochastic protein-similarity-like input (64-node clusters),
     inflation 2, threshold 1e-4, top-64 per column, 4 iterations under a
     2 GiB per-process budget. First a profile of one batch of the second
     iteration (the multiply step and the prune, top ops by device time),
     then the loop, held against the host loop (mcl_iterate_host: the same
     card multiply, pruning in numpy): nnz trajectories equal within 1e-5
     per iteration (every difference printed: f32 sums in another order can
     move an entry across the threshold), chaos within rtol 1e-3, identical
     cluster partitions, at most 64 entries per column with column sums
     1 +- 1e-4, and under 1 KiB of host traffic per device-loop iteration.
  8. Markov clustering, dense path (densify + SpMM + col_prune), n = 2^14,
     4 forced batches of 16384 x 4096 f32 tiles, 6 iterations, held against
     the sparse device loop and the host loop: nnz trajectories as in 7,
     identical partitions; the col_prune, SpMM and densify kernels must
     launch.

The last two lines are a JSON object with one entry per ported kernel (all
seven) and the JSON result line. Without a CUDA device, or without the
repository's src/ beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 outside the
# tensor cores. A card set below 700 W runs slower under load.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

N_FULL = 1 << 20
N_DEFAULT = 1 << 14
N_MCL = 1 << 18
VALUE_RTOL = 1e-4  # vs scipy: fp32 sums in another order
KERNEL_RTOL = 1e-5  # kernel vs plain: atomics add in a run-dependent order
DENSIFY_RTOL = 1e-6  # atomic sums of a few duplicates, in a run-dependent order
CHAOS_RTOL = 1e-3  # device loop (f32) vs host loop (f64 pruning), as the JAX tests allow
MCL_BUDGET = 2 << 30  # per-process bytes: iteration 2 of the n = 2^18 run plans b >= 4
# MCL loops that sum in another order (binned atomics, SpMM rows, ESC runs;
# f32 device pruning vs f64 host pruning) can move an entry across the 1e-4
# threshold: their nnz may differ by this share per iteration, never more
NNZ_RTOL = 1e-5
PROFILE_MARGIN_S = 0.02  # idle time around a profiled window (see device_ms)
SORT_CALLS = 20  # bitonic sorts per profiled window: one is ~tens of microseconds


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean ms of ``fn()`` on the current stream, CUDA events around each
    rep (``setup()`` runs before each rep, outside the timed window)."""
    import torch

    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_ms(fn, calls: int, kernel: str, reps: int, setup=None) -> float:
    """Device time (ms) per wrapper call: everything torch.profiler (CUPTI)
    records on the card during ``fn()``, which makes ``calls`` calls, mean
    over ``reps`` profiled runs (``setup()`` runs before each, outside the
    profiled window). The window keeps PROFILE_MARGIN_S of idle time before
    and after ``fn()``: device events of a window of a few microseconds
    went missing on the card, which the margin guards against (only device
    events are summed, so it adds nothing to the time). Raises if no kernel
    named ``kernel`` was recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    total_us, per_kernel = 0.0, {}
    for _ in range(reps):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        dev = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        if not any(kernel in ev.name for ev in dev):
            raise RuntimeError(f"profiler recorded no device time for {kernel}: "
                               f"{sorted({ev.name for ev in dev})}")
        for ev in dev:
            us = ev.time_range.elapsed_us()
            total_us += us
            per_kernel[ev.name[:100]] = per_kernel.get(ev.name[:100], 0.0) + us
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    log("  profiled on the card, us per call: "
        + "; ".join(f"{name} {us / reps / calls:.3f}" for name, us in ranked))
    return total_us / reps / calls / 1e3


def library_device_ms(label: str, fn, calls: int = 1, reps: int = 5) -> float:
    """A yardstick's device time per call, measured as a kernel's
    (``device_ms``: every kernel and memset the call puts on the card).
    ``fn()`` makes ``calls`` calls; a warm-up call runs first. Its
    CUDA-event time, host gaps included, is only logged."""
    fn()
    dev = device_ms(fn, calls, "", reps)
    events = cuda_ms(fn, reps) / calls
    log(f"  {label}: {dev:.6f} ms device time, {events:.6f} ms with CUDA events")
    return dev


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scipy_square(a):
    """scipy's A @ A for a port SparseCOO: (row-major keys r*n+c, values)."""
    import scipy.sparse as sps

    from repro_torch.core import convert

    n = a.shape[0]
    r, c, v = convert.triplets(a)
    s = sps.csr_matrix((v, (r, c)), shape=a.shape)
    p = (s @ s).tocsr()
    p.sort_indices()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(p.indptr))
    return rows * n + p.indices.astype(np.int64), p.data


def check_product(parts, ref, n) -> float:
    """Hold the driver's batches against scipy; returns max relative error."""
    import torch

    rows = torch.cat([p[0] for p in parts])
    cols = torch.cat([p[1] for p in parts])
    vals = torch.cat([p[2] for p in parts])
    key, perm = torch.sort(rows * n + cols)
    ref_key = torch.as_tensor(ref[0], device=key.device)
    ref_val = torch.as_tensor(ref[1], device=key.device)
    if key.shape != ref_key.shape or not torch.equal(key, ref_key):
        raise AssertionError(
            f"structure differs from scipy: {key.numel()} vs {ref_key.numel()} entries"
        )
    err = float(((vals[perm] - ref_val).abs() / ref_val.abs()).max())
    if not err <= VALUE_RTOL:
        raise AssertionError(f"values differ from scipy: max rel err {err}")
    return err


def run_multiply(A, B, grid, budget, local_path):
    """One batched_summa3d run with a consumer that keeps every batch in
    global coordinates; returns (result, wall s, peak bytes, parts)."""
    import torch

    from repro_torch.core import batched, convert, specs

    parts = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = batched.batched_summa3d(
        A, B, grid, budget,
        consumer=lambda bi, cb, cm: parts.append(convert.batch_to_global(cb, cm)),
        spec=specs.PlanSpec(local_path=local_path),
    )
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated(), parts


def batch0_operands(A, B, grid, plan):
    """The gathered A and B of batch 0, as the fused step builds them."""
    from repro_torch.core import summa3d

    sel, _ = B.local(*grid.coords).select_cols_blockcyclic(
        0, plan.num_batches, grid.l, plan.sel_cap
    )
    return (summa3d._gather_A(A.local(*grid.coords), grid),
            summa3d._gather_B(sel, grid))


def hash_bytes_per_launch(chunks, chunk_cap) -> tuple:
    """Least bytes and adds per launch of inserting ``chunks`` in order into
    an empty table: every valid flag read, key and value of each valid entry
    read, and per distinct key of a chunk its slot's key and value read and
    the value written, plus the key written where the chunk claims a new
    slot. Returns (bytes per launch, f32 adds per launch)."""
    import torch

    seen = None
    nbytes = adds = 0
    for key, _, ok in chunks:
        live = torch.unique(key[ok])
        new = live if seen is None else live[~torch.isin(live, seen)]
        seen = live if seen is None else torch.cat([seen, new])
        n_ok = int(ok.sum())
        nbytes += chunk_cap + 8 * n_ok + 12 * live.numel() + 4 * new.numel()
        adds += n_ok
    return nbytes / len(chunks), adds / len(chunks)


def check_hash_kernel(a_cat, b_cat, hc):
    """Hash insert: kernel vs plain on batch 0's chunks, sum/min/max, in the
    planned table and in a table far too small. Returns (max abs err,
    kernel ms/launch, plain ms/launch, bytes/launch, adds/launch)."""
    import torch

    from repro_torch.core import local_spgemm, semiring as sr
    from repro_torch.kernels import spgemm_hash as H

    dev = a_cat.device
    max_err, timing = 0.0, None
    for semi in (sr.PLUS_TIMES, sr.MIN_PLUS, sr.MAX_TIMES):
        kind = semi.add_kind
        total, it = local_spgemm.hash_chunks(a_cat, b_cat, hc.chunk_cap, hc.num_chunks, semi)
        chunks = list(it)
        distinct = None
        for table_cap in (hc.table_cap, None):
            if table_cap is None:  # far too small: about an eighth of the keys
                table_cap = max(8, 1 << (distinct.bit_length() - 4))
            tables = []
            for fn in (H.hash_insert_cuda, H.hash_insert_ref):
                tk = torch.full((table_cap,), H.EMPTY, dtype=torch.int32, device=dev)
                tv = torch.full((table_cap,), H.table_init_val(kind), device=dev)
                dropped = torch.zeros((), dtype=torch.int32, device=dev)
                for key, vals, valid in chunks:
                    fn(tk, tv, key, vals, valid, dropped, add_kind=kind,
                       max_probes=hc.max_probes)
                torch.cuda.synchronize()
                skey, perm = torch.sort(tk)
                tables.append((skey, tv[perm], int(dropped)))
            (kk, kv, kd), (pk, pv, pd) = tables
            if distinct is None:
                distinct = int((kk != H.EMPTY).sum())
                if kd or pd:
                    raise AssertionError(f"hash {kind}: drops in the planned table {kd} {pd}")
                if not torch.equal(kk, pk):
                    raise AssertionError(f"hash {kind}: key sets differ")
                live = kk != H.EMPTY
                diff = (kv[live] - pv[live]).abs()
                max_err = max(max_err, float(diff.max()))
                if kind == "sum":
                    ok = bool((diff <= KERNEL_RTOL * pv[live].abs()).all())
                else:
                    ok = torch.equal(kv[live], pv[live])
                if not ok:
                    raise AssertionError(f"hash {kind}: values differ, max {float(diff.max())}")
                log(f"hash {kind}: table {table_cap}, {distinct} keys, flops "
                    f"{int(total)}, max abs err {float(diff.max()):.3g}")
            elif not (kd > 0 and pd > 0):
                raise AssertionError(f"hash {kind}: small table must drop in both ({kd}, {pd})")
            else:
                log(f"hash {kind}: table {table_cap} too small: dropped {kd} (kernel) {pd} (plain)")
        if kind == "sum":
            tk = torch.empty((hc.table_cap,), dtype=torch.int32, device=dev)
            tv = torch.empty((hc.table_cap,), device=dev)
            dropped = torch.zeros((), dtype=torch.int32, device=dev)

            def reset():
                tk.fill_(H.EMPTY)
                tv.fill_(0.0)

            def insert_all(fn):
                return lambda: [fn(tk, tv, k, v, ok, dropped, add_kind="sum",
                                   max_probes=hc.max_probes) for k, v, ok in chunks]

            n_ch = len(chunks)
            for fn in (H.hash_insert_cuda, H.hash_insert_ref):  # warm-up
                reset()
                insert_all(fn)()
            gaps = cuda_ms(insert_all(H.hash_insert_cuda), 10, reset) / n_ch
            ms = device_ms(insert_all(H.hash_insert_cuda), n_ch, "hash_insert_kernel", 5, reset)
            log(f"hash insert: {ms:.6f} ms/launch device time; {gaps:.6f} ms/launch "
                f"with the host gaps between launches (CUDA events)")
            plain = cuda_ms(insert_all(H.hash_insert_ref), 2, reset) / n_ch
            nbytes, adds = hash_bytes_per_launch(chunks, hc.chunk_cap)
            log(f"hash insert: {adds:.1f} valid entries, {nbytes:.0f} B per launch (bound)")
            timing = (ms, plain, nbytes, adds)
    return (max_err,) + timing


def library_operands(a_cat, b_cat):
    """Batch 0's gathered A and selected B as coalesced torch sparse COO
    tensors (for the torch.sparse.mm yardstick), and the count of matching
    (A entry, B entry) pairs, the product's multiply-adds."""
    import torch

    m, k = a_cat.shape
    _, n = b_cat.shape
    a_valid = a_cat.valid_mask() & (a_cat.cols < k)
    b_valid = b_cat.valid_mask() & (b_cat.rows < k)
    ka = a_cat.cols[a_valid].long()
    kbv = b_cat.rows[b_valid].long()
    matches = int((torch.bincount(ka, minlength=k) * torch.bincount(kbv, minlength=k)).sum())
    a_sp = torch.sparse_coo_tensor(
        torch.stack([a_cat.rows[a_valid].long(), ka]), a_cat.vals[a_valid], (m, k),
        check_invariants=False,
    ).coalesce()
    b_sp = torch.sparse_coo_tensor(
        torch.stack([kbv, b_cat.cols[b_valid].long()]), b_cat.vals[b_valid], (k, n),
        check_invariants=False,
    ).coalesce()
    return a_sp, b_sp, matches


def check_binned_kernel(a_cat, b_cat, kb, bin_of_k):
    """Binned multiply: kernel vs plain (and torch.sparse.mm as the library
    yardstick) on batch 0's binned operands. Returns (max abs err, kernel
    ms, plain ms, library ms, bytes, flops, shapes)."""
    import torch

    from repro_torch.kernels import spgemm_binned as Bn

    m, k = a_cat.shape
    _, n = b_cat.shape
    a_valid = a_cat.valid_mask() & (a_cat.cols < k)
    b_valid = b_cat.valid_mask() & (b_cat.rows < k)
    av = torch.where(a_valid, a_cat.vals, torch.zeros_like(a_cat.vals))
    bv = torch.where(b_valid, b_cat.vals, torch.zeros_like(b_cat.vals))
    ak, ar, avb, _ = Bn.bin_entries_by_k(
        a_cat.cols, a_cat.rows, av, a_valid, k, kb.num_bins, kb.bin_cap_a,
        fill_k=-1, fill_other=m, bin_map=bin_of_k)
    bk, bc, bvb, _ = Bn.bin_entries_by_k(
        b_cat.rows, b_cat.cols, bv, b_valid, k, kb.num_bins, kb.bin_cap_b,
        fill_k=-2, fill_other=n, bin_map=bin_of_k)
    args = (ar, ak, avb, bk, bc, bvb, m, n)
    got = Bn.spgemm_paired_binned_cuda(*args)
    want = Bn.spgemm_paired_binned_ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=1e-6):
        raise AssertionError(f"binned: kernel differs from plain, max abs err {err}")
    a_sp, b_sp, matches = library_operands(a_cat, b_cat)
    events = cuda_ms(lambda: Bn.spgemm_paired_binned_cuda(*args), 20)
    # the wrapper's time: C's zero fill and the kernel
    ms = device_ms(lambda: Bn.spgemm_paired_binned_cuda(*args), 1, "binned_paired_kernel", 10)
    log(f"binned: {ms:.6f} ms device time (zero fill + kernel); {events:.6f} ms "
        f"with CUDA events")
    plain = cuda_ms(lambda: Bn.spgemm_paired_binned_ref(*args), 3)
    lib = library_device_ms("torch.sparse.mm", lambda: torch.sparse.mm(a_sp, b_sp))
    # the six binned arrays read once, C written once
    nbytes = (ar.numel() + bk.numel()) * 12 + m * n * 4
    shapes = f"{kb.num_bins} bins x ({kb.bin_cap_a} A, {kb.bin_cap_b} B) -> ({m}, {n})"
    log(f"binned: {shapes}, {matches} matching pairs, max abs err {err:.3g}")
    return err, ms, plain, lib, nbytes, 2 * matches


def ops_phase(a_cat, b_cat, kb, bin_of_k):
    """Phase 5: the kernel API (kernels.ops) on batch 0 of the default
    product. Runs the API once with every launch count set to 0 just before
    (the paired multiply, its binned and SpMM-of-densify counterparts, and
    sort_pairs at three lengths), then holds each result against its plain
    version and its counterparts, and times the two kernels the API alone
    reaches. Returns {name: (launches, max abs err, ms, plain ms, library
    ms, bytes, ops)} for bitonic_sort_pairs and spgemm_paired."""
    import torch

    from repro_torch.core import local_spgemm, semiring as sr
    from repro_torch.kernels import ops, sort_engine as So, spgemm_acc as Ac
    from repro_torch.kernels.densify_kernel import densify_cuda
    from repro_torch.kernels.spgemm_binned import spgemm_paired_binned_cuda
    from repro_torch.kernels.spmm_kernel import spmm_cuda

    m, k = a_cat.shape
    _, n = b_cat.shape
    big = So.MAX_BITONIC_ELEMS
    lengths = (big, 12345, big + 8)  # the network; padded; routed to torch.sort
    # the packed-key engine's input: the row-major keys of batch 0's first
    # partial products, in expansion order (duplicate-heavy), and their values
    total, chunks = local_spgemm.hash_chunks(a_cat, b_cat, big + 8, 1, sr.PLUS_TIMES)
    keys, vals, valid = next(chunks)
    if not bool(valid.all()):
        raise AssertionError(f"ops: batch 0 has only {int(total)} partial products")

    wrappers = {"bitonic_sort_pairs": So.bitonic_sort_pairs_cuda,
                "spgemm_paired": Ac.spgemm_paired_cuda,
                "spgemm_paired_binned": spgemm_paired_binned_cuda,
                "spmm": spmm_cuda, "densify": densify_cuda}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_paired = ops.spgemm_paired(a_cat, b_cat)
    c_binned, overflow = ops.spgemm_paired_binned(
        a_cat, b_cat, kb.num_bins, kb.bin_cap_a, kb.bin_cap_b, bin_map=bin_of_k)
    c_spmm = ops.spmm(a_cat, ops.densify(b_cat))
    sorted_runs = {ln: ops.sort_pairs(keys[:ln], vals[:ln]) for ln in lengths}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"ops API on batch 0: {wall * 1e3:.1f} ms wall, launches {launches}")
    if launches["spgemm_paired"] != 1 or launches["bitonic_sort_pairs"] != 2:
        raise AssertionError(f"ops: the paired kernel must launch once and the bitonic "
                             f"kernel twice (2^14 and 12345 pairs): {launches}")

    # the paired multiply against its plain version and its counterparts
    av = torch.where(a_cat.valid_mask(), a_cat.vals, torch.zeros_like(a_cat.vals))
    bv = torch.where(b_cat.valid_mask(), b_cat.vals, torch.zeros_like(b_cat.vals))
    args = (a_cat.rows, a_cat.cols, av, b_cat.rows, b_cat.cols, bv, m, n)
    want = Ac.spgemm_paired_ref(*args)
    torch.cuda.synchronize()
    err = float((c_paired - want).abs().max())
    for label, other in (("plain", want), ("binned", c_binned), ("spmm(densify)", c_spmm)):
        if not torch.allclose(c_paired, other, rtol=KERNEL_RTOL, atol=1e-6):
            raise AssertionError(f"ops: spgemm_paired differs from {label}, max abs err "
                                 f"{float((c_paired - other).abs().max())}")
    if int(overflow) != 0:
        raise AssertionError(f"ops: the run's bin plan overflowed ({int(overflow)})")
    a_sp, b_sp, matches = library_operands(a_cat, b_cat)
    lib_c = torch.sparse.mm(a_sp, b_sp).to_dense()
    lib_err = float((c_paired - lib_c).abs().max())
    cap_a, cap_b = a_cat.cap, b_cat.cap
    log(f"spgemm_paired: A {cap_a} slots x B {cap_b} slots = {cap_a * cap_b} pairings, "
        f"{matches} matching pairs, C ({m}, {n}); max abs err {err:.3g} (plain), "
        f"{lib_err:.3g} (torch.sparse.mm)")
    ms = device_ms(lambda: Ac.spgemm_paired_cuda(*args), 1, "paired_match_kernel", 10)
    events = cuda_ms(lambda: Ac.spgemm_paired_cuda(*args), 10)
    plain = cuda_ms(lambda: Ac.spgemm_paired_ref(*args), 2)
    lib = library_device_ms("torch.sparse.mm", lambda: torch.sparse.mm(a_sp, b_sp))
    log(f"spgemm_paired: {ms:.6f} ms device time (zero fill + kernel); {events:.6f} ms "
        f"with CUDA events; plain {plain:.4f} ms, torch.sparse.mm {lib:.6f} ms device time")
    out = {"spgemm_paired": (launches["spgemm_paired"], err, ms, plain, lib,
                             12 * (cap_a + cap_b) + 4 * m * n, 2 * matches)}

    # sort_pairs: keys as torch.sort's, values bit-identical to the plain
    # network on the same padding, per-key value sums as torch.sort + gather's
    sort_err = 0.0
    for ln, (sk, sv) in sorted_runs.items():
        ref_k, perm = torch.sort(keys[:ln])
        if not torch.equal(sk, ref_k):
            raise AssertionError(f"ops: sort_pairs keys differ from torch.sort at {ln}")
        uniq, inv = torch.unique(sk, return_inverse=True)
        sums = torch.zeros(uniq.numel(), dtype=torch.float64, device=sk.device)
        ref_sums = torch.zeros_like(sums)
        sums.index_add_(0, inv, sv.double())
        ref_sums.index_add_(0, inv, vals[:ln][perm].double())
        if not torch.allclose(sums, ref_sums, rtol=1e-12, atol=0):
            raise AssertionError(f"ops: sort_pairs per-key sums differ at {ln}")
        if ln <= big:
            plain_k, plain_v = So.sort_pairs(keys[:ln].cpu(), vals[:ln].cpu())  # the plain network
            sort_err = max(sort_err, float((sv.cpu() - plain_v).abs().max()),
                           float((sk.cpu() - plain_k).abs().max()))
            if not torch.equal(sv.cpu().view(torch.int32), plain_v.view(torch.int32)):
                raise AssertionError(f"ops: sort_pairs values differ from the plain network "
                                     f"at {ln}")
        log(f"sort_pairs {ln}: keys equal to torch.sort's, {uniq.numel()} distinct, values "
            f"{'bit-identical to the plain network' if ln <= big else 'per-key sums equal'}")
    k16, v16 = keys[:big].contiguous(), vals[:big].contiguous()

    def sorts():
        for _ in range(SORT_CALLS):
            So.bitonic_sort_pairs_cuda(k16, v16)

    sorts()  # warm-up
    ms = device_ms(sorts, SORT_CALLS, "bitonic_cluster_kernel", 10)
    # one block of 2048 pairs: the network inside a block, with no cluster
    k11, v11 = keys[:2048].contiguous(), vals[:2048].contiguous()
    ms11 = device_ms(lambda: [So.bitonic_sort_pairs_cuda(k11, v11) for _ in range(SORT_CALLS)],
                     SORT_CALLS, "bitonic_cluster_kernel", 10)
    log(f"bitonic_sort_pairs 2048 (one block, no cluster): {ms11:.6f} ms device time")
    events = cuda_ms(sorts, 10) / SORT_CALLS
    plain = cuda_ms(lambda: So.bitonic_sort_pairs_ref(k16, v16), 3)

    def torch_sort_gather():
        sk, perm = torch.sort(k16)
        return sk, v16[perm]

    lib = library_device_ms("torch.sort + gather",
                            lambda: [torch_sort_gather() for _ in range(SORT_CALLS)],
                            SORT_CALLS, 10)
    log(f"bitonic_sort_pairs {big}: {ms:.6f} ms device time; {events:.6f} ms per call with "
        f"CUDA events over {SORT_CALLS} back-to-back calls; plain {plain:.4f} ms; torch.sort "
        f"+ gather {lib:.6f} ms device time")
    out["bitonic_sort_pairs"] = (launches["bitonic_sort_pairs"], sort_err, ms, plain, lib,
                                 16 * big, big * (big.bit_length() - 1))
    for name, (_, e, t, pl, lb, nb, ops_n) in out.items():
        bound, by = bound_ms(nb, ops_n)
        log(f"{name}: {t:.6f} ms, bound {bound:.7f} ms ({by}, {nb} B, {ops_n} ops), "
            f"{100 * bound / t:.3f} % of bound, library {lb:.6f} ms, max abs err {e:.3g}")
    return out


def column_stochastic(a):
    """``a`` with every column scaled to sum 1 (MCL's input)."""
    from repro_torch.core import convert
    from repro_torch.core.sparse import from_numpy_coo

    n = a.shape[1]
    r, c, v = convert.triplets(a)
    sums = np.bincount(c, weights=v.astype(np.float64), minlength=n)
    v = (v / np.where(sums > 0, sums, 1.0)[c]).astype(np.float32)
    return from_numpy_coo(r, c, v, a.shape, cap=len(r), device=a.device)


def partition(final, n):
    """Cluster labels of a converged MCL matrix in a canonical form (each
    node labelled by the first node of its cluster): two results have the
    same partition exactly when these arrays are equal."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import connected_components

    from repro_torch.core import convert

    r, c, _ = convert.triplets(final)
    g = sps.coo_matrix((np.ones(len(r)), (r, c)), shape=(n, n))
    _, labels = connected_components(g, directed=False)
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    return first[inv]


def check_mcl_matrix(final, k):
    """At most k entries per column, nonempty columns summing to 1 +- 1e-4."""
    import torch

    n = final.shape[1]
    cols = final.cols[: int(final.nnz)].long()
    counts = torch.bincount(cols, minlength=n)
    sums = torch.zeros(n, dtype=torch.float64, device=cols.device)
    sums.index_add_(0, cols, final.vals[: int(final.nnz)].double())
    live = counts > 0
    dev = float((sums[live] - 1).abs().max())
    if int(counts.max()) > k or not dev <= 1e-4:
        raise AssertionError(f"MCL matrix: max {int(counts.max())} per column (k={k}), "
                             f"column sums off by {dev}")
    return int(counts.max()), dev


def compare_loops(label, hist, ref_hist, lab, ref_lab, chaos_rtol=None):
    """nnz trajectories equal within ``NNZ_RTOL`` per iteration (every
    difference is printed), identical partitions, and chaos within
    ``chaos_rtol`` if asked."""
    nnz, ref_nnz = [h["nnz"] for h in hist], [h["nnz"] for h in ref_hist]
    diff = [a - b for a, b in zip(nnz, ref_nnz)]
    if len(nnz) != len(ref_nnz) or any(abs(d) > NNZ_RTOL * b for d, b in zip(diff, ref_nnz)):
        raise AssertionError(f"{label}: nnz trajectories differ: {nnz} vs {ref_nnz}")
    if chaos_rtol is not None:
        ch = np.array([h["chaos"] for h in hist])
        ref = np.array([h["chaos"] for h in ref_hist])
        if not np.allclose(ch, ref, rtol=chaos_rtol, atol=1e-5):
            raise AssertionError(f"{label}: chaos differs: {ch} vs {ref}")
    if not np.array_equal(lab, ref_lab):
        raise AssertionError(f"{label}: cluster partitions differ")
    log(f"{label}: nnz trajectories {nnz} vs {ref_nnz} (differences {diff}), identical "
        f"partitions ({len(np.unique(lab))} clusters)")


def run_mcl(fn, a, grid, cfg, label):
    """One MCL loop with the kernel counts set to 0 just before it; returns
    (final, history, wall s, peak bytes, launches)."""
    import torch

    from repro_torch.kernels import col_prune, spgemm_binned, spgemm_hash
    from repro_torch.kernels.densify_kernel import densify_cuda
    from repro_torch.kernels.spmm_kernel import spmm_cuda
    from repro_torch.sparse_apps import mcl

    wrappers = {
        "hash_insert": spgemm_hash.hash_insert_cuda,
        "spgemm_paired_binned": spgemm_binned.spgemm_paired_binned_cuda,
        "col_topk_bounds": col_prune.col_topk_bounds_cuda,
        "spmm": spmm_cuda,
        "densify": densify_cuda,
    }
    for w in wrappers.values():
        w.launches = 0
    mcl.reset_transfer_bytes()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final, hist = fn(a, grid, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"{label}: {len(hist)} iterations, wall {wall:.2f} s, peak {peak / 2**30:.3f} GiB, "
        f"launches {launches}")
    for h in hist:
        log(f"  iter {h['iter']}: nnz {h['nnz']}, chaos {h['chaos']:.6g}, b={h['batches']}, "
            f"path {h['local_path']}, retries {h['retries']}, replans {h['replans']}, "
            f"host bytes {h['host_bytes']}, {h['wall_ms']:.1f} ms")
    return final, hist, wall, peak, launches


def profile_top(label, fn, rows=8):
    """One profiled call of ``fn``: its device time and the ops that take
    the most of it. Diagnostic only: logs and returns nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels carry the device time; each PyTorch op that launched them
    # carries the same time again, so sum the one and list the other
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events
                if e.device_type == DeviceType.CUDA) / 1e3
    ops = [e for e in events if e.device_type != DeviceType.CUDA]
    log(f"{label}: {total:.1f} ms device time; top PyTorch ops (ms, calls):")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:rows]:
        log(f"  {e.self_device_time_total / 1e3:10.2f}  {e.count:4d}  {e.key[:90]}")


def profile_mcl_batch(a, grid, cfg):
    """Where one batch of the sparse MCL loop's second iteration spends its
    device time: the fused multiply step, then the prune postprocess."""
    import dataclasses

    from repro_torch.core import summa3d
    from repro_torch.core.batched import plan_batches
    from repro_torch.core.specs import PlanSpec
    from repro_torch.sparse_apps import mcl

    st = mcl._mcl_cold_state(a, grid, cfg)
    st, _, _ = mcl._mcl_sparse_step(st, grid, dataclasses.replace(cfg, max_iters=1))
    _, _, reserved = mcl._mcl_caps(a.shape[0], grid, cfg)
    plan = plan_batches(st.A, st.B, grid, cfg.per_process_memory,
                        spec=PlanSpec(local_path=st.lp_arg, reserved_bytes=reserved),
                        floors=st.floors.replace(caps_pow2=True))
    log(f"mcl sparse, iteration 2 plan: b={plan.num_batches}, caps {plan.caps}")

    def step():
        return summa3d.summa3d_fused_step(st.A, st.B, 0, grid=grid, num_batches=plan.num_batches,
                                          sel_cap=plan.sel_cap, caps=plan.caps)

    c, _ = step()  # warm-up
    profile_top("mcl sparse batch 0, multiply step", step)
    k, tn = cfg.max_per_col, c.tile_shape[1]
    profile_top("mcl sparse batch 0, prune", lambda: mcl._mcl_prune_sparse(
        c, grid, cfg.inflation, cfg.prune_threshold, k, new_cap=min(k * tn, c.cap)))


def mcl_sparse_phase(grid):
    """Phase 7: sparse MCL at n = 2^18, device loop vs host loop."""
    from repro_torch.core import gen
    from repro_torch.sparse_apps import mcl

    t0 = time.perf_counter()
    a = column_stochastic(gen.protein_similarity_like(
        N_MCL, blocks=N_MCL // 64, intra_p=0.12, seed=0))
    log(f"mcl sparse: n={N_MCL}, nnz(A)={int(a.nnz)}, set-up {time.perf_counter() - t0:.1f} s")
    # "auto" plans the k-binned multiply here, whose dense (n, n/b) f32
    # output tile the planner does not charge (256 GiB at b = 1): ESC
    cfg = mcl.MCLConfig(inflation=2.0, prune_threshold=1e-4, max_per_col=64,
                        local_path="esc", max_iters=4, per_process_memory=MCL_BUDGET)
    profile_mcl_batch(a, grid, cfg)
    fin_d, hist_d, wall_d, peak_d, launches = run_mcl(
        mcl.mcl_iterate, a, grid, cfg, "mcl sparse n=2^18, device loop")
    fin_h, hist_h, wall_h, peak_h, _ = run_mcl(
        mcl.mcl_iterate_host, a, grid, cfg, "mcl sparse n=2^18, host loop")
    compare_loops("mcl sparse n=2^18 device vs host", hist_d, hist_h,
                  partition(fin_d, N_MCL), partition(fin_h, N_MCL), chaos_rtol=CHAOS_RTOL)
    most, dev = check_mcl_matrix(fin_d, cfg.max_per_col)
    host_bytes = [h["host_bytes"] for h in hist_d]
    if max(host_bytes) >= 1024:
        raise AssertionError(f"mcl sparse: device loop moved {host_bytes} host bytes")
    if len(hist_d) < 2 or hist_d[1]["batches"] < 4:
        raise AssertionError("mcl sparse: iteration 2 must plan b >= 4")
    log(f"mcl sparse n=2^18: device loop {wall_d:.2f} s, peak {peak_d / 2**30:.3f} GiB, host "
        f"bytes/iter {host_bytes}; host loop {wall_h:.2f} s, peak {peak_h / 2**30:.3f} GiB, "
        f"host bytes/iter {[h['host_bytes'] for h in hist_h]}; final: <= {most} per column, "
        f"column sums within {dev:.3g} of 1")
    return launches


def mcl_dense_input():
    """The dense MCL run's column-stochastic input (n = 2^14) and config."""
    from repro_torch.core import gen
    from repro_torch.sparse_apps import mcl

    a = column_stochastic(gen.protein_similarity_like(
        N_DEFAULT, blocks=N_DEFAULT // 64, intra_p=0.12, seed=0))
    cfg = mcl.MCLConfig(inflation=2.0, prune_threshold=1e-4, max_per_col=64, path="dense",
                        force_num_batches=4, max_iters=6, per_process_memory=MCL_BUDGET)
    return a, cfg


def mcl_dense_phase(grid, a, cfg):
    """Phase 8: dense MCL at n = 2^14 vs the sparse device loop and the host
    loop; returns the launch counts of the dense run."""
    import dataclasses

    from repro_torch.sparse_apps import mcl

    fin_d, hist_d, _, _, launches = run_mcl(
        mcl.mcl_iterate, a, grid, cfg, "mcl dense n=2^14, device loop")
    fin_s, hist_s, _, _, _ = run_mcl(
        mcl.mcl_iterate, a, grid, dataclasses.replace(cfg, path="sparse"),
        "mcl dense n=2^14, sparse device loop")
    fin_h, hist_h, _, _, _ = run_mcl(
        mcl.mcl_iterate_host, a, grid, cfg, "mcl dense n=2^14, host loop")
    lab = partition(fin_d, N_DEFAULT)
    compare_loops("mcl n=2^14 dense vs sparse", hist_d, hist_s, lab, partition(fin_s, N_DEFAULT))
    compare_loops("mcl n=2^14 dense vs host", hist_d, hist_h, lab, partition(fin_h, N_DEFAULT))
    ported = ("col_topk_bounds", "spmm", "densify")
    if not all(launches[name] > 0 for name in ported):
        raise AssertionError(f"mcl dense: a dense-path kernel did not launch: {launches}")
    return launches


def dense_batch0(a, grid, cfg):
    """Batch 0 of the dense run's second multiply: the iterate after one
    dense iteration, re-scattered at the loop's operand capacities, and
    batch 0's gathered A, selected B and inflated, normalized D block (the
    col_prune kernel's input)."""
    import dataclasses

    import torch

    from repro_torch.core import local_spgemm
    from repro_torch.core.batched import plan_batches
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.specs import PlanSpec
    from repro_torch.sparse_apps import mcl

    it1, _ = mcl.mcl_iterate(a, grid, dataclasses.replace(cfg, max_iters=1))
    cap_a, cap_b, _ = mcl._mcl_caps(a.shape[0], grid, cfg)  # the loop's operand capacities
    A = scatter_to_grid(it1, grid, "A", cap=cap_a)
    B = scatter_to_grid(it1, grid, "B", cap=cap_b)
    plan = plan_batches(A, B, grid, cfg.per_process_memory,
                        spec=PlanSpec(local_path="esc", force_num_batches=cfg.force_num_batches))
    a_cat, b_cat = batch0_operands(A, B, grid, plan)
    d = local_spgemm.spmm(a_cat, b_cat.to_dense()) ** cfg.inflation
    x = d / torch.where(d.sum(0) > 0, d.sum(0), torch.ones_like(d[0]))[None, :]
    log(f"dense batch 0: nnz(A) {int(it1.nnz)}, A entries {a_cat.cap}, B entries "
        f"{int((b_cat.rows < b_cat.shape[0]).sum())} of {b_cat.cap}, D {tuple(x.shape)}")
    return a_cat, b_cat, x


def check_dense_kernels(a_cat, b_cat, x, k):
    """Phase 6: col_prune, SpMM and densify against their plain versions and
    a library yardstick. Returns {name: (max abs err, ms, plain ms,
    library ms, bytes, ops)}."""
    import torch

    from repro_torch.kernels import col_prune as P
    from repro_torch.kernels.densify_kernel import densify_cuda, densify_ref
    from repro_torch.kernels.spmm_kernel import spmm_cuda, spmm_ref

    out = {}
    m, kk = a_cat.shape
    _, n = b_cat.shape

    # col_prune: bit-identical
    got, want = P.col_topk_bounds_cuda(x, k), P.col_topk_bounds_ref(x, k)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("col_prune: kernel bracket differs from plain")
    ms = device_ms(lambda: P.col_topk_bounds_cuda(x, k), 1, "col_topk_bounds_kernel", 5)
    plain = cuda_ms(lambda: P.col_topk_bounds_ref(x, k), 3)
    lib = library_device_ms("torch.topk", lambda: torch.topk(x.abs(), k, dim=0))
    xm, xn = x.shape
    out["col_prune"] = (0.0, ms, plain, lib, xm * xn * 4 + 8 * xn,
                        2 * P.THRESH_ITERS * xm * xn)

    # SpMM: A's live entries (row, col, val) times the dense selected B
    valid = a_cat.valid_mask()
    rows = torch.where(valid, a_cat.rows, torch.full_like(a_cat.rows, m))
    vals = torch.where(valid, a_cat.vals, torch.zeros_like(a_cat.vals))
    bd = b_cat.to_dense()
    args = (rows, a_cat.cols, vals, bd, m)
    got, want = spmm_cuda(*args), spmm_ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=1e-6):
        raise AssertionError(f"spmm: kernel differs from plain, max abs err {err}")
    live = (rows < m) & (a_cat.cols < kk)
    nnz_a = int(live.sum())
    a_csr = torch.sparse_coo_tensor(
        torch.stack([rows[live].long(), a_cat.cols[live].long()]), vals[live], (m, kk),
        check_invariants=False,
    ).coalesce().to_sparse_csr()
    ms = device_ms(lambda: spmm_cuda(*args), 1, "spmm_rows_kernel", 5)
    plain = cuda_ms(lambda: spmm_ref(*args), 3)
    lib = library_device_ms("torch.sparse.mm", lambda: torch.sparse.mm(a_csr, bd))
    out["spmm"] = (err, ms, plain, lib, 12 * a_cat.cap + 4 * (kk * n + m * n), 2 * nnz_a * n)

    # densify: the selected B's entries into a (k, n) tile, duplicates summed
    args = (b_cat.rows, b_cat.cols, b_cat.vals, kk, n)
    got, want = densify_cuda(*args), densify_ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=DENSIFY_RTOL, atol=1e-7):
        raise AssertionError(f"densify: kernel differs from plain, max abs err {err}")
    ok = (b_cat.rows < kk) & (b_cat.cols < n)
    idx = (b_cat.rows[ok].long(), b_cat.cols[ok].long())
    bv = b_cat.vals[ok]
    ms = device_ms(lambda: densify_cuda(*args), 1, "densify_kernel", 5)
    plain = cuda_ms(lambda: densify_ref(*args), 3)
    lib = library_device_ms("index_put_", lambda: torch.zeros((kk, n), device=bv.device)
                            .index_put_(idx, bv, accumulate=True))
    out["densify"] = (err, ms, plain, lib, 12 * b_cat.cap + 4 * kk * n, b_cat.cap)
    for name, (e, t, pl, lb, nb, ops) in out.items():
        bound, by = bound_ms(nb, ops)
        log(f"{name}: {t:.6f} ms device time (plain {pl:.4f}, library {lb:.4f}), bound "
            f"{bound:.6f} ms ({by}, {nb} B, {ops} ops), {100 * bound / t:.2f} % of bound, "
            f"max abs err {e:.3g}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import gen, symbolic
    from repro_torch.core.batched import plan_batches
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.grid import make_grid
    from repro_torch.core.specs import PlanSpec
    from repro_torch.kernels import _build, spgemm_binned as Bn, spgemm_hash as H

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(built)}")
    for name, (secs, out) in built.items():
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: {secs:.2f} s; " + " | ".join(regs))

    # 3. main path
    grid = make_grid(1, 1, 1)
    t0 = time.perf_counter()
    a = gen.protein_similarity_like(N_FULL, blocks=N_FULL // 64, intra_p=0.12, seed=0)
    A = scatter_to_grid(a, grid, "A")
    B = scatter_to_grid(a, grid, "B")
    nnz = int(a.nnz)
    log(f"full size: n={N_FULL}, nnz(A)={nnz} ({nnz / N_FULL:.2f}/row), "
        f"tile cap {A.cap}, set-up {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ref_full = scipy_square(a)
    log(f"scipy A@A: nnz {len(ref_full[0])} ({len(ref_full[0]) / N_FULL:.1f}/row), "
        f"{time.perf_counter() - t0:.1f} s")
    # budget: inputs plus 1/1024 of the hash plan's table bytes, so the
    # plan's own batch count is 1024 (wb = 1024: the hash path's packed
    # (tm, wb) keys must fit in i32)
    r = PlanSpec().r_bytes
    probe = plan_batches(A, B, grid, 1 << 62, spec=PlanSpec(local_path="hash"))
    hash_bytes = symbolic.estimate_mem_c_bytes(
        probe.max_unmerged_nnz, probe.compression_est, r, local_path="hash")
    inputs = r * (int(A.nnz.max()) + int(B.nnz.max()))
    budget = inputs + -(-r * -(-hash_bytes // r) // 1024)
    log(f"budget: {budget} B per process (inputs {inputs} B, hash table "
        f"estimate {hash_bytes} B, flops {probe.total_flops}, "
        f"compression est {probe.compression_est:.3f})")

    a14 = gen.protein_similarity_like(N_DEFAULT, blocks=N_DEFAULT // 64, intra_p=0.12, seed=0)
    A14 = scatter_to_grid(a14, grid, "A")
    B14 = scatter_to_grid(a14, grid, "B")
    budget14 = 48 * int(a14.nnz)
    ref14 = scipy_square(a14)

    runs, launches = {}, {}
    for label, (AA, BB, bud, lp, n) in {
        "hash n=2^20": (A, B, budget, "hash", N_FULL),
        "esc n=2^20": (A, B, budget, "esc", N_FULL),
        "auto n=2^14": (A14, B14, budget14, "auto", N_DEFAULT),
    }.items():
        H.hash_insert_cuda.launches = 0
        Bn.spgemm_paired_binned_cuda.launches = 0
        res, wall, peak, parts = run_multiply(AA, BB, grid, bud, lp)
        launches[label] = {"hash": H.hash_insert_cuda.launches,
                           "binned": Bn.spgemm_paired_binned_cuda.launches}
        err = check_product(parts, ref_full if n == N_FULL else ref14, n)
        del parts
        runs[label] = res
        log(f"{label}: path {res.local_path}, b={res.plan.num_batches}, "
            f"retries {res.num_retries}, wall {wall:.2f} s, peak "
            f"{peak / 2**30:.3f} GiB, max rel err {err:.3g}, launches "
            f"{launches[label]}, caps {res.plan.caps}, "
            f"hash_caps {res.hash_caps}, binned_caps {res.binned_caps}")
    hash_launches = launches["hash n=2^20"]["hash"]
    binned_launches = launches["auto n=2^14"]["binned"]
    rh, rb = runs["hash n=2^20"], runs["auto n=2^14"]
    if not (rh.plan.num_batches >= 1024 and hash_launches > 0):
        raise AssertionError("hash run: needs b >= 1024 and hash launches > 0")
    if not (rb.local_path == "binned" and rb.plan.num_batches == 16 and binned_launches > 0):
        raise AssertionError("default run: must plan binned with b = 16 and launch it")

    # 4. kernels against their plain versions, on batch 0's operands
    a_cat, b_cat = batch0_operands(A, B, grid, rh.plan)
    h_err, h_ms, h_plain, h_bytes, h_adds = check_hash_kernel(a_cat, b_cat, rh.hash_caps)
    h_bound, h_by = bound_ms(h_bytes, h_adds)
    a_cat, b_cat = batch0_operands(A14, B14, grid, rb.plan)
    bin_of_k = torch.as_tensor(rb.plan.kbin.bin_of_k, device=a_cat.device)
    b_err, b_ms, b_plain, b_lib, b_bytes, b_flops = check_binned_kernel(
        a_cat, b_cat, rb.binned_caps, bin_of_k)
    b_bound, b_by = bound_ms(b_bytes, b_flops)
    log(f"hash insert: {h_ms:.6f} ms/launch (plain {h_plain:.4f}), bound {h_bound:.7f} ms "
        f"({h_by}), {100 * h_bound / h_ms:.2f} % of bound")
    log(f"binned: {b_ms:.6f} ms (plain {b_plain:.4f}, torch.sparse.mm {b_lib:.4f}), "
        f"bound {b_bound:.6f} ms ({b_by}), {100 * b_bound / b_ms:.2f} % of bound")

    # 5. the kernel API on the same batch 0 operands
    t0 = time.perf_counter()
    api = ops_phase(a_cat, b_cat, rb.binned_caps, bin_of_k)
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    del a, A, B, a14, A14, B14, a_cat, b_cat, runs, rh, rb, ref_full, ref14
    torch.cuda.empty_cache()

    # 6. the dense-path kernels against their plain versions
    t0 = time.perf_counter()
    a_mcl, cfg_dense = mcl_dense_input()
    dk = check_dense_kernels(*dense_batch0(a_mcl, grid, cfg_dense), cfg_dense.max_per_col)
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")
    # 7-8. Markov clustering, sparse and dense
    t0 = time.perf_counter()
    mcl_sparse_phase(grid)
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dense_launches = mcl_dense_phase(grid, a_mcl, cfg_dense)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")

    kernels = [
        {"name": "hash_insert", "route": "cuda",
         "source": "src/repro_torch/csrc/spgemm_hash.cu",
         "replaces": "src/repro/kernels/spgemm_hash.py:159",
         "launches": hash_launches, "max_abs_err": h_err, "ms": h_ms,
         "plain_ms": h_plain, "bound_ms": h_bound, "bound_by": h_by, "library_ms": None},
        {"name": "spgemm_paired_binned", "route": "cuda",
         "source": "src/repro_torch/csrc/spgemm_binned.cu",
         "replaces": "src/repro/kernels/spgemm_binned.py:119",
         "launches": binned_launches, "max_abs_err": b_err, "ms": b_ms,
         "plain_ms": b_plain, "bound_ms": b_bound, "bound_by": b_by, "library_ms": b_lib},
    ]
    for name, launch_key, source, replaces in (
        ("col_topk_bounds", "col_topk_bounds", "col_prune.cu", "col_prune.py:54"),
        ("spmm", "spmm", "spmm.cu", "spmm.py:64"),
        ("densify", "densify", "densify.cu", "densify.py:46"),
    ):
        err, ms, plain, lib, nbytes, ops = dk["col_prune" if name == "col_topk_bounds" else name]
        bound, by = bound_ms(nbytes, ops)
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": dense_launches[launch_key],
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": lib,
        })
    for name, source, replaces in (
        ("bitonic_sort_pairs", "sort_engine.cu", "sort_engine.py:69"),
        ("spgemm_paired", "spgemm_acc.cu", "spgemm_acc.py:67"),
    ):
        launched, err, ms, plain, lib, nbytes, ops = api[name]
        bound, by = bound_ms(nbytes, ops)
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": launched,
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": lib,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
