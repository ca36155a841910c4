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
          the fused hash kernel must launch exactly once per batch and the
          one-chunk kernel never;
       b. the same product on the ESC path, same budget (the segment-reduce
          kernel sums every batch);
       c. the default path: n = 2^14, budget 48 B x nnz(A), local_path
          "auto", which plans the k-binned multiply with b = 16; run a
          second time, which must give the same bits.
     Each product is checked against scipy's A @ A on the host: identical
     structure, values within rtol 1e-4 (fp32 sums in another order).
  4. Each kernel against its plain PyTorch version on the card, on the
     operands of batch 0 of the run above that uses it: the one-chunk hash
     insert on batch 0's chunks and the fused hash kernel on the whole
     batch, each for sum/min/max in a table that fits (same key set, sums
     within rtol 1e-5 since atomics add in a run-dependent order, min/max
     exact, no drops) and in one that is far too small (both drop); the
     hash run's per-batch split of wall and device time; the binned
     multiply bit-identical to its plain version run on the CPU (both add
     in bin, A slot, B slot order) and to a second call; the segment
     reduction on the ESC run's batch 0 sum (rtol 1e-5, bit-identical
     between calls), beside torch.segment_reduce and the scatter_reduce_
     it replaced; and the ESC multiply of that batch run twice, which must
     give the same bits. A kernel's time is the
     device time of its wrapper per call (every kernel and memset the
     wrapper puts on the card, from torch.profiler); it raises if the
     profiler records none in 3 profiled runs of a rep. A library call's time (the yardstick) is its
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
     12345 (padded, the bitonic kernel) and 2^14 + 8 (routed to a stable
     torch.sort). The paired kernel must agree with its plain version and
     both counterparts within rtol 1e-5 / atol 1e-6; the sorted keys must
     equal torch.sort's, the values be bit-identical to the plain network
     on the same padding (to a stable torch.sort + gather when routed),
     and per-key value sums equal torch.sort + gather's. Both kernels timed
     as in 4, beside torch.sparse.mm and torch.sort + gather as
     yardsticks; the bitonic kernel also on one block of 2048 pairs (no
     cluster).
  6. The three dense-path kernels against their plain versions on batch 0
     of the dense MCL run's second multiply (the run of 8): col_prune
     bit-identical in one launch (the log says how many reads of x it
     makes), SpMM within rtol 1e-5 in f32 and with bf16 values and
     B (both sum in f32), bit-identical between calls, densify within rtol
     1e-6 (atomic sums of duplicates), each timed as in 4, beside one
     PyTorch call that computes the same function (torch.topk,
     torch.sparse.mm, index_put_), timed only as a yardstick.
  7. Markov clustering (sparse_apps.mcl.mcl_iterate), sparse path, n = 2^18:
     a column-stochastic protein-similarity-like input (64-node clusters),
     inflation 2, threshold 1e-4, top-64 per column, 4 iterations under a
     2 GiB per-process budget. First one batch of the second iteration
     (the multiply step and the prune): every segment-reduce input it
     makes held against the plain version (rtol 1e-5, bit-identical
     between calls; the log counts each input's runs by the kernel's
     path), then a profile (top ops by device time, and each
     segment-reduce launch: runs, entries, device time, bound). Then the
     loop, twice (both trajectories printed, and whether they are
     bit-identical), held against the host loop (mcl_iterate_host: the same
     card multiply, pruning in numpy): nnz trajectories equal within 1e-5
     per iteration (every difference printed: f32 sums in another order can
     move an entry across the threshold), chaos within rtol 1e-3, identical
     cluster partitions, at most 64 entries per column with column sums
     1 +- 1e-4, and under 1 KiB of host traffic per device-loop iteration.
  8. Markov clustering, dense path (densify + SpMM + col_prune), n = 2^14,
     4 forced batches of 16384 x 4096 f32 tiles, 6 iterations, held against
     the sparse device loop and the host loop: nnz trajectories as in 7,
     identical partitions; the col_prune, SpMM and densify kernels must
     launch. The dense loop, the sparse loop on its default (binned)
     multiply and the sparse loop on the ESC multiply each run twice and
     must repeat their results bit for bit.

The last two lines are a JSON object with one entry per kernel (the seven
that replace the TPU kernels, the hash row per batch, and the segment
reduction, whose row also holds its launches, device time and bound in
phase 7's profiled batch) and the JSON result line. Without a CUDA device,
or without the repository's src/ beside this file, it exits non-zero and
prints no result.
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
KERNEL_RTOL = 1e-5  # kernel vs plain: sums in another order (hash and paired atomics, SpMM)
DENSIFY_RTOL = 1e-6  # atomic sums of a few duplicates, in a run-dependent order
CHAOS_RTOL = 1e-3  # device loop (f32) vs host loop (f64 pruning), as the JAX tests allow
MCL_BUDGET = 2 << 30  # per-process bytes: iteration 2 of the n = 2^18 run plans b >= 4
# MCL loops that sum in another order (SpMM rows, binned vs ESC runs; f32
# device pruning vs f64 host pruning) can move an entry across the 1e-4
# threshold: their nnz may differ by this share per iteration, never more
NNZ_RTOL = 1e-5
PROFILE_MARGIN_S = 0.02  # idle time around a profiled window (see device_ms)
PROFILE_ATTEMPTS = 3  # profiled runs of one rep before a window without device events fails
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
    events are summed, so it adds nothing to the time). Even so, a window
    now and then comes back with no device event at all (seen once in
    ~200 windows of one run): such a rep is profiled again, and the call
    raises if PROFILE_ATTEMPTS runs in a row record no kernel named
    ``kernel``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    total_us, per_kernel = 0.0, {}
    for _ in range(reps):
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            if setup is not None:
                setup()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILE_MARGIN_S)
                fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_MARGIN_S)
            dev = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
            if any(kernel in ev.name for ev in dev):
                break
            log(f"  profiled run {attempt} of {PROFILE_ATTEMPTS} recorded no device time for "
                f"{kernel!r}: {sorted({ev.name for ev in dev})}")
        else:
            raise RuntimeError(f"profiler recorded no device time for {kernel!r} in "
                               f"{PROFILE_ATTEMPTS} runs")
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


def same_parts(parts, parts2) -> bool:
    """Two runs' batches (rows, cols, vals) are the same bits."""
    import torch

    return len(parts) == len(parts2) and all(
        torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])
        and torch.equal(p[2].view(torch.int32), q[2].view(torch.int32))
        for p, q in zip(parts, parts2))


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


def check_fused_hash(a_cat, b_cat, hc):
    """The fused hash kernel (one launch per batch) against its plain
    version (the chunk loop) on batch 0's whole expansion: sum/min/max in
    the planned table and in one far too small. Returns (max abs err,
    kernel ms per batch, plain ms per batch, bytes per batch, ops per
    batch)."""
    import torch

    from repro_torch.core import local_spgemm, semiring as sr
    from repro_torch.kernels import spgemm_hash as H

    dev = a_cat.device
    x, total = local_spgemm.hash_expansion(a_cat, b_cat)
    nc, cc = hc.num_chunks, hc.chunk_cap
    max_err, distinct = 0.0, None

    def run(fn, table_cap, semi):
        tk = torch.full((table_cap,), H.EMPTY, dtype=torch.int32, device=dev)
        tv = torch.full((table_cap,), H.table_init_val(semi.add_kind), device=dev)
        dropped = torch.zeros((), dtype=torch.int32, device=dev)
        fn(tk, tv, dropped, x, cc, nc, semiring=semi, max_probes=hc.max_probes)
        skey, perm = torch.sort(tk)
        return skey, tv[perm], int(dropped)

    for semi in (sr.PLUS_TIMES, sr.MIN_PLUS, sr.MAX_TIMES):
        kind = semi.add_kind
        (kk, kv, kd), (pk, pv, pd) = (run(fn, hc.table_cap, semi) for fn in
                                      (H.hash_expand_insert_cuda, H.hash_expand_insert_ref))
        if kd or pd:
            raise AssertionError(f"fused hash {kind}: drops in the planned table {kd} {pd}")
        if not torch.equal(kk, pk):
            raise AssertionError(f"fused hash {kind}: key sets differ")
        live = kk != H.EMPTY
        distinct = int(live.sum())
        diff = (kv[live] - pv[live]).abs()
        max_err = max(max_err, float(diff.max()))
        ok = (bool((diff <= KERNEL_RTOL * pv[live].abs()).all()) if kind == "sum"
              else torch.equal(kv[live], pv[live]))
        if not ok:
            raise AssertionError(f"fused hash {kind}: values differ, max {float(diff.max())}")
        small = max(8, 1 << (distinct.bit_length() - 4))  # about an eighth of the keys
        (_, _, kd), (_, _, pd) = (run(fn, small, semi) for fn in
                                  (H.hash_expand_insert_cuda, H.hash_expand_insert_ref))
        if not (kd > 0 and pd > 0):
            raise AssertionError(f"fused hash {kind}: small table must drop in both ({kd}, {pd})")
        log(f"fused hash {kind}: table {hc.table_cap}, {distinct} keys, flops {int(total)}, "
            f"max abs err {float(diff.max()):.3g}; table {small}: dropped {kd} (kernel) "
            f"{pd} (plain)")

    tk = torch.empty((hc.table_cap,), dtype=torch.int32, device=dev)
    tv = torch.empty((hc.table_cap,), device=dev)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)

    def reset():
        tk.fill_(H.EMPTY)
        tv.fill_(0.0)

    def insert(fn):
        return lambda: fn(tk, tv, dropped, x, cc, nc, semiring=sr.PLUS_TIMES,
                          max_probes=hc.max_probes)

    reset()
    insert(H.hash_expand_insert_cuda)()  # warm-up
    ms = device_ms(insert(H.hash_expand_insert_cuda), 1, "hash_expand_insert_kernel", 10, reset)
    plain = cuda_ms(insert(H.hash_expand_insert_ref), 2, reset)
    # B's entries and cum read once; of A, the (row, value) of every entry
    # in a column that B's block reaches, and that column's start and end;
    # per distinct key its slot's key and value read and written
    cnt = x.cum - torch.cat([x.cum.new_zeros(1), x.cum[:-1]])
    touched = torch.unique(x.b_cols[cnt > 0]).long()
    a_needed = int((x.colptr[touched + 1] - x.colptr[touched]).sum())
    nbytes = 8 * a_needed + 8 * touched.numel() + 16 * x.cum.numel() + 16 * distinct
    flops = min(int(total), nc * cc)
    log(f"fused hash: {ms:.6f} ms device time per batch (one launch, {flops} partial "
        f"products, {nc} chunks of {cc} before); plain {plain:.4f} ms; {nbytes} B per batch")
    return max_err, ms, plain, nbytes, 2 * flops


def hash_batch_split(A, B, grid, plan, hc, wall, batches):
    """Where one batch of the hash run spends its time: the wall and the
    device time of batch 0's fused step (selection, gathers, local multiply,
    split, merge), beside the run's wall per batch."""
    import torch

    from repro_torch.core import summa3d

    def step():
        return summa3d.summa3d_fused_step(A, B, 0, grid=grid, num_batches=plan.num_batches,
                                          sel_cap=plan.sel_cap, caps=plan.caps, hashc=hc)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 100
    log(f"hash n=2^20: {wall / batches * 1e3:.3f} ms wall per batch in the run; batch 0's "
        f"step alone {step_ms:.3f} ms wall (mean of 10)")
    profile_top("hash n=2^20 batch 0, fused step", step)


def capture_segment_inputs(fn, clone=False):
    """Run ``fn`` with the segment-reduce dispatcher patched to note each
    call's (values, offsets, kind), copied if ``clone`` (values in
    float32, as the kernel gets them). Returns (fn's result, the inputs).
    The callers reach the kernel through the dispatcher; the wrapper counts
    its own launches, so it is left as it is."""
    from repro_torch.kernels import segment_reduce as S

    captured, orig = [], S.segment_reduce

    def note(v, o, kind):
        captured.append((v.float().clone(), o.clone(), kind) if clone else (v, o, kind))
        return orig(v, o, kind)

    S.segment_reduce = note
    try:
        out = fn()
    finally:
        S.segment_reduce = orig
    return out, captured


def hold_segment_reduce(label, vals, offsets, kind):
    """The kernel on one input against its plain version (KERNEL_RTOL) and
    against a second call (bit-identical); logs the input's runs by the
    kernel's path. Returns the max abs error."""
    import torch

    from repro_torch.kernels import segment_reduce as S

    got = S.segment_reduce_cuda(vals, offsets, kind)
    again = S.segment_reduce_cuda(vals, offsets, kind)
    want = S.segment_reduce_ref(vals, offsets, kind)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=1e-6):
        raise AssertionError(f"{label}: segment_reduce differs from plain, max abs err {err}")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"{label}: segment_reduce: two calls differ")
    thread_run, warp_run = S.path_limits()
    lengths = offsets[1:] - offsets[:-1]
    paths = [int((lengths <= thread_run).sum()),
             int(((lengths > thread_run) & (lengths <= warp_run)).sum()),
             int((lengths > warp_run).sum())]
    log(f"{label}: segment_reduce {kind} over {lengths.numel()} runs (by path: {paths[0]} "
        f"thread, {paths[1]} warp, {paths[2]} block; longest {int(lengths.max())}) within "
        f"rtol {KERNEL_RTOL} of plain, max abs err {err:.3g}; two calls bit-identical")
    return err


def check_segment_reduce(a_cat, b_cat, caps):
    """The segment reduction on the ESC run's batch 0 (the expansion's
    compress, captured from one spgemm_esc call) against its plain version,
    twice bit-identical; then the ESC multiply of that batch twice, which
    must give the same bits. Returns (max abs err, ms, plain ms, library ms,
    bytes, ops)."""
    import torch

    from repro_torch.core import local_spgemm
    from repro_torch.kernels import segment_reduce as S

    runs, captured = capture_segment_inputs(
        lambda: [local_spgemm.spgemm_esc(a_cat, b_cat, caps.d_cap, caps.flops_cap)
                 for _ in range(2)])
    (c1, o1), (c2, o2) = runs
    same = all(torch.equal(getattr(c1, f), getattr(c2, f)) for f in ("rows", "cols", "nnz"))
    if not (same and int(o1) == int(o2) == 0
            and torch.equal(c1.vals.view(torch.int32), c2.vals.view(torch.int32))):
        raise AssertionError("esc batch 0: two runs differ (or overflowed)")
    log(f"esc n=2^20 batch 0: two runs bit-identical, nnz {int(c1.nnz)}")
    vals, offsets, kind = max(captured, key=lambda c: c[0].numel())
    err = hold_segment_reduce("esc n=2^20 batch 0", vals, offsets, kind)
    lo, hi = int(offsets[0]), int(offsets[-1])
    num = offsets.numel() - 1
    ms = device_ms(lambda: S.segment_reduce_cuda(vals, offsets, kind), 1,
                   "segment_reduce_kernel", 10)
    plain = cuda_ms(lambda: S.segment_reduce_ref(vals, offsets, kind), 3)
    data, offs = vals[lo:hi], (offsets - lo).long()
    lib = library_device_ms("torch.segment_reduce",
                            lambda: torch.segment_reduce(data, "sum", offsets=offs, unsafe=True))
    # what it replaced: scatter_reduce_ of every slot, padding into one discard slot
    seg = (torch.searchsorted(offsets, torch.arange(vals.numel(), dtype=torch.int32,
                                                    device=vals.device), right=True) - 1).long()
    seg = torch.where((seg >= 0) & (seg < num), seg, torch.full_like(seg, num))
    old = library_device_ms(
        "scatter_reduce_ (discard slot)",
        lambda: torch.zeros(num + 1, device=vals.device).scatter_reduce_(0, seg, vals, "sum"))
    log(f"segment_reduce: {num} runs over {hi - lo} of {vals.numel()} slots, {ms:.6f} ms "
        f"device time; plain {plain:.4f} ms; torch.segment_reduce {lib:.6f} ms; "
        f"scatter_reduce_ {old:.6f} ms; max abs err {err:.3g}")
    return err, ms, plain, lib, 4 * (hi - lo) + 8 * num + 4, hi - lo


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


def binned_operands(a_cat, b_cat, kb, bin_of_k):
    """Batch 0's gathered A and selected B, binned by the run's plan as
    local_spgemm.spgemm_kbinned bins them: the binned multiply's arguments
    (a_rows, a_k, a_vals, b_k, b_cols, b_vals, m, n)."""
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
    return ar, ak, avb, bk, bc, bvb, m, n


def check_binned_kernel(a_cat, b_cat, kb, bin_of_k):
    """Binned multiply on batch 0's binned operands: the kernel bit-identical
    to its plain version run on the CPU and to a second call; timed beside
    the plain version on the card and torch.sparse.mm (the library
    yardstick). Returns (max abs err, kernel ms, plain ms, library ms,
    bytes, flops)."""
    import torch

    from repro_torch.kernels import spgemm_binned as Bn

    args = binned_operands(a_cat, b_cat, kb, bin_of_k)
    ar, bk, m, n = args[0], args[3], args[6], args[7]
    got = Bn.spgemm_paired_binned_cuda(*args)
    again = Bn.spgemm_paired_binned_cuda(*args)
    t0 = time.perf_counter()
    want = Bn.spgemm_paired_binned_ref(*(t.cpu() for t in args[:6]), m, n)
    cpu_s = time.perf_counter() - t0
    got = got.cpu()
    err = float((got - want).abs().max())
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"binned: kernel differs from its plain version on the CPU in "
                             f"{int((got.view(torch.int32) != want.view(torch.int32)).sum())} "
                             f"entries, max abs err {err}")
    if not torch.equal(got.view(torch.int32), again.cpu().view(torch.int32)):
        raise AssertionError("binned: a second call gives other bits")
    log(f"binned: bit-identical to the plain version on the CPU ({cpu_s:.1f} s) and "
        f"between two calls")
    a_sp, b_sp, matches = library_operands(a_cat, b_cat)
    events = cuda_ms(lambda: Bn.spgemm_paired_binned_cuda(*args), 20)
    # the wrapper's time: its two stable sorts and the two kernels
    ms = device_ms(lambda: Bn.spgemm_paired_binned_cuda(*args), 1, "binned_pull_kernel", 10)
    log(f"binned: {ms:.6f} ms device time (sorts + kernels); {events:.6f} ms "
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
        if ln > big and not torch.equal(sv, vals[:ln][torch.sort(keys[:ln], stable=True)[1]]):
            raise AssertionError(f"ops: routed sort_pairs values differ from a stable sort at {ln}")
        if ln <= big:
            plain_k, plain_v = So.sort_pairs(keys[:ln].cpu(), vals[:ln].cpu())  # the plain network
            sort_err = max(sort_err, float((sv.cpu() - plain_v).abs().max()),
                           float((sk.cpu() - plain_k).abs().max()))
            if not torch.equal(sv.cpu().view(torch.int32), plain_v.view(torch.int32)):
                raise AssertionError(f"ops: sort_pairs values differ from the plain network "
                                     f"at {ln}")
        log(f"sort_pairs {ln}: keys equal to torch.sort's, {uniq.numel()} distinct, values "
            f"{'bit-identical to the plain network' if ln <= big else 'as a stable sort'}")
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

    from repro_torch.kernels import col_prune, segment_reduce, spgemm_binned, spgemm_hash
    from repro_torch.kernels.densify_kernel import densify_cuda
    from repro_torch.kernels.spmm_kernel import spmm_cuda
    from repro_torch.sparse_apps import mcl

    wrappers = {
        "hash_insert": spgemm_hash.hash_expand_insert_cuda,
        "spgemm_paired_binned": spgemm_binned.spgemm_paired_binned_cuda,
        "col_topk_bounds": col_prune.col_topk_bounds_cuda,
        "spmm": spmm_cuda,
        "densify": densify_cuda,
        "segment_reduce": segment_reduce.segment_reduce_cuda,
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


def same_bits(fin, hist, fin2, hist2) -> bool:
    """Two MCL results are the same bits: final matrices field by field and
    every iteration's nnz and chaos."""
    import torch

    fields = all(torch.equal(getattr(fin, f), getattr(fin2, f)) for f in ("rows", "cols", "nnz"))
    vals = torch.equal(fin.vals.view(torch.int32), fin2.vals.view(torch.int32))
    traj = [(h["nnz"], h["chaos"]) for h in hist] == [(h["nnz"], h["chaos"]) for h in hist2]
    return fields and vals and traj


def check_repeats(label, fn, a, grid, cfg, first):
    """Run an MCL loop once more and hold it to ``first`` = (final,
    history) bit for bit; raises if they differ."""
    fin2, hist2, wall2, _, _ = run_mcl(fn, a, grid, cfg, f"{label}, second run")
    if not same_bits(*first, fin2, hist2):
        raise AssertionError(f"{label}: a second run differs: "
                             f"{[h['nnz'] for h in first[1]]} vs {[h['nnz'] for h in hist2]}")
    log(f"{label}: second run bit-identical ({wall2:.2f} s)")


def profile_top(label, fn, rows=8, kernel=None):
    """One profiled call of ``fn``: its device time and the ops that take
    the most of it (logged). Returns the device time (us) of each launch
    of the kernel named ``kernel``, in launch order, or None without one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = None if kernel is None else sorted(
        (ev.time_range.start, ev.time_range.elapsed_us()) for ev in prof.events()
        if ev.device_type == DeviceType.CUDA and kernel in ev.name)
    # kernels carry the device time; each PyTorch op that launched them
    # carries the same time again, so sum the one and list the other
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events
                if e.device_type == DeviceType.CUDA) / 1e3
    ops = [e for e in events if e.device_type != DeviceType.CUDA]
    log(f"{label}: {total:.1f} ms device time; top PyTorch ops (ms, calls):")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:rows]:
        log(f"  {e.self_device_time_total / 1e3:10.2f}  {e.count:4d}  {e.key[:90]}")
    return None if launches is None else [us for _, us in launches]


def profile_segment_reduce(label, fn):
    """Profile ``fn`` (as profile_top) and log each segment-reduce launch
    it makes: runs, entries, device time and bound. A profiled run that
    misses some of the launches is run again, up to PROFILE_ATTEMPTS runs.
    Returns (launches, device ms or None if never all profiled, bound ms)
    summed over the launches of one run."""
    from repro_torch.kernels import segment_reduce as S

    kern = S.segment_reduce_cuda
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        kern.launches = 0
        times, calls = capture_segment_inputs(
            lambda: profile_top(label, fn, kernel="segment_reduce_kernel"))
        if len(calls) != kern.launches:
            raise AssertionError(f"{label}: {kern.launches} segment-reduce launches, "
                                 f"{len(calls)} calls")
        if len(times) == kern.launches:
            break
        log(f"  profiled run {attempt} of {PROFILE_ATTEMPTS} recorded {len(times)} of "
            f"{kern.launches} segment-reduce launches")
    else:
        times = [None] * len(calls)
    total_bound = 0.0
    for (v, o, _), us in zip(calls, times):
        slots, runs, entries = v.numel(), o.numel() - 1, int(o[-1] - o[0])
        bound, _ = bound_ms(4 * entries + 8 * runs + 4, entries)
        total_bound += bound
        t = "not measured" if us is None else f"{us / 1e3:.6f} ms device time"
        log(f"  segment_reduce: {runs} runs over {entries} of {slots} slots, {t}, "
            f"bound {bound:.6f} ms")
    ms = None if None in times else sum(times) / 1e3
    log(f"{label}: {len(calls)} segment-reduce launches, "
        f"{'not measured' if ms is None else f'{ms:.6f} ms'} device time, "
        f"bound {total_bound:.6f} ms")
    return len(calls), ms, total_bound


def mcl_sparse_input():
    """The sparse MCL run's column-stochastic input (n = 2^18) and config."""
    from repro_torch.core import gen
    from repro_torch.sparse_apps import mcl

    a = column_stochastic(gen.protein_similarity_like(
        N_MCL, blocks=N_MCL // 64, intra_p=0.12, seed=0))
    # "auto" plans the k-binned multiply here, whose dense (n, n/b) f32
    # output tile the planner does not charge (256 GiB at b = 1): ESC
    cfg = mcl.MCLConfig(inflation=2.0, prune_threshold=1e-4, max_per_col=64,
                        local_path="esc", max_iters=4, per_process_memory=MCL_BUDGET)
    return a, cfg


def mcl_batch(a, grid, cfg):
    """Batch 0 of the sparse MCL loop's second iteration as its two stages:
    ``step()`` runs the fused multiply step and returns the batch's product
    C, ``prune(c)`` the prune postprocess of C. Logs the plan."""
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
                                          sel_cap=plan.sel_cap, caps=plan.caps)[0]

    def prune(c):
        k = cfg.max_per_col
        return mcl._mcl_prune_sparse(c, grid, cfg.inflation, cfg.prune_threshold, k,
                                     new_cap=min(k * c.tile_shape[1], c.cap))

    return step, prune


def profile_mcl_batch(a, grid, cfg):
    """One batch of the sparse MCL loop's second iteration (mcl_batch):
    each segment-reduce input of its multiply step and of its prune held
    against the plain version, then where its device time goes, with each
    segment-reduce launch. Returns {stage: (launches, device ms, bound ms,
    max abs err)} of the segment reduction."""
    def stage(name, fn, inputs):
        label = f"mcl sparse batch 0, {name}"
        err = max(hold_segment_reduce(f"{label}, input {i}", *inp)
                  for i, inp in enumerate(inputs))
        return (*profile_segment_reduce(label, fn), err)

    step, prune = mcl_batch(a, grid, cfg)
    c, inputs = capture_segment_inputs(step, clone=True)  # also the step's warm-up
    seg = {"multiply step": stage("multiply step", step, inputs)}
    _, inputs = capture_segment_inputs(lambda: prune(c), clone=True)
    seg["prune"] = stage("prune", lambda: prune(c), inputs)
    return seg


def mcl_sparse_phase(grid):
    """Phase 7: sparse MCL at n = 2^18, device loop vs host loop. Returns
    the segment reduction's numbers in the profiled batch (see
    profile_mcl_batch)."""
    from repro_torch.sparse_apps import mcl

    t0 = time.perf_counter()
    a, cfg = mcl_sparse_input()
    log(f"mcl sparse: n={N_MCL}, nnz(A)={int(a.nnz)}, set-up {time.perf_counter() - t0:.1f} s")
    seg = profile_mcl_batch(a, grid, cfg)
    fin_d, hist_d, wall_d, peak_d, _ = run_mcl(
        mcl.mcl_iterate, a, grid, cfg, "mcl sparse n=2^18, device loop")
    fin_2, hist_2, wall_2, _, _ = run_mcl(
        mcl.mcl_iterate, a, grid, cfg, "mcl sparse n=2^18, device loop, second run")
    log(f"mcl sparse n=2^18: device loop trajectories {[h['nnz'] for h in hist_d]} and "
        f"{[h['nnz'] for h in hist_2]}; bit-identical: {same_bits(fin_d, hist_d, fin_2, hist_2)}")
    del fin_2
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
    return seg


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
    check_repeats("mcl dense n=2^14, device loop", mcl.mcl_iterate, a, grid, cfg,
                  (fin_d, hist_d))
    sparse = dataclasses.replace(cfg, path="sparse")
    fin_s, hist_s, _, _, sparse_launches = run_mcl(
        mcl.mcl_iterate, a, grid, sparse, "mcl dense n=2^14, sparse device loop")
    if sparse_launches["spgemm_paired_binned"] == 0:
        raise AssertionError(f"mcl sparse n=2^14: the binned kernel did not launch: "
                             f"{sparse_launches}")
    check_repeats("mcl dense n=2^14, sparse device loop", mcl.mcl_iterate, a, grid, sparse,
                  (fin_s, hist_s))
    esc = dataclasses.replace(cfg, path="sparse", local_path="esc")
    fin_e, hist_e, _, _, _ = run_mcl(mcl.mcl_iterate, a, grid, esc,
                                     "mcl n=2^14, sparse device loop (esc)")
    check_repeats("mcl n=2^14, sparse device loop (esc)", mcl.mcl_iterate, a, grid, esc,
                  (fin_e, hist_e))
    compare_loops("mcl n=2^14 sparse esc vs binned", hist_e, hist_s, partition(fin_e, N_DEFAULT),
                  partition(fin_s, N_DEFAULT))
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


def spmm_reuse(rows, cols, live, k, block_rows=(16, 32, 64, 128)):
    """How often the SpMM kernel can reuse a staged B stripe on these
    operands: per block of R rows, nnz / distinct columns, and (at each R)
    the share of entries whose column occurs twice or more in the block and
    the most such columns in one block (the stripes it would stage)."""
    import torch

    r, c = rows[live].long(), cols[live].long()
    for rb in block_rows:
        keys, counts = torch.unique((r // rb) * k + c, return_counts=True)
        multi = counts >= 2
        per_block = torch.bincount(keys[multi] // k)
        log(f"spmm reuse, {rb} rows a block: nnz / distinct columns "
            f"{r.numel() / keys.numel():.3f}; columns used twice or more carry "
            f"{float(counts[multi].sum()) / r.numel():.4f} of the entries, at most "
            f"{int(per_block.max())} such columns in a block")


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
    before = P.col_topk_bounds_cuda.launches
    got, want = P.col_topk_bounds_cuda(x, k), P.col_topk_bounds_ref(x, k)
    if not all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want)):
        raise AssertionError("col_prune: kernel bracket differs from plain")
    if P.col_topk_bounds_cuda.launches != before + 1:
        raise AssertionError("col_prune: one call must be one launch")
    reads = P.reads_of_x()
    log(f"col_prune: bracket bit-identical, one launch; the built kernel reads x {reads} "
        f"times by design ({P.THRESH_ITERS} steps, {P.THRESH_ITERS // (reads - 1)} a read, "
        f"after one for the maxima)")
    ms = device_ms(lambda: P.col_topk_bounds_cuda(x, k), 1, "col_topk_bounds_kernel", 5)
    plain = cuda_ms(lambda: P.col_topk_bounds_ref(x, k), 3)
    lib = library_device_ms("torch.topk", lambda: torch.topk(x.abs(), k, dim=0))
    xm, xn = x.shape
    out["col_prune"] = (0.0, ms, plain, lib, xm * xn * 4 + 8 * xn,
                        2 * P.THRESH_ITERS * xm * xn)

    # SpMM: A's live entries (row, col, val) times the dense selected B, in
    # f32 and with bf16 values and B (both sum in f32); two calls bit-identical
    valid = a_cat.valid_mask()
    rows = torch.where(valid, a_cat.rows, torch.full_like(a_cat.rows, m))
    vals = torch.where(valid, a_cat.vals, torch.zeros_like(a_cat.vals))
    bd = b_cat.to_dense()
    live = (rows < m) & (a_cat.cols < kk)
    nnz_a = int(live.sum())
    spmm_reuse(rows, a_cat.cols, live, kk)
    for dtype in (torch.bfloat16, torch.float32):
        args = (rows, a_cat.cols, vals.to(dtype), bd.to(dtype), m)
        got, again, want = spmm_cuda(*args), spmm_cuda(*args), spmm_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=1e-6):
            raise AssertionError(f"spmm {dtype}: kernel differs from plain, max abs err {err}")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"spmm {dtype}: two calls differ")
        ms = device_ms(lambda: spmm_cuda(*args), 1, "spmm_tile_kernel", 5)
        nbytes = 12 * nnz_a + (kk * n) * bd.to(dtype).element_size() + 4 * m * n
        log(f"spmm {dtype}: {ms:.6f} ms device time, two calls bit-identical, max abs err "
            f"{err:.3g} (plain), bound {bound_ms(nbytes, 2 * nnz_a * n)[0]:.6f} ms")
    plain = cuda_ms(lambda: spmm_ref(*args), 3)
    a_csr = torch.sparse_coo_tensor(
        torch.stack([rows[live].long(), a_cat.cols[live].long()]), vals[live], (m, kk),
        check_invariants=False,
    ).coalesce().to_sparse_csr()
    lib = library_device_ms("torch.sparse.mm", lambda: torch.sparse.mm(a_csr, bd))
    lib_c = torch.sparse.mm(a_csr, bd)
    lib_again = torch.sparse.mm(a_csr, bd)
    log(f"spmm: torch.sparse.mm max abs diff from the kernel {float((lib_c - got).abs().max()):.3g}, "
        f"bit-identical between calls: {torch.equal(lib_c, lib_again)}")
    out["spmm"] = (err, ms, plain, lib, 12 * nnz_a + 4 * (kk * n + m * n), 2 * nnz_a * n)

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

    started = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import gen, symbolic
    from repro_torch.core.batched import plan_batches
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.grid import make_grid
    from repro_torch.core.specs import PlanSpec
    from repro_torch.kernels import _build, segment_reduce as S, spgemm_binned as Bn
    from repro_torch.kernels import spgemm_hash as H

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

    runs, launches, walls = {}, {}, {}
    counted = {"hash": H.hash_expand_insert_cuda, "hash_chunk": H.hash_insert_cuda,
               "binned": Bn.spgemm_paired_binned_cuda, "segment_reduce": S.segment_reduce_cuda}
    for label, (AA, BB, bud, lp, n) in {
        "hash n=2^20": (A, B, budget, "hash", N_FULL),
        "esc n=2^20": (A, B, budget, "esc", N_FULL),
        "auto n=2^14": (A14, B14, budget14, "auto", N_DEFAULT),
    }.items():
        for w in counted.values():
            w.launches = 0
        res, wall, peak, parts = run_multiply(AA, BB, grid, bud, lp)
        launches[label] = {name: w.launches for name, w in counted.items()}
        err = check_product(parts, ref_full if n == N_FULL else ref14, n)
        if lp == "auto":
            auto_parts = parts
        del parts
        runs[label], walls[label] = res, wall
        log(f"{label}: path {res.local_path}, b={res.plan.num_batches}, "
            f"retries {res.num_retries}, wall {wall:.2f} s, peak "
            f"{peak / 2**30:.3f} GiB, max rel err {err:.3g}, launches "
            f"{launches[label]}, caps {res.plan.caps}, "
            f"hash_caps {res.hash_caps}, binned_caps {res.binned_caps}")
    hash_launches = launches["hash n=2^20"]["hash"]
    binned_launches = launches["auto n=2^14"]["binned"]
    rh, resc, rb = runs["hash n=2^20"], runs["esc n=2^20"], runs["auto n=2^14"]
    if not (rh.plan.num_batches >= 1024 and rh.num_retries == 0
            and hash_launches == rh.plan.num_batches
            and launches["hash n=2^20"]["hash_chunk"] == 0):
        raise AssertionError(f"hash run: needs b >= 1024 and exactly one fused hash launch "
                             f"per batch, no one-chunk launches: {launches['hash n=2^20']}")
    if launches["esc n=2^20"]["segment_reduce"] < resc.plan.num_batches:
        raise AssertionError(f"esc run: the segment reduction must sum every batch: "
                             f"{launches['esc n=2^20']}")
    if not (rb.local_path == "binned" and rb.plan.num_batches == 16 and binned_launches > 0):
        raise AssertionError("default run: must plan binned with b = 16 and launch it")
    _, wall2, _, parts2 = run_multiply(A14, B14, grid, budget14, "auto")
    if not same_parts(auto_parts, parts2):
        raise AssertionError("auto n=2^14: a second run gives other bits")
    log(f"auto n=2^14: second run bit-identical, wall {wall2:.2f} s")
    del auto_parts, parts2

    # 4. kernels against their plain versions, on batch 0's operands
    a_cat, b_cat = batch0_operands(A, B, grid, rh.plan)
    h_err, h_ms, h_plain, h_bytes, h_adds = check_hash_kernel(a_cat, b_cat, rh.hash_caps)
    h_bound, h_by = bound_ms(h_bytes, h_adds)
    log(f"hash insert, one chunk: {h_ms:.6f} ms/launch (plain {h_plain:.4f}), bound "
        f"{h_bound:.7f} ms ({h_by}), {100 * h_bound / h_ms:.2f} % of bound")
    f_err, f_ms, f_plain, f_bytes, f_ops = check_fused_hash(a_cat, b_cat, rh.hash_caps)
    f_bound, f_by = bound_ms(f_bytes, f_ops)
    log(f"hash insert, fused: {f_ms:.6f} ms per batch (plain {f_plain:.4f}), bound "
        f"{f_bound:.7f} ms ({f_by}), {100 * f_bound / f_ms:.2f} % of bound")
    hash_batch_split(A, B, grid, rh.plan, rh.hash_caps, walls["hash n=2^20"],
                     rh.plan.num_batches)
    a_cat, b_cat = batch0_operands(A, B, grid, resc.plan)
    seg = check_segment_reduce(a_cat, b_cat, resc.plan.caps)
    seg_launches = launches["esc n=2^20"]["segment_reduce"]
    a_cat, b_cat = batch0_operands(A14, B14, grid, rb.plan)
    bin_of_k = torch.as_tensor(rb.plan.kbin.bin_of_k, device=a_cat.device)
    b_err, b_ms, b_plain, b_lib, b_bytes, b_flops = check_binned_kernel(
        a_cat, b_cat, rb.binned_caps, bin_of_k)
    b_bound, b_by = bound_ms(b_bytes, b_flops)
    log(f"binned: {b_ms:.6f} ms (plain {b_plain:.4f}, torch.sparse.mm {b_lib:.4f}), "
        f"bound {b_bound:.6f} ms ({b_by}), {100 * b_bound / b_ms:.2f} % of bound")

    # 5. the kernel API on the same batch 0 operands
    t0 = time.perf_counter()
    api = ops_phase(a_cat, b_cat, rb.binned_caps, bin_of_k)
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    del a, A, B, a14, A14, B14, a_cat, b_cat, runs, rh, resc, rb, ref_full, ref14
    torch.cuda.empty_cache()

    # 6. the dense-path kernels against their plain versions
    t0 = time.perf_counter()
    a_mcl, cfg_dense = mcl_dense_input()
    dk = check_dense_kernels(*dense_batch0(a_mcl, grid, cfg_dense), cfg_dense.max_per_col)
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")
    # 7-8. Markov clustering, sparse and dense
    t0 = time.perf_counter()
    seg_mcl = mcl_sparse_phase(grid)
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dense_launches = mcl_dense_phase(grid, a_mcl, cfg_dense)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")

    seg_err, seg_ms, seg_plain, seg_lib, seg_bytes, seg_ops = seg
    seg_bound, seg_by = bound_ms(seg_bytes, seg_ops)
    kernels = [
        {"name": "hash_insert", "route": "cuda",
         "source": "src/repro_torch/csrc/spgemm_hash.cu",
         "replaces": "src/repro/kernels/spgemm_hash.py:159",
         "launches": hash_launches, "max_abs_err": max(h_err, f_err), "ms": f_ms,
         "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by, "library_ms": None,
         "per": "batch: one fused expansion + insert launch"},
        {"name": "segment_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_reduce.cu",
         "replaces": "src/repro/core/sortkeys.py:94",
         "launches": seg_launches,
         "max_abs_err": max(seg_err, *(s[3] for s in seg_mcl.values())), "ms": seg_ms,
         "plain_ms": seg_plain, "bound_ms": seg_bound, "bound_by": seg_by,
         "library_ms": seg_lib,
         "mcl_n2^18_batch": {stage: {"launches": n, "ms": ms, "bound_ms": b,
                                     "max_abs_err": e}
                             for stage, (n, ms, b, e) in seg_mcl.items()}},
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
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
