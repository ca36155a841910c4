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
     profiler records none. Plain and library times are CUDA-event times.
     A kernel's bound counts the bytes its wrapper must move on this run's
     data (inputs read once, outputs written once) against the card's
     memory rate, or its f32 operations against the f32 peak.

The last two lines are a JSON object with one entry per ported kernel and
the JSON result line. Without a CUDA device, or without the repository's
src/ beside this file, it exits non-zero and prints no result.
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
VALUE_RTOL = 1e-4  # vs scipy: fp32 sums in another order
KERNEL_RTOL = 1e-5  # kernel vs plain: atomics add in a run-dependent order


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
    profiled window). Raises if no kernel named ``kernel`` was recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    total_us, names = 0.0, set()
    for _ in range(reps):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        if not any(kernel in ev.name for ev in dev):
            raise RuntimeError(f"profiler recorded no device time for {kernel}: "
                               f"{sorted({ev.name for ev in dev})}")
        total_us += sum(ev.time_range.elapsed_us() for ev in dev)
        names |= {ev.name[:100] for ev in dev}
    log(f"  profiled on the card: {sorted(names)}")
    return total_us / reps / calls / 1e3


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
    torch.sparse.mm(a_sp, b_sp)  # warm-up
    events = cuda_ms(lambda: Bn.spgemm_paired_binned_cuda(*args), 20)
    # the wrapper's time: C's zero fill and the kernel
    ms = device_ms(lambda: Bn.spgemm_paired_binned_cuda(*args), 1, "binned_paired_kernel", 10)
    log(f"binned: {ms:.6f} ms device time (zero fill + kernel); {events:.6f} ms "
        f"with CUDA events")
    plain = cuda_ms(lambda: Bn.spgemm_paired_binned_ref(*args), 3)
    lib = cuda_ms(lambda: torch.sparse.mm(a_sp, b_sp), 5)
    # the six binned arrays read once, C written once
    nbytes = (ar.numel() + bk.numel()) * 12 + m * n * 4
    shapes = f"{kb.num_bins} bins x ({kb.bin_cap_a} A, {kb.bin_cap_b} B) -> ({m}, {n})"
    log(f"binned: {shapes}, {matches} matching pairs, max abs err {err:.3g}")
    return err, ms, plain, lib, nbytes, 2 * matches


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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
