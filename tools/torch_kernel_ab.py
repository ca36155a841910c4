"""Compare the port's column top-k, segment-reduce and k-binned kernels, and
the runs that use them, between this checkout and another one, on one card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/torch_kernel_ab.py --baseline DIR

DIR holds the files of the commit to compare against (for example
``git archive <commit> | tar -x -C DIR``): its ``src/repro_torch`` and
``chip_smoke.py``. The script prints, with the card's name and power limit:

  1. Kernels. Each tree's ``csrc/col_prune.cu`` and ``csrc/segment_reduce.cu``
     are built with the port's nvcc flags and run on the same inputs, in
     turns baseline, this, this, baseline, each turn the device time per
     launch (torch.profiler, mean of 5 profiled launches): the column top-k
     on chip_smoke.py's phase-6 block (batch 0 of the dense n=2^14 MCL run's
     second multiply) and on a uniform random block of the same shape, each
     bracket held bit-identical to the plain version; the segment reduction
     on every input one n=2^18 sparse MCL batch gives it (batch 0 of the
     second iteration: its multiply step, then its prune, captured and
     replayed), each sum held to the plain version within rtol 1e-5.
  2. Runs, one process per turn, baseline, this, this, baseline, each with
     that tree's whole package: the dense n=2^14 MCL loop three times (the
     first run builds the kernels) and the sparse n=2^18 device loop once,
     with their walls and nnz trajectories; the default (k-binned) n=2^14
     product three times (walls), then the binned multiply on its batch 0
     (chip_smoke.py's binned check: device time of the wrapper per call,
     mean of 5 profiled calls, and a checksum of C's bits), and the sparse
     n=2^14 MCL loop on that multiply three times (walls, nnz), then once
     more with every binned call's inputs captured, which are replayed and
     profiled (device time per call, mean over the loop's calls).

Inputs, batches and timers are this checkout's chip_smoke.py helpers, in
both trees' turns.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
KERNELS = {"col_prune": "col_topk_bounds_launch", "segment_reduce": "segment_reduce_launch"}


def log(msg: str) -> None:
    print(msg, flush=True)


def use_tree(root: Path):
    """Import ``repro_torch`` from ``root``; returns this checkout's
    chip_smoke.py as a module, whose helpers then run that tree's code."""
    sys.path.insert(0, str(root / "src"))
    import repro_torch  # noqa: F401  (before chip_smoke puts this checkout's src/ on the path)

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def loops(label: str, C) -> None:
    """Part 2 in this process, for the tree ``C`` was loaded over."""
    import dataclasses

    import torch

    from repro_torch.core import gen
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.grid import make_grid
    from repro_torch.kernels import spgemm_binned as Bn
    from repro_torch.sparse_apps import mcl

    grid = make_grid(1, 1, 1)
    a, cfg = C.mcl_dense_input()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hist = mcl.mcl_iterate(a, grid, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"{label}: dense n=2^14 loop walls {[round(w, 4) for w in walls]} s, "
        f"nnz {[h['nnz'] for h in hist]}")
    a, cfg = C.mcl_sparse_input()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = mcl.mcl_iterate(a, grid, cfg)
    torch.cuda.synchronize()
    log(f"{label}: sparse n=2^18 device loop wall {time.perf_counter() - t0:.4f} s, iterations "
        f"{[round(h['wall_ms'], 1) for h in hist]} ms, nnz {[h['nnz'] for h in hist]}")
    del a

    a14 = gen.protein_similarity_like(C.N_DEFAULT, blocks=C.N_DEFAULT // 64, intra_p=0.12, seed=0)
    A14, B14 = scatter_to_grid(a14, grid, "A"), scatter_to_grid(a14, grid, "B")
    walls = []
    for _ in range(3):
        res, wall, _, _ = C.run_multiply(A14, B14, grid, 48 * int(a14.nnz), "auto")
        walls.append(round(wall, 4))
    a_cat, b_cat = C.batch0_operands(A14, B14, grid, res.plan)
    bin_of_k = torch.as_tensor(res.plan.kbin.bin_of_k, device=a_cat.device)
    args = C.binned_operands(a_cat, b_cat, res.binned_caps, bin_of_k)
    out = Bn.spgemm_paired_binned_cuda(*args)
    bits = int(out.view(torch.int32).sum(dtype=torch.int64))
    ms = C.device_ms(lambda: Bn.spgemm_paired_binned_cuda(*args), 1, "", 5)
    log(f"{label}: auto n=2^14 product ({res.local_path}, b={res.plan.num_batches}) walls "
        f"{walls} s; binned multiply on batch 0: {ms:.6f} ms device time, C bits sum {bits}")
    a, cfg = C.mcl_dense_input()
    sparse = dataclasses.replace(cfg, path="sparse")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hist = mcl.mcl_iterate(a, grid, sparse)
        torch.cuda.synchronize()
        walls.append(round(time.perf_counter() - t0, 4))
    log(f"{label}: sparse n=2^14 loop ({hist[0]['local_path']}) walls {walls} s, "
        f"nnz {[h['nnz'] for h in hist]}")
    captured, dispatch = [], Bn.spgemm_paired_binned

    def capture(*call):
        captured.append(tuple(x.clone() if torch.is_tensor(x) else x for x in call))
        return dispatch(*call)

    Bn.spgemm_paired_binned = capture
    mcl.mcl_iterate(a, grid, sparse)
    Bn.spgemm_paired_binned = dispatch
    ms = C.device_ms(lambda: [Bn.spgemm_paired_binned_cuda(*call) for call in captured],
                     len(captured), "", 3)
    shapes = sorted({(call[0].shape, call[3].shape, call[6], call[7]) for call in captured})
    log(f"{label}: binned multiply in the sparse n=2^14 loop: {len(captured)} calls, "
        f"{ms:.6f} ms device time per call; shapes (A bins, B bins, m, n) {shapes}")


def build(trees: dict) -> dict:
    """{(tag, source): C entry point} for each tree's two kernels."""
    from repro_torch.kernels import _build, col_prune, segment_reduce

    argtypes = {"col_prune": col_prune._LAUNCH_ARGTYPES,
                "segment_reduce": segment_reduce._LAUNCH_ARGTYPES}
    out_dir = HERE / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, root in trees.items():
        for name in KERNELS:
            lib = out_dir / f"lib{name}-{tag}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                   str(root / "src/repro_torch/csrc" / f"{name}.cu")]
            procs[tag, name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (tag, name), (lib, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag} {name}:\n{report}")
        fn = getattr(ctypes.CDLL(str(lib)), KERNELS[name])
        fn.argtypes, fn.restype = argtypes[name], ctypes.c_int
        fns[tag, name] = fn
    return fns


def kernels(baseline: Path, C) -> None:
    """Part 1."""
    import torch

    from repro_torch.core.grid import make_grid
    from repro_torch.kernels import col_prune as P, segment_reduce as S

    fns = build({"baseline": baseline, "this": HERE})
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def col_prune(tag, x, k):
        out = torch.empty((2, x.shape[1]), device=x.device)
        err = fns[tag, "col_prune"](x.data_ptr(), x.shape[0], x.shape[1], k, out.data_ptr(),
                                    stream())
        if err:
            raise RuntimeError(f"{tag} col_prune: CUDA error {err}")
        return out

    def seg(tag, v, o, kind):
        out = torch.empty((o.numel() - 1,), device=v.device)
        err = fns[tag, "segment_reduce"](v.data_ptr(), o.data_ptr(), o.numel() - 1,
                                         S._ADD_KINDS[kind], out.data_ptr(), stream())
        if err:
            raise RuntimeError(f"{tag} segment_reduce: CUDA error {err}")
        return out

    def turns(label, fn, kernel, bound):
        ms = {"baseline": [], "this": []}
        for tag in ("baseline", "this", "this", "baseline"):
            fn(tag)
            ms[tag].append(C.device_ms(lambda: fn(tag), 1, kernel, 5))
        log(f"{label}: bound {bound:.6f} ms; baseline {ms['baseline']} ms, this {ms['this']} ms")

    grid = make_grid(1, 1, 1)
    a, cfg = C.mcl_dense_input()
    _, _, x = C.dense_batch0(a, grid, cfg)
    k = cfg.max_per_col
    bound = C.bound_ms(x.numel() * 4 + 8 * x.shape[1], 2 * P.THRESH_ITERS * x.numel())[0]
    for label, block in (("phase-6 block", x), ("uniform random block", torch.rand_like(x))):
        want = torch.stack(P.col_topk_bounds_ref(block, k)).view(torch.int32)
        for tag in ("baseline", "this"):
            if not torch.equal(col_prune(tag, block, k).view(torch.int32), want):
                raise AssertionError(f"{tag} col_prune: bracket differs from plain on the {label}")
        turns(f"col_prune, {label} {tuple(block.shape)}, k = {k}",
              lambda tag: col_prune(tag, block, k), "col_topk_bounds_kernel", bound)
    del x, block
    torch.cuda.empty_cache()

    a, cfg = C.mcl_sparse_input()
    step, prune = C.mcl_batch(a, grid, cfg)
    c, captured = C.capture_segment_inputs(step, clone=True)
    in_step = len(captured)
    captured += C.capture_segment_inputs(lambda: prune(c), clone=True)[1]
    del a, c, step, prune
    thread_run = S.path_limits()[0]
    for i, (v, o, kind) in enumerate(captured):
        runs, entries = o.numel() - 1, int(o[-1] - o[0])
        lengths = (o[1:] - o[:-1]).long()
        want = S.segment_reduce_ref(v, o, kind)
        for tag in ("baseline", "this"):
            if not torch.allclose(seg(tag, v, o, kind), want, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"{tag} segment_reduce differs from plain on input {i}")
        turns(f"segment_reduce, n=2^18 MCL batch, {'multiply step' if i < in_step else 'prune'}: "
              f"{runs} runs over {entries} of {v.numel()} slots, longest {int(lengths.max())}, "
              f"{float((lengths <= thread_run).float().mean()):.4f} of them <= {thread_run}",
              lambda tag: seg(tag, v, o, kind), "segment_reduce_kernel",
              C.bound_ms(4 * entries + 8 * runs + 4, entries)[0])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path, required=True,
                        help="the files of the commit to compare against")
    parser.add_argument("--loops-of", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--label", default="", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.loops_of is not None:  # one turn of part 2, in its own process
        loops(args.label, use_tree(args.loops_of.resolve()))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip())
    baseline = args.baseline.resolve()
    kernels(baseline, use_tree(HERE))
    for tag, root in (("baseline", baseline), ("this", HERE), ("this", HERE),
                      ("baseline", baseline)):
        subprocess.run([sys.executable, __file__, "--baseline", str(baseline),
                        "--loops-of", str(root), "--label", tag], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
