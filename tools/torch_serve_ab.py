"""Compare phase 14b of chip_smoke.py (OLMoE-1B-7B at its full width and
depth in bf16, a stream of 16 requests served twice through the LM engine)
between this checkout and another one, on one card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/torch_serve_ab.py --baseline DIR

DIR holds the files of the commit to compare against (for example
``git archive <commit> | tar -x -C DIR``). The script prints, with the
card's name and power limit:

  1. Turns baseline, this, this, baseline, one process each, each with that
     tree's ``src/repro_torch`` and ``chip_smoke.py`` (its SpMM kernel built
     into that tree's ``build/``): 14b's lines, that is each run's prefill
     tokens/s and the mean and median host time of its decode-only ticks,
     and the profiled tick's device time; and the mean CPU time of the
     main thread (``time.thread_time``) over each run's decode-only ticks,
     which leaves out the time the thread waits for a core (a mean: that
     clock may tick in steps of 10 ms, so one tick's reading is coarse but
     unbiased). The wall times
     move by tens of percent from run to run on the machine's shared CPU
     cores; the device time does not.
  2. In this process, the host cost of the parameter walk that
     ``models.transformer._run_cached`` makes on every prefill and decode
     tick (``_at_use`` on every layer) over OLMoE-1B-7B's 16 layers of
     "meta" tensors in bf16, as a serving model holds them: mean of 2000
     calls, twice.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
WALK_REPS = 2000


def log(msg: str) -> None:
    print(msg, flush=True)


def turn(root: Path) -> None:
    """14b alone from ``root``'s package and chip_smoke.py."""
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not Path(_build.__file__).is_relative_to(root):
        raise RuntimeError(f"{_build.__file__} is not under {root}")
    t0 = time.perf_counter()
    _build.build(["spmm"])
    log(f"build {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py's phase 14
    runs, make = [], cs.olmoe_engine

    def engine(*args):
        eng, cpu_ms = make(*args), []
        step = eng.step

        def timed():
            decode_only = not (eng.queue and eng._free_slots())
            t = time.thread_time()
            step()
            if decode_only:
                cpu_ms.append((time.thread_time() - t) * 1e3)

        eng.step = timed
        runs.append(cpu_ms)
        return eng

    cs.olmoe_engine = engine
    t0 = time.perf_counter()
    cs.olmoe_phase()
    log(f"14b: {time.perf_counter() - t0:.1f} s")
    for i, cpu_ms in enumerate(runs[:2], 1):  # the stream's two runs (a third engine feeds 14c)
        log(f"14b run {i}: main thread CPU {np.mean(cpu_ms):.3f} ms mean over "
            f"{len(cpu_ms)} decode-only ticks")


def walk_ms() -> float:
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    cfg = get_config("olmoe-1b-7b")
    layers = tfm.init_params(cfg, None, "meta")["layers"]
    t = time.perf_counter()
    for _ in range(WALK_REPS):
        for lp in layers:
            tfm._at_use(cfg, lp)
    return (time.perf_counter() - t) / WALK_REPS * 1e3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path, help="the other tree's root")
    parser.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.turn is not None:
        turn(args.turn.resolve())
        return 0
    if args.baseline is None:
        parser.error("--baseline DIR is required")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip())
    trees = {"baseline": args.baseline.resolve(), "this": HERE}
    for i, label in enumerate(("baseline", "this", "this", "baseline"), 1):
        out = subprocess.run([sys.executable, __file__, "--turn", str(trees[label])],
                             capture_output=True, text=True, cwd=trees[label])
        if out.returncode != 0:
            log(out.stdout[-4000:] + out.stderr[-4000:])
            raise RuntimeError(f"turn {i} ({label}) failed: rc {out.returncode}")
        log(f"turn {i}: {label} ({trees[label]})")
        for line in out.stdout.splitlines():
            if line.startswith(("14b", "build")):
                log(f"  {line}")
    for _ in range(2):
        log(f"parameter walk of OLMoE-1B-7B's 16 layers (this tree): {walk_ms():.4f} ms a call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
