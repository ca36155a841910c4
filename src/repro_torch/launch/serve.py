"""SpGEMM serving launcher: plan-cached multiply-as-a-service on a grid.

  python -m repro_torch.launch.serve --requests 16 --repeat-frac 0.5
  python -m repro_torch.launch.serve --device cpu
  python -m repro_torch.launch.serve --pr 2            # 2x2x1: four ranks

Generates a mixed repeat/novel request stream, runs it through the
``SpgemmEngine`` admission queue + plan cache, and prints per-request
latency percentiles, throughput and the plan-cache hit rate. The engine
runs on the card unless ``--device cpu``. A grid of more than one point
(``--pr``, ``--layers``) starts one process per point
(``launch.spawn``: NCCL when every rank has a card of its own, gloo on
the CPU and for ranks sharing a card); every rank submits the same stream
and rank 0's summary line is printed.

The launcher drives the engine one tick at a time and checks for a
translated SIGTERM between ticks (``runtime.resilient.check_preemption``,
MAX-reduced over the grid, so a signal that reaches one rank stops all of
them at the same tick): the run then stops admitting and dispatching,
prints ``preempted: ... served k of N`` and exits 0. On a grid the signal
must reach the ranks (send it to the process group).
"""
from __future__ import annotations

import argparse
import time

GRID_TIMEOUT_S = 3600.0  # spawned ranks: a bound for a hung rank and every collective


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--n", type=int, default=128, help="matrix dimension")
    ap.add_argument("--deg", type=float, default=4.0,
                    help="average nonzeros per row")
    ap.add_argument("--repeat-frac", type=float, default=0.5,
                    help="fraction of requests repeating one signature")
    ap.add_argument("--memory", type=int, default=1 << 26,
                    help="per-process admission budget (bytes)")
    ap.add_argument("--pr", type=int, default=1)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--local-path", choices=("auto", "esc", "binned", "hash"),
                    default="auto", help="local multiply policy (ServeConfig.local_path)")
    return ap.parse_args(argv)


def serve_rank(grid, args: argparse.Namespace) -> str:
    """Serve the launcher's request stream on ``grid`` (one rank of it);
    returns the summary line (or the preemption line)."""
    import numpy as np

    from ..core.gen import erdos_renyi
    from ..runtime.resilient import (
        PreemptionError,
        check_preemption,
        install_preemption_handler,
    )
    from ..serve import MultiplyRequest, ServeConfig, SpgemmEngine

    install_preemption_handler()
    eng = SpgemmEngine(grid, ServeConfig(per_process_memory=args.memory,
                                         local_path=args.local_path))
    # host operands; the engine scatters them to the grid's device
    a0 = erdos_renyi(args.n, args.deg, seed=7, device="cpu")
    b0 = erdos_renyi(args.n, args.deg, seed=8, device="cpu")
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        if rng.random() < args.repeat_frac:
            eng.submit(MultiplyRequest(rid=rid, a=a0, b=b0))
        else:
            eng.submit(MultiplyRequest(
                rid=rid,
                a=erdos_renyi(args.n, args.deg, seed=100 + 2 * rid, device="cpu"),
                b=erdos_renyi(args.n, args.deg, seed=101 + 2 * rid, device="cpu"),
            ))
    t0 = time.perf_counter()
    try:
        while eng.queue or eng.active:
            check_preemption(grid)
            eng.step()
    except PreemptionError as e:
        return f"preempted: {e} — served {len(eng.done)} of {args.requests}"
    wall = time.perf_counter() - t0
    ok = [r for r in eng.done if r.status == "ok"]
    lat = sorted(r.latency_ms for r in ok)
    p = lambda q: lat[min(int(q * len(lat)), len(lat) - 1)] if lat else 0.0  # noqa: E731
    return (
        f"served {len(ok)}/{args.requests} "
        f"(refused {eng.stats['refused']}, deferred {eng.stats['deferred']}) "
        f"p50 {p(0.5):.1f}ms p99 {p(0.99):.1f}ms "
        f"plan-cache hit rate {eng.cache_hit_rate():.2f} "
        f"({len(ok) / wall:.1f} req/s on {grid.pr}x{grid.pc}x{grid.l} {grid.device.type})"
    )


def main(argv=None) -> int:
    args = parse_args(argv)
    shape = (args.pr, args.pr, args.layers)
    if shape == (1, 1, 1):
        from ..core.grid import make_grid

        print(serve_rank(make_grid(1, 1, 1, device=args.device), args))
        return 0
    import torch

    from ..launch import spawn
    from ..runtime.resilient import install_preemption_handler

    # a SIGTERM to this process only sets the flag: the ranks drain on their own
    install_preemption_handler()
    p = shape[0] * shape[1] * shape[2]
    one_per_card = args.device == "cuda" and torch.cuda.device_count() >= p
    lines = spawn.run(serve_rank, shape, backend="nccl" if one_per_card else "gloo",
                      device=args.device, args=(args,), timeout_s=GRID_TIMEOUT_S)
    print(lines[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
