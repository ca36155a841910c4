"""Start one process per grid point and run a function on each.

    from repro_torch.launch import spawn

    def rank_fn(grid, n):          # module level: ranks import it by name
        ...                        # the same program on every grid point
        return result

    per_rank = spawn.run(rank_fn, (2, 2, 1), backend="gloo", device="cpu",
                         args=(n,), timeout_s=120)

``run`` starts pr·pc·l ranks with the ``spawn`` start method. Each rank
joins a ``file://`` rendezvous, builds its grid with ``core.grid.make_grid``
(rank r sits at grid point (r // (pc·l), r // l % pc, r % l)) and calls
``fn(grid, *args)``. On the card, rank r runs on card r mod the card count
(several ranks may share one card under gloo); on the CPU each rank uses
one thread. The backend is the caller's choice: NCCL for one rank per
card, gloo otherwise. On the card the parent builds every kernel before
it spawns, so the ranks only load them.

``run_mesh(fn, (data, model), ...)`` starts a process mesh's ranks the same
way: each builds its mesh with ``launch.mesh.make_debug_mesh`` (rank r
sits at the row-major point of r over ("data", "model"), or over ("pod",
"data", "model") for a three-entry shape) and calls ``fn(mesh, *args)``.

``run`` returns every rank's result, in rank order. If a rank raises, the
parent raises with the rank's number and traceback; if no result arrives
within ``timeout_s`` seconds (which also bounds every collective), it
raises. Either way every rank is stopped before ``run`` returns.
"""
from __future__ import annotations

import datetime
import math
import queue as queue_mod
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.grid import make_grid

POLL_S = 0.5  # how often the parent checks for a rank that died without a result


def _build(kind: str, shape: Tuple[int, ...], device):
    """This rank's grid (``kind`` "grid") or mesh ("mesh")."""
    if kind == "grid":
        return make_grid(*shape, device=device)
    from .mesh import make_debug_mesh

    return make_debug_mesh(*shape[-2:], pod=shape[0] if len(shape) == 3 else 0,
                           device=device)


def _rank_main(rank: int, kind: str, shape: Tuple[int, ...], backend: str, device: str,
               init_file: str, timeout_s: float, fn: Callable, args: tuple, results) -> None:
    try:
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(device)
            torch.set_num_threads(1)
        p = math.prod(shape)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=p, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(_build(kind, shape, dev), *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def run(fn: Callable, shape: Tuple[int, int, int], *, backend: str, device: str,
        args: tuple = (), timeout_s: float = 600.0,
        workdir: Optional[Path] = None) -> List[object]:
    """Run ``fn(grid, *args)`` on every point of a ``shape`` grid, one process
    each; see the module docstring. ``workdir`` holds the rendezvous file (a
    new temporary directory by default)."""
    return _run("grid", fn, tuple(shape), backend, device, args, timeout_s, workdir)


def run_mesh(fn: Callable, shape: Sequence[int], *, backend: str, device: str,
             args: tuple = (), timeout_s: float = 600.0,
             workdir: Optional[Path] = None) -> List[object]:
    """Run ``fn(mesh, *args)`` on every point of a (data, model) or (pod,
    data, model) mesh, one process each, as ``run`` does for a grid."""
    if len(shape) not in (2, 3):
        raise ValueError(f"a mesh shape is (data, model) or (pod, data, model), got {shape}")
    return _run("mesh", fn, tuple(shape), backend, device, args, timeout_s, workdir)


def _run(kind: str, fn: Callable, shape: Tuple[int, ...], backend: str, device: str,
         args: tuple, timeout_s: float, workdir: Optional[Path]) -> List[object]:
    p = math.prod(shape)
    if device == "cuda":
        from ..kernels import _build

        _build.build()
    workdir = Path(workdir) if workdir is not None else Path(tempfile.mkdtemp())
    init_file = workdir / f"rendezvous-{time.monotonic_ns()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, name=f"{kind}-rank-{r}", args=(
            r, kind, shape, backend, device, str(init_file), timeout_s, fn, args, results))
        for r in range(p)
    ]
    out = {}
    deadline = time.monotonic() + timeout_s
    dead = []
    try:
        for proc in procs:
            proc.start()
        while len(out) < p:
            try:
                rank, ok, value = results.get(timeout=POLL_S)
            except queue_mod.Empty:
                # a rank seen dead at two polls in a row left nothing in the queue
                was_dead, dead = dead, [r for r, proc in enumerate(procs)
                                        if r not in out and proc.exitcode is not None]
                if dead and dead == was_dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                if time.monotonic() > deadline:
                    missing = [r for r in range(p) if r not in out]
                    raise TimeoutError(f"ranks {missing} gave no result in {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {kind} {shape} failed:\n{value}")
            out[rank] = value
    finally:
        for proc in procs:
            proc.join(timeout=max(deadline - time.monotonic(), 5.0) if len(out) == p else 0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [out[r] for r in range(p)]
