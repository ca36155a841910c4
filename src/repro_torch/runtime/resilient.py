"""Fault-tolerant harness for iterated SpGEMM: checkpoint/resume + injection.

MCL expansion/inflation and APSP iterated squaring run for hours on real
inputs (HipMCL at 262K cores, paper §V-C), where preemption, checkpoint
corruption and under-predicted output memory are routine. ``run_iterated``
is the generic restartable loop:

  * **checkpoint every N iterations** through ``store.AsyncCheckpointer``
    (a host snapshot on the caller's thread, the write on a worker thread,
    overlapped with the next multiply; stall time and bytes land in the
    ``RunReport``);
  * **cold-or-warm start**: ``restore_arrays_latest`` walks the complete
    checkpoints newest-first, *refusing* any corrupt or truncated one
    (content-hash or unreadable-archive failure) and falling back to the
    previous step — a refused restore is counted and logged, never fatal,
    and a store with no valid checkpoint degrades to a cold start, counted
    in ``refused_restores`` and logged;
  * **plan-signature meta** rides in the checkpoint manifest: the
    workload's encode/decode snapshot the plan floors, the pinned local
    multiply and the batch-count floor next to the iterate, so the
    restored loop plans exactly what the uninterrupted one planned and its
    trajectory repeats bit for bit on the order-fixed multiplies;
  * **straggler watchdog**: the driver's warm-up-seeded ``StragglerEwma``
    observes per-iteration wall time; events are logged and counted.

On a grid of more than one process (``grid=``) every rank runs the loop:
``encode`` gathers the tiles (a collective on every rank) and rank 0 alone
writes and collects old steps; a restore waits for rank 0's write to land,
rank 0 picks the step (and counts refusals) and the other ranks learn it
by a reduction before reading it, so every rank resumes from the same step;
a SIGTERM that reaches one rank only is MAX-reduced over the grid at the
iteration boundary, so every rank takes the restore path together.

``SpgemmFailureInjector`` grows the deterministic ``FailureInjector`` to the
SpGEMM failure modes: preemption at an iteration or mid-iteration (at a
chosen batch, inside the pipelined lookahead window), checkpoint truncation
after a completed save, overflow storms (forced capacity under-prediction
through a slack override), and per-batch straggler delays.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import re
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import store
from ..core.batched import RunReport
from .driver import FailureInjector, StragglerEwma

log = logging.getLogger("repro_torch.runtime.resilient")


class PreemptionError(RuntimeError):
    """Injected (or real) preemption: the loop restores and continues."""


# --- real-preemption translation (SIGTERM → PreemptionError) ---------------
# Schedulers deliver preemption as a signal, not an exception; the handler
# only flips this flag (signal-safe), and ``check_preemption`` — called at
# the iteration boundary inside ``run_iterated`` — turns it into the same
# ``PreemptionError`` the injector raises, so the restore path covers real
# kills as it covers injected ones.
_PREEMPTION = {"requested": False}


def _sigterm_handler(signum, frame):
    _PREEMPTION["requested"] = True
    log.warning("signal %d received — requesting preemption", signum)


def install_preemption_handler(signals=None) -> None:
    """Install the SIGTERM→``PreemptionError`` translation for this process.

    Launchers call this once before entering a resilient loop; later
    SIGTERMs set a flag that ``run_iterated`` turns into the restore path
    at the next iteration boundary (a signal mid-step never corrupts an
    in-flight checkpoint write).
    """
    import signal as _signal

    for s in signals if signals is not None else (_signal.SIGTERM,):
        _signal.signal(s, _sigterm_handler)


def preemption_requested() -> bool:
    return _PREEMPTION["requested"]


def clear_preemption() -> None:
    _PREEMPTION["requested"] = False


def check_preemption(grid=None) -> None:
    """Raise (and clear: one restore per signal, not a restart storm) when
    a translated signal is pending. On a grid of more than one process the
    flag is MAX-reduced over the grid first, so a signal that reached one
    rank sends every rank down the restore path (a collective on every
    rank: call it at the same point on all of them)."""
    requested = _PREEMPTION["requested"]
    if grid is not None and grid.p > 1:
        flag = torch.tensor(int(requested), dtype=torch.int32, device=grid.device)
        requested = bool(int(grid.pmax_all(flag)))
    if requested:
        _PREEMPTION["requested"] = False
        raise PreemptionError("preemption signal received (SIGTERM)")


@dataclasses.dataclass
class ResilientConfig:
    """Knobs of the resilient iterated loop (checkpoint cadence + watchdog)."""

    ckpt_dir: str
    ckpt_every: int = 1  # iterations between checkpoints
    keep: int = 3  # keep-N garbage collection
    max_restarts: int = 3  # bounded preemption recoveries
    async_save: bool = True  # off-thread writes (False: synchronous)
    resume: bool = True  # warm-start from the newest valid checkpoint
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    ewma_warmup: int = 1  # iterations before the watchdog arms


class SpgemmFailureInjector(FailureInjector):
    """Deterministic SpGEMM fault injection (tests and the card smoke run).

    Every site fires once (like ``FailureInjector.maybe_fail``), so a
    recovered run proceeds past the fault:

      * ``preempt_iters`` — ``PreemptionError`` at the start of those
        iterations; with ``preempt_batch`` set, the preemption fires
        *mid-iteration* instead, when the workload's consumer reaches that
        batch index (inside the pipelined lookahead window).
      * ``corrupt_steps`` — after the checkpoint of step s is on disk,
        truncate its ``arrays.npz`` (the restore must refuse it and fall
        back to the previous step).
      * ``overflow_iters`` — force capacity under-prediction: the workload
        plans those iterations with ``overflow_slack`` instead of its
        normal slack, driving the retry ladder (and, under a tight budget,
        the degradation replans).
      * ``straggle_batches`` — sleep ``batch_straggle_s`` inside the
        consumer at the given (iteration, batch) pairs.
    """

    def __init__(
        self, fail_steps=(), straggle_steps=(), straggle_s: float = 0.0,
        preempt_iters=(), preempt_batch: Optional[int] = None,
        corrupt_steps=(), overflow_iters=(), overflow_slack: float = 0.05,
        straggle_batches=(), batch_straggle_s: float = 0.0,
    ):
        super().__init__(fail_steps, straggle_steps, straggle_s)
        self.preempt_iters = set(preempt_iters)
        self.preempt_batch = preempt_batch
        self.corrupt_steps = set(corrupt_steps)
        self.overflow_iters = set(overflow_iters)
        self.overflow_slack = overflow_slack
        self.straggle_batches = set(straggle_batches)
        self.batch_straggle_s = batch_straggle_s

    def maybe_preempt(self, it: int, batch: Optional[int] = None) -> None:
        """Iteration-start check (``batch=None``) or mid-iteration check
        from the workload's consumer (``batch`` = batch index)."""
        if it not in self.preempt_iters:
            return
        at_batch = self.preempt_batch is not None
        if (batch is None) == at_batch:
            return  # armed for the other site
        if at_batch and batch != self.preempt_batch:
            return
        self.preempt_iters.discard(it)  # fire once
        where = f"batch {batch} of " if batch is not None else ""
        raise PreemptionError(f"injected preemption at {where}iteration {it}")

    def maybe_corrupt(self, ckpt_dir: str, step: int) -> bool:
        """Truncate step's on-disk payload (call after the save landed)."""
        if step not in self.corrupt_steps:
            return False
        self.corrupt_steps.discard(step)
        path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
        log.warning("injected corruption: truncated %s", path)
        return True

    def capacity_slack(self, it: int) -> Optional[float]:
        """Slack override for iteration ``it`` (None = no storm)."""
        return self.overflow_slack if it in self.overflow_iters else None

    def maybe_straggle_batch(self, it: int, batch: int) -> None:
        if (it, batch) in self.straggle_batches:
            self.straggle_batches.discard((it, batch))
            time.sleep(self.batch_straggle_s)


_KEYSTR_RE = re.compile(r"^\['(.*)'\]$")


def _plain_key(k: str) -> str:
    """Undo keystr naming on a single-level dict key: the store names a
    top-level leaf ``A_rows`` ``['A_rows']``; decoders see ``A_rows``."""
    m = _KEYSTR_RE.match(k)
    return m.group(1) if m else k


def restore_arrays_latest(
    ckpt_dir: str,
) -> Tuple[Optional[Dict[str, np.ndarray]], Optional[dict], Optional[int], int]:
    """Newest-valid restore: ``(arrays, meta, step, refused)``.

    Walks the complete checkpoints newest-first; a corrupt, truncated or
    unreadable one is REFUSED (logged and counted) and the previous step is
    tried. With no valid checkpoint, returns ``(None, None, None, refused)``
    and the caller cold-starts.
    """
    refused = 0
    for s in reversed(store.steps_available(ckpt_dir)):
        try:
            arrays = store.restore_arrays(ckpt_dir, s)
            meta = store.load_meta(ckpt_dir, s)
            return {_plain_key(k): v for k, v in arrays.items()}, meta, s, refused
        except IOError as e:
            refused += 1
            log.warning("refusing checkpoint step %d: %s", s, e)
    return None, None, None, refused


def _restore_agreed(ckpt_dir: str, grid):
    """``restore_arrays_latest`` with every rank of ``grid`` on one step:
    rank 0 walks the store (its own write has landed: the caller waited on
    it), the other ranks wait in a MAX reduction for its step and refusal
    count, then read that step themselves."""
    if grid is None or grid.p == 1:
        return restore_arrays_latest(ckpt_dir)
    if grid.rank == 0:
        arrays, meta, step, refused = restore_arrays_latest(ckpt_dir)
        mine = [-1 if step is None else step, refused]
    else:
        mine = [-1, 0]
    agreed = grid.pmax_all(torch.tensor(mine, dtype=torch.int64, device=grid.device))
    s, refused = (int(x) for x in agreed.tolist())
    if grid.rank == 0:
        return arrays, meta, step, refused
    if s < 0:
        return None, None, None, refused
    arrays = {_plain_key(k): v for k, v in store.restore_arrays(ckpt_dir, s).items()}
    return arrays, store.load_meta(ckpt_dir, s), s, refused


@dataclasses.dataclass
class IteratedResult:
    """What ``run_iterated`` hands back: final state + durability accounting."""

    state: Any
    it: int  # iterations completed
    report: RunReport


def run_iterated(
    *,
    rc: ResilientConfig,
    max_iters: int,
    cold_start: Callable[[], Any],
    step_fn: Callable[[Any, int, "SpgemmFailureInjector"], Tuple[Any, Optional[RunReport], bool]],
    encode: Callable[[Any], Tuple[Dict[str, np.ndarray], dict]],
    decode: Callable[[Dict[str, np.ndarray], dict], Any],
    injector: Optional[SpgemmFailureInjector] = None,
    verbose: bool = False,
    grid=None,
) -> IteratedResult:
    """The restartable iterated-SpGEMM loop (MCL, APSP, …).

    Contract with the workload:
      * ``cold_start() -> state`` builds iteration-0 state from the input;
      * ``step_fn(state, it, injector) -> (state', report_i, done)`` runs ONE
        iteration; ``report_i`` (a per-iteration ``RunReport`` or None) is
        merged into the loop's report; ``done`` stops the loop after a
        checkpoint;
      * ``encode(state) -> (arrays, meta)`` flattens the state into
        checkpoint leaves (exact-dtype tensors or arrays) and a JSON-safe
        meta dict carrying the plan signature; ``decode(arrays, meta) ->
        state`` inverts it onto the current grid's device.

    A ``PreemptionError`` from ``step_fn`` (injected, or a SIGTERM
    translated by ``check_preemption``) triggers the restore path: wait out
    the in-flight write, restore the newest VALID checkpoint (refusing
    corrupt ones) and continue from its iteration, at most
    ``rc.max_restarts`` times. ``grid`` (a multi-process ``Grid``) makes
    the loop run on every rank with one writer; see the module docstring.
    """
    injector = injector or SpgemmFailureInjector()
    writer = grid is None or grid.rank == 0
    ckpt = store.AsyncCheckpointer(rc.ckpt_dir, keep=rc.keep) if writer else None
    report = RunReport()
    ewma = StragglerEwma(rc.straggler_factor, rc.ewma_alpha, rc.ewma_warmup)

    def warm_or_cold(first: bool = False) -> Tuple[Any, int]:
        # rc.resume=False only opts the INITIAL start out of warm-starting
        # (a deliberately fresh run); recovery from a preemption always
        # reads the store — that is the point of the checkpoints
        nonlocal report
        if rc.resume or not first:
            arrays, meta, s, refused = _restore_agreed(rc.ckpt_dir, grid)
            report = report.merged(RunReport(refused_restores=refused))
            if arrays is not None:
                log.info("restored checkpoint at iteration %d", s)
                if verbose:
                    print(f"[resilient] resume from iteration {s}")
                return decode(arrays, meta), s
            if refused:
                log.warning("no valid checkpoint in %s (%d refused): cold start",
                            rc.ckpt_dir, refused)
        return cold_start(), 0

    state, it = warm_or_cold(first=True)
    restarts = 0
    done = False
    while it < max_iters and not done:
        try:
            injector.maybe_preempt(it)
            check_preemption(grid)  # real SIGTERM, translated at the boundary
            t0 = time.perf_counter()
            state, rep_i, done = step_fn(state, it, injector)
            dt = time.perf_counter() - t0
            if rep_i is not None:
                report = report.merged(rep_i)
            if ewma.observe(dt):
                report = report.merged(RunReport(straggler_events=1))
                log.warning("straggler: iteration %d took %.3fs (ewma %.3fs)",
                            it, dt, ewma.ewma)
            if verbose:
                ew = f"{ewma.ewma:.3f}" if ewma.ewma is not None else "warmup"
                print(f"[resilient] iter={it} wall={dt:.3f}s ewma={ew}s")
            it += 1
            if it % rc.ckpt_every == 0 or done or it == max_iters:
                arrays, meta = encode(state)  # every rank: may gather over the grid
                if writer:
                    if rc.async_save:
                        ckpt.save(it, arrays, meta=meta)
                    else:
                        ckpt.save_sync(it, arrays, meta=meta)
                    if it in injector.corrupt_steps:
                        ckpt.wait()  # the file must be on disk to truncate
                        injector.maybe_corrupt(rc.ckpt_dir, it)
        except PreemptionError as e:
            restarts += 1
            report = report.merged(RunReport(restarts=1))
            if restarts > rc.max_restarts:
                raise
            log.warning("%s — restoring", e)
            if writer:
                ckpt.wait()  # the in-flight write lands before the store is read
            state, it = warm_or_cold()
            done = False
    if writer:
        ckpt.wait()
        report = report.merged(RunReport(
            checkpoint_stalls=ckpt.stalls,
            checkpoint_stall_s=ckpt.stall_s,
            checkpoint_bytes=ckpt.bytes_written,
        ))
    return IteratedResult(state=state, it=it, report=report)
