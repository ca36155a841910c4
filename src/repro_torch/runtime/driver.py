"""Pipelined dispatch for the batched driver, and the fault-tolerant
training loop with its knobs, the straggler watchdog and deterministic
fault injection.

  * ``LookaheadWindow`` bounds the batches in flight on the card.
  * ``RuntimeConfig`` holds the restartable loop's knobs.
  * ``StragglerEwma`` flags a step slower than ``factor`` times the
    per-step wall-time EWMA (``StragglerEvent`` is the exception a caller
    may raise for one).
  * ``FailureInjector`` fails or delays chosen steps, once each, for tests.
  * ``run_training`` is the JAX package's restartable loop: a restart from
    the newest checkpoint on ``RuntimeError`` (a node failure), a rollback
    on a non-finite loss with the poisoned batch replaced by the batch of
    step + steps, the straggler EWMA, and a save every ``ckpt_every`` steps
    and at the last. The state is a dict of tensors (nested dicts allowed)
    through ``checkpoint.store``; a model (``nn.Module``) in it is stored
    as its ``state_dict()`` and restored into itself. On a process mesh
    every rank runs the loop and rank 0 writes (``mesh=``).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..checkpoint import store

log = logging.getLogger("repro_torch.runtime")


class LookaheadWindow:
    """Bounded in-flight window for pipelined dispatch.

    ``push`` enqueues a dispatched unit of work; once more than ``depth``
    units are in flight the oldest is completed via ``finish`` (which is
    where the host first waits on device results — overflow flags, batch
    payloads). ``drain`` completes everything still in flight. The batched
    SUMMA3D driver runs its per-batch pipeline through one window.
    """

    def __init__(self, depth: int, finish: Callable[..., None]):
        self.depth = depth
        self.finish = finish
        self._inflight: deque = deque()

    @classmethod
    def from_exec(cls, exec_spec, finish: Callable[..., None]
                  ) -> "LookaheadWindow":
        """Window sized by an ``ExecSpec``: ``lookahead`` deep when the
        pipelined schedule is on, depth 0 (every push completes at once)
        when it is off."""
        return cls(exec_spec.lookahead if exec_spec.pipelined else 0, finish)

    def push(self, *item) -> None:
        self._inflight.append(item)
        while len(self._inflight) > self.depth:
            self.finish(*self._inflight.popleft())

    def drain(self) -> None:
        while self._inflight:
            self.finish(*self._inflight.popleft())


@dataclasses.dataclass
class RuntimeConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_rollbacks: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    ewma_warmup: int = 3  # steps before straggler detection arms (first-call builds)


class StragglerEvent(Exception):
    pass


class StragglerEwma:
    """Per-step wall-time EWMA, seeded after a warm-up.

    The first steps pay one-time costs (kernel builds and loads, allocator
    growth), so the EWMA is seeded with the *minimum* of the first
    ``warmup + 1`` observations: a one-time cost never makes a step faster.
    ``observe`` returns True when the armed watchdog flags the step as a
    straggler; it never fires during warm-up.
    """

    def __init__(self, factor: float = 3.0, alpha: float = 0.2, warmup: int = 3):
        self.factor = factor
        self.alpha = alpha
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self._warmup_dts: list = []

    def observe(self, dt: float) -> bool:
        if self.ewma is None:
            self._warmup_dts.append(dt)
            if len(self._warmup_dts) > self.warmup:
                self.ewma = min(self._warmup_dts)
            return False
        slow = dt > self.factor * max(self.ewma, 1e-4)
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


class FailureInjector:
    """Deterministic fault injection for tests: fail at given steps."""

    def __init__(self, fail_steps=(), straggle_steps=(), straggle_s: float = 0.0):
        self.fail_steps = set(fail_steps)
        self.straggle_steps = set(straggle_steps)
        self.straggle_s = straggle_s

    def maybe_fail(self, step: int):
        if step in self.fail_steps:
            self.fail_steps.discard(step)  # fail once
            raise RuntimeError(f"injected node failure at step {step}")

    def maybe_straggle(self, step: int):
        if step in self.straggle_steps:
            time.sleep(self.straggle_s)


@dataclasses.dataclass
class TrainLoopResult:
    final_step: int
    losses: list
    rollbacks: int
    restarts: int
    straggler_events: int


def _arrays(state):
    """``state``'s tensors as the store takes them: a module as its
    ``state_dict()``, dicts and lists walked."""
    if isinstance(state, nn.Module):
        return dict(state.state_dict())
    if isinstance(state, dict):
        return {k: _arrays(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_arrays(v) for v in state)
    return state


def _restored(state, arrays):
    """``state`` holding ``arrays`` (``_arrays``' layout): a module loads
    them in place, every other leaf is replaced."""
    if isinstance(state, nn.Module):
        state.load_state_dict(arrays)
        return state
    if isinstance(state, dict):
        return {k: _restored(v, arrays[k]) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_restored(v, a) for v, a in zip(state, arrays))
    return arrays


def run_training(
    *,
    steps: int,
    make_state: Callable[[], Dict[str, Any]],  # fresh (params, opt) dict
    step_fn: Callable,  # (state, batch) -> (state, metrics)
    batch_fn: Callable[[int], Any],  # step -> batch
    rc: RuntimeConfig,
    injector: Optional[FailureInjector] = None,
    mesh=None,
    codec=None,
) -> TrainLoopResult:
    """The restartable loop (see the module docstring). A restored state's
    tensors go where ``make_state`` put them, in their dtypes.

    On a process mesh (``mesh`` of more than one rank) every rank runs the
    loop, and ``codec`` (``train.step.MeshState``) maps this rank's state
    to the whole one as host arrays on rank 0 (``encode``, collective:
    every rank calls it) and back (``decode``). Rank 0 alone writes
    checkpoints, of the whole state, in the one-card layout. A restore
    waits for rank 0's write, takes the step rank 0 finds newest (a MAX
    over the mesh), and every rank reads it one leaf at a time
    (``store.LeafReader``) and keeps its slices. The restart, rollback and
    straggler decisions are MAX-reduced over the mesh at each step, so
    every rank takes the same branch; an injected failure fires before the
    step's collectives."""
    meshed = mesh is not None and mesh.size > 1
    writer = not meshed or mesh.rank == 0
    ckpt = store.AsyncCheckpointer(rc.ckpt_dir, keep=rc.keep) if writer else None
    injector = injector or FailureInjector()

    def any_rank(*flags) -> list:
        if not meshed:
            return [bool(f) for f in flags]
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32, device=mesh.device)
        return [bool(x) for x in mesh.pmax_all(t).tolist()]

    def cold_or_warm_start():
        # drain an in-flight write before listing the store: latest_step
        # sweeps step_*.tmp dirs, and would sweep a running writer's
        last = None
        if writer:
            ckpt.wait()
            last = store.latest_step(rc.ckpt_dir)
        if meshed:
            mine = torch.tensor(-1 if last is None else last, dtype=torch.int64,
                                device=mesh.device)
            last = int(mesh.pmax_all(mine))
            last = None if last < 0 else last
        state = make_state()
        if last is None:
            return state, 0
        log.info("restored checkpoint at step %d", last)
        if meshed:
            with store.LeafReader(rc.ckpt_dir, last) as leaves:
                return codec.decode(state, leaves), last
        return _restored(state, store.restore(rc.ckpt_dir, last, _arrays(state))), last

    state, start = cold_or_warm_start()
    losses: list = []
    rollbacks = restarts = straggler_events = 0
    ewma = StragglerEwma(rc.straggler_factor, rc.ewma_alpha, rc.ewma_warmup)
    step = start
    skip_batches = set()

    while step < steps:
        try:
            try:
                injector.maybe_fail(step)
                failed = None
            except RuntimeError as e:
                failed = e
            if any_rank(failed)[0]:
                raise failed or RuntimeError(f"a peer failed at step {step}")
            t0 = time.perf_counter()
            injector.maybe_straggle(step)
            batch_step = step
            while batch_step in skip_batches:
                batch_step += steps  # deterministic replacement stream
            state, metrics = step_fn(state, batch_fn(batch_step))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            slow, bad = any_rank(ewma.observe(dt), not np.isfinite(loss))
            if slow:
                straggler_events += 1
                log.warning("straggler: step %d took %.3fs (ewma %.3fs)", step, dt, ewma.ewma)

            if bad:
                raise FloatingPointError(f"non-finite loss at step {step}")

            losses.append(loss)
            step += 1
            if step % rc.ckpt_every == 0 or step == steps:
                arrays = codec.encode(state) if meshed else _arrays(state)
                if writer:
                    ckpt.save(step, arrays, owned=meshed)
        except FloatingPointError as e:
            rollbacks += 1
            if rollbacks > rc.max_rollbacks:
                raise
            log.warning("%s — rolling back", e)
            skip_batches.add(step)  # poisoned batch: skip after restore
            state, step = cold_or_warm_start()
            losses = losses[: step - start]
        except RuntimeError as e:
            restarts += 1
            log.warning("%s — restart path", e)
            state, step = cold_or_warm_start()
            losses = losses[: step - start]
    if writer:
        ckpt.wait()
    return TrainLoopResult(
        final_step=step,
        losses=losses,
        rollbacks=rollbacks,
        restarts=restarts,
        straggler_events=straggler_events,
    )
