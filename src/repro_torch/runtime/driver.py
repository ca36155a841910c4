"""Pipelined dispatch for the batched driver, and the pieces of the
fault-tolerant loop: its knobs, the straggler watchdog and deterministic
fault injection.

  * ``LookaheadWindow`` bounds the batches in flight on the card.
  * ``RuntimeConfig`` holds the restartable loop's knobs.
  * ``StragglerEwma`` flags a step slower than ``factor`` times the
    per-step wall-time EWMA (``StragglerEvent`` is the exception a caller
    may raise for one).
  * ``FailureInjector`` fails or delays chosen steps, once each, for tests.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional


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
