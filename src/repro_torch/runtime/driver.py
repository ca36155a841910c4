"""Pipelined dispatch for the batched driver."""
from __future__ import annotations

from collections import deque
from typing import Callable


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
