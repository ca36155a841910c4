"""Batched LM serving engine: continuous batching over prefill and decode.

Requests enter a FIFO queue; the engine holds up to ``max_batch`` sequences
in cache slots, prefills each new arrival alone (B = 1) and splices its
cache into a free slot, then decodes every slot in lock-step, one
``decode_step`` a tick. A finished sequence frees its slot at once; the
slot is refilled on the next tick.

The scheduling is the JAX package's, kept exactly, since it decides the
tokens:
  * the whole batch decodes at ``slot_pos.max()``, so a shorter prompt's
    slot sees positions it never wrote (zero, or stale K/V) before its new
    token;
  * every one of the ``max_batch`` slots is decoded, idle ones with token 0:
    in an MoE model they take expert capacity from the live ones;
  * a sequence stops after ``max_new_tokens`` tokens, at ``eos_id``, or when
    its slot reaches ``s_max - 1``.

The model must take token inputs: the engine feeds each sequence's last
token back, which an ``"embeds"`` model cannot take (the JAX package's
engine fails at its first decode tick; this one refuses the model).

On a process mesh (``mesh`` given; the model this rank's slices, see
``models.transformer``) every rank runs this same host loop on the same
logits, so every rank makes the same decisions and returns the same
tokens. The cache is each rank's slice under ``cache_specs``: with more
than one data rank the slots split over "data" (when ``max_batch``
divides), and a decode's routing is local to each data rank's slots, as
the JAX package's. A prefill (B = 1) runs on every data rank, and only
the rank holding the slot keeps its cache; the JAX package's engine
cannot prefill an MoE model there (its shard_map needs B to divide
"data"), so the port replicates that batch, as its step builders do.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..models import transformer as tfm
from ..models.common import batch_shard, shard_index


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) tokens
    max_new_tokens: int
    out_tokens: Optional[List[int]] = None


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    s_max: int = 256
    greedy: bool = True
    eos_id: int = -1  # -1: never stop early


class ServeEngine:
    """``model`` is the port's LM (``models.transformer.init_params`` or
    ``core.convert.lm_params_from_reference``) on ``device``, where the
    cache is kept."""

    def __init__(self, cfg: tfm.ModelConfig, model, ecfg: EngineConfig, device="cuda",
                 mesh=None):
        if cfg.input_mode != "tokens":
            raise ValueError(f"{cfg.arch_id}: the engine feeds tokens back into the model, "
                             f"which takes input_mode={cfg.input_mode!r}")
        self.device = torch.device(device)
        wrong = {str(p.device) for p in model.parameters() if p.device.type != self.device.type}
        if wrong:
            raise ValueError(f"the model's parameters are on {sorted(wrong)}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.ecfg = ecfg
        self.mesh = mesh
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> request
        self.slot_pos = np.zeros(ecfg.max_batch, np.int32)  # tokens in slot
        self.cache = tfm.init_cache(cfg, ecfg.max_batch, ecfg.s_max, self.device, mesh)
        # the slots this rank's cache holds: [lo, lo + its batch)
        n = next(iter(self.cache.values())).shape[1]
        self._slot_lo = 0 if n == ecfg.max_batch else \
            shard_index(mesh, batch_shard(mesh, ecfg.max_batch))[0] * n
        self.done: List[Request] = []

    def submit(self, req: Request):
        req.out_tokens = []
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.ecfg.max_batch) if i not in self.active]

    @torch.inference_mode()
    def _prefill_into_slot(self, slot: int, req: Request):
        prompt = torch.as_tensor(np.asarray(req.prompt), device=self.device)[None]
        logits, pcache = tfm.prefill(self.cfg, self.model, prompt, s_max=self.ecfg.s_max,
                                     mesh=self.mesh)
        # splice the single-sequence cache into the batched cache at `slot`
        at = slot - self._slot_lo
        for name, single in pcache.items():
            if 0 <= at < self.cache[name].shape[1]:
                self.cache[name][:, at:at + 1] = single.to(self.cache[name].dtype)
        self.slot_pos[slot] = prompt.shape[1]
        req.out_tokens.append(int(torch.argmax(logits[0])))
        self.active[slot] = req

    @torch.inference_mode()
    def step(self) -> int:
        """One engine tick. Returns the number of active sequences."""
        # admit new requests into free slots (continuous batching)
        for slot in self._free_slots():
            if not self.queue:
                break
            self._prefill_into_slot(slot, self.queue.popleft())
        if not self.active:
            return 0
        # the decode batch: the last token of each active slot, 0 elsewhere
        toks = np.zeros((self.ecfg.max_batch, 1), np.int32)
        for slot, req in self.active.items():
            toks[slot, 0] = req.out_tokens[-1]
        index = int(self.slot_pos.max())
        logits, self.cache = tfm.decode_step(
            self.cfg, self.model, self.cache, torch.as_tensor(toks, device=self.device), index,
            mesh=self.mesh, s_max=self.ecfg.s_max)
        logits = logits.cpu().numpy()
        finished = []
        for slot, req in list(self.active.items()):
            tok = int(np.argmax(logits[slot]))
            req.out_tokens.append(tok)
            self.slot_pos[slot] += 1
            if (
                len(req.out_tokens) >= req.max_new_tokens
                or tok == self.ecfg.eos_id
                or self.slot_pos[slot] >= self.ecfg.s_max - 1
            ):
                finished.append(slot)
        for slot in finished:
            self.done.append(self.active.pop(slot))
            self.slot_pos[slot] = 0
        return len(self.active)

    def run_to_completion(self, max_ticks: int = 10_000) -> List[Request]:
        ticks = 0
        while (self.queue or self.active) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.done
