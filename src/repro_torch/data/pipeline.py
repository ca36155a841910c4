"""Deterministic synthetic token pipeline, made on the device.

The JAX package's contract (``repro.data.pipeline``): every step maps to
its own counter-based random stream, so a restart resumes the same batches
(a checkpoint stores only the step) and a batch needs no host I/O. The
stream is ramps plus 10 % noise (a learnable bigram structure, so the LM
loss falls), targets the inputs shifted by one; the ``"embeds"`` mode
draws normal embeddings and random targets.

Deviation: the JAX package draws from threefry (``fold_in(seed, step)``),
whose bits the port cannot reproduce without JAX. The port seeds a
``torch.Generator`` on the batch's device from a splitmix64 mix of
(seed, step): the same (seed, step, device) gives the same batch, other
numbers than the JAX package's. Parity tests feed the JAX package's
batches, as numpy, to both packages.

A real deployment swaps ``synthetic_batch`` for a tokenized corpus reader
with the same (step -> global batch) contract.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import torch

Tensor = torch.Tensor

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    input_mode: str = "tokens"  # "tokens" | "embeds"
    d_model: int = 0  # for embeds mode
    seed: int = 0


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def step_generator(cfg: DataConfig, step: int, device) -> torch.Generator:
    """The generator of ``step``'s batch on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(_splitmix64(_splitmix64(cfg.seed) ^ (step & _MASK64)))
    return g


def synthetic_batch(cfg: DataConfig, step: int, device="cuda") -> Dict[str, Tensor]:
    """Global batch for ``step`` on ``device``: ramps + noise, so the LM
    loss decreases."""
    g = step_generator(cfg, step, device)
    B, S = cfg.global_batch, cfg.seq_len
    if cfg.input_mode == "tokens":
        starts = torch.randint(0, cfg.vocab, (B, 1), generator=g, device=device)
        ramps = (starts + torch.arange(S + 1, device=device)[None, :]) % cfg.vocab
        noise = torch.rand((B, S + 1), generator=g, device=device) < 0.1
        rand = torch.randint(0, cfg.vocab, (B, S + 1), generator=g, device=device)
        seq = torch.where(noise, rand, ramps).to(torch.int32)
        return {"inputs": seq[:, :S], "targets": seq[:, 1:]}
    embeds = torch.randn((B, S, cfg.d_model), generator=g, device=device)
    targets = torch.randint(0, cfg.vocab, (B, S), generator=g, device=device).to(torch.int32)
    return {"inputs": embeds, "targets": targets}


class Prefetcher:
    """One-step-ahead prefetch: batch t+1 is enqueued on the device when
    batch t is handed out, so its generation runs ahead of the consumer's
    next step (launches are asynchronous: the host does not wait for it)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, device="cuda"):
        self.cfg = cfg
        self.step = start_step
        self.device = device
        self._next = synthetic_batch(cfg, self.step, device)

    def __next__(self) -> Dict[str, Tensor]:
        batch = self._next
        self.step += 1
        self._next = synthetic_batch(self.cfg, self.step, self.device)
        return batch

    def __iter__(self) -> Iterator[Dict[str, Tensor]]:
        return self
