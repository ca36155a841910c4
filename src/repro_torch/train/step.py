"""The train step on one card: loss and gradients, microbatch
accumulation, AdamW.

``build_train_step(cfg, train_cfg, device)`` returns step(params, opt,
batch) -> (params, opt, metrics), as the JAX package's
``repro.train.step.build_train_step`` returns its jitted step: the loss
``models.transformer.lm_loss``, its gradients with respect to every
parameter of the model, accumulated over ``microbatches`` in f32 as the
reference's ``lax.scan`` does (loss/mb and g/mb, summed in order), then
``optim.adamw.apply_updates`` in place. Metrics are 0-dim tensors on the
device (``loss``, ``grad_norm``, ``lr``): reading one waits for the step.

On one card both strategies ("tp": tensor parallel over a mesh's "model"
axis, "dp": pure data parallel) are the same local computation, as the
MoE's two expert-parallel modes are; the reference's shardings,
``shardings_for`` and the decode and prefill step builders wait for the
port's mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..models import transformer as tfm
from ..optim import adamw

Tensor = torch.Tensor

STRATEGIES = ("tp", "dp")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatches: int = 1  # grad accumulation steps per optimizer step
    aux_weight: float = 0.01
    strategy: str = "tp"


def value_and_grad(loss_fn: Callable[..., Tensor], params, *args
                   ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """(``loss_fn(params, *args)``, its gradient with respect to every
    parameter of ``params``, ``{name: tensor}``; zeros for a parameter the
    loss does not reach, as JAX gives)."""
    leaves = adamw.named(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = loss_fn(params, *args)
    grads = torch.autograd.grad(loss, list(leaves.values()), materialize_grads=True)
    return loss.detach(), dict(zip(leaves, grads))


def build_train_step(cfg: tfm.ModelConfig, train_cfg: TrainConfig = TrainConfig(),
                     device="cuda"):
    """step(params, opt, batch) -> (params, opt, metrics); ``batch`` holds
    ``inputs`` and ``targets`` (tensors or arrays, moved to ``device``)."""
    if train_cfg.strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {train_cfg.strategy!r}")
    mb = train_cfg.microbatches

    def loss_fn(params, batch):
        return tfm.lm_loss(cfg, params, batch["inputs"], batch["targets"],
                           aux_weight=train_cfg.aux_weight)

    def step(params, opt, batch):
        batch = {k: v.to(device) if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.array(v, copy=True), device=device)
                 for k, v in batch.items()}
        if mb > 1:
            parts = {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = None
            for i in range(mb):
                loss_i, g = value_and_grad(loss_fn, params, {k: v[i] for k, v in parts.items()})
                loss = loss + loss_i / mb
                if grads is None:
                    grads = {k: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                             for k, x in g.items()}
                for k, x in g.items():
                    grads[k] += x / mb
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt, om = adamw.apply_updates(params, grads, opt, train_cfg.optimizer)
        return params, opt, {"loss": loss, **om}

    return step
