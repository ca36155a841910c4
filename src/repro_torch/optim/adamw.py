"""AdamW with global-norm clipping, on one card.

The JAX package's ``repro.optim.adamw`` without its sharding: state =
(mu, nu, count), and with ``master_in_opt`` an f32 master copy of every
parameter in the state, which the update writes and the (lower-precision)
model parameters are cast from. ZeRO-1's specs (``opt_state_specs*``,
``zero1``) shard that state over a mesh and wait for the port's mesh.

A parameter tree here is a model (``nn.Module``: its ``named_parameters``)
or a dict of tensors keyed by the same names; mu, nu and master are such
dicts, ``count`` an int32 scalar tensor. ``apply_updates`` writes the
parameters and the state in place (the JAX package returns new arrays):
at OLMoE-1B-7B's width a second copy of the parameters and moments would
not fit the card. The arithmetic is the JAX package's, in the same order:
bias corrections ``1 - b ** count`` and the warm-up ``min(count / warmup,
1)`` in f32, weight decay on every leaf (norms included).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch import nn

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # model parameters in bf16, the f32 master copy in the optimizer state
    master_in_opt: bool = False


def named(params) -> Dict[str, Tensor]:
    """A parameter tree as ``{name: tensor}``: a module's parameters, or
    the dict as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params, master_in_opt: bool = False) -> Dict[str, Any]:
    leaves = named(params)
    device = next(iter(leaves.values())).device
    state = {
        "mu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in leaves.items()},
        "nu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in leaves.items()},
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }
    if master_in_opt:
        state["master"] = {k: p.detach().to(torch.float32, copy=True) for k, p in leaves.items()}
    return state


def _schedule(cfg: AdamWConfig, count: Tensor) -> Tensor:
    warm = torch.clamp(count.to(torch.float32) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def clip_by_global_norm(grads: Dict[str, Tensor], max_norm: float
                        ) -> Tuple[Dict[str, Tensor], Tensor]:
    """(grads scaled so their global f32 norm is at most ``max_norm``, in
    their own dtypes, as new tensors; the norm before scaling)."""
    sq = [g.to(torch.float32).square().sum() for g in grads.values()]
    gnorm = torch.sqrt(sum(sq[1:], sq[0]))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype) for k, g in grads.items()}, gnorm


@torch.no_grad()
def apply_updates(params, grads: Dict[str, Tensor], state: Dict[str, Any], cfg: AdamWConfig):
    """One AdamW step, in place. Returns (params, state, metrics) with
    metrics ``grad_norm`` (before clipping) and ``lr``, 0-dim tensors."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    count = state["count"] + 1
    lr = _schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.to(torch.float32)
    b2c = 1 - cfg.b2 ** count.to(torch.float32)
    masters = state.get("master")
    for name, p in named(params).items():
        g32 = grads[name].to(torch.float32)
        m, v = state["mu"][name], state["nu"][name]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
        w = p if masters is None else masters[name]
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * w.to(torch.float32)
        w.copy_((w.to(torch.float32) - lr * step).to(w.dtype))
        if masters is not None:  # emit the model's weights from the master
            p.copy_(w.to(p.dtype))
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}
