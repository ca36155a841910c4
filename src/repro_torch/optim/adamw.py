"""AdamW with global-norm clipping and ZeRO-1 optimizer-state sharding.

The JAX package's ``repro.optim.adamw``: state = (mu, nu, count), and with
``master_in_opt`` an f32 master copy of every parameter in the state,
which the update writes and the (lower-precision) model parameters are
cast from.

A parameter tree here is a model (``nn.Module``: its ``named_parameters``)
or a dict of tensors keyed by the same names; mu, nu and master are such
dicts, ``count`` an int32 scalar tensor. ``apply_updates`` writes the
parameters and the state in place (the JAX package returns new arrays):
at OLMoE-1B-7B's width a second copy of the parameters and moments would
not fit the card. The arithmetic is the JAX package's, in the same order:
bias corrections ``1 - b ** count`` and the warm-up ``min(count / warmup,
1)`` in f32, weight decay on every leaf (norms included).

ZeRO-1 on a process mesh (``launch.mesh``): ``opt_state_specs*`` give the
reference's spec trees (``layers`` stacked), where each state tensor is
also split over the data axes on its first free dimension that divides
(``models.common.zero1_shard_spec``). The port keeps its layers apart;
``models.common.ZeroLayout`` reads those specs per parameter (a split
dimension of a layer's tensor, or whole layers owned by one data rank
each). The train step reduces the gradients onto the slices,
``apply_updates`` takes the layout's global norm, updates the slices and
has the layout gather them back into every rank's tensor-parallel
parameter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..models.common import Spec, ZeroLayout, batch_axes, zero1_shard_spec

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
    zero1: bool = True  # on a mesh: the state split over the data axes as well
    # model parameters in bf16, the f32 master copy in the optimizer state
    master_in_opt: bool = False


def named(params) -> Dict[str, Tensor]:
    """A parameter tree as ``{name: tensor}``: a module's parameters, or
    the dict as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params, master_in_opt: bool = False, mesh=None,
                   specs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Zero moments (and the f32 master with ``master_in_opt``). With
    ``mesh`` and ``specs`` (``train.step.shardings_for``'s spec trees):
    this rank's ZeRO-1 slices of its tensor-parallel parameters."""
    leaves = named(params)
    device = next(iter(leaves.values())).device
    if mesh is not None:
        layout = ZeroLayout(leaves, specs, mesh)
        leaves = {k: layout.slice(k, p) for k, p in leaves.items() if layout.owns(k)}
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


def _map_specs(fn, specs, shapes):
    if isinstance(specs, Spec):
        return fn(specs, shapes)
    return {k: _map_specs(fn, v, shapes[k]) for k, v in specs.items()}


def opt_state_specs(param_specs_tree, params_shapes, mesh, cfg: AdamWConfig):
    """The optimizer state's spec tree, ZeRO-1 over the mesh's data axes."""
    dp = batch_axes(mesh)
    return opt_state_specs_axes(param_specs_tree, params_shapes, dp,
                                math.prod(mesh.shape[a] for a in dp), cfg)


def opt_state_specs_axes(param_specs_tree, params_shapes, dp_axes, dp_size: int,
                         cfg: AdamWConfig):
    """ZeRO-1 over an explicit axis set (the "dp" strategy passes its
    batch axes, "model" among them). ``params_shapes``: the stacked shape
    tree (``models.transformer.param_shapes``)."""

    def one(spec, shape):
        if not cfg.zero1 or dp_size == 1:
            return spec
        return zero1_shard_spec(spec, shape, tuple(dp_axes), dp_size)

    mu = _map_specs(one, param_specs_tree, params_shapes)
    specs = {"mu": mu, "nu": mu, "count": Spec()}
    if cfg.master_in_opt:
        specs["master"] = mu
    return specs


def _schedule(cfg: AdamWConfig, count: Tensor) -> Tensor:
    warm = torch.clamp(count.to(torch.float32) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def clip_by_global_norm(grads: Dict[str, Tensor], max_norm: float,
                        norm_sq: Optional[Tensor] = None) -> Tuple[Dict[str, Tensor], Tensor]:
    """(grads scaled so their global f32 norm is at most ``max_norm``, in
    their own dtypes, as new tensors; the norm before scaling). ``norm_sq``:
    the squared global norm where ``grads`` are slices of the gradient."""
    if norm_sq is None:
        sq = [g.to(torch.float32).square().sum() for g in grads.values()]
        norm_sq = sum(sq[1:], sq[0])
    gnorm = torch.sqrt(norm_sq)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype) for k, g in grads.items()}, gnorm


@torch.no_grad()
def apply_updates(params, grads: Dict[str, Tensor], state: Dict[str, Any], cfg: AdamWConfig,
                  layout: Optional[ZeroLayout] = None):
    """One AdamW step, in place. Returns (params, state, metrics) with
    metrics ``grad_norm`` (before clipping) and ``lr``, 0-dim tensors.
    With ``layout`` (a mesh's ``models.common.ZeroLayout``, of which it
    calls ``norms_sq``, ``slice`` and ``gather_into``): ``grads`` and the
    state are this rank's ZeRO slices (``layout.reduce``), the norm is the
    global one, and the updated slices are gathered into ``params``."""
    grads, gnorm = clip_by_global_norm(
        grads, cfg.grad_clip, None if layout is None else layout.norms_sq(grads).sum())
    count = state["count"] + 1
    lr = _schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.to(torch.float32)
    b2c = 1 - cfg.b2 ** count.to(torch.float32)
    masters = state.get("master")
    leaves = named(params)
    out = {}
    for name, g in grads.items():
        p = leaves[name] if layout is None else layout.slice(name, leaves[name])
        g32 = g.to(torch.float32)
        m, v = state["mu"][name], state["nu"][name]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
        w = p if masters is None else masters[name]
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * w.to(torch.float32)
        w.copy_((w.to(torch.float32) - lr * step).to(w.dtype))
        out[name] = w if masters is None else w.to(p.dtype)
        if masters is not None and layout is None:  # emit the model's weights from the master
            p.copy_(out[name])
    if layout is not None:
        layout.gather_into(leaves, out)
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}
