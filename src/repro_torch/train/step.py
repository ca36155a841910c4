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
axis, "dp": pure data parallel) are the same local computation.

On a process mesh (``mesh=``; ``launch.mesh``) the step is the reference's
sharded one. It takes the global batch and each rank keeps its share;
the model is the rank's slices under ``shardings_for``'s "params" specs,
the AdamW state its ZeRO-1 slices under the "opt" specs
(``adamw.init_opt_state(..., mesh=, specs=)``).

  * "tp": tensor parallel over "model", the batch over the data axes
    ("pod", "data"), the vocab-parallel loss
    (``transformer.lm_loss_shard``).
  * "dp": every parameter whole on every rank, the batch over ("pod",)
    "data" and "model" (the pod axis dropped first when the global batch
    does not divide), the plain loss on each rank's share, averaged over
    those axes; ZeRO-1 over all of them. An MoE model raises: the
    reference runs the MoE's expert-parallel layer with no mesh there and
    fails.

Each rank's gradient is its share's (see ``models.collectives``); the
data-parallel sum is an ordered reduce-scatter onto each parameter's ZeRO
slice (``models.common.ZeroLayout.reduce``), or an ordered sum where the state is
whole, after the microbatches are accumulated; AdamW updates the slices
and gathers them back.

``build_prefill_step`` and ``build_decode_step`` are the serving steps on
a process mesh (``launch.mesh``), the reference's builders: the step takes
global inputs and this rank's slices of the model and cache
(``models.transformer.param_specs``/``cache_specs``, returned with the
step), and returns global logits and this rank's cache. A batch that does
not divide the data axes is replicated over them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models import collectives as C
from ..models import transformer as tfm
from ..checkpoint import store
from ..models.common import (Spec, ZeroLayout, batch_axes, gather_tensor, leaf_spec,
                             shard_tensor)
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


def _dp_axes_for(mesh, train_cfg: TrainConfig, global_batch: int = 0) -> Tuple[str, ...]:
    """The axes the batch splits over: the data axes under "tp"; under "dp"
    the data axes and "model", dropping the pod axis first while the
    global batch does not divide their size."""
    if train_cfg.strategy == "dp":
        axes = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
        if global_batch:
            size = math.prod(mesh.shape[a] for a in axes)
            while axes and global_batch % size != 0:
                size //= mesh.shape[axes[0]]
                axes = axes[1:]
        return axes
    return batch_axes(mesh)


def shardings_for(cfg: tfm.ModelConfig, mesh, train_cfg: TrainConfig,
                  global_batch: int = 0) -> Dict[str, Any]:
    """The spec trees of the train step on ``mesh``, the reference's:
    ``{"params": ..., "opt": ..., "batch": ...}`` (``layers`` stacked;
    ``Spec``s where the reference has ``NamedSharding``s)."""
    tp = mesh.shape.get("model", 1) if train_cfg.strategy == "tp" else 1
    pspecs = tfm.param_specs(cfg, tp)
    dp = _dp_axes_for(mesh, train_cfg, global_batch)
    ospecs = adamw.opt_state_specs_axes(pspecs, tfm.param_shapes(cfg), dp,
                                        math.prod(mesh.shape[a] for a in dp),
                                        train_cfg.optimizer)
    dspec = dp if len(dp) > 1 else dp[0]
    tail = (None,) if cfg.input_mode == "tokens" else (None, None)
    bspecs = {"inputs": Spec(dspec, *tail), "targets": Spec(dspec, None)}
    return {"params": pspecs, "opt": ospecs, "batch": bspecs}


def build_train_step(cfg: tfm.ModelConfig, train_cfg: TrainConfig = TrainConfig(),
                     device="cuda", mesh=None, global_batch: int = 0):
    """step(params, opt, batch) -> (params, opt, metrics); ``batch`` holds
    ``inputs`` and ``targets`` (tensors or arrays, moved to ``device``).
    With ``mesh``: the global batch (``global_batch`` rows, which may pick
    "dp"'s axes) on every rank, and this rank's slices of the model and
    the state (see the module docstring); the step has the attribute
    ``specs`` (``shardings_for``'s) and ``layout`` (the
    ``models.common.ZeroLayout``; both None without a mesh), and its two
    halves ``grads(params, batch)`` -> (loss, gradients) and
    ``update(params, opt, gradients)``."""
    if train_cfg.strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {train_cfg.strategy!r}")
    if mesh is not None and train_cfg.strategy == "dp" and cfg.moe:
        raise ValueError(
            f"{cfg.arch_id}: the \"dp\" strategy cannot train an MoE model: the JAX "
            f"package's build_train_step runs its loss with mesh=None there, and moe_layer "
            f"fails on batch_axes(None)")
    mb = train_cfg.microbatches
    specs = shardings_for(cfg, mesh, train_cfg, global_batch) if mesh is not None else None
    dp = _dp_axes_for(mesh, train_cfg, global_batch) if mesh is not None else ()
    bspec = Spec(dp) if dp else None

    def loss_fn(params, batch):
        if mesh is None:
            return tfm.lm_loss(cfg, params, batch["inputs"], batch["targets"],
                               aux_weight=train_cfg.aux_weight)
        if train_cfg.strategy == "tp":
            return tfm.lm_loss_shard(cfg, params, batch["inputs"], batch["targets"], mesh,
                                     aux_weight=train_cfg.aux_weight)
        loss = tfm.lm_loss(cfg, params, batch["inputs"], batch["targets"],
                           aux_weight=train_cfg.aux_weight)
        return C.mean_of_partials(mesh, loss, dp)

    def mine(x):  # this rank's share of a global batch
        return shard_tensor(x, bspec, mesh) if bspec is not None else x

    def grads(params, batch):
        """(loss, gradients): on a mesh this rank's ZeRO slices of the
        gradient summed over the data axes."""
        batch = {k: v.to(device) if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.array(v, copy=True), device=device)
                 for k, v in batch.items()}
        if mb > 1:
            parts = {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=device)
            g_sum = None
            for i in range(mb):
                loss_i, g = value_and_grad(loss_fn, params,
                                           {k: mine(v[i]) for k, v in parts.items()})
                loss = loss + loss_i / mb
                if g_sum is None:
                    g_sum = {k: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                             for k, x in g.items()}
                for k, x in g.items():
                    g_sum[k] += x / mb
            g = g_sum
        else:
            loss, g = value_and_grad(loss_fn, params, {k: mine(v) for k, v in batch.items()})
        return loss, (layout.reduce(g) if layout is not None else g)

    def update(params, opt, g):
        """AdamW on ``grads``' output, in place: (params, opt, metrics)."""
        return adamw.apply_updates(params, g, opt, train_cfg.optimizer, layout=layout)

    def step(params, opt, batch):
        loss, g = grads(params, batch)
        params, opt, om = update(params, opt, g)
        return params, opt, {"loss": loss, **om}

    layout = None
    if mesh is not None:  # the parameter names, from the model's structure alone
        names = [n for n, _ in tfm.init_params(cfg, None, "meta").named_parameters()]
        layout = ZeroLayout(names, specs, mesh)
    step.specs, step.layout, step.grads, step.update = specs, layout, grads, update
    return step


class MeshState:
    """A train state ``{"params": model, "opt": AdamW state}`` on a mesh
    (this rank's slices under ``step``'s specs and ZeRO layout) to and
    from the whole state, as one card holds it: ``run_training(mesh=)``'s
    codec. ``encode`` gathers (every rank calls it); ``decode`` writes
    this rank's slices of a checkpoint's arrays into the state in place.
    Both go one leaf at a time, so neither holds more of the whole state
    on the card than a leaf (a chunk of a split stack of layers)."""

    def __init__(self, step, mesh):
        self.specs, self.layout, self.mesh = step.specs, step.layout, mesh

    def _spec(self, name):
        return leaf_spec(self.specs["params"], name)

    def encode(self, state) -> Optional[Dict[str, Any]]:
        """The whole state as host arrays (``store.host_copy``'s) on rank
        0, None on the others: each leaf gathered, copied to the host on
        rank 0 and dropped before the next."""
        keep = self.mesh.rank == 0

        def host(name, t):
            t = gather_tensor(t, self._spec(name), self.mesh)
            return store.host_copy(t) if keep else None

        out = {"params": {n: host(n, p.detach())
                          for n, p in adamw.named(state["params"]).items()},
               "opt": {"count": store.host_copy(state["opt"]["count"])}}
        for key in ("mu", "nu", "master"):
            if key in state["opt"]:
                out["opt"][key] = {n: host(n, t) for n, t in self.layout.gather(state["opt"][key])}
        return out if keep else None

    @torch.no_grad()
    def decode(self, state, arrays):
        """``arrays``: a checkpoint's leaves by keystr (a dict, or a
        ``store.LeafReader``, read one leaf at a time)."""
        def whole(*path):
            return torch.from_numpy(arrays["".join(f"[{p!r}]" for p in path)])

        for n, p in adamw.named(state["params"]).items():
            p.copy_(shard_tensor(whole("params", n), self._spec(n), self.mesh))
        for key, tree in state["opt"].items():
            if key == "count":
                tree.copy_(whole("opt", "count"))
                continue
            for n, t in tree.items():
                t.copy_(self.layout.slice(n, shard_tensor(whole("opt", key, n), self._spec(n),
                                                          self.mesh)))
        return state


def _serve_specs(cfg: tfm.ModelConfig, mesh, batch: int, s_max: Optional[int]):
    tp = mesh.shape.get("model", 1)
    return {"params": tfm.param_specs(cfg, tp), "cache": tfm.cache_specs(cfg, mesh, batch, s_max)}


def build_decode_step(cfg: tfm.ModelConfig, mesh, batch: int, s_max: Optional[int] = None):
    """(step(params, cache, inputs, cache_index) -> (logits (B, vocab),
    cache), {"specs": {"params", "cache"}}): one token for every sequence
    on ``mesh``, the cache updated in place."""
    specs = _serve_specs(cfg, mesh, batch, s_max)

    def step(params, cache, inputs, cache_index):
        if inputs.shape[0] != batch:
            raise ValueError(f"the step was built for a batch of {batch}, got {inputs.shape[0]}")
        return tfm.decode_step(cfg, params, cache, inputs, cache_index, mesh=mesh, s_max=s_max)

    return step, {"specs": specs}


def build_prefill_step(cfg: tfm.ModelConfig, mesh, s_max: int, batch: int):
    """(step(params, inputs) -> (last-position logits (B, vocab), cache),
    {"specs": {"params", "cache"}}): the prompt's forward on ``mesh``."""
    specs = _serve_specs(cfg, mesh, batch, s_max)

    def step(params, inputs):
        if inputs.shape[0] != batch:
            raise ValueError(f"the step was built for a batch of {batch}, got {inputs.shape[0]}")
        return tfm.prefill(cfg, params, inputs, s_max, mesh=mesh)

    return step, {"specs": specs}
