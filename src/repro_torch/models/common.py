"""Shared model-building blocks: norms, soft-cap, RoPE, initialisers and the
parameter tree.

The JAX package keeps a model's parameters as nested dicts of arrays. Here a
``ParamTree`` holds the same names, shapes and axis orders as an
``nn.Module`` (each dict a submodule, each list an ``nn.ModuleList``) and
reads as the dict does (``tree["wq"]``, ``"shared" in tree``), so every
model function takes either a ``ParamTree`` or a plain dict of tensors.

Initialisers take an explicit ``torch.Generator``: the port's seeded init
draws other numbers than ``jax.random`` from the same seed, so parity tests
carry the JAX package's weights over (``core.convert.lm_params_from_reference``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

Tensor = torch.Tensor


class ParamTree(nn.Module):
    """A nested dict of tensors as a module of parameters, frozen until a
    trainer asks for their gradients."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(v) for v in value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return getattr(self, name) if name in self else default

    def items(self):
        """(name, tensor or subtree) pairs, parameters first, as a dict's."""
        yield from self._parameters.items()
        yield from self._modules.items()


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS norm in f32, scaled by (1 + scale), cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def soft_cap(x: Tensor, cap: Optional[float]) -> Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap), in f32."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float = 10_000.0, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10_000.0) -> Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotates the
    two halves of the head dimension (not interleaved pairs)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def dense_init(generator, shape, in_axis: int = 0, dtype=torch.float32,
               device="cuda") -> Tensor:
    """Truncated normal on [-2, 2], scaled by 1/sqrt(fan-in)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(1.0 / math.sqrt(shape[in_axis])).to(dtype)


def embed_init(generator, shape, dtype=torch.float32, device="cuda") -> Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device).mul_(0.02).to(dtype)


def param_count(params) -> int:
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return params.numel()
