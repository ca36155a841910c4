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

Sharding over a process mesh (``launch.mesh``) is written as the JAX
package writes it: a tree of ``Spec`` (the port's ``PartitionSpec``: one
entry a tensor dimension, each an axis name, a tuple of axis names or
None), made by each module's ``*_specs`` function, with the ``layers``
subtree stacked (a leading None for the layer axis). ``shard_tree`` cuts
this rank's slice of every parameter, ``gather_tree`` puts the whole
tensors back together on every rank.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

Tensor = torch.Tensor

# Mesh axis conventions (launch/mesh.py): "pod" and "data" are data parallel,
# "model" tensor and expert parallel.
MODEL_AX = "model"


class Spec(tuple):
    """A tensor's sharding over a mesh, as ``jax.sharding.PartitionSpec``:
    ``Spec(None, "model")`` keeps dimension 0 whole and splits dimension 1
    over "model"; an entry may also be a tuple of axes (split over their
    row-major product; a tuple of one axis is that axis, as in a
    ``PartitionSpec``). Dimensions past the last entry are whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, (list, tuple)) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes the global batch is sharded over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_shard(mesh, batch: int):
    """The batch dimension's spec entry: the data axes when ``batch``
    divides their size, else None (replicated, as the JAX package's step
    builders replicate a batch of 1)."""
    dp = batch_axes(mesh)
    size = math.prod(mesh.shape[a] for a in dp)
    return dp if batch % size == 0 else None


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(mesh, entry) -> Tuple[int, int]:
    """(this rank's index, number of parts) of a dimension split over
    ``entry``'s axes, row-major."""
    index, n = 0, 1
    for a in _axes(entry):
        index = index * mesh.axis_size(a) + mesh.axis_index(a)
        n *= mesh.axis_size(a)
    return index, n


def shard_tensor(x: Tensor, spec, mesh) -> Tensor:
    """This rank's slice of ``x`` under ``spec`` (a copy, so the whole
    tensor can be freed; ``x`` itself when nothing is split)."""
    idx = []
    for d, entry in enumerate(spec):
        i, n = shard_index(mesh, entry)
        if n > 1 and x.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not split in {n}")
        m = x.shape[d] // n
        idx.append(slice(i * m, (i + 1) * m))
    if all(sl == slice(0, x.shape[d]) for d, sl in enumerate(idx)):
        return x
    return x[tuple(idx)].clone()


def gather_tensor(x: Tensor, spec, mesh) -> Tensor:
    """The whole tensor from every rank's slice under ``spec``."""
    for d, entry in enumerate(spec):
        for a in reversed(_axes(entry)):  # the minor axis first
            if mesh.axis_size(a) > 1:
                x = torch.cat(tuple(mesh.all_gather(x, a)), dim=d)
    return x


def zero1_shard_spec(spec, shape: Tuple[int, ...], dp_axes: Tuple[str, ...],
                     dp_size: int) -> Spec:
    """ZeRO-1, the JAX package's rule: an optimizer-state tensor is also
    split over the data axes ``dp_axes`` (of ``dp_size`` ranks together) on
    its first dimension that is not split yet and divides; ``spec`` as it
    is when none does."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, cur) in enumerate(zip(shape, entries)):
        if cur is None and dim % dp_size == 0 and dim > 0:
            entries[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            return Spec(*entries)
    return Spec(*spec)


def leaf_spec(specs, name: str, keep_layer: bool = False) -> "Spec":
    """The spec of the parameter ``name`` (``"layers.3.attn.wq"``) in a
    spec tree whose ``layers`` are stacked: the layer's entry is dropped
    (kept first with ``keep_layer``)."""
    node, stacked = specs, False
    for part in name.split("."):
        if part.isdigit():
            stacked = True
            continue
        node = node[part]
    if stacked and not keep_layer:
        if node[0] is not None:
            raise ValueError(f"{name}: a stacked spec {node} splits the layer axis")
        return Spec(*node[1:])
    return Spec(*node)


def _layer_kind(name: str) -> str:
    """``"layers.3.attn.wq"`` -> ``"layers.attn.wq"``."""
    return ".".join(p for p in name.split(".") if not p.isdigit())


class ZeroLayout:
    """Where this rank's ZeRO-1 slice of every parameter lies, from the
    spec trees ``specs`` (``train.step.shardings_for``: "params", "opt",
    "batch"; the reference's, ``layers`` stacked), for the parameter names
    ``names``. A parameter is

      * whole: its state is not split (gradients summed over the data
        axes);
      * split along one dimension of this rank's tensor-parallel tensor;
      * or one of a stack of layers whose layer axis is split: each data
        rank owns L/n whole layers, and holds state for those alone.

    ``reduce``, ``norms_sq`` and ``gather`` issue their collectives in the
    order of ``names``, the same on every rank, a stack of layers n layers
    at a time (n the ranks it splits over), so none holds a whole stack."""

    def __init__(self, names: Iterable[str], specs: Dict[str, Any], mesh):
        self.mesh = mesh
        self.dp_axes = _axes(specs["batch"]["inputs"][0])
        self.names: List[str] = list(names)
        self.dim: Dict[str, Optional[int]] = {}  # split dimension; -1: the layer axis
        self.axes: Dict[str, Tuple[str, ...]] = {}
        self.model: Dict[str, bool] = {}  # split over "model" (tensor parallel)
        self.groups: Dict[str, List[str]] = {}  # layer kind -> names by layer
        for name in self.names:
            ps = leaf_spec(specs["params"], name, keep_layer=True)
            os_ = leaf_spec(specs["opt"]["mu"], name, keep_layer=True)
            n = max(len(ps), len(os_))
            ps, os_ = tuple(ps) + (None,) * (n - len(ps)), tuple(os_) + (None,) * (n - len(os_))
            self.model[name] = any(MODEL_AX in _axes(e) for e in ps)
            diff = [i for i in range(n) if ps[i] != os_[i]]
            if not diff:
                self.dim[name], self.axes[name] = None, ()
                continue
            stacked = name.split(".")[0] == "layers"
            self.axes[name] = _axes(os_[diff[0]])
            self.dim[name] = -1 if stacked and diff[0] == 0 else diff[0] - stacked
            if self.dim[name] == -1:
                self.groups.setdefault(_layer_kind(name), []).append(name)

    def _chunks(self, name: str):
        """For the first layer of a stack whose layer axis is split: lists
        of n layers, the j-th of every rank's L/n in rank order (a chunk
        reduce-scatters onto, and gathers from, one layer a rank); else
        nothing."""
        if self.dim[name] != -1 or name != self.groups[_layer_kind(name)][0]:
            return []
        group = self.groups[_layer_kind(name)]
        n = shard_index(self.mesh, self.axes[name])[1]
        per = len(group) // n
        return [[group[r * per + j] for r in range(n)] for j in range(per)]

    def owns(self, name: str) -> bool:
        """Whether this rank holds state for ``name``."""
        if self.dim[name] != -1:
            return True
        group = self.groups[_layer_kind(name)]
        index, n = shard_index(self.mesh, self.axes[name])
        return group.index(name) // (len(group) // n) == index

    def slice(self, name: str, t: Tensor) -> Tensor:
        """This rank's ZeRO slice of ``t``, the rank's tensor-parallel
        parameter ``name`` (or a tensor of its shape): a view."""
        d = self.dim[name]
        if d is None or d == -1:
            return t
        index, n = shard_index(self.mesh, self.axes[name])
        m = t.shape[d] // n
        return t.narrow(d, index * m, m)

    def reduce(self, grads: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The gradients summed over the data axes, each rank keeping its
        slices: ordered ``psum_scatter``s along each split (for a split
        layer axis, of the stacked layers), ordered ``psum``s where the
        state is whole."""
        out: Dict[str, Tensor] = {}
        index = {}
        for name in self.names:
            d, g = self.dim[name], grads[name]
            if d is None:
                for a in self.dp_axes:
                    g = self.mesh.psum(g, a)
                out[name] = g
            elif d >= 0:
                for a in self.axes[name]:
                    g = self.mesh.psum_scatter(g, a, d)
                out[name] = g
            for chunk in self._chunks(name):
                g = torch.stack([grads[k] for k in chunk])
                for a in self.axes[name]:
                    g = self.mesh.psum_scatter(g, a, 0)
                index.setdefault(name, shard_index(self.mesh, self.axes[name])[0])
                out[chunk[index[name]]] = g[0]
        return out

    def norms_sq(self, slices: Dict[str, Tensor]) -> Tensor:
        """The squared norm of every leaf of the gradient whose ZeRO slices
        are ``slices``, a vector in ``names``' order (the same on every
        rank): each element counted once, the slices' sums of squares
        summed in axis order over the ZeRO axes, and over "model" for the
        tensor-parallel parameters."""
        device = next(iter(slices.values())).device
        zero = torch.zeros((), dtype=torch.float32, device=device)
        sq = torch.stack([slices[n].to(torch.float32).square().sum() if n in slices else zero
                          for n in self.names])
        flag = lambda f: torch.tensor([f(n) for n in self.names], device=device)  # noqa: E731
        split = flag(lambda n: self.dim[n] is not None)
        part = torch.where(split, sq, zero)
        for a in self.dp_axes:
            part = self.mesh.psum(part, a)
        sq = torch.where(split, part, sq)
        if MODEL_AX in self.mesh.shape:
            model = flag(lambda n: self.model[n])
            sq = torch.where(model, self.mesh.psum(torch.where(model, sq, zero), MODEL_AX), sq)
        return sq

    def gather(self, slices: Dict[str, Tensor]):
        """(name, this rank's whole tensor-parallel tensor) for every
        parameter, from every rank's ZeRO slices ``slices`` (state, or
        updated parameters), gathered over the ZeRO axes in ``names``'
        order; a split stack of layers n layers at a time."""
        for name in self.names:
            d = self.dim[name]
            if d is None:
                yield name, slices[name]
            elif d >= 0:
                yield name, gather_tensor(slices[name], Spec(*(None,) * d, self.axes[name]),
                                          self.mesh)
            for chunk in self._chunks(name):
                mine = next(slices[k] for k in chunk if k in slices).unsqueeze(0)
                yield from zip(chunk, gather_tensor(mine, Spec(self.axes[name]), self.mesh))

    def gather_into(self, params: Dict[str, Tensor], slices: Dict[str, Tensor]):
        """Every rank's updated slices (``slices``, in the parameters'
        dtypes) gathered over the ZeRO axes into ``params``, in place."""
        for name, whole in self.gather(slices):
            if whole is not params[name]:
                params[name].copy_(whole)


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"a.0.b": x}`` -> ``{"a": [{"b": x}]}``: dotted names as nested
    dicts, all-digit keys as lists."""
    root: Dict[str, Any] = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def shard_tree(model, specs, mesh) -> "ParamTree":
    """This rank's slice of every parameter of ``model`` (a ``ParamTree``)
    under the spec tree ``specs``, as a ``ParamTree`` of the same names."""
    return ParamTree(unflatten({name: shard_tensor(p.detach(), leaf_spec(specs, name), mesh)
                                for name, p in model.named_parameters()}))


def gather_tree(model, specs, mesh) -> "ParamTree":
    """The inverse of ``shard_tree``: every parameter whole, on every rank."""
    return ParamTree(unflatten({name: gather_tensor(p.detach(), leaf_spec(specs, name), mesh)
                                for name, p in model.named_parameters()}))


def tree_specs_like(params, spec_fn: Callable[[str, Tensor], Spec]) -> Dict[str, Any]:
    """The spec tree of ``params`` (a ``ParamTree`` or nested dict/list):
    ``spec_fn(name, tensor)`` for every leaf, named by its dotted path."""
    def walk(node, path):
        if isinstance(node, torch.Tensor):
            return spec_fn(path, node)
        if isinstance(node, (list, tuple, nn.ModuleList)):
            return [walk(v, f"{path}.{i}") for i, v in enumerate(node)]
        return {k: walk(v, f"{path}.{k}" if path else k) for k, v in node.items()}

    return walk(params, "")



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
