"""Carrying state into and out of the port.

  * ``from_reference`` — any object with array fields ``rows``/``cols``/
    ``vals``/``nnz`` and a ``shape`` (numpy arrays, or the JAX package's
    ``SparseCOO``/``DistSparse``, whose fields convert with ``np.asarray``)
    becomes the port's ``SparseCOO`` — or ``DistSparse`` when it also has
    ``tile_shape``/``grid_shape``/``kind`` — with the same padding.
  * ``to_numpy`` — the exact padded state of a port object as numpy arrays.
  * ``triplets`` — the live (rows, cols, vals) of a port ``SparseCOO``.
  * ``batch_to_global`` — this process's tile of one C batch of the driver
    in global coordinates, on the batch's device.
  * ``iterate_from_reference`` — an MCL iterate of the JAX package (its
    ``MCLLoopState``: the A/B operands, iteration, chaos, plan floors and
    pinned binned and local-path decisions) as the fields of the port's ``MCLLoopState``, so
    both loops can go on from the same iterate.
  * ``lm_params_from_reference`` — the JAX package's LM parameter tree (as
    numpy arrays) as the port's model, its stacked layers unstacked; with
    ``master=True`` in f32 (the training model), else ndim > 1 in the
    compute dtype (the serving model); with ``mesh``, this rank's slices.
  * ``opt_state_from_reference`` — the JAX package's AdamW state (mu, nu,
    count, and master with ``master_in_opt``) as the port's, its trees
    unstacked in the same way, so both packages train on from one state;
    with ``mesh``, this rank's ZeRO-1 slices.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models import transformer
from ..models.common import MODEL_AX, ParamTree, ZeroLayout, leaf_spec, shard_tensor, unflatten
from .distsparse import DistSparse
from .sparse import SparseCOO
from .specs import PlanFloors

Tensor = torch.Tensor


def _tensor(x, dtype, device) -> Tensor:
    return torch.as_tensor(np.array(x, copy=True), dtype=dtype, device=device)


def from_reference(x, device="cuda"):
    """The port's ``SparseCOO`` or ``DistSparse`` holding ``x``'s padded
    fields unchanged (see the module docstring)."""
    fields = (
        _tensor(x.rows, torch.int32, device),
        _tensor(x.cols, torch.int32, device),
        torch.as_tensor(np.array(x.vals, copy=True), device=device),
        _tensor(x.nnz, torch.int32, device),
    )
    shape = tuple(int(s) for s in x.shape)
    if hasattr(x, "tile_shape"):
        return DistSparse(
            *fields, shape=shape, tile_shape=tuple(int(s) for s in x.tile_shape),
            grid_shape=tuple(int(s) for s in x.grid_shape), kind=x.kind,
        )
    return SparseCOO(*fields, shape=shape)


def to_numpy(x) -> Dict[str, np.ndarray]:
    """Padded fields of a port ``SparseCOO``/``DistSparse`` as numpy arrays."""
    return {k: getattr(x, k).detach().cpu().numpy() for k in ("rows", "cols", "vals", "nnz")}


def triplets(c: SparseCOO) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Live (rows, cols, vals) of ``c`` on the host."""
    nnz = int(c.nnz)
    f = to_numpy(c)
    return f["rows"][:nnz], f["cols"][:nnz], f["vals"][:nnz]


def batch_to_global(c: DistSparse, col_map: np.ndarray) -> Tuple[Tensor, Tensor, Tensor]:
    """This process's tile of one C batch (kind "C", tiles (tm, wb/l)) in
    global coordinates: (rows i64, cols i64, vals) of its live entries, on
    the batch's device.
    ``col_map`` is the driver's ``batch_column_map`` for the batch."""
    tm, _ = c.tile_shape
    i, j, k = c.coords
    t = c.local(i, j, k)
    live = t.valid_mask()
    cmap = torch.as_tensor(col_map[j, k], dtype=torch.int64, device=c.device)
    return i * tm + t.rows[live].long(), cmap[t.cols[live].long()], t.vals[live]


def iterate_from_reference(state, device="cuda") -> dict:
    """Fields of the port's ``sparse_apps.mcl.MCLLoopState`` holding the
    reference state's iterate: ``A``/``B`` (padded tiles unchanged), ``it``,
    ``chaos``, ``floors`` (through ``PlanFloors.to_meta``), ``binned_arg``
    and ``lp_arg``. The history and the run report start empty."""
    return {
        "A": from_reference(state.A, device),
        "B": from_reference(state.B, device),
        "it": int(state.it),
        "chaos": float(state.chaos),
        "floors": PlanFloors.from_meta(state.floors.to_meta()),
        "binned_arg": state.binned_arg,
        "lp_arg": state.lp_arg,
    }


def _unstacked(cfg: transformer.ModelConfig, params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``{port parameter name: array}`` of a JAX LM parameter tree (or a
    tree of its shape, such as AdamW's moments) for ``cfg``: every
    ``layers`` leaf's leading axis unstacked into ``layers.<i>.<rest>``.
    Raises ``ValueError`` on a leaf the model has no place for, a leaf it
    needs that is missing, or a shape that differs."""
    flat: Dict[str, np.ndarray] = {}

    def walk(path, node):
        if isinstance(node, dict):
            for name, child in node.items():
                walk(path + (str(name),), child)
        elif path[0] == "layers":
            arr = np.asarray(node)
            for i in range(arr.shape[0]):
                flat[".".join(("layers", str(i)) + path[1:])] = arr[i]
        else:
            flat[".".join(path)] = np.asarray(node)

    walk((), params)
    model = transformer.init_params(cfg, None, "meta")
    want = {name: tuple(p.shape) for name, p in model.named_parameters()}
    missing, extra = sorted(want.keys() - flat.keys()), sorted(flat.keys() - want.keys())
    shapes = [f"{k}: {flat[k].shape} for {want[k]}" for k in sorted(want.keys() & flat.keys())
              if tuple(flat[k].shape) != want[k]]
    if missing or extra or shapes:
        raise ValueError(f"{cfg.arch_id}: parameters missing {missing}, not consumed "
                         f"{extra}, of another shape {shapes}")
    return {name: flat[name] for name in want}  # the model's order


def lm_params_from_reference(cfg: transformer.ModelConfig, params: Dict[str, Any],
                             device="cuda", master: bool = False,
                             mesh=None) -> transformer.ParamTree:
    """The port's model (``models.transformer``) holding the JAX package's
    parameters ``params`` (its nested dict, leaves as numpy arrays or
    anything ``np.asarray`` takes) for ``cfg``.

    The leading layer axis of every ``layers`` leaf is unstacked into one
    entry a layer; ``shared_block``, ``moe.shared``, a tied head (no
    ``lm_head``) and an ``"embeds"`` model (no ``embed``) carry over as they
    are. Leaves with ndim > 1 (per layer) go to the compute dtype, or stay
    f32 with ``master`` (the JAX package's f32 masters, cast at use), the
    rest stay f32. Raises ``ValueError`` as ``_unstacked`` does. With
    ``mesh`` (``launch.mesh``): this rank's slice of every leaf under
    ``transformer.param_specs(cfg, tp)``, cut on the host, so only the
    slices reach ``device``."""
    flat = _unstacked(cfg, params)
    cd = torch.float32 if master else cfg.compute_dtype
    specs = transformer.param_specs(cfg, mesh.shape.get(MODEL_AX, 1)) if mesh is not None else None

    def leaf(name, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
        if specs is not None:
            t = shard_tensor(t, leaf_spec(specs, name), mesh)
        return t.to(device, cd if a.ndim > 1 else torch.float32)

    return ParamTree(unflatten({name: leaf(name, a) for name, a in flat.items()}))


def opt_state_from_reference(cfg: transformer.ModelConfig, state: Dict[str, Any],
                             device="cuda", mesh=None, specs=None) -> Dict[str, Any]:
    """The port's AdamW state (``optim.adamw``) holding the JAX package's
    ``state`` for ``cfg``'s parameters: mu, nu (and master, when present)
    unstacked as ``lm_params_from_reference`` unstacks the parameters, in
    f32, and count as an int32 scalar. With ``mesh`` and ``specs``
    (``train.step.shardings_for``'s spec trees): this rank's ZeRO-1 slices
    (``models.common.ZeroLayout``) of its tensor-parallel slices, cut on the host."""
    layout = None
    if mesh is not None:
        names = [n for n, _ in transformer.init_params(cfg, None, "meta").named_parameters()]
        layout = ZeroLayout(names, specs, mesh)

    def leaf(name, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
        if layout is not None:
            t = layout.slice(name, shard_tensor(t, leaf_spec(specs["params"], name), mesh))
        return t.contiguous().to(device, copy=True)

    out = {key: {k: leaf(k, v) for k, v in _unstacked(cfg, state[key]).items()
                 if layout is None or layout.owns(k)}
           for key in ("mu", "nu", "master") if key in state}
    out["count"] = torch.tensor(int(np.asarray(state["count"])), dtype=torch.int32,
                                device=device)
    return out
