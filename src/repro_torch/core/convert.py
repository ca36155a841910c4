"""Carrying state into and out of the port.

  * ``from_reference`` — any object with array fields ``rows``/``cols``/
    ``vals``/``nnz`` and a ``shape`` (numpy arrays, or the JAX package's
    ``SparseCOO``/``DistSparse``, whose fields convert with ``np.asarray``)
    becomes the port's ``SparseCOO`` — or ``DistSparse`` when it also has
    ``tile_shape``/``grid_shape``/``kind`` — with the same padding.
  * ``to_numpy`` — the exact padded state of a port object as numpy arrays.
  * ``triplets`` — the live (rows, cols, vals) of a port ``SparseCOO``.
  * ``batch_to_global`` — one C batch of the driver in global coordinates,
    on the batch's device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .distsparse import DistSparse
from .sparse import SparseCOO

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
    """One C batch (kind "C", tiles (tm, wb/l)) in global coordinates:
    (rows i64, cols i64, vals) of its live entries, on the batch's device.
    ``col_map`` is the driver's ``batch_column_map`` for the batch."""
    tm, _ = c.tile_shape
    cap = c.cap
    valid = torch.arange(cap, device=c.device) < c.nnz[..., None]
    i, j, k, s = torch.nonzero(valid, as_tuple=True)
    cmap = torch.as_tensor(col_map, dtype=torch.int64, device=c.device)
    rows = i * tm + c.rows[i, j, k, s].long()
    cols = cmap[j, k, c.cols[i, j, k, s].long()]
    return rows, cols, c.vals[i, j, k, s]
