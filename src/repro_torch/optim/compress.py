"""Top-k sparsified gradient exchange with error feedback.

The JAX package's ``repro.optim.compress``: before the data-parallel
exchange each large gradient keeps only its top-k magnitude entries (per
replica), the rest accumulates in a local residual (error feedback, as in
Deep Gradient Compression), and the entries travel as (values, flat
indices), a padded COO vector.

Two things keep the port's picks the reference's:
  * the JAX package stacks a model's layers on a leading axis, so each of
    its ``layers`` leaves is (L, ...): top-k runs over all layers together
    (k = ⌊L·size·density⌋) and ``min_size`` is tested on the stacked size.
    The port's trees hold a tensor a layer (``layers.<i>.<rest>``), so
    ``compress_tree`` compresses the ``torch.stack`` of the layers and
    ``reference_leaves`` orders the stacks as ``jax.tree.leaves`` does
    (dict keys sorted at every level);
  * ``lax.top_k`` breaks ties toward the lower index, and gradients hold
    many exact zeros; ``torch.topk`` promises no order among ties, so the
    top k are the head of a stable descending sort.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from .adamw import named

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    density: float = 0.01  # fraction of entries kept
    min_size: int = 4096  # tensors smaller than this are sent dense


def init_error_state(params) -> Dict[str, Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named(params).items()}


def compress_grad(g: Tensor, err: Tensor, cfg: CompressConfig) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (values (k,), flat indices (k,) int32, new error residual)."""
    flat = g.to(torch.float32).reshape(-1) + err.reshape(-1)
    k = max(int(flat.shape[0] * cfg.density), 1)
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    sel = flat[idx]
    resid = flat.clone()
    resid[idx] = 0.0
    return sel, idx.to(torch.int32), resid.reshape(g.shape)


def decompress(vals: Tensor, idx: Tensor, shape) -> Tensor:
    size = 1
    for s in shape:
        size *= s
    out = torch.zeros((size,), dtype=torch.float32, device=vals.device)
    return out.index_add_(0, idx.long(), vals.to(torch.float32)).reshape(shape)


def reference_leaves(names) -> List[Tuple[str, List[str]]]:
    """The JAX package's leaves of a tree with these names, in
    ``jax.tree.leaves`` order: (its dotted path, the port's names it
    stacks, layer by layer). ``layers.<i>.<rest>`` is layer i of leaf
    ``layers.<rest>``; every other name is a leaf of its own."""
    groups: Dict[Tuple[str, ...], List[Tuple[int, str]]] = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "layers":
            groups.setdefault(("layers",) + tuple(parts[2:]), []).append((int(parts[1]), name))
        else:
            groups.setdefault(tuple(parts), []).append((0, name))
    return [(".".join(key), [n for _, n in sorted(groups[key])]) for key in sorted(groups)]


def _stacked(tree: Dict[str, Tensor], path: str, members: List[str]) -> Tensor:
    if path.startswith("layers."):
        return torch.stack([tree[n] for n in members])
    return tree[members[0]]


def unstack(groups, leaves: List[Tensor]) -> Dict[str, Tensor]:
    """The port's tree of ``leaves`` (one a reference leaf, in ``groups``'
    order): a stacked leaf split into its layers."""
    out = {}
    for (path, members), leaf in zip(groups, leaves):
        if path.startswith("layers."):
            out.update(zip(members, leaf.unbind(0)))
        else:
            out[members[0]] = leaf
    return out


def compress_tree(grads, err_state: Dict[str, Tensor], cfg: CompressConfig):
    """EF-top-k on every reference leaf of at least ``min_size`` entries.
    Returns ((groups, reps), new error state): a rep is ("dense", the
    stacked gradient) or ("topk", (values, indices, stacked shape))."""
    grads = named(grads)
    groups = reference_leaves(grads)
    reps, new_errs = [], []
    for path, members in groups:
        g = _stacked(grads, path, members)
        e = _stacked(err_state, path, members)
        if g.numel() < cfg.min_size:
            reps.append(("dense", g))
            new_errs.append(e)
        else:
            v, i, r = compress_grad(g, e, cfg)
            reps.append(("topk", (v, i, tuple(g.shape))))
            new_errs.append(r)
    return (groups, reps), unstack(groups, new_errs)


def decompress_tree(compressed) -> Dict[str, Tensor]:
    groups, reps = compressed
    outs = []
    for kind, payload in reps:
        if kind == "dense":
            outs.append(payload)
        else:
            v, i, shape = payload
            outs.append(decompress(v, i, shape))
    return unstack(groups, outs)


def compression_ratio(grads, cfg: CompressConfig) -> float:
    """Bytes after / bytes before (for the comm-model benchmark), over the
    reference's (stacked) leaves."""
    grads = named(grads)
    sizes = [sum(grads[n].numel() for n in members)
             for _, members in reference_leaves(grads)]
    kept = sum(s if s < cfg.min_size else 2 * max(int(s * cfg.density), 1) for s in sizes)
    return kept / sum(sizes)
