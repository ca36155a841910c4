"""Hierarchical data parallelism with compressed inter-cluster gradients.

The JAX package's ``repro.runtime.hierarchical``: one model replica per
cluster, clusters joined by a slow link, and only error-feedback top-k
compressed gradients (``optim.compress``) cross it; every cluster applies
the same summed update, so the replicas stay bit-identical without dense
gradients ever moving between clusters.

As in the reference, the "clusters" here are distinct replicas (states)
on the same device, and the exchange is the sum of what would cross the
link: per reference leaf either every cluster's (values, indices), or its
dense gradient when the leaf is under ``min_size``, summed in cluster
order. ``wire_bytes`` counts what (num_clusters − 1) peers would receive:
8 B an entry (f32 value, i32 index), 4 B a dense entry.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..optim import adamw, compress
from ..train.step import value_and_grad

Tensor = torch.Tensor


@dataclasses.dataclass
class ClusterState:
    params: Any
    opt: Any
    err: Any  # error-feedback residual (compress.init_error_state)


class CrossClusterDP:
    """num_clusters model replicas; inter-cluster grads are EF-top-k sparse."""

    def __init__(
        self,
        loss_fn: Callable[[Any, Any], Tensor],  # (params, batch) -> scalar
        opt_cfg: adamw.AdamWConfig,
        comp_cfg: compress.CompressConfig,
        num_clusters: int = 2,
    ):
        self.loss_fn = loss_fn
        self.opt_cfg = opt_cfg
        self.comp_cfg = comp_cfg
        self.num_clusters = num_clusters

    def init(self, params) -> List[ClusterState]:
        return [
            ClusterState(
                params=copy.deepcopy(params),
                opt=adamw.init_opt_state(params),
                err=compress.init_error_state(params),
            )
            for _ in range(self.num_clusters)
        ]

    def step(
        self, states: List[ClusterState], batches: List[Any]
    ) -> Tuple[List[ClusterState], Dict[str, float]]:
        """One global step: local grads -> compress -> exchange -> sum ->
        identical update on every cluster."""
        if len(batches) != self.num_clusters:
            raise ValueError(f"{len(batches)} batches for {self.num_clusters} clusters")
        losses, compressed, errs = [], [], []
        groups = None
        for st, batch in zip(states, batches):
            loss, grads = value_and_grad(self.loss_fn, st.params, batch)
            losses.append(float(loss))
            (groups, reps), new_err = compress.compress_tree(grads, st.err, self.comp_cfg)
            compressed.append(reps)
            errs.append(new_err)
        # the slow-link exchange: only (vals, idx) pairs cross clusters
        wire_bytes = 0
        summed = []
        for li in range(len(compressed[0])):
            kinds = {c[li][0] for c in compressed}
            if len(kinds) != 1:
                raise RuntimeError(f"leaf {groups[li][0]}: clusters disagree on {kinds}")
            if kinds.pop() == "dense":
                total = sum(c[li][1].to(torch.float32) for c in compressed)
                wire_bytes += (self.num_clusters - 1) * compressed[0][li][1].numel() * 4
            else:
                shape = compressed[0][li][1][2]
                total = sum(compress.decompress(c[li][1][0], c[li][1][1], shape)
                            for c in compressed)
                k = int(compressed[0][li][1][0].shape[0])
                wire_bytes += (self.num_clusters - 1) * k * 8  # f32 val + i32 idx
            summed.append(total / self.num_clusters)
        g_sum = compress.unstack(groups, summed)
        new_states = []
        metrics_last = {}
        for st, err in zip(states, errs):
            p, o, m = adamw.apply_updates(st.params, g_sum, st.opt, self.opt_cfg)
            new_states.append(ClusterState(params=p, opt=o, err=err))
            metrics_last = m
        return new_states, {
            "loss": float(np.mean(losses)),
            "wire_bytes": float(wire_bytes),
            "grad_norm": float(metrics_last.get("grad_norm", 0.0)),
        }
