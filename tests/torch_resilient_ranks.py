"""Spawned ranks of ``tests/test_torch_resilient.py``'s grid case (no JAX:
the ranks import this module by name, and it imports only the port).

``mcl_rank`` runs, on one rank of a multi-process grid, the sparse MCL
device loop uninterrupted, then under ``mcl_iterate_resilient`` twice:
preempted mid-iteration by the injector (the same batch on every rank),
and with a SIGTERM sent to rank ``sigterm_rank`` only, from inside its
consumer. Returns per run the final triplets, the (nnz, chaos)
trajectory, the run report's restarts and refusals, and the iteration each
restore resumed from; rank 0 also returns the shapes of the newest
checkpoint's leaves.
"""
import logging
import os
import signal

import numpy as np

from repro_torch.checkpoint import store
from repro_torch.core import convert
from repro_torch.core.batched import RunReport
from repro_torch.core.sparse import from_numpy_coo
from repro_torch.runtime.resilient import (
    ResilientConfig,
    SpgemmFailureInjector,
    clear_preemption,
    install_preemption_handler,
)
from repro_torch.sparse_apps import mcl


class _Restores(logging.Handler):
    """Notes the iteration of every restore the resilient loop logs."""

    def __init__(self):
        super().__init__()
        self.steps = []

    def emit(self, record):
        if record.getMessage().startswith("restored checkpoint at iteration"):
            self.steps.append(int(record.args[0]))


class _SigtermOnRank(SpgemmFailureInjector):
    """Sends this process a SIGTERM when its consumer reaches ``at``
    (iteration, batch), on one rank of the grid only."""

    def __init__(self, armed, at):
        super().__init__()
        self.armed, self.at = armed, at

    def maybe_straggle_batch(self, it, batch):
        if self.armed and (it, batch) == self.at:
            self.armed = False
            os.kill(os.getpid(), signal.SIGTERM)


def _record(final, hist, rep, restores):
    r, c, v = convert.triplets(final)
    return {"triplets": (r.tolist(), c.tolist(), v.view(np.int32).tolist()),
            "traj": [(h["nnz"], h["chaos"]) for h in hist],
            "restarts": rep.restarts, "refused": rep.refused_restores,
            "restored_from": list(restores)}


def mcl_rank(grid, coo, n, cfg_kw, ckpt_root, preempt, sigterm_rank, sigterm_at):
    a = from_numpy_coo(*coo, (n, n), cap=len(coo[0]), device=grid.device)
    cfg = mcl.MCLConfig(**cfg_kw)
    handler = _Restores()
    logger = logging.getLogger("repro_torch.runtime.resilient")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    out = {}
    try:
        final, hist = mcl.mcl_iterate(a, grid, cfg)
        out["plain"] = _record(final, hist, RunReport(), [])
        for label, inj in (
            ("preempted", SpgemmFailureInjector(preempt_iters=(preempt[0],),
                                                preempt_batch=preempt[1])),
            ("sigterm", _SigtermOnRank(grid.rank == sigterm_rank, sigterm_at)),
        ):
            if label == "sigterm":
                install_preemption_handler()
                clear_preemption()
            handler.steps.clear()
            rc = ResilientConfig(ckpt_dir=os.path.join(ckpt_root, label), ckpt_every=1)
            final, hist, rep = mcl.mcl_iterate_resilient(a, grid, cfg, rc, injector=inj)
            out[label] = _record(final, hist, rep, handler.steps)
    finally:
        logger.removeHandler(handler)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    if grid.rank == 0:
        path = os.path.join(ckpt_root, "preempted")
        arrays = store.restore_arrays(path, store.latest_step(path))
        out["leaf_shapes"] = {k: tuple(x.shape) for k, x in arrays.items()}
    return out
