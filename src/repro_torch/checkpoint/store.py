"""Checkpoint store: atomic step directories with content-hashed leaves.

Layout:  <dir>/step_<N>/
           manifest.json      — step, user meta, leaves (shape, dtype,
                                content hash)
           arrays.npz         — one entry per leaf, on the host

The format is the JAX package's (``repro.checkpoint.store``), so a
checkpoint written by either package reads in the other:

  * a state is a dict of tensors or arrays (nested dicts and lists allowed);
    its leaf names are ``jax.tree_util.keystr``'s — ``['A_rows']`` for a
    top-level key, ``['a']['b']`` for a nested one, ``[0]`` for a list
    index — with dict keys in sorted order; npz member names replace ``/``
    by ``\\x00``;
  * each leaf records the first 16 hex characters of the sha256 of its
    bytes, and every read verifies them: a truncated or altered file is
    refused with ``IOError`` (a real failure mode at scale);
  * a write goes to ``step_<N>.tmp`` and is renamed into place, so a kill
    mid-write never corrupts the newest complete checkpoint; stale
    ``.tmp`` leftovers are swept by the next ``latest_step``;
  * a free-form JSON ``meta`` dict rides in the manifest — the iterated
    SpGEMM loops store their plan signature there (see
    ``runtime/resilient.py``);
  * ``AsyncCheckpointer`` copies the state to fresh host memory on the
    caller's thread and writes it on a worker thread, overlapping the next
    multiply; it counts stall time and bytes written for the ``RunReport``.

``restore`` puts the leaves on the device the caller gives (by default the
template's), whatever device wrote them, in the template's dtype. numpy has
no bfloat16, so a bfloat16 leaf is written as float32 (exactly: every
bfloat16 is a float32) and ``restore`` casts it back.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


def _step_of(name: str) -> Optional[int]:
    """Step number of a checkpoint dir entry, or None for foreign entries
    (``step_00000003.bak``, editor droppings, ``.tmp`` from a mid-write
    kill), which a naive ``int(d.split("_")[1])`` would crash on."""
    m = _STEP_RE.match(name)
    return int(m.group(1)) if m else None


def sweep_stale_tmp(path: str) -> int:
    """Remove ``step_*.tmp`` leftovers from a mid-write kill. Safe under the
    store's rule of one writer per directory (``AsyncCheckpointer`` keeps
    at most one save in flight). Returns the number swept."""
    if not os.path.isdir(path):
        return 0
    swept = 0
    for d in os.listdir(path):
        if d.endswith(".tmp") and _step_of(d[: -len(".tmp")]) is not None:
            try:
                shutil.rmtree(os.path.join(path, d))
                swept += 1
            except FileNotFoundError:
                pass  # vanished between list and rmtree — already gone
    return swept


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{keystr path: leaf}`` of a dict/list tree, in the JAX package's
    order (dict keys sorted, list items in order)."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, x in enumerate(tree):
            out.update(_flatten(x, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _unflatten(like, leaves: Dict[str, Any], prefix: str = ""):
    """``like``'s structure with every leaf replaced from ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}[{k!r}]") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves, f"{prefix}[{i}]") for i, x in enumerate(like))
    return leaves[prefix]


def _host_copy(x) -> np.ndarray:
    """A fresh host copy of a leaf: a tensor is copied off its device
    (blocking), a bfloat16 one widened to float32 on the host, an array or
    scalar copied, so later writes to ``x`` never reach the copy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x, copy=True)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _write(path: str, step: int, arrays: Dict[str, np.ndarray],
           meta: Optional[Dict[str, Any]]) -> str:
    """Write host arrays (``{keystr: ndarray}``) as step ``step``."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "meta": meta or {},
        "leaves": {
            k: {"shape": list(a.shape), "dtype": str(a.dtype), "hash": _digest(a)}
            for k, a in arrays.items()
        },
    }
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k.replace("/", "\x00"): a for k, a in arrays.items()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(
    path: str, step: int, state: Dict[str, Any],
    meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Synchronous checkpoint write of a dict of tensors or arrays. Returns
    the final directory. ``meta`` is any JSON-serializable dict, stored in
    the manifest and read back by ``load_meta``; it never touches the array
    payload."""
    return _write(path, step, {k: _host_copy(v) for k, v in _flatten(state).items()}, meta)


def dir_nbytes(d: str) -> int:
    """Total bytes of one checkpoint directory (manifest + arrays)."""
    try:
        return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    except OSError:
        return 0


def steps_available(path: str) -> List[int]:
    """Sorted complete checkpoint steps (foreign entries and .tmp ignored)."""
    if not os.path.isdir(path):
        return []
    return sorted(s for d in os.listdir(path) if (s := _step_of(d)) is not None)


def latest_step(path: str) -> Optional[int]:
    sweep_stale_tmp(path)
    steps = steps_available(path)
    return steps[-1] if steps else None


def _read_verified(d: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Load one checkpoint dir, verifying every leaf hash. Any corruption —
    an unreadable or truncated archive, a missing leaf, a hash mismatch —
    surfaces as IOError, so callers have one refusal channel."""
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        # the file is opened here so that it closes when np.load fails
        with open(os.path.join(d, "arrays.npz"), "rb") as fh, np.load(fh) as z:
            arrays = {k.replace("\x00", "/"): z[k] for k in z.files}
    except IOError:
        raise
    except Exception as e:  # truncated zip, bad JSON, missing member ...
        raise IOError(f"checkpoint unreadable: {d}: {e}") from e
    for k, leaf in manifest["leaves"].items():
        if k not in arrays:
            raise IOError(f"checkpoint corruption: {k} missing from arrays")
        if _digest(arrays[k]) != leaf["hash"]:
            raise IOError(f"checkpoint corruption: {k} hash mismatch")
    return arrays, manifest


def load_meta(path: str, step: int) -> Dict[str, Any]:
    """The ``meta`` dict stored with ``save`` (the plan signature et al.)."""
    d = os.path.join(path, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f).get("meta", {})
    except IOError:
        raise
    except Exception as e:
        raise IOError(f"checkpoint manifest unreadable: {d}: {e}") from e


def restore_arrays(path: str, step: int) -> Dict[str, np.ndarray]:
    """Hash-verified flat leaf dict keyed by keystr paths, on the host: for
    callers that rebuild typed state themselves (the resilient loops)."""
    arrays, _ = _read_verified(os.path.join(path, f"step_{step:08d}"))
    return arrays


def restore(
    path: str, step: int, like: Dict[str, Any], device=None,
) -> Dict[str, Any]:
    """Restore into the structure of ``like`` (a dict of tensors): every
    leaf becomes a tensor on ``device``, by default the template leaf's, in
    the template leaf's dtype. The saved layout is irrelevant; names and
    shapes must match."""
    arrays, _ = _read_verified(os.path.join(path, f"step_{step:08d}"))
    flat_like = _flatten(like)
    if set(flat_like) != set(arrays):
        missing = set(flat_like) ^ set(arrays)
        raise KeyError(f"checkpoint tree mismatch: {sorted(missing)[:5]} ...")
    out = {}
    for k, template in flat_like.items():
        a = arrays[k]
        if tuple(a.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint leaf {k}: shape {a.shape}, template "
                             f"{tuple(template.shape)}")
        dev = device if device is not None else getattr(template, "device", "cpu")
        dtype = template.dtype if isinstance(template, torch.Tensor) else None
        out[k] = torch.from_numpy(a).to(dev, dtype)
    return _unflatten(like, out)


class AsyncCheckpointer:
    """Threaded save with back-pressure: at most one write in flight.

    ``save`` copies the state (and its meta) to fresh host memory on the
    caller's thread (blocking device-to-host copies, so the snapshot is the
    state as of the call), then hashes and writes it on a worker thread that touches only
    numpy. Accounting for the ``RunReport``: ``stalls``/``stall_s`` count
    saves that blocked on the previous in-flight write, ``bytes_written``
    totals finished checkpoints. A failed background write surfaces on the
    next ``save``/``wait``.
    """

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_saved: Optional[int] = None
        self.stalls = 0
        self.stall_s = 0.0
        self.bytes_written = 0
        sweep_stale_tmp(path)

    def save(self, step: int, state, meta: Optional[Dict[str, Any]] = None):
        if self._thread is not None and self._thread.is_alive():
            self.stalls += 1
        t0 = time.perf_counter()
        self.wait()
        self.stall_s += time.perf_counter() - t0
        # snapshot now: the arrays, and the meta, whose lists (a loop's
        # history) the caller goes on appending to
        host = {k: _host_copy(v) for k, v in _flatten(state).items()}
        meta = json.loads(json.dumps(meta or {}))

        def work():
            try:
                self._landed(step, _write(self.path, step, host, meta))
            except BaseException as e:  # surfaces on the next save/wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, step: int, state, meta: Optional[Dict[str, Any]] = None):
        """Blocking save through the same accounting and GC as ``save``."""
        self.wait()
        final = save(self.path, step, state, meta=meta)
        self._landed(step, final)
        return final

    def _landed(self, step: int, final: str) -> None:
        self.bytes_written += dir_nbytes(final)
        self.last_saved = step
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self):
        try:
            entries = os.listdir(self.path)
        except FileNotFoundError:
            return  # the whole dir vanished (external cleanup): nothing to do
        steps = sorted(s for d in entries if (s := _step_of(d)) is not None)
        for s in steps[: -self.keep] if self.keep > 0 else steps:
            try:
                shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"))
            except FileNotFoundError:
                pass  # vanished between list and rmtree — already gone
