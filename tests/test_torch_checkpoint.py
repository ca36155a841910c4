"""The port's checkpoint store (``repro_torch.checkpoint.store``): its
durability contract on its own, and its on-disk format against the JAX
package's store (``repro.checkpoint.store``).

  * contract: atomic rename and the stale ``.tmp`` sweep, foreign entries
    ignored, every corruption (truncation, altered bytes, a missing leaf)
    refused with IOError (also by ``LeafReader``, which reads a leaf at a
    time), keep-N GC, the async writer's accounting, its snapshot and its
    error surfacing;
  * format: the same arrays saved by both stores give equal manifests
    (leaf names, shapes, dtypes, hashes, meta), and each package's
    ``restore_arrays`` and ``restore`` read the other's checkpoint, bit
    for bit.
"""
import json
import os
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro_torch.checkpoint import store


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.random((8, 4), np.float32)),
        "step": torch.tensor(seed, dtype=torch.int32),
    }


def _numpy_states():
    """Named states of numpy leaves, in the shapes the loops checkpoint."""
    rng = np.random.default_rng(7)
    return {
        "flat": {
            "A_rows": rng.integers(0, 9, (1, 1, 1, 16)).astype(np.int32),
            "A_vals": rng.random((1, 1, 1, 16)).astype(np.float32),
            "A_nnz": np.array(11, np.int32).reshape(1, 1, 1),
            "x": rng.random(3),
        },
        "nested": {"b": {"y": np.arange(4, dtype=np.int64), "x": np.float32(2.5)},
                   "a": rng.random((2, 3)).astype(np.float32)},
        "list": {"l": [np.arange(3, dtype=np.int32), np.ones((2, 2), np.float32)]},
    }


def _read_manifest(path, step):
    with open(os.path.join(path, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the store's contract
# ---------------------------------------------------------------------------
def test_step_of_foreign_entries():
    assert store._step_of("step_00000003") == 3
    assert store._step_of("step_0001.bak") is None
    assert store._step_of("step_") is None
    assert store._step_of("step_12.tmp") is None
    assert store._step_of("notes.txt") is None


def test_latest_step_ignores_foreign_entries(tmp_path):
    store.save(str(tmp_path), 4, _state())
    os.makedirs(tmp_path / "step_00000004.bak")
    (tmp_path / "step_readme").write_text("junk")
    (tmp_path / "other_7").write_text("junk")
    assert store.latest_step(str(tmp_path)) == 4
    assert store.steps_available(str(tmp_path)) == [4]
    assert store.latest_step(str(tmp_path / "nope")) is None


def test_sweep_stale_tmp(tmp_path):
    store.save(str(tmp_path), 2, _state())
    stale = tmp_path / "step_00000005.tmp"
    os.makedirs(stale)
    (stale / "arrays.npz").write_bytes(b"partial write")
    assert store.sweep_stale_tmp(str(tmp_path)) == 1
    assert not stale.exists()
    assert store.latest_step(str(tmp_path)) == 2


def test_kill_between_write_and_rename(tmp_path, monkeypatch):
    """A kill after the temp-dir write but before the rename leaves the
    previous checkpoint whole and only a .tmp leftover."""
    store.save(str(tmp_path), 1, _state(1))

    def boom(src, dst):
        raise OSError("killed before rename")

    monkeypatch.setattr(os, "rename", boom)
    with pytest.raises(OSError):
        store.save(str(tmp_path), 2, _state(2))
    monkeypatch.undo()
    assert (tmp_path / "step_00000002.tmp").exists()
    assert store.latest_step(str(tmp_path)) == 1  # sweeps the leftover
    assert not (tmp_path / "step_00000002.tmp").exists()
    back = store.restore(str(tmp_path), 1, _state(0))
    assert torch.equal(back["w"], _state(1)["w"])


def _flip_a_bit(d):
    with np.load(d / "arrays.npz") as z:
        arrays = {k: z[k].copy() for k in z.files}
    key = [k for k in arrays if "w" in k][0]
    arrays[key][0, 0] += 1.0  # silent bit-flip
    np.savez(d / "arrays.npz", **arrays)


def _truncate(d):
    p = d / "arrays.npz"
    size = os.path.getsize(p)
    with open(p, "r+b") as f:
        f.truncate(size // 2)


def _drop_leaf(d):
    with np.load(d / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files if "w" not in k}
    np.savez(d / "arrays.npz", **arrays)


@pytest.mark.parametrize("damage,match", [
    (_flip_a_bit, "hash mismatch"), (_truncate, "unreadable"), (_drop_leaf, "missing"),
], ids=["hash_mismatch", "truncated", "missing_leaf"])
def test_corruption_refused(tmp_path, damage, match):
    store.save(str(tmp_path), 3, _state())
    damage(tmp_path / "step_00000003")
    with pytest.raises(IOError, match=match):
        store.restore_arrays(str(tmp_path), 3)
    with pytest.raises(IOError, match=match):
        store.restore(str(tmp_path), 3, _state())
    with pytest.raises(IOError, match=match):
        with store.LeafReader(str(tmp_path), 3) as leaves:
            for k in leaves.leaves:
                leaves[k]


def test_leaf_reader_reads_the_leaves_restore_arrays_reads(tmp_path):
    state = {"a": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
             "b": torch.tensor(3, dtype=torch.int32), "c": torch.ones(4, dtype=torch.bfloat16)}
    store.save(str(tmp_path), 2, state)
    whole = store.restore_arrays(str(tmp_path), 2)
    with store.LeafReader(str(tmp_path), 2) as leaves:
        assert sorted(leaves.leaves) == sorted(whole)
        for k, a in whole.items():
            got = leaves[k]
            assert got.dtype == a.dtype and np.array_equal(got, a), k


def test_tree_mismatch_and_shape(tmp_path):
    store.save(str(tmp_path), 3, _state())
    with pytest.raises(KeyError, match="tree mismatch"):
        store.restore(str(tmp_path), 3, {"w": torch.zeros(8, 4)})
    with pytest.raises(ValueError, match="shape"):
        store.restore(str(tmp_path), 3, {"w": torch.zeros(4, 8), "step": torch.zeros(())})


def test_meta_and_structure_roundtrip(tmp_path):
    meta = {"it": 7, "plan_sig": {"caps": [1, 2, 3, 4], "nb": 2}, "chaos": float("inf")}
    state = {"a": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
             "l": [torch.tensor([1, 2], dtype=torch.int64), torch.tensor(True)]}
    store.save(str(tmp_path), 7, state, meta=meta)
    assert store.load_meta(str(tmp_path), 7) == meta
    assert sorted(store.restore_arrays(str(tmp_path), 7)) == [
        "['a']['w']", "['l'][0]", "['l'][1]"]
    like = {"a": {"w": torch.zeros(2, 3)},
            "l": [torch.zeros(2, dtype=torch.int64), torch.tensor(False)]}
    back = store.restore(str(tmp_path), 7, like, device="cpu")
    assert torch.equal(back["a"]["w"], state["a"]["w"])
    assert torch.equal(back["l"][0], state["l"][0]) and bool(back["l"][1])
    assert back["l"][0].dtype == torch.int64 and back["a"]["w"].device.type == "cpu"


def test_keep_n_with_foreign_entries(tmp_path):
    ck = store.AsyncCheckpointer(str(tmp_path), keep=2)
    os.makedirs(tmp_path / "step_junk.bak")
    for s in range(1, 5):
        ck.save_sync(s, _state(s))
    assert store.steps_available(str(tmp_path)) == [3, 4]
    assert (tmp_path / "step_junk.bak").exists()  # never collected


def test_gc_survives_vanishing_entries(tmp_path, monkeypatch):
    ck = store.AsyncCheckpointer(str(tmp_path), keep=1)
    for s in (1, 2, 3):
        store.save(str(tmp_path), s, _state(s))
    real_rmtree = shutil.rmtree

    def racing_rmtree(path, *a, **k):
        real_rmtree(path, *a, **k)  # an external cleaner got there first
        raise FileNotFoundError(path)

    monkeypatch.setattr(shutil, "rmtree", racing_rmtree)
    ck._gc()
    monkeypatch.undo()
    assert store.steps_available(str(tmp_path)) == [3]
    gone = store.AsyncCheckpointer(str(tmp_path / "sub"), keep=1)
    gone._gc()  # the directory never existed: nothing to do


def test_async_accounting(tmp_path):
    ck = store.AsyncCheckpointer(str(tmp_path), keep=3)
    ck.save(1, _state(1), meta={"it": 1})
    ck.wait()
    assert ck.last_saved == 1
    assert ck.bytes_written == store.dir_nbytes(str(tmp_path / "step_00000001")) > 0
    assert store.load_meta(str(tmp_path), 1) == {"it": 1}


def test_async_snapshot_is_taken_at_save(tmp_path, monkeypatch):
    """The worker writes the state and meta as of ``save``: later in-place
    writes to the caller's tensors and meta lists (the next iteration) never
    reach the checkpoint."""
    release = threading.Event()
    real_write = store._write

    def held_write(*a, **k):
        release.wait(timeout=30)
        return real_write(*a, **k)

    monkeypatch.setattr(store, "_write", held_write)
    ck = store.AsyncCheckpointer(str(tmp_path), keep=3)
    state = _state(1)
    want = state["w"].clone()
    meta = {"history": [{"iter": 0}]}
    ck.save(1, state, meta=meta)
    state["w"].add_(1.0)  # the caller moves on while the write is held
    meta["history"].append({"iter": 1})
    release.set()
    ck.wait()
    back = store.restore(str(tmp_path), 1, _state(0))
    assert torch.equal(back["w"], want)
    assert store.load_meta(str(tmp_path), 1) == {"history": [{"iter": 0}]}


@pytest.mark.parametrize("surface", ["wait", "save"])
def test_background_error_surfaces(tmp_path, monkeypatch, surface):
    ck = store.AsyncCheckpointer(str(tmp_path), keep=3)

    def boom(*a, **k):
        raise RuntimeError("disk full")

    monkeypatch.setattr(store, "_write", boom)
    ck.save(2, _state(2))
    ck._thread.join()
    with pytest.raises(RuntimeError, match="disk full"):
        ck.wait() if surface == "wait" else ck.save(3, _state(3))


def test_stall_accounting(tmp_path, monkeypatch):
    ck = store.AsyncCheckpointer(str(tmp_path), keep=3)
    release = threading.Event()
    real_write = store._write

    def slow_write(*a, **k):
        release.wait(timeout=30)
        return real_write(*a, **k)

    monkeypatch.setattr(store, "_write", slow_write)
    ck.save(1, _state(1))
    threading.Timer(0.05, release.set).start()
    ck.save(2, _state(2))  # blocks on the first write: one stall
    ck.wait()
    assert ck.stalls == 1 and ck.stall_s > 0
    assert store.steps_available(str(tmp_path)) == [1, 2]


# ---------------------------------------------------------------------------
# the format, against the JAX package's store
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(_numpy_states()))
def test_manifests_equal_across_packages(tmp_path, name):
    state = _numpy_states()[name]
    meta = {"workload": "mcl", "it": 2, "history": [{"nnz": 5, "chaos": 0.25}]}
    jstore.save(str(tmp_path / "jax"), 2, state, meta=meta)
    store.save(str(tmp_path / "torch"), 2,
               {k: v for k, v in state.items()}, meta=meta)
    jm, tm = _read_manifest(tmp_path / "jax", 2), _read_manifest(tmp_path / "torch", 2)
    assert tm == jm
    assert list(tm["leaves"]) == list(jm["leaves"])  # same leaf order too
    with np.load(tmp_path / "jax" / "step_00000002" / "arrays.npz") as z:
        jfiles = z.files
    with np.load(tmp_path / "torch" / "step_00000002" / "arrays.npz") as z:
        assert z.files == jfiles


def test_tensor_and_array_leaves_hash_alike(tmp_path):
    state = _numpy_states()["flat"]
    store.save(str(tmp_path / "np"), 1, state)
    store.save(str(tmp_path / "pt"), 1, {k: torch.from_numpy(np.asarray(v))
                                         for k, v in state.items()})
    assert _read_manifest(tmp_path / "np", 1) == _read_manifest(tmp_path / "pt", 1)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_restore_arrays_reads_the_other_package(tmp_path, writer):
    state = _numpy_states()["nested"]
    if writer == "jax":
        jstore.save(str(tmp_path), 5, {k: v for k, v in state.items()}, meta={"v": 1})
        got = store.restore_arrays(str(tmp_path), 5)
        assert store.load_meta(str(tmp_path), 5) == {"v": 1}
    else:
        store.save(str(tmp_path), 5, state, meta={"v": 1})
        got = jstore.restore_arrays(str(tmp_path), 5)
        assert jstore.load_meta(str(tmp_path), 5) == {"v": 1}
    assert sorted(got) == ["['a']", "['b']['x']", "['b']['y']"]
    np.testing.assert_array_equal(got["['a']"], state["a"])
    np.testing.assert_array_equal(got["['b']['y']"], state["b"]["y"])
    assert got["['b']['y']"].dtype == np.int64


def test_bf16_leaf_written_as_f32_and_restored_as_bf16(tmp_path):
    """numpy has no bfloat16: the leaf is written as float32, which holds
    every bfloat16 exactly, and comes back in the template's dtype."""
    w = torch.randn(8, 4, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    store.save(str(tmp_path), 1, {"w": w, "m": w.float()})
    assert store.restore_arrays(str(tmp_path), 1)["['w']"].dtype == np.float32
    back = store.restore(str(tmp_path), 1, {"w": torch.zeros(8, 4, dtype=torch.bfloat16),
                                            "m": torch.zeros(8, 4)})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], w)
    assert back["m"].dtype == torch.float32 and torch.equal(back["m"], w.float())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_restore_into_template_across_packages(tmp_path, writer):
    rng = np.random.default_rng(3)
    w = rng.random((8, 4)).astype(np.float32)
    if writer == "jax":
        jstore.save(str(tmp_path), 1, {"w": jnp.asarray(w), "step": jnp.asarray(3, jnp.int32)})
        back = store.restore(str(tmp_path), 1, {"w": torch.zeros(8, 4),
                                                "step": torch.zeros((), dtype=torch.int32)})
        assert torch.equal(back["w"], torch.from_numpy(w)) and int(back["step"]) == 3
    else:
        store.save(str(tmp_path), 1, {"w": torch.from_numpy(w),
                                      "step": torch.tensor(3, dtype=torch.int32)})
        back = jstore.restore(str(tmp_path), 1, {"w": jnp.zeros((8, 4)),
                                                 "step": jnp.zeros((), jnp.int32)})
        np.testing.assert_array_equal(np.asarray(back["w"]), w)
        assert int(back["step"]) == 3


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_corruption_refused_across_packages(tmp_path, writer):
    """A checkpoint one package wrote and the other finds truncated is
    refused through the same IOError channel."""
    state = {"w": np.ones((64, 64), np.float32)}
    (jstore if writer == "jax" else store).save(str(tmp_path), 1, state)
    _truncate(tmp_path / "step_00000001")
    reader = store if writer == "jax" else jstore
    with pytest.raises(IOError, match="unreadable"):
        reader.restore_arrays(str(tmp_path), 1)
