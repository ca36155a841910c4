"""The port's mesh train step, its spec trees and its restartable loop
against the JAX package, on gloo process meshes.

  * The train step (``build_train_step(..., mesh=)``, "tp", ZeRO-1) against
    the JAX package's ``build_train_step`` on the same ``make_debug_mesh``,
    2 steps from weights and batches of one numpy seed (B = 4, S = 8):
    starcoder2, gemma2 and granite on 2x2, starcoder2 on 1x2, and on 2x2
    with 2 microbatches, with "dp" and with ``zero1=False`` (the state
    whole on every data rank). ``grad_clip`` is 0.01, so both
    packages clip: the clipped gradient does not depend on the gradient's
    scale, so the JAX mesh gradient's 1/tp (ROADMAP §3.1) cancels, and the
    port's gradient norm is tp times the JAX one under "tp" ("dp" runs the
    plain loss: the two agree). Every rank's parameter slice, its mu, nu
    and count slices (in the reference's stacked layout, shaped as
    ``shardings_for``'s "opt" specs give) against the JAX state cut at the
    rank's mesh point, and the JAX state carried over by
    ``opt_state_from_reference(..., mesh=, specs=)`` equal to the port's.
  * ``shardings_for``'s spec trees equal the JAX package's (as axis-name
    tuples) for every attention-family SMOKE arch, "tp" and "dp", on 2x2
    and on the pod mesh 2x2x2.
  * ``run_training(..., mesh=)`` on 1x2 with a failure injected at step 3
    (checkpoints every 2 steps) resumes to the uninterrupted loop's losses
    and state bit for bit on every rank; rank 0's checkpoint is the whole
    state, as one card writes it, and what ``MeshState.encode`` gives rank
    0 (None on the other ranks).
  * ``master_in_opt`` on the mesh: the same parameters bit for bit, the
    master held as ZeRO slices.

Tolerances: losses rtol 1e-5, gradient norms rtol 1e-5; parameters, as
``tests/test_torch_train_loop.py``, within rtol 1e-4 / atol 1e-6 on at
least 99.9 % of a leaf's entries and all within 1e-4; mu and nu within
rtol 1e-4 and an atol of 1e-5 of the leaf's largest entry (the clipped
gradients of two f32 sums in other orders).

The JAX side runs once for the module, one subprocess a mesh shape, all
started together, each with 8 host devices (XLA's LLVM backend at -O0):

    python tests/test_torch_mesh_train_step.py --reference INPUTS.pkl OUT.pkl 2x2

(the 1x2 one also gives the spec trees of the 2x2 and pod meshes).
"""
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SEED = 9
B, S = 4, 8
STEPS = 2
OPT = dict(lr=3e-3, warmup_steps=2, grad_clip=0.01)
# (arch, (data, model), strategy, microbatches, zero1)
# (gemma2's and granite's 1x2 gradients are in test_torch_mesh_train.py;
# their steps run on 2x2 here, within the test's time budget)
CASES = (("starcoder2-7b", (2, 2), "tp", 1, True), ("gemma2-9b", (2, 2), "tp", 1, True),
         ("granite-20b", (2, 2), "tp", 1, True), ("starcoder2-7b", (1, 2), "tp", 1, True),
         ("starcoder2-7b", (2, 2), "tp", 2, True), ("starcoder2-7b", (2, 2), "dp", 1, True),
         ("starcoder2-7b", (2, 2), "tp", 1, False))
ARCHS = sorted({c[0] for c in CASES})
MASTER_CASE = CASES[3]  # starcoder2 on 1x2, also run with master_in_opt
TAGS = ("2x2", "1x2", "2x2-more")  # the reference's subprocesses
POD = (2, 2, 2)
LOOP_SHAPE, LOOP_STEPS, LOOP_FAIL, LOOP_EVERY = (1, 2), 4, 3, 2
LOSS_RTOL = 1e-5
PARAM_TOL, PARAM_SHARE, ADAM_ATOL = dict(rtol=1e-4, atol=1e-6), 0.999, 1e-4
SPAWN_TIMEOUT_S = 300  # a bound for a hung rank, not a run time
REFERENCE_TIMEOUT_S = 600  # likewise, for the reference's subprocesses together

pytestmark = pytest.mark.slow


def _tag(shape):
    return "x".join(map(str, shape))


def _cid(case):
    arch, shape, strategy, mb, zero1 = case
    return f"{arch}-{_tag(shape)}-{strategy}-mb{mb}" + ("" if zero1 else "-nozero1")


def _subprocess_of(case):
    """The reference subprocess that runs ``case``: 2x2's six cases split
    in two, so the three run side by side."""
    if case[1] == (1, 2):
        return "1x2"
    return "2x2-more" if case[3] > 1 or case[2] == "dp" or not case[4] else "2x2"


def _attn_archs():
    from repro_torch.configs import ARCHS as ALL, get_config

    return tuple(a for a in ALL if get_config(a, smoke=True).family == "attn")


def _inputs():
    from repro_torch.configs import get_config

    rng = np.random.default_rng(SEED)
    out = {}
    for arch in ARCHS:
        vocab = get_config(arch, smoke=True).vocab
        out[arch] = [{"inputs": rng.integers(0, vocab, (B, S)).astype(np.int32),
                      "targets": rng.integers(0, vocab, (B, S)).astype(np.int32)}
                     for _ in range(STEPS)]
    return out


def _plain(tree):
    """Nested dicts of tuples, from either package's spec tree."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in tree)


def _stacked(tree):
    """{name: array} of a rank's per-layer state with ``layers.<i>.<rest>``
    stacked over the layers it holds, in the reference's layout."""
    layers, out = {}, {}
    for name, a in tree.items():
        parts = name.split(".")
        if parts[0] == "layers":
            layers.setdefault(".".join(["layers"] + parts[2:]), []).append(a)
        else:
            out[name] = a
    out.update({k: np.stack(v) for k, v in layers.items()})
    return out


def _weights(arch):
    """The JAX package's parameter tree for ``arch`` (its names and shapes,
    from ``jax.eval_shape`` of its init) filled from one numpy seed: every
    matrix N(0, 0.05²), every vector (norm scales) N(0, 0.1²)."""
    import jax

    from repro.configs import get_config
    from repro.models import transformer as jtfm

    shapes = jax.eval_shape(lambda: jtfm.init_params(get_config(arch, smoke=True),
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(SEED)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape)
                                   * (0.05 if len(s.shape) > 1 else 0.1)).astype(np.float32),
                        shapes)


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------
def _step_rank(mesh, inputs_path, cases, loop_root=None):
    from repro_torch.configs import get_config
    from repro_torch.core.convert import lm_params_from_reference
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, build_train_step

    with open(inputs_path, "rb") as f:  # a file: a large argument slows the spawn
        inp, params = pickle.load(f)
    out = {"coords": mesh.coords, "rank": mesh.rank, "cases": {}}
    np_tree = lambda t: {k: v.detach().numpy().copy() for k, v in t.items()}  # noqa: E731
    for case in cases:
        arch, _, strategy, mb, zero1 = case
        cfg = get_config(arch, smoke=True)
        step = build_train_step(cfg, TrainConfig(optimizer=adamw.AdamWConfig(**OPT, zero1=zero1),
                                                 strategy=strategy, microbatches=mb),
                                "cpu", mesh=mesh, global_batch=B)
        model = lm_params_from_reference(cfg, params[arch], "cpu", master=True, mesh=mesh) \
            if strategy == "tp" else lm_params_from_reference(cfg, params[arch], "cpu",
                                                               master=True)
        opt = adamw.init_opt_state(model, mesh=mesh, specs=step.specs)
        losses, norms = [], []
        for batch in inp[arch]:
            model, opt, m = step(model, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        if case == MASTER_CASE:  # again with the f32 master in the ZeRO state
            step = build_train_step(cfg, TrainConfig(optimizer=adamw.AdamWConfig(
                **OPT, master_in_opt=True), strategy=strategy, microbatches=mb), "cpu",
                mesh=mesh, global_batch=B)
            twin = lm_params_from_reference(cfg, params[arch], "cpu", master=True, mesh=mesh)
            state = adamw.init_opt_state(twin, True, mesh=mesh, specs=step.specs)
            for batch in inp[arch]:
                twin, state, _ = step(twin, state, batch)
            out["master_in_opt"] = {"params": np_tree(dict(twin.named_parameters())),
                                    "master": np_tree(state["master"])}
        out["cases"][_cid(case)] = {
            "losses": losses, "norms": norms, "count": int(opt["count"]),
            "params": np_tree(dict(model.named_parameters())),
            "mu": np_tree(opt["mu"]), "nu": np_tree(opt["nu"]),
            "specs": _plain_specs(step.specs)}
    if loop_root is not None:
        out["loop"] = _loop_rank(mesh, loop_root)
    out["loaded"] = sorted(m for m in ("jax", "jaxlib", "repro") if m in sys.modules)
    return out


def _plain_specs(specs):
    return {"params": _plain(specs["params"]), "opt": _plain(specs["opt"]),
            "batch": _plain(specs["batch"])}


def _loop_batches():
    from repro_torch.configs import get_config

    rng = np.random.default_rng(SEED + 1)
    vocab = get_config("olmoe-1b-7b", smoke=True).vocab
    return [{"inputs": rng.integers(0, vocab, (B, S)).astype(np.int32),
             "targets": rng.integers(0, vocab, (B, S)).astype(np.int32)} for _ in range(3)]


def _loop_rank(mesh, root):
    """olmoe's restartable loop on this rank: uninterrupted, then with a
    failure injected at LOOP_FAIL; each run's losses and whole final state
    (gathered, as rank 0 writes it)."""
    import torch

    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime import FailureInjector, RuntimeConfig, run_training
    from repro_torch.train import MeshState, TrainConfig, build_train_step

    cfg = get_config("olmoe-1b-7b", smoke=True)
    step = build_train_step(cfg, TrainConfig(optimizer=adamw.AdamWConfig(**OPT)), "cpu",
                            mesh=mesh, global_batch=B)
    codec = MeshState(step, mesh)
    batches, last = _loop_batches(), {}

    def make_state():
        model = tfm.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu", master=True,
                                mesh=mesh)
        return {"params": model, "opt": adamw.init_opt_state(model, mesh=mesh, specs=step.specs)}

    def step_fn(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        last["state"] = {"params": p, "opt": o}
        return last["state"], m

    out = {"coords": mesh.coords, "rank": mesh.rank}
    for label, fail in (("plain", ()), ("failed", (LOOP_FAIL,))):
        res = run_training(steps=LOOP_STEPS, make_state=make_state, step_fn=step_fn,
                           batch_fn=lambda s: batches[s % len(batches)],
                           rc=RuntimeConfig(ckpt_dir=f"{root}/{label}", ckpt_every=LOOP_EVERY),
                           injector=FailureInjector(fail_steps=fail), mesh=mesh, codec=codec)
        out[label] = {"losses": res.losses, "restarts": res.restarts,
                      "final_step": res.final_step, "state": _own(last["state"])}
    encoded = codec.encode(last["state"])
    out["encoded"] = None if encoded is None else store._flatten(encoded)
    return out


def _own(state):
    """This rank's slices of a train state, flat, as numpy."""
    return _flat({"params": dict(state["params"].named_parameters()), "opt": state["opt"]})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().numpy().copy()
    return out


# ---------------------------------------------------------------------------
# the JAX side (subprocess only)
# ---------------------------------------------------------------------------
def _reference(inputs_path, out_path, tag):
    import dataclasses

    import jax

    from repro.compat import set_mesh
    from repro.configs import get_config
    from repro.launch.mesh import make_debug_mesh
    from repro.optim import adamw
    from repro.train.step import TrainConfig, build_train_step, shardings_for

    with open(inputs_path, "rb") as f:
        inp, init = pickle.load(f)  # the weights, made once by the test process
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    res = {"cases": {}, "specs": {}}
    for case in CASES:
        if _subprocess_of(case) != tag:
            continue
        arch, shape, strategy, mb, zero1 = case
        # remat off: the same arithmetic, compiled in a fifth of the time
        cfg = dataclasses.replace(get_config(arch, smoke=True), remat=False)
        mesh = make_debug_mesh(*shape)
        tc = TrainConfig(optimizer=adamw.AdamWConfig(**OPT, zero1=zero1), strategy=strategy,
                         microbatches=mb)
        params = jax.tree.map(jax.numpy.asarray, init[arch])
        opt = adamw.init_opt_state(params)
        step, _, _ = build_train_step(cfg, mesh, tc, global_batch=B)
        losses, norms = [], []
        with set_mesh(mesh):
            for batch in inp[arch]:
                params, opt, m = step(params, opt, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        res["cases"][_cid(case)] = {"losses": losses, "norms": norms, "params": np_tree(params),
                                    "opt": np_tree(opt)}
    if tag == "1x2":  # the spec trees, host-only
        for shape in ((2, 2), POD):
            mesh = make_debug_mesh(*shape[-2:], pod=shape[0] if len(shape) == 3 else 0)
            for arch in _attn_archs():
                for strategy in ("tp", "dp"):
                    specs = shardings_for(get_config(arch, smoke=True), mesh,
                                          TrainConfig(strategy=strategy), B)[3]
                    res["specs"][_tag(shape), arch, strategy] = {
                        "params": _plain(specs["params"]), "opt": _plain(specs["opt"]),
                        "batch": _plain(specs["batch"])}
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results by case id and spec key, {shape: per-rank port
    results}, the loop's ranks)."""
    from repro_torch.launch import spawn

    work = tmp_path_factory.mktemp("mesh_train_step")
    params = {a: _weights(a) for a in ARCHS}
    inp = _inputs()
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump((inp, params), f)
    # LLVM at -O0 halves the reference's compile time; it keeps IEEE
    # arithmetic (no fast-math), so the values are the same computation's
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_backend_optimization_level=0")
    refs = {}
    deadline = time.monotonic() + REFERENCE_TIMEOUT_S
    try:
        for tag in TAGS:
            with open(work / f"reference_{tag}.log", "w") as log:
                refs[tag] = subprocess.Popen(
                    [sys.executable, __file__, "--reference", str(work / "inputs.pkl"),
                     str(work / f"reference_{tag}.pkl"), tag],
                    env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        def run(shape):  # each mesh its own rendezvous directory
            (work / _tag(shape)).mkdir()
            return spawn.run_mesh(
                _step_rank, shape, backend="gloo", device="cpu",
                args=(str(work / "inputs.pkl"), [c for c in CASES if c[1] == shape],
                      str(work / "loop") if shape == LOOP_SHAPE else None),
                timeout_s=SPAWN_TIMEOUT_S, workdir=work / _tag(shape))

        shapes = sorted({c[1] for c in CASES})
        with ThreadPoolExecutor(len(shapes)) as pool:  # the meshes side by side
            port = dict(zip(shapes, pool.map(run, shapes)))
        loop = [r["loop"] for r in port[LOOP_SHAPE]]
        for ref in refs.values():
            ref.wait(timeout=max(deadline - time.monotonic(), 1.0))
        ref = {"cases": {}, "specs": {}}
        for tag in TAGS:
            log = (work / f"reference_{tag}.log").read_text()
            assert refs[tag].returncode == 0, f"{tag}: {log[-4000:]}"
            with open(work / f"reference_{tag}.pkl", "rb") as f:
                got = pickle.load(f)
            ref["cases"].update(got["cases"])
            ref["specs"].update(got["specs"])
    finally:
        for r in refs.values():
            if r.poll() is None:
                r.kill()
                r.wait()
    return ref, port, loop, work / "loop"


def _unstack(tree, path=()):
    """{port parameter name: array} of a JAX tree (layers unstacked)."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update(_unstack(node, path + (name,)))
        elif path and path[0] == "layers":
            for i in range(node.shape[0]):
                out[".".join(("layers", str(i)) + path[1:] + (name,))] = node[i]
        else:
            out[".".join(path + (name,))] = node
    return out


def _flat_ref(tree, path=()):
    """{stacked name: array} of a JAX tree (``layers.attn.wq``)."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update(_flat_ref(node, path + (name,)))
        else:
            out[".".join(path + (name,))] = np.asarray(node)
    return out


class _At:
    """A mesh point, for cutting a reference array to a rank's slice."""

    def __init__(self, shape, coords):
        self.shape = dict(zip(("data", "model"), shape))
        self.coords = coords

    def axis_size(self, a):
        return self.shape[a]

    def axis_index(self, a):
        return self.coords[a]


def _cut(x, spec, shape, coords):
    import torch

    from repro_torch.models.common import Spec, shard_tensor

    return shard_tensor(torch.as_tensor(np.asarray(x)), Spec(*spec), _At(shape, coords)).numpy()


def _spec_at(tree, name):
    node = tree
    for part in name.split("."):
        node = node[part]
    return node


def _assert_params(got, want, name):
    close = np.isclose(got, want, **PARAM_TOL)
    assert close.mean() >= PARAM_SHARE, (name, close.mean())
    np.testing.assert_allclose(got, want, rtol=0, atol=ADAM_ATOL, err_msg=name)


def _assert_moment(got, want, name):
    atol = max(1e-12, 1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=name)


def test_ranks_load_no_jax(runs):
    _, port, loop, _ = runs
    for ranks in port.values():
        assert all(r["loaded"] == [] for r in ranks)


def _carried(case, opt, n_ranks):
    """``opt_state_from_reference(..., mesh=, specs=)`` of the JAX state
    ``opt`` at every mesh point (a stand-in mesh: the slices read only the
    mesh's names, sizes and this rank's point), as numpy."""
    from repro_torch.configs import get_config
    from repro_torch.core.convert import opt_state_from_reference
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, shardings_for

    arch, shape, strategy, mb, zero1 = case
    cfg = get_config(arch, smoke=True)
    out = []
    for rank in range(n_ranks):
        mesh = Mesh(("data", "model"), shape, "cpu", rank)
        specs = shardings_for(cfg, mesh, TrainConfig(optimizer=adamw.AdamWConfig(**OPT,
                                                                                 zero1=zero1),
                                                     strategy=strategy, microbatches=mb), B)
        st = opt_state_from_reference(cfg, opt, "cpu", mesh=mesh, specs=specs)
        out.append({"count": st["count"], **{k: {n: t.numpy() for n, t in st[k].items()}
                                             for k in ("mu", "nu")}})
    return out


@pytest.mark.parametrize("case", CASES, ids=_cid)
def test_train_step_matches_jax_on_the_mesh(runs, case):
    ref, port, _, _ = runs
    arch, shape, strategy, mb, _ = case
    cid = _cid(case)
    want = ref["cases"][cid]
    tp = shape[1] if strategy == "tp" else 1
    specs = port[shape][0]["cases"][cid]["specs"]
    wparams = _unstack(want["params"])
    wopt = {k: _flat_ref(want["opt"][k]) for k in ("mu", "nu")}
    carried = _carried(case, want["opt"], len(port[shape]))
    for r in port[shape]:
        got = r["cases"][cid]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["norms"], np.multiply(want["norms"], tp), rtol=LOSS_RTOL)
        assert got["count"] == int(want["opt"]["count"]) == STEPS
        for name, a in got["params"].items():
            stacked = ".".join(p for p in name.split(".") if not p.isdigit())
            spec = _spec_at(specs["params"], stacked)[1 if name.startswith("layers.") else 0:]
            _assert_params(a, _cut(wparams[name], spec, shape, r["coords"]), name)
        for key in ("mu", "nu"):
            held = _stacked(got[key])
            assert sorted(held) == sorted(wopt[key])
            for name, a in held.items():
                w = _cut(wopt[key][name], _spec_at(specs["opt"][key], name), shape, r["coords"])
                assert a.shape == w.shape, (key, name, a.shape, w.shape)
                _assert_moment(a, w, f"{key} {name}")
                np.testing.assert_array_equal(_stacked(carried[r["rank"]][key])[name], w,
                                              err_msg=f"carried {key} {name}")
        assert int(carried[r["rank"]]["count"]) == STEPS


def test_master_in_opt_on_the_mesh_is_the_same_step(runs):
    """The f32 master kept in the ZeRO state (``master_in_opt``) gives the
    parameters the plain step gives f32 masters, bit for bit; each rank's
    master holds its ZeRO slices of them."""
    _, port, _, _ = runs
    for r in port[MASTER_CASE[1]]:
        got, plain = r["master_in_opt"], r["cases"][_cid(MASTER_CASE)]["params"]
        for name, a in plain.items():
            np.testing.assert_array_equal(got["params"][name], a, err_msg=name)
        assert sorted(got["master"]) == sorted(r["cases"][_cid(MASTER_CASE)]["mu"])
        for name, m in got["master"].items():
            assert m.shape == r["cases"][_cid(MASTER_CASE)]["mu"][name].shape, name


@pytest.mark.parametrize("strategy", ("tp", "dp"))
@pytest.mark.parametrize("shape", ((2, 2), POD), ids=_tag)
def test_shardings_for_matches_jax(runs, shape, strategy):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train import TrainConfig, shardings_for

    ref, _, _, _ = runs
    names = ("pod", "data", "model")[-len(shape):]
    mesh = Mesh(names, shape, "cpu")  # a stand-in: the specs read names and sizes only
    for arch in _attn_archs():
        got = shardings_for(get_config(arch, smoke=True), mesh, TrainConfig(strategy=strategy), B)
        assert _plain_specs(got) == ref["specs"][_tag(shape), arch, strategy], arch


def test_mesh_loop_resumes_bit_for_bit(runs):
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime import driver

    _, _, loop, root = runs
    plain = loop[0]["plain"]
    assert plain["final_step"] == LOOP_STEPS and plain["restarts"] == 0
    for r in loop:
        assert r["plain"]["losses"] == plain["losses"]
        failed = r["failed"]
        assert failed["restarts"] == 1 and failed["final_step"] == LOOP_STEPS
        assert failed["losses"] == plain["losses"]
        assert sorted(failed["state"]) == sorted(r["plain"]["state"])
        for k, a in failed["state"].items():  # this rank's slices
            np.testing.assert_array_equal(a, r["plain"]["state"][k], err_msg=k)
    # rank 0 wrote the whole state, in the layout one card writes
    cfg = get_config("olmoe-1b-7b", smoke=True)
    model = tfm.init_params(cfg, None, "meta")
    one_card = store._flatten(driver._arrays({"params": model, "opt": adamw.init_opt_state(
        tfm.init_params(cfg, None, "meta"))}))
    saved = store.restore_arrays(str(root / "plain"), LOOP_STEPS)
    assert sorted(saved) == sorted(one_card)
    for k, a in saved.items():
        assert tuple(a.shape) == tuple(one_card[k].shape), k
    # MeshState.encode: the whole state on rank 0 alone, as the checkpoint
    # of the last step holds it (the failed run ends in the same state)
    for r in loop:
        assert (r["encoded"] is None) == (r["rank"] != 0)
    encoded = next(r["encoded"] for r in loop if r["rank"] == 0)
    assert sorted(encoded) == sorted(saved)
    for k, a in saved.items():
        np.testing.assert_array_equal(encoded[k], a, err_msg=k)


def test_train_launcher_refuses_a_mesh_without_distributed_init(capsys):
    from repro_torch.launch import train

    with pytest.raises(SystemExit):
        train.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu", "--mesh", "2x2"])
    assert "--distributed-init" in capsys.readouterr().err


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(*sys.argv[2:5])
