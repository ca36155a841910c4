"""The port's Mamba2 (ssm) and Zamba2 (hybrid) families on gloo process
meshes with a "model" axis against the JAX package.

The port runs one process per mesh point (gloo, on the CPU), each holding
its slices of weights made from one numpy seed (the JAX package's tree
filled with N(0, 0.05²) matrices and N(0, 0.1²) vectors, carried over by
``lm_params_from_reference(..., mesh=)``); the JAX package runs the same
weights on as many host devices. Meshes 1x2 and 2x2 ("data" x "model")
for mamba2-370m and zamba2-2.7b SMOKE, and on 1x2 a mamba2 variant with
``head_dim=128`` (one head, so d_inner splits over "model" and the heads
do not: every rank scans the whole head). Checks:

  * serving: ``build_prefill_step``'s logits (a prompt of 12, which pads
    the last SSD chunk), the cache slice every rank holds against the
    reference's cache at the rank's mesh point (``cache_specs``: the conv
    window whole, the SSM state over heads, the shared block's k/v over
    kv heads), and one decode step's logits and cache; every rank's
    parameter slices have the 1/tp shapes ``param_specs`` gives;
  * ``ServeEngine(..., mesh=)`` on 1x2 and 2x2: every rank's tokens equal
    the JAX ``ServeEngine``'s on the same mesh, token for token;
  * training: the mesh loss against the JAX mesh loss, and the gradient,
    assembled from every rank's slice (concatenated over "model", summed
    over "data"), against the JAX one-device gradient, ``conv_w``,
    ``w_bc``, ``norm`` and every ``shared_block`` leaf among the rest (a
    replicated leaf's gradient is the same on every model rank, bit for
    bit); the JAX mesh gradient is 1/2 of the one-device one on every leaf
    at tp = 2 (ROADMAP §3.1; shown for both archs by
    ``tests/test_torch_mesh_train.py``), so it is no target;
  * one ZeRO-1 "tp" train step of each arch on 2x2 against the JAX
    package's ``build_train_step`` under an active clip (``grad_clip``
    0.01: the clipped step does not depend on the gradient's scale, and
    the port's gradient norm is tp times the JAX one): every rank's
    parameter, mu and nu slices against the JAX state cut at its mesh
    point, and the JAX state carried over by ``opt_state_from_reference
    (..., mesh=, specs=)`` equal to the port's.

Tolerances: logits, caches and losses within rtol 1e-5 (atol 1e-5 for
logits and caches; f32, partial sums over "model" added in other orders
than XLA's); gradients as ``tests/test_torch_train.py``'s
``close_model_grad``; the step's state as
``tests/test_torch_mesh_train_step.py``'s.

The JAX side runs once for the module, one subprocess a part, all
started together, each with 8 host devices (XLA's LLVM backend at -O0):

    python tests/test_torch_mesh_ssm.py --reference INPUTS.pkl OUT.pkl 1x2

which imports JAX only in that branch. The port's ranks are this file's
module-level functions, and its top imports no JAX.
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
SEED = 11
SHAPES = ((1, 2), (2, 2))
# model key -> (arch, SSM head_dim override or None)
MODELS = {"mamba2": ("mamba2-370m", None), "zamba2": ("zamba2-2.7b", None),
          "heads": ("mamba2-370m", 128)}
SERVE_ON = {(1, 2): ("mamba2", "zamba2", "heads"), (2, 2): ("mamba2", "zamba2")}
TRAIN_ON = {(1, 2): ("mamba2", "zamba2", "heads"), (2, 2): ("mamba2", "zamba2")}
STEP_SHAPE, STEP_MODELS = (2, 2), ("mamba2", "zamba2")
ENGINE_MODELS = ("mamba2", "zamba2")
B, S, S_MAX = 2, 12, 16  # serving: a prompt of 12 pads the last chunk of 8
TB, TS = 4, 8  # training
LENGTHS, NEW_TOKENS, ENGINE_BATCH, ENGINE_S_MAX = (3, 9, 5), (4, 6, 3), 2, 32
OPT = dict(lr=3e-3, warmup_steps=2, grad_clip=0.01)
TAGS = ("1x1", "1x2", "2x2", "2x2-step")  # the reference's subprocesses
TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
SPAWN_TIMEOUT_S = 300  # a bound for a hung rank, not a run time
REFERENCE_TIMEOUT_S = 600  # likewise, for the reference's subprocesses together

pytestmark = pytest.mark.slow


def _tag(shape):
    return "x".join(map(str, shape))


def _config(key, get_config):
    """The SMOKE config of ``key`` from either package's ``get_config``."""
    import dataclasses

    arch, head_dim = MODELS[key]
    cfg = get_config(arch, smoke=True)
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, head_dim=head_dim))
    return cfg


def _port_config(key):
    from repro_torch.configs import get_config

    return _config(key, get_config)


def _inputs():
    rng = np.random.default_rng(SEED)
    out = {}
    for key in MODELS:
        vocab = _port_config(key).vocab
        out[key] = {
            "prompt": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "next": rng.integers(0, vocab, (B, 1)).astype(np.int32),
            "train": {"inputs": rng.integers(0, vocab, (TB, TS)).astype(np.int32),
                      "targets": rng.integers(0, vocab, (TB, TS)).astype(np.int32)},
            "stream": [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]}
    return out


def _weights(key):
    """The JAX package's parameter tree for ``key`` (its names and shapes,
    from ``jax.eval_shape`` of its init) filled from one numpy seed."""
    import jax

    from repro.configs import get_config
    from repro.models import transformer as jtfm

    cfg = _config(key, get_config)
    shapes = jax.eval_shape(lambda: jtfm.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(SEED)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape)
                                   * (0.05 if len(s.shape) > 1 else 0.1)).astype(np.float32),
                        shapes)


def _serve(pkg, cfg, model, mesh, prompts):
    eng = pkg.engine(cfg, model, mesh)
    for rid, prompt in enumerate(prompts):
        eng.submit(pkg.Request(rid=rid, prompt=prompt, max_new_tokens=NEW_TOKENS[rid]))
    return [(r.rid, [int(x) for x in r.out_tokens]) for r in eng.run_to_completion()]


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------
def _port_rank(mesh, inputs_path):
    import torch

    from repro_torch import serve
    from repro_torch.core.convert import lm_params_from_reference
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import leaf_spec
    from repro_torch.optim import adamw
    from repro_torch.train import (TrainConfig, build_decode_step, build_prefill_step,
                                   build_train_step, value_and_grad)

    with open(inputs_path, "rb") as f:  # a file: a large argument slows the spawn
        inp, params = pickle.load(f)
    shape = tuple(mesh.sizes)
    np_tree = lambda t: {k: v.detach().numpy().copy() for k, v in t.items()}  # noqa: E731
    out = {"coords": mesh.coords, "rank": mesh.rank, "serve": {}, "engine": {}, "train": {},
           "step": {}}
    for key in SERVE_ON[shape]:
        cfg = _port_config(key)
        model = lm_params_from_reference(cfg, params[key], "cpu", mesh=mesh)
        pstep, info = build_prefill_step(cfg, mesh, S_MAX, B)
        dstep, _ = build_decode_step(cfg, mesh, B, S_MAX)
        logits, cache = pstep(model, torch.as_tensor(inp[key]["prompt"]))
        prefilled = {k: v.clone().numpy() for k, v in cache.items()}
        dlogits, cache = dstep(model, cache, torch.as_tensor(inp[key]["next"]), S)
        specs = info["specs"]["params"]
        out["serve"][key] = {
            "prefill": logits.numpy(), "decode": dlogits.numpy(), "cache": prefilled,
            "cache_decoded": {k: v.numpy() for k, v in cache.items()},
            "cache_specs": {k: tuple(v) for k, v in info["specs"]["cache"].items()},
            "shapes": {n: (tuple(p.shape), tuple(leaf_spec(specs, n)))
                       for n, p in model.named_parameters()}}
        if key in ENGINE_MODELS:
            pkg = type("pkg", (), {"Request": serve.Request, "engine": staticmethod(
                lambda c, m, msh: serve.ServeEngine(
                    c, m, serve.EngineConfig(max_batch=ENGINE_BATCH, s_max=ENGINE_S_MAX),
                    device="cpu", mesh=msh))})
            out["engine"][key] = _serve(pkg, cfg, model, mesh, inp[key]["stream"])
    for key in TRAIN_ON[shape]:
        cfg = _port_config(key)
        x, y = (torch.as_tensor(inp[key]["train"][k]) for k in ("inputs", "targets"))
        model = lm_params_from_reference(cfg, params[key], "cpu", master=True, mesh=mesh)
        loss, g = value_and_grad(lambda p: tfm.lm_loss(cfg, p, x, y, mesh), model)
        out["train"][key] = {"loss": float(loss), "grads": np_tree(g)}
    if shape == STEP_SHAPE:
        for key in STEP_MODELS:
            cfg = _port_config(key)
            step = build_train_step(cfg, TrainConfig(optimizer=adamw.AdamWConfig(**OPT)), "cpu",
                                    mesh=mesh, global_batch=TB)
            model = lm_params_from_reference(cfg, params[key], "cpu", master=True, mesh=mesh)
            opt = adamw.init_opt_state(model, mesh=mesh, specs=step.specs)
            model, opt, m = step(model, opt, inp[key]["train"])
            out["step"][key] = {
                "loss": float(m["loss"]), "norm": float(m["grad_norm"]),
                "count": int(opt["count"]), "params": np_tree(dict(model.named_parameters())),
                "mu": np_tree(opt["mu"]), "nu": np_tree(opt["nu"])}
    out["loaded"] = sorted(m for m in ("jax", "jaxlib", "repro") if m in sys.modules)
    return out


# ---------------------------------------------------------------------------
# the JAX side (subprocess only)
# ---------------------------------------------------------------------------
def _reference(inputs_path, out_path, tag):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import serve as jserve
    from repro.compat import set_mesh
    from repro.configs import get_config
    from repro.launch.mesh import make_debug_mesh
    from repro.models import transformer as tfm
    from repro.optim import adamw
    from repro.train.step import (TrainConfig, build_decode_step, build_prefill_step,
                                  build_train_step)

    with open(inputs_path, "rb") as f:
        inp, params = pickle.load(f)  # the weights, made once by the test process
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    shape = (1, 1) if tag == "1x1" else tuple(int(x) for x in tag.split("-")[0].split("x"))
    mesh = make_debug_mesh(*shape)
    res = {"serve": {}, "engine": {}, "loss": {}, "grad": {}, "step": {}}
    # the train step's state, placed as the step's own jit places it
    state = {key: (jax.tree.map(jnp.asarray, params[key]),
                   adamw.init_opt_state(jax.tree.map(jnp.asarray, params[key])))
             for key in (STEP_MODELS if tag == "2x2-step" else ())}
    with set_mesh(mesh):
        if tag == "1x1":  # the one-device gradients, remat off (the same arithmetic)
            for key in MODELS:
                cfg = dataclasses.replace(_config(key, get_config), remat=False)
                x, y = inp[key]["train"]["inputs"], inp[key]["train"]["targets"]
                loss, g = jax.jit(jax.value_and_grad(
                    lambda p, c=cfg: tfm.lm_loss(c, p, x, y, mesh)))(params[key])
                res["loss"][key], res["grad"][key] = float(loss), np_tree(g)
        elif tag == "2x2-step":
            for key in STEP_MODELS:
                cfg = dataclasses.replace(_config(key, get_config), remat=False)
                step, _, _ = build_train_step(
                    cfg, mesh, TrainConfig(optimizer=adamw.AdamWConfig(**OPT)), global_batch=TB)
                p, opt, m = step(*state[key], inp[key]["train"])
                res["step"][key] = {"loss": float(m["loss"]), "norm": float(m["grad_norm"]),
                                    "params": np_tree(p), "opt": np_tree(opt)}
        else:
            for key in SERVE_ON[shape]:
                cfg = _config(key, get_config)
                pstep, _ = build_prefill_step(cfg, mesh, S_MAX, B)
                dstep, _ = build_decode_step(cfg, mesh, B, S_MAX)
                logits, cache = pstep(params[key], jnp.asarray(inp[key]["prompt"]))
                prefilled = np_tree(cache)
                dlogits, cache = dstep(params[key], cache, jnp.asarray(inp[key]["next"]),
                                       jnp.int32(S))
                res["serve"][key] = {"prefill": np.asarray(logits), "decode": np.asarray(dlogits),
                                     "cache": prefilled, "cache_decoded": np_tree(cache)}
            pkg = type("pkg", (), {"Request": jserve.Request, "engine": staticmethod(
                lambda c, p, msh: jserve.ServeEngine(c, p, msh, jserve.EngineConfig(
                    max_batch=ENGINE_BATCH, s_max=ENGINE_S_MAX)))})
            for key in ENGINE_MODELS:
                res["engine"][key] = _serve(pkg, _config(key, get_config), params[key], mesh,
                                            inp[key]["stream"])
            for key in TRAIN_ON[shape]:
                cfg = dataclasses.replace(_config(key, get_config), remat=False)
                x, y = inp[key]["train"]["inputs"], inp[key]["train"]["targets"]
                loss = jax.jit(lambda p, c=cfg: tfm.lm_loss(c, p, x, y, mesh))(params[key])
                res["loss"][key] = float(loss)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results by tag, {shape: per-rank port results}): the
    reference's subprocesses and the port's meshes run side by side."""
    from repro_torch.launch import spawn

    work = tmp_path_factory.mktemp("mesh_ssm")
    params = {key: _weights(key) for key in MODELS}
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump((_inputs(), params), f)
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
            return spawn.run_mesh(_port_rank, shape, backend="gloo", device="cpu",
                                  args=(str(work / "inputs.pkl"),), timeout_s=SPAWN_TIMEOUT_S,
                                  workdir=work / _tag(shape))

        with ThreadPoolExecutor(len(SHAPES)) as pool:  # the meshes side by side
            port = dict(zip(SHAPES, pool.map(run, SHAPES)))
        for ref in refs.values():
            ref.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for ref in refs.values():
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    ref = {}
    for tag in TAGS:
        log = (work / f"reference_{tag}.log").read_text()
        assert refs[tag].returncode == 0, f"{tag}: {log[-4000:]}"
        with open(work / f"reference_{tag}.pkl", "rb") as f:
            ref[tag] = pickle.load(f)
    return ref, port


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


def _assemble(ranks, shape, key, pick):
    """{name: whole gradient}: every rank's slice (``pick(rank)[name]``)
    concatenated over "model" under the parameter's spec and summed over
    "data"; a replicated leaf must be the same on every model rank."""
    from repro_torch.models import transformer as ttfm
    from repro_torch.models.common import leaf_spec

    specs = ttfm.param_specs(_port_config(key), shape[1])
    by = {(r["coords"]["data"], r["coords"]["model"]): pick(r) for r in ranks}
    out = {}
    for name in by[(0, 0)]:
        spec = tuple(leaf_spec(specs, name))
        dims = [i for i, e in enumerate(spec) if e == "model"]
        total = 0
        for d in range(shape[0]):
            blocks = [by[(d, m)][name] for m in range(shape[1])]
            if dims:
                whole = np.concatenate(blocks, axis=dims[0])
            else:
                for m, blk in enumerate(blocks[1:], 1):
                    np.testing.assert_array_equal(blk, blocks[0], err_msg=f"{name} rank ({d}, {m})")
                whole = blocks[0]
            total = total + whole
        out[name] = total
    return out


def _unstack(tree):
    from test_torch_mesh_train import _unstack as unstack

    return unstack(tree)


def _cases(on):
    return [(s, k) for s in SHAPES for k in on[s]]


def _ids(x):
    return _tag(x) if isinstance(x, tuple) else x


def test_ranks_load_no_jax(runs):
    _, port = runs
    for shape, ranks in port.items():
        assert all(r["loaded"] == [] for r in ranks), [r["loaded"] for r in ranks]
        assert [r["coords"] for r in ranks] == [
            {"data": d, "model": m} for d in range(shape[0]) for m in range(shape[1])]


@pytest.mark.parametrize("shape,key", _cases(SERVE_ON), ids=_ids)
def test_prefill_cache_and_decode_match_jax(runs, shape, key):
    ref, port = runs
    want = ref[_tag(shape)]["serve"][key]
    for r in port[shape]:
        got = r["serve"][key]
        np.testing.assert_allclose(got["prefill"], want["prefill"], **TOL)
        np.testing.assert_allclose(got["decode"], want["decode"], **TOL)
        for part in ("cache", "cache_decoded"):
            assert sorted(got[part]) == sorted(want[part])
            for name, spec in got["cache_specs"].items():
                np.testing.assert_allclose(
                    got[part][name], _cut(want[part][name], spec, shape, r["coords"]),
                    err_msg=f"{part}/{name}", **TOL)


@pytest.mark.parametrize("shape,key", _cases(SERVE_ON), ids=_ids)
def test_rank_holds_its_slices(runs, shape, key):
    """d_inner columns, heads and ``w_out`` rows (and the shared block's
    heads and MLP columns): each rank's leaf is its 1/tp slice of the
    whole; ``w_bc`` and ``conv_w`` are whole."""
    from repro_torch.models import transformer as ttfm

    tp = shape[1]
    whole = {n: tuple(p.shape) for n, p in
             ttfm.init_params(_port_config(key), None, "meta").named_parameters()}
    for r in runs[1][shape]:
        held = r["serve"][key]["shapes"]
        for name, (got, spec) in held.items():
            want = tuple(n // (tp if e == "model" else 1)
                         for n, e in zip(whole[name], spec + (None,) * 8))
            assert got == want, (name, got, want)
        split = ["w_in_z", "w_in_x", "norm", "w_out"] + \
            ([] if key == "heads" else ["w_dt", "dt_bias", "A_log", "D_skip"])
        for part in split:
            name = f"layers.0.mamba.{part}"
            assert np.prod(held[name][0]) * tp == np.prod(whole[name]), name
        for part in ("w_bc", "conv_w") + (("w_dt", "A_log") if key == "heads" else ()):
            name = f"layers.0.mamba.{part}"
            assert held[name][0] == whole[name], name
        for name in ("shared_block.attn.wq", "shared_block.mlp.w_out") if key == "zamba2" else ():
            assert np.prod(held[name][0]) * tp == np.prod(whole[name]), name


@pytest.mark.parametrize("shape,key", [(s, k) for s in SHAPES for k in ENGINE_MODELS], ids=_ids)
def test_engine_matches_jax_on_every_rank(runs, shape, key):
    ref, port = runs
    want = ref[_tag(shape)]["engine"][key]
    assert sorted(rid for rid, _ in want) == list(range(len(LENGTHS)))
    for r in port[shape]:
        assert r["engine"][key] == want, r["coords"]


@pytest.mark.parametrize("shape,key", _cases(TRAIN_ON), ids=_ids)
def test_loss_matches_the_jax_mesh(runs, shape, key):
    ref, port = runs
    want = ref[_tag(shape)]["loss"][key]
    for r in port[shape]:
        np.testing.assert_allclose(r["train"][key]["loss"], want, rtol=LOSS_RTOL)
        assert r["train"][key]["loss"] == port[shape][0]["train"][key]["loss"]


@pytest.mark.parametrize("shape,key", _cases(TRAIN_ON), ids=_ids)
def test_grads_match_jax_one_device(runs, shape, key):
    from test_torch_train import close_model_grad

    ref, port = runs
    got = _assemble(port[shape], shape, key, lambda r: r["train"][key]["grads"])
    want = _unstack(ref["1x1"]["grad"][key])
    assert sorted(got) == sorted(want)
    for part in ("conv_w", "w_bc", "norm"):
        assert f"layers.0.mamba.{part}" in want
    assert (key == "zamba2") == any(n.startswith("shared_block.") for n in want)
    for name in want:
        try:
            close_model_grad(got[name], want[name])
        except AssertionError as e:
            raise AssertionError(name) from e


@pytest.mark.parametrize("key", STEP_MODELS)
def test_train_step_matches_jax_on_the_mesh(runs, key):
    from repro_torch.core.convert import opt_state_from_reference
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, shardings_for
    from test_torch_mesh_train_step import (_assert_moment, _assert_params, _flat_ref,
                                            _spec_at, _stacked)

    ref, port = runs
    want = ref["2x2-step"]["step"][key]
    cfg, shape = _port_config(key), STEP_SHAPE
    wparams = _unstack(want["params"])
    wopt = {k: _flat_ref(want["opt"][k]) for k in ("mu", "nu")}
    for r in port[shape]:
        got = r["step"][key]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["norm"], want["norm"] * shape[1], rtol=LOSS_RTOL)
        assert got["count"] == int(want["opt"]["count"]) == 1
        mesh = Mesh(("data", "model"), shape, "cpu", r["rank"])  # names, sizes, point
        specs = shardings_for(cfg, mesh, TrainConfig(optimizer=adamw.AdamWConfig(**OPT)), TB)
        for name, a in got["params"].items():
            stacked = ".".join(p for p in name.split(".") if not p.isdigit())
            spec = _spec_at(specs["params"], stacked)[1 if name.startswith("layers.") else 0:]
            _assert_params(a, _cut(wparams[name], spec, shape, r["coords"]), name)
        carried = opt_state_from_reference(cfg, want["opt"], "cpu", mesh=mesh, specs=specs)
        for k in ("mu", "nu"):
            held = _stacked(got[k])
            assert sorted(held) == sorted(wopt[k])
            for name, a in held.items():
                w = _cut(wopt[k][name], _spec_at(specs["opt"][k], name), shape, r["coords"])
                assert a.shape == w.shape, (k, name, a.shape, w.shape)
                _assert_moment(a, w, f"{k} {name}")
                np.testing.assert_array_equal(
                    _stacked({n: t.numpy() for n, t in carried[k].items()})[name], w,
                    err_msg=f"carried {k} {name}")


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    sys.path.insert(0, str(ROOT / "src"))
    _reference(*sys.argv[2:5])
