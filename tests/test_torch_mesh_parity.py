"""The port's LM serving on gloo process meshes against the JAX package on
the same ``make_debug_mesh``.

The port runs one process per mesh point (gloo, on the CPU), each holding
its slices of the JAX package's seeded weights
(``lm_params_from_reference(..., mesh=)``); the JAX package runs its
``build_prefill_step`` and ``build_decode_step`` (jitted, sharded) and its
``ServeEngine`` on as many host devices. Meshes 1x2, 2x1 and 2x2
("data" x "model"). Cases: olmoe and deepseek-moe (shared experts) with an
even prompt ("a2a": the sequence split over "model", tokens routed on
each shard) and an odd one (its "dense_ep" fallback), granite (kv_heads
1: the cache's sequence split over "model", decode combining partial
softmaxes; and an s_max that does not divide, the cache whole), gemma2
(tied, vocab-split embedding; sliding window), starcoder2 (and a batch of
1 that does not divide "data", replicated). Each case checks the prefill's
logits, the cache slice each rank holds against the reference's cache at
the rank's mesh point (``cache_specs``), and one decode step's logits;
every rank's slices have the 1/tp shapes ``param_specs`` gives, and the
MoE's SpMM (``core.local_spgemm.spmm``) runs exactly twice a MoE layer a
model call on every rank. The engine serves a mixed stream on 1x2 and 2x2
(olmoe, deepseek-moe, and granite, whose 3 slots on 2x2 do not split over
"data"): every rank returns the same tokens, equal to the JAX
``ServeEngine``'s on the same mesh. On 2x2 the JAX engine cannot prefill
an MoE model (its shard_map needs the batch of 1 to divide "data"), so
there its prefill
runs on the mesh's first data row, which is what the port's replicated
batch computes; the decode runs on the whole 2x2 mesh, routing each data
rank's slots.
A pod mesh (2 x 2 x 2) checks ``grid_from_mesh``: the rank at every grid
point equals the reference grid's device, and the grid's collectives run
in grid order.

Tolerances: logits and caches within rtol 1e-5 / atol 1e-5 (f32; partial
sums over "model" and the flash-decoding combine add in other orders than
XLA's); engine tokens token for token.

The JAX side runs once for the module, one subprocess a mesh shape, all
started together, each with 8 host devices:

    python tests/test_torch_mesh_parity.py --reference INPUTS.pkl OUT.pkl 2x2

which imports JAX only in that branch. The port's ranks are this file's
module-level functions, and its top imports no JAX, so spawned ranks never
load it.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((1, 2), (2, 1), (2, 2))
POD_SHAPE = (2, 2, 2)  # (pod, data, model): grid_from_mesh only
SEED = 5
# (arch, batch, prompt length, s_max)
CASES = (("olmoe-1b-7b", 2, 8, 16), ("olmoe-1b-7b", 2, 7, 16),
         ("deepseek-moe-16b", 2, 8, 16), ("deepseek-moe-16b", 2, 7, 16),
         ("granite-20b", 2, 8, 16), ("granite-20b", 2, 7, 15),
         ("gemma2-9b", 2, 9, 16), ("starcoder2-7b", 2, 8, 16), ("starcoder2-7b", 1, 8, 16))
ARCHS = sorted({c[0] for c in CASES})
# engine streams: shape -> ((arch, max_batch, requests), ...); max_batch is
# even for an MoE model on 2x2, so its slots split over "data"
LENGTHS, NEW_TOKENS = (3, 9, 5, 12, 4, 7), (4, 6, 3, 5, 6, 2)
ENGINE_S_MAX = 32
ENGINES = {(1, 2): (("olmoe-1b-7b", 3, 6), ("deepseek-moe-16b", 3, 6), ("granite-20b", 2, 5)),
           (2, 2): (("olmoe-1b-7b", 4, 6), ("deepseek-moe-16b", 4, 6), ("granite-20b", 3, 5))}
TOL = dict(rtol=1e-5, atol=1e-5)
SPAWN_TIMEOUT_S = 300  # a bound for a hung rank, not a run time
REFERENCE_TIMEOUT_S = 600  # likewise, for the reference's subprocesses together

pytestmark = pytest.mark.slow


def _tag(shape):
    return "x".join(map(str, shape))


def _case_id(case):
    arch, b, s, s_max = case
    return f"{arch}-b{b}-s{s}-smax{s_max}"


def _inputs():
    """Prompts and next tokens per case, and the engine streams, from one
    numpy seed."""
    from repro_torch.configs import get_config

    rng = np.random.default_rng(SEED)
    out = {}
    for case in CASES:
        arch, b, s, _ = case
        vocab = get_config(arch, smoke=True).vocab
        out[_case_id(case)] = (rng.integers(0, vocab, (b, s)).astype(np.int32),
                               rng.integers(0, vocab, (b, 1)).astype(np.int32))
    for arch in ARCHS:
        vocab = get_config(arch, smoke=True).vocab
        out[f"stream/{arch}"] = [rng.integers(0, vocab, s).astype(np.int32) for s in LENGTHS]
    return out


def _serve(pkg, cfg, model, mesh, max_batch, n_req, prompts):
    eng = pkg.engine(cfg, model, mesh, max_batch)
    for rid in range(n_req):
        eng.submit(pkg.Request(rid=rid, prompt=prompts[rid], max_new_tokens=NEW_TOKENS[rid]))
    return [(r.rid, [int(x) for x in r.out_tokens]) for r in eng.run_to_completion()]


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------
def _port_rank(mesh, params, inp):
    import torch

    from repro_torch import serve
    from repro_torch.configs import get_config
    from repro_torch.core import local_spgemm
    from repro_torch.core.convert import lm_params_from_reference
    from repro_torch.models.common import leaf_spec
    from repro_torch.train import build_decode_step, build_prefill_step

    calls = [0]
    plain = local_spgemm.spmm

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    local_spgemm.spmm = counted
    shape = tuple(mesh.sizes)
    out = {"coords": mesh.coords, "cases": {}, "engines": {}, "shapes": {}}
    models = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        models[arch] = lm_params_from_reference(cfg, params[arch], "cpu", mesh=mesh)
    for case in CASES:
        arch, b, s, s_max = case
        cfg, model = get_config(arch, smoke=True), models[arch]
        prompt, nxt = inp[_case_id(case)]
        pstep, info = build_prefill_step(cfg, mesh, s_max, b)
        dstep, _ = build_decode_step(cfg, mesh, b, s_max)
        calls[0] = 0
        logits, cache = pstep(model, torch.as_tensor(prompt))
        prefill_calls = calls[0]
        cache_after_prefill = {k: v.clone().numpy() for k, v in cache.items()}
        calls[0] = 0
        dlogits, cache = dstep(model, cache, torch.as_tensor(nxt), s)
        out["cases"][_case_id(case)] = {
            "prefill": logits.numpy(), "decode": dlogits.numpy(),
            "cache": cache_after_prefill, "cache_decoded": {k: v.numpy() for k, v in cache.items()},
            "spmm": (prefill_calls, calls[0]),
            "cache_specs": {k: tuple(v) for k, v in info["specs"]["cache"].items()}}
    for arch in ARCHS:  # every leaf's local shape against the whole one under its spec
        cfg = get_config(arch, smoke=True)
        specs = build_prefill_step(cfg, mesh, 16, 2)[1]["specs"]["params"]
        out["shapes"][arch] = {n: (tuple(p.shape), tuple(leaf_spec(specs, n)))
                               for n, p in models[arch].named_parameters()}
    for arch, max_batch, n_req in ENGINES.get(shape, ()):
        cfg = get_config(arch, smoke=True)
        pkg = type("pkg", (), {"Request": serve.Request, "engine": staticmethod(
            lambda c, m, msh, mb: serve.ServeEngine(
                c, m, serve.EngineConfig(max_batch=mb, s_max=ENGINE_S_MAX), device="cpu",
                mesh=msh))})
        out["engines"][arch] = _serve(pkg, cfg, models[arch], mesh, max_batch, n_req,
                                      inp[f"stream/{arch}"])
    out["loaded"] = sorted(m for m in ("jax", "jaxlib", "repro") if m in sys.modules)
    return out


def _pod_rank(mesh):
    """grid_from_mesh on a (pod, data, model) mesh: the grid's layout, and
    its collectives' order along each axis and over the whole grid."""
    import torch

    from repro_torch.core.grid import COL_AX, LAYER_AX, ROW_AX, grid_from_mesh

    grid = grid_from_mesh(mesh)
    me = torch.tensor([grid.rank])
    return {"rank": grid.rank, "coords": grid.coords, "ranks": grid.ranks,
            "shape": (grid.pr, grid.pc, grid.l),
            "along": {ax: grid.all_gather(me, ax)[:, 0].tolist()
                      for ax in (ROW_AX, COL_AX, LAYER_AX)},
            "grid": grid.gather_grid(me)[..., 0].tolist(),
            "sum": float(grid.psum_all(torch.tensor(float(grid.rank))))}


# ---------------------------------------------------------------------------
# the JAX side (subprocess only)
# ---------------------------------------------------------------------------
def _reference(inputs_path, out_path, tag):
    import jax
    import jax.numpy as jnp

    from repro import serve as jserve
    from repro.compat import AxisType, make_mesh, set_mesh
    from repro.configs import get_config
    from repro.core.grid import grid_from_mesh
    from repro.launch.mesh import make_debug_mesh
    from repro.models import transformer as tfm
    from repro.train.step import build_decode_step, build_prefill_step

    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    res = {"cases": {}, "engines": {}}
    if tag == _tag(POD_SHAPE):
        mesh = make_debug_mesh(*POD_SHAPE[1:], pod=POD_SHAPE[0])
        grid = grid_from_mesh(mesh)
        res["mesh_ids"] = np.vectorize(lambda d: d.id)(mesh.devices)
        res["grid_ids"] = np.vectorize(lambda d: d.id)(grid.mesh.devices)
        res["grid_shape"] = (grid.pr, grid.pc, grid.l)
        with open(out_path, "wb") as f:
            pickle.dump(res, f)
        return
    shape = tuple(int(x) for x in tag.split("x"))
    mesh = make_debug_mesh(*shape)
    res["mesh_ids"] = np.vectorize(lambda d: d.id)(mesh.devices)
    params = {arch: tfm.init_params(get_config(arch, smoke=True), jax.random.PRNGKey(SEED))
              for arch in ARCHS}
    with set_mesh(mesh):
        for case in CASES:
            arch, b, s, s_max = case
            cfg = get_config(arch, smoke=True)
            prompt, nxt = inp[_case_id(case)]
            pstep, _ = build_prefill_step(cfg, mesh, s_max, b)
            dstep, _ = build_decode_step(cfg, mesh, b, s_max)
            logits, cache = pstep(params[arch], jnp.asarray(prompt))
            cache_np = jax.tree.map(np.asarray, cache)
            dlogits, cache = dstep(params[arch], cache, jnp.asarray(nxt), jnp.int32(s))
            res["cases"][_case_id(case)] = {
                "prefill": np.asarray(logits), "decode": np.asarray(dlogits),
                "cache": cache_np, "cache_decoded": jax.tree.map(np.asarray, cache)}
        # the engine; on a mesh with data > 1 an MoE prefill (B = 1) runs on
        # the first data row, as the port's replicated batch computes
        row = make_mesh(mesh.devices[:1], ("data", "model"), axis_types=(AxisType.Auto,) * 2)

        class Engine(jserve.ServeEngine):
            def _prefill_into_slot(self, slot, req):
                if self.mesh.shape["data"] == 1 or not self.cfg.moe:
                    return super()._prefill_into_slot(slot, req)
                with set_mesh(row):
                    logits, pcache = tfm.prefill(self.cfg, self.params,
                                                 jnp.asarray(req.prompt)[None],
                                                 s_max=self.ecfg.s_max, mesh=row)
                    logits, pcache = np.asarray(logits), jax.tree.map(np.asarray, pcache)
                self.cache = jax.tree.map(
                    lambda c, one: c.at[:, slot:slot + 1].set(one.astype(c.dtype)),
                    self.cache, pcache)
                self.slot_pos[slot] = len(req.prompt)
                req.out_tokens.append(int(np.argmax(logits[0])))
                self.active[slot] = req

        pkg = type("pkg", (), {"Request": jserve.Request, "engine": staticmethod(
            lambda c, p, msh, mb: Engine(c, p, msh, jserve.EngineConfig(
                max_batch=mb, s_max=ENGINE_S_MAX)))})
        for arch, max_batch, n_req in ENGINES.get(shape, ()):
            res["engines"][arch] = _serve(pkg, get_config(arch, smoke=True), params[arch], mesh,
                                          max_batch, n_req, inp[f"stream/{arch}"])
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results by shape tag, {shape: per-rank port results},
    pod-mesh ranks): the reference's subprocesses and the port's ranks run
    side by side."""
    import jax

    from repro.configs import get_config as j_get_config
    from repro.models import transformer as jtfm
    from repro_torch.launch import spawn

    work = tmp_path_factory.mktemp("mesh_parity")
    inp = _inputs()
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    tags = [_tag(shape) for shape in SHAPES + (POD_SHAPE,)]
    refs = {}
    deadline = time.monotonic() + REFERENCE_TIMEOUT_S
    try:
        for tag in tags:
            with open(work / f"reference_{tag}.log", "w") as log:
                refs[tag] = subprocess.Popen(
                    [sys.executable, __file__, "--reference", str(work / "inputs.pkl"),
                     str(work / f"reference_{tag}.pkl"), tag],
                    env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        params = {arch: jax.tree.map(np.asarray, jtfm.init_params(
            j_get_config(arch, smoke=True), jax.random.PRNGKey(SEED))) for arch in ARCHS}
        port = {shape: spawn.run_mesh(_port_rank, shape, backend="gloo", device="cpu",
                                      args=(params, inp), timeout_s=SPAWN_TIMEOUT_S,
                                      workdir=work)
                for shape in SHAPES}
        pod = spawn.run_mesh(_pod_rank, POD_SHAPE, backend="gloo", device="cpu",
                             timeout_s=SPAWN_TIMEOUT_S, workdir=work)
        for ref in refs.values():
            ref.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for ref in refs.values():
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    ref = {}
    for tag in tags:
        log = (work / f"reference_{tag}.log").read_text()
        assert refs[tag].returncode == 0, f"{tag}: {log[-4000:]}"
        with open(work / f"reference_{tag}.pkl", "rb") as f:
            ref[tag] = pickle.load(f)
    return ref, port, pod


class _At:
    """A mesh point, for cutting a reference array to a rank's slice."""

    def __init__(self, shape, coords):
        self.shape = dict(zip(("data", "model"), shape))
        self.coords = coords

    def axis_size(self, a):
        return self.shape[a]

    def axis_index(self, a):
        return self.coords[a]


def _slice(x, spec, shape, coords):
    import torch

    from repro_torch.models.common import shard_tensor

    return shard_tensor(torch.as_tensor(x), spec, _At(shape, coords)).numpy()


def test_ranks_load_no_jax_and_sit_on_the_reference_mesh(runs):
    ref, port, _ = runs
    for shape, ranks in port.items():
        assert all(r["loaded"] == [] for r in ranks), [r["loaded"] for r in ranks]
        # the reference mesh's devices run row-major, as the port's ranks
        np.testing.assert_array_equal(ref[_tag(shape)]["mesh_ids"],
                                      np.arange(np.prod(shape)).reshape(shape))
        assert [r["coords"] for r in ranks] == [
            {"data": d, "model": m} for d in range(shape[0]) for m in range(shape[1])]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_prefill_cache_and_decode_match_jax(runs, shape, case):
    ref, port, _ = runs
    cid = _case_id(case)
    want = ref[_tag(shape)]["cases"][cid]
    for r in port[shape]:
        got = r["cases"][cid]
        np.testing.assert_allclose(got["prefill"], want["prefill"], **TOL)
        np.testing.assert_allclose(got["decode"], want["decode"], **TOL)
        for key in ("cache", "cache_decoded"):
            for name, spec in got["cache_specs"].items():
                np.testing.assert_allclose(
                    got[key][name], _slice(want[key][name], spec, shape, r["coords"]),
                    err_msg=f"{key}/{name}", **TOL)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_moe_spmm_runs_twice_a_layer_a_call_on_every_rank(runs, shape, case):
    from repro_torch.configs import get_config

    cfg = get_config(case[0], smoke=True)
    want = 2 * cfg.n_layers if cfg.moe else 0
    assert all(r["cases"][_case_id(case)]["spmm"] == (want, want) for r in runs[1][shape])


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_rank_holds_its_slices(runs, shape):
    """Expert weights, attention heads, MLP columns and the split vocab or
    hidden dimension: each rank's leaf is its 1/tp slice of the whole."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as ttfm

    tp = shape[1]
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        whole = {n: tuple(p.shape) for n, p in
                 ttfm.init_params(cfg, None, "meta").named_parameters()}
        split = 0
        for r in runs[1][shape]:
            for name, (got, spec) in r["shapes"][arch].items():
                want = tuple(n // (tp if e == "model" else 1)
                             for n, e in zip(whole[name], spec + (None,) * 8))
                assert got == want, (arch, name, got, want)
                split += got != whole[name]
        if tp > 1:  # heads, experts and columns do split
            assert split > 0, arch
            moe = ("moe.w_in", "moe.w_out") if cfg.moe else ("mlp.w_in", "mlp.w_out")
            for part in ("attn.wq", "attn.wo") + moe:
                got = runs[1][shape][0]["shapes"][arch][f"layers.0.{part}"][0]
                assert np.prod(got) * tp == np.prod(whole[f"layers.0.{part}"]), (arch, part)


@pytest.mark.parametrize("shape", tuple(ENGINES), ids=_tag)
def test_engine_matches_jax_on_every_rank(runs, shape):
    ref, port, _ = runs
    for arch, _, n_req in ENGINES[shape]:
        want = ref[_tag(shape)]["engines"][arch]
        assert sorted(rid for rid, _ in want) == list(range(n_req))
        for r in port[shape]:
            assert r["engines"][arch] == want, (arch, r["coords"])


def test_grid_from_mesh_matches_jax(runs):
    ref, _, pod = runs
    want = ref[_tag(POD_SHAPE)]
    np.testing.assert_array_equal(want["mesh_ids"], np.arange(8).reshape(POD_SHAPE))
    pr, pc, l = want["grid_shape"]
    ids = want["grid_ids"]  # (pr, pc, l): the device (= rank) at every grid point
    for r in pod:
        assert r["shape"] == (pr, pc, l)
        i, j, k = r["coords"]
        assert ids[i, j, k] == r["rank"]
        assert r["along"]["gr"] == ids[:, j, k].tolist()
        assert r["along"]["gc"] == ids[i, :, k].tolist()
        assert r["along"]["gl"] == ids[i, j, :].tolist()
        assert r["grid"] == ids.tolist()
        assert r["sum"] == float(sum(range(8)))
    assert pod[0]["ranks"] == tuple(ids.reshape(-1).tolist())


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(*sys.argv[2:5])
