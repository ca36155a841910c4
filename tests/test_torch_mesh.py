"""The port's sharding specs and mesh helpers against the JAX package's, in
one process.

``param_specs`` equals the reference's spec tree for all ten SMOKE
architectures at tp in {1, 2, 4, 16}, and ``cache_specs`` for every
architecture at those tp on ("data", "model") and ("pod", "data",
"model") meshes, with no batch or s_max, a batch of 1 (replicated), and an
s_max that does not divide tp. Both packages read only a mesh's axis
names and sizes there, so both take the same stand-in mesh. The spec
entries compare as tuples: ``Spec`` and ``PartitionSpec`` hold the same
entries. On a 1 x 1 mesh (one process, no process group) prefill, decode
and the engine equal the meshless port bit for bit. The multi-process
cases are in ``test_torch_mesh_parity.py``.
"""
import types

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import common as jcommon
from repro.models import transformer as jtfm
from repro_torch import serve
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttfm

TPS = (1, 2, 4, 16)
# (pod, data) of the stand-in meshes, and the (batch, s_max) of cache_specs
MESHES = ((0, 1), (0, 2), (2, 4))
CACHES = ((None, None), (1, 64), (8, 48), (6, 33))


def _plain(tree):
    """Nested dicts of tuples, from either package's spec tree."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    assert isinstance(tree, (P, tcommon.Spec)), type(tree)
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in tree)


def _stand_in(pod, data, tp):
    names = (("pod",) if pod else ()) + ("data", "model")
    sizes = ((pod,) if pod else ()) + (data, tp)
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def test_the_ten_archs():
    assert tuple(ARCHS) == tuple(J_ARCHS)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, tp):
    got = ttfm.param_specs(get_config(arch, smoke=True), tp)
    want = jtfm.param_specs(j_get_config(arch, smoke=True), tp)
    assert _plain(got) == _plain(want)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(arch, tp):
    cfg, jcfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    for pod, data in MESHES:
        mesh = _stand_in(pod, data, tp)
        assert tcommon.batch_axes(mesh) == jcommon.batch_axes(mesh)
        for batch, s_max in CACHES:
            got = ttfm.cache_specs(cfg, mesh, batch, s_max)
            want = jtfm.cache_specs(jcfg, mesh, batch, s_max)
            assert _plain(got) == _plain(want), (pod, data, batch, s_max)


def test_tree_specs_like_names_every_leaf():
    cfg = get_config("deepseek-moe-16b", smoke=True)
    model = ttfm.init_params(cfg, None, "meta")
    specs = tcommon.tree_specs_like(model, lambda name, t: tcommon.Spec(name, t.dim()))
    flat = {name: p.dim() for name, p in model.named_parameters()}
    seen = {}

    def walk(node):
        if isinstance(node, tcommon.Spec):
            seen[node[0]] = node[1]
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        else:
            for v in node:
                walk(v)

    walk(specs)
    assert seen == flat


def test_shard_tensor_cuts_the_row_major_block():
    mesh = Mesh(("pod", "data", "model"), (2, 3, 2), torch.device("cpu"), rank=9)
    assert mesh.coords == {"pod": 1, "data": 1, "model": 1}
    assert mesh.rank_of(mesh.coords) == 9
    x = torch.arange(6 * 4).reshape(6, 4)
    got = tcommon.shard_tensor(x, tcommon.Spec(("pod", "data"), "model"), mesh)
    torch.testing.assert_close(got, x[4:5, 2:4])  # row block 1*3+1 of 6, column block 1
    assert tcommon.shard_tensor(x, tcommon.Spec(None, None), mesh) is x
    with pytest.raises(ValueError):  # 5 rows do not split in 3
        tcommon.shard_tensor(torch.zeros(5, 4), tcommon.Spec("data", None), mesh)


@pytest.mark.parametrize("arch", ("olmoe-1b-7b", "granite-20b", "gemma2-9b", "mamba2-370m"))
def test_one_point_mesh_equals_no_mesh(arch):
    """On a 1 x 1 mesh every collective is the identity and nothing is cut:
    prefill, decode and the engine give the meshless port's bits."""
    cfg = get_config(arch, smoke=True)
    mesh = make_debug_mesh(1, 1, device="cpu")
    model = ttfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    local = ttfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu", mesh=mesh)
    for (n, a), (_, b) in zip(model.named_parameters(), local.named_parameters()):
        assert torch.equal(a, b), n
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 8)))
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1)))
    want, cache = ttfm.prefill(cfg, model, toks, 16)
    got, mcache = ttfm.prefill(cfg, local, toks, 16, mesh=mesh)
    assert torch.equal(got, want)
    assert all(torch.equal(mcache[k], cache[k]) for k in cache)
    want, _ = ttfm.decode_step(cfg, model, cache, nxt, 8)
    got, _ = ttfm.decode_step(cfg, local, mcache, nxt, 8, mesh=mesh, s_max=16)
    assert torch.equal(got, want)
    done = []
    for m in (None, mesh):
        eng = serve.ServeEngine(cfg, model, serve.EngineConfig(max_batch=2, s_max=24),
                                device="cpu", mesh=m)
        for rid, s in enumerate((3, 7, 5)):
            prompt = (np.arange(s, dtype=np.int32) * 7 + rid) % cfg.vocab
            eng.submit(serve.Request(rid=rid, prompt=prompt, max_new_tokens=4))
        done.append([(r.rid, r.out_tokens) for r in eng.run_to_completion()])
    assert done[0] == done[1]

