"""The port's continuous-batching LM engine (``repro_torch.serve.ServeEngine``)
against the JAX package's ``repro.serve.ServeEngine``, on the CPU.

Both engines serve the same numpy-seeded request stream with the JAX
package's seeded weights (carried over by ``lm_params_from_reference``),
SMOKE configs in f32. Greedy decoding makes the result deterministic: the
requests must finish in the same order with the same tokens, token for
token. ``max_batch`` is below the number of requests and the prompts have
mixed lengths, so slots are refilled and the lock-step decode position
(the largest slot's) differs from most slots' own.
"""
import jax
import numpy as np
import pytest

from repro import serve as jserve
from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs import get_config as j_get_config
from repro.models import transformer as jtfm
from repro_torch import serve as tserve
from repro_torch.configs import get_config
from repro_torch.core.convert import lm_params_from_reference
from repro_torch.models import transformer as ttfm


@pytest.fixture(scope="module")
def mesh():
    dev = np.array(jax.devices()[:1]).reshape(1, 1)
    return make_mesh(dev, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


@pytest.fixture(scope="module")
def models():
    """(JAX params, port model) per arch, made once per module."""
    made = {}

    def get(arch):
        if arch not in made:
            params = jtfm.init_params(j_get_config(arch, smoke=True), jax.random.PRNGKey(21))
            made[arch] = params, lm_params_from_reference(
                get_config(arch, smoke=True), jax.tree.map(np.asarray, params), "cpu")
        return made[arch]

    return get


def stream(cfg, lengths, new_tokens, seed=0):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, cfg.vocab, s).astype(np.int32), n)
            for rid, (s, n) in enumerate(zip(lengths, new_tokens))]


def serve_both(arch, models, mesh, reqs, **ecfg):
    """The finished requests of each engine, in the order done, as
    (rid, tokens)."""
    params, model = models(arch)
    with set_mesh(mesh):
        jeng = jserve.ServeEngine(j_get_config(arch, smoke=True), params, mesh,
                                  jserve.EngineConfig(**ecfg))
        for rid, prompt, n in reqs:
            jeng.submit(jserve.Request(rid=rid, prompt=prompt, max_new_tokens=n))
        want = [(r.rid, list(r.out_tokens)) for r in jeng.run_to_completion()]
    teng = tserve.ServeEngine(get_config(arch, smoke=True), model,
                              tserve.EngineConfig(**ecfg), device="cpu")
    for rid, prompt, n in reqs:
        teng.submit(tserve.Request(rid=rid, prompt=prompt, max_new_tokens=n))
    got = [(r.rid, list(r.out_tokens)) for r in teng.run_to_completion()]
    return got, want


@pytest.mark.parametrize("arch,max_batch,n_req", [
    ("granite-20b", 2, 5), ("olmoe-1b-7b", 3, 6), ("deepseek-moe-16b", 3, 6),
    ("mamba2-370m", 2, 5), ("zamba2-2.7b", 3, 6),
])
def test_engine_matches_reference(arch, max_batch, n_req, models, mesh):
    cfg = get_config(arch, smoke=True)
    lengths = [3, 9, 5, 12, 4, 7][:n_req]
    new_tokens = [4, 6, 3, 5, 6, 2][:n_req]
    got, want = serve_both(arch, models, mesh, stream(cfg, lengths, new_tokens),
                           max_batch=max_batch, s_max=32)
    assert got == want
    assert sorted(rid for rid, _ in got) == list(range(n_req))
    for rid, toks in got:
        assert len(toks) == max(new_tokens[rid], 2)  # the prefill's token, then a tick's
        assert all(0 <= tok < cfg.vocab for tok in toks)


def test_eos_stop(models, mesh):
    cfg = get_config("granite-20b", smoke=True)
    reqs = stream(cfg, [5, 8, 6, 4], [8, 8, 8, 8], seed=3)
    free, _ = serve_both("granite-20b", models, mesh, reqs, max_batch=2, s_max=32)
    eos = free[0][1][2]  # a token the first request emits third
    got, want = serve_both("granite-20b", models, mesh, reqs, max_batch=2, s_max=32,
                           eos_id=eos)
    assert got == want
    stopped = [toks for _, toks in got if len(toks) < 8]
    assert stopped and all(toks[-1] == eos for toks in stopped)


def test_s_max_stop_and_clamped_write(models, mesh):
    """Slots stop at s_max - 1; a prompt of s_max tokens decodes at index
    s_max, whose cache write both engines clamp to the last position."""
    cfg = get_config("granite-20b", smoke=True)
    reqs = stream(cfg, [6, 12, 9, 3], [20, 20, 20, 20], seed=4)
    got, want = serve_both("granite-20b", models, mesh, reqs, max_batch=2, s_max=12)
    assert got == want
    assert all(len(toks) < 20 for _, toks in got)


def test_embeds_model_refused():
    cfg = get_config("musicgen-large", smoke=True)
    model = ttfm.init_params(cfg, None, "meta")
    with pytest.raises(ValueError, match="embeds"):
        tserve.ServeEngine(cfg, model, tserve.EngineConfig(), device="cpu")


def test_model_on_another_device_refused():
    cfg = get_config("granite-20b", smoke=True)
    model = ttfm.init_params(cfg, None, "meta")
    with pytest.raises(ValueError, match="meta"):
        tserve.ServeEngine(cfg, model, tserve.EngineConfig(), device="cpu")
