"""How far f32 whole-model gradients sit from an f64 one, on the CPU.

For each SMOKE architecture (or those named), on the inputs of
``tests/test_torch_train.py::test_lm_loss_and_grads_match_jax`` (the JAX
package's seeded init, seed 11, a batch of 2 x 8): the gradient of
``lm_loss`` in f32 from the port and from the JAX package (under a 1 x 1
mesh, as the test runs it), and from the port in f64. Prints one line a
parameter: the tensor's largest |entry|, each f32 result's largest
distance from the f64 one and the two f32 results' distance, each also as
a share of that largest entry, and how many entries miss the old check
(rtol 1e-4, atol 1e-6). Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/torch_grad_f64.py [ARCH ...]

The f64 run is the port's own code with ``Tensor.float`` and
``torch.float32`` made to mean f64 for that run only, so every cast the
models make to "f32" keeps f64.
"""
from __future__ import annotations

import sys

import jax
import numpy as np
import torch

from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs import get_config as j_get_config
from repro.models import transformer as jtfm
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.convert import lm_params_from_reference
from repro_torch.models import transformer as ttfm
from repro_torch.train import value_and_grad

SEED, B, S = 11, 2, 8  # test_torch_train.py's _lm_case


def case(arch):
    cfg = j_get_config(arch, smoke=True)
    params = jax.tree.map(np.asarray, jtfm.init_params(cfg, jax.random.PRNGKey(SEED)))
    rng = np.random.default_rng(SEED)
    if cfg.input_mode == "tokens":
        inputs = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    else:
        inputs = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    targets = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return cfg, params, inputs, targets


def unstack(tree, path=()):
    """{port parameter name: array} of a JAX tree (layers unstacked)."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update(unstack(node, path + (name,)))
        elif (path + (name,))[0] == "layers":
            for i in range(node.shape[0]):
                out[".".join(("layers", str(i)) + path[1:] + (name,))] = node[i]
        else:
            out[".".join(path + (name,))] = node
    return out


def port_grads(cfg, params, inputs, targets):
    model = lm_params_from_reference(cfg, params, "cpu", master=True)
    t = lambda x: torch.as_tensor(np.array(x, copy=True))  # noqa: E731
    return value_and_grad(
        lambda p: ttfm.lm_loss(cfg, p, t(inputs), t(targets), aux_weight=0.01), model)


def main(archs):
    mesh = make_mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
    for arch in archs:
        jcfg, params, inputs, targets = case(arch)
        fn = jax.jit(jax.value_and_grad(
            lambda p, i, tg: jtfm.lm_loss(jcfg, p, i, tg, mesh, aux_weight=0.01)))
        with set_mesh(mesh):
            _, jg = fn(params, inputs, targets)
        jg = unstack(jax.tree.map(np.asarray, jg))
        cfg = get_config(arch, smoke=True)
        _, g32 = port_grads(cfg, params, inputs, targets)
        f32, to_float = torch.float32, torch.Tensor.float
        torch.float32 = torch.float64
        torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
        try:
            _, g64 = port_grads(cfg, params, inputs, targets)
        finally:
            torch.float32, torch.Tensor.float = f32, to_float
        print(f"== {arch}")
        for name in sorted(g64):
            assert g64[name].dtype == torch.float64, name
            ref = g64[name].numpy()
            port, jx = g32[name].double().numpy(), jg[name].astype(np.float64)
            top = float(np.abs(ref).max()) or 1.0
            ep, ej, epj = (float(np.abs(a - b).max()) for a, b in
                           ((port, ref), (jx, ref), (port, jx)))
            misses = int((~np.isclose(port, jx, rtol=1e-4, atol=1e-6)).sum())
            print(f"{name:40s} max|g| {top:.3e} |port-f64| {ep:.3e} ({ep / top:.2e}) "
                  f"|jax-f64| {ej:.3e} ({ej / top:.2e}) |port-jax| {epj:.3e} "
                  f"({epj / top:.2e}) misses {misses}")


if __name__ == "__main__":
    main(sys.argv[1:] or ARCHS)
