"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version, with public wrappers (``ops``) and the plain versions under the
JAX package's oracle names (``ref``):

  spgemm_hash    hash-accumulator insert
  spgemm_binned  k-binned paired multiply
  spgemm_acc     sort-free paired multiply
  sort_engine    bitonic sort of (key, value) pairs
  col_prune      per-column top-k bisection
  spmm_kernel    sparse × dense
  densify_kernel COO → dense tile
  segment_reduce order-fixed reduction of sorted runs (the packed-key
                 engine's deterministic sum; no TPU kernel behind it)

``_build`` compiles ``csrc/`` with nvcc at first launch; importing builds
nothing. The package exports the ``ops`` wrappers by name:
``repro_torch.kernels.spmm`` and ``.densify`` are those functions.
"""
from . import ops, ref  # noqa: F401
from .ops import (  # noqa: F401
    densify,
    sort_pairs,
    spgemm_paired,
    spgemm_paired_binned,
    spmm,
)
