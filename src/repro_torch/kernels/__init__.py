"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``spgemm_hash`` (hash-accumulator insert) and ``spgemm_binned``
(k-binned paired multiply). ``_build`` compiles ``csrc/`` with nvcc at first
use."""
