"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``spgemm_hash`` (hash-accumulator insert), ``spgemm_binned``
(k-binned paired multiply), ``col_prune`` (per-column top-k bisection),
``spmm`` (sparse × dense) and ``densify`` (COO → dense tile). ``_build``
compiles ``csrc/`` with nvcc at first use."""
