"""PyTorch port of the communication-avoiding, memory-constrained SpGEMM.

Laid out module for module like the JAX package ``repro``:

  core/      semirings, padded-COO format, packed-key engine, grid,
             distributed matrices, symbolic planning, local multiplies,
             the SUMMA3D steps, placement and the batched driver
  tune/      the α–β–γ cost model and the autotuner
  kernels/   the hand-written Hopper kernels (CUDA C++ in ``csrc/``), each
             beside its plain PyTorch version, and their nvcc/ctypes build
  runtime/   the pipelined dispatch window
  sparse_apps/  applications on the batched multiply: Markov clustering,
             triangle counting and overlap pairs

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU. Importing the package builds nothing.
"""
