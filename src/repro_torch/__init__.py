"""PyTorch port of the communication-avoiding, memory-constrained SpGEMM.

Laid out module for module like the JAX package ``repro``:

  core/      semirings, padded-COO format, packed-key engine, grid,
             distributed matrices, symbolic planning, local multiplies,
             the SUMMA3D steps, placement and the batched driver
  tune/      the α–β–γ cost model and the autotuner
  kernels/   the hand-written Hopper kernels (CUDA C++ in ``csrc/``), each
             beside its plain PyTorch version, and their nvcc/ctypes build
  checkpoint/  the checkpoint store (the JAX package's on-disk format)
  runtime/   the pipelined dispatch window, and the resilient iterated
             loop (checkpoint/resume, fault injection, SIGTERM)
  sparse_apps/  applications on the batched multiply: Markov clustering,
             triangle counting, overlap pairs and all-pairs shortest paths
  serve/     the plan-cached SpGEMM engine and the continuous-batching LM
             engine
  models/    the decoder LMs (attention, MLP, MoE with its dispatch on the
             SpMM kernel, Mamba2) and configs/ their architectures

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU. Importing the package builds nothing.
"""
