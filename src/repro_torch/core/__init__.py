"""Core library: the communication-avoiding, memory-constrained SpGEMM
(BatchedSUMMA3D) as PyTorch modules.

Layering (bottom-up):
  semiring      algebra the multiply runs over (paper §II-A)
  sparse        fixed-capacity padded COO + structural ops
  sortkeys      packed-key sort / compress / merge engine
  local_spgemm  per-process multiply/merge (paper §IV-D)
  symbolic      batch-count math (paper Alg. 3 line 12 + Eq. 2)
  grid          the process grid and its collectives
  distsparse    matrices distributed over the grid (paper Fig. 1)
  summa3d       one batch of the 3D sparse SUMMA (paper Alg. 2)
  batched       BatchedSUMMA3D + the symbolic step (paper Alg. 3/4)
  convert       moving state between the JAX reference and the port
"""
