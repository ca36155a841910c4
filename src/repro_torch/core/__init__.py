"""Core library: the communication-avoiding, memory-constrained SpGEMM
(BatchedSUMMA3D) as PyTorch modules.

Layering (bottom-up):
  semiring      algebra the multiply runs over (paper §II-A)
  sparse        fixed-capacity padded COO + structural ops
  sortkeys      packed-key sort / compress / merge engine
  local_spgemm  per-process multiply/merge (paper §IV-D)
  symbolic      batch-count math (paper Alg. 3 line 12 + Eq. 2)
  gen           synthetic workload generators (paper Table V regimes)
  grid          the process grid and its collectives
  distsparse    matrices distributed over the grid (paper Fig. 1)
  summa3d       one batch of the 3D sparse SUMMA (paper Alg. 2): the fused
                step, the dense step (allgather or the Cannon ring) and
                the sparse step
  specs         the driver's knobs: PlanSpec, PlanFloors, ExecSpec
  placement     tile→batch distributions and structure-aware permutations
  batched       BatchedSUMMA3D + the symbolic step (paper Alg. 3/4)
  convert       moving state between the JAX reference and the port

``repro_torch.tune`` prices configurations of this multiply;
``repro_torch.launch.spawn`` starts one process per point of a grid.
"""
from . import gen, local_spgemm, semiring, sparse, symbolic  # noqa: F401
from .sparse import SparseCOO, coalesce, empty, from_dense, from_numpy_coo  # noqa: F401
from .semiring import PLUS_TIMES, OR_AND, MIN_PLUS, MAX_TIMES, PLUS_PAIR  # noqa: F401
