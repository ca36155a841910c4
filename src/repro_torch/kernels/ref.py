"""The plain PyTorch versions of the kernels under the JAX package's oracle
names (``repro/kernels/ref.py``), for callers and tests that hold a kernel
against its plain version. Each is re-exported from its kernel module, not
written a second time."""
from .densify_kernel import densify_ref  # noqa: F401
from .spgemm_acc import spgemm_paired_ref  # noqa: F401
from .spgemm_binned import spgemm_paired_binned_ref  # noqa: F401
from .spmm_kernel import spmm_ref  # noqa: F401
