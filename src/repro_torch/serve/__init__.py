"""Serving: the plan-cached SpGEMM engine (multiply-as-a-service).

The JAX package's ``repro.serve`` also exports ``EngineConfig``, ``Request``
and ``ServeEngine``, its transformer server; they come to the port with the
LM scaffold.
"""
from .engine import (  # noqa: F401
    MultiplyRequest,
    MultiplyResult,
    PlanCacheEntry,
    ServeConfig,
    SpgemmEngine,
    matrix_signature,
)
