"""Serving: the plan-cached SpGEMM engine (multiply-as-a-service) and the
continuous-batching LM engine."""
from .engine import (  # noqa: F401
    MultiplyRequest,
    MultiplyResult,
    PlanCacheEntry,
    ServeConfig,
    SpgemmEngine,
    matrix_signature,
)
from .lm_engine import EngineConfig, Request, ServeEngine  # noqa: F401
