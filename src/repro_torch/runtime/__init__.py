"""Runtime pieces: the batched driver's dispatch window and the restartable
training loop (``driver``), hierarchical data parallelism
(``hierarchical``) and the fault-tolerant iterated loop (``resilient``)."""
from .driver import (  # noqa: F401
    FailureInjector,
    LookaheadWindow,
    RuntimeConfig,
    StragglerEvent,
    StragglerEwma,
    TrainLoopResult,
    run_training,
)
from .hierarchical import ClusterState, CrossClusterDP  # noqa: F401
from .resilient import (  # noqa: F401
    IteratedResult,
    PreemptionError,
    ResilientConfig,
    SpgemmFailureInjector,
    check_preemption,
    clear_preemption,
    install_preemption_handler,
    preemption_requested,
    restore_arrays_latest,
    run_iterated,
)
