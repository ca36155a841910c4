from .step import (MeshState, TrainConfig, build_decode_step, build_prefill_step,  # noqa: F401
                   build_train_step, shardings_for, value_and_grad)
