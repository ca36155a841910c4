from .step import (TrainConfig, build_decode_step, build_prefill_step,  # noqa: F401
                   build_train_step, value_and_grad)
