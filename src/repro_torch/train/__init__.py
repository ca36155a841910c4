from .step import TrainConfig, build_train_step, value_and_grad  # noqa: F401
