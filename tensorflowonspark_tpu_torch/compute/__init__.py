"""Optimizers and the single-device train and eval steps."""

from tensorflowonspark_tpu_torch.compute.optim import (  # noqa: F401
    adamw,
    mixed_precision_adamw,
    scale_by_adam,
    sgd,
)
from tensorflowonspark_tpu_torch.compute.train import (  # noqa: F401
    TrainState,
    build_bn_train_step,
    build_eval_step,
    build_train_step,
)
