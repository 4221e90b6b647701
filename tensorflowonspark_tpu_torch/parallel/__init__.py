"""Ambient mesh context (port of :mod:`tensorflowonspark_tpu.parallel`)."""

from tensorflowonspark_tpu_torch.parallel.context import (  # noqa: F401
    current_mesh,
    dispatch_mesh,
    use_mesh,
)
