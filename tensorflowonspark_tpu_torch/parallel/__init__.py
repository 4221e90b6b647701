"""Ambient mesh context and mixture-of-experts (port of
:mod:`tensorflowonspark_tpu.parallel`; ring attention, Ulysses and the
pipeline wait for ROADMAP A10)."""

from tensorflowonspark_tpu_torch.parallel.context import (  # noqa: F401
    current_mesh,
    dispatch_mesh,
    use_mesh,
)
from tensorflowonspark_tpu_torch.parallel.moe import (  # noqa: F401
    MoEConfig,
    MoEMLP,
    moe_param_shardings,
)
