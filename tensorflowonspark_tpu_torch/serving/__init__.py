"""Serving runtime of the port: :mod:`engine` provides slot-based
continuous batching — requests join and leave a persistent batched decode
loop at token granularity instead of waiting for fixed-batch windows.

The JAX package's fleet, router and rollout modules are not ported yet
(ROADMAP A9b); this package exports the engine and its errors only.
"""

from tensorflowonspark_tpu_torch.serving.engine import (
    ContinuousBatcher,
    DeadlineExceeded,
    EngineOverloaded,
    EngineWedged,
    WeightsIncompatible,
)

__all__ = [
    "ContinuousBatcher",
    "DeadlineExceeded",
    "EngineOverloaded",
    "EngineWedged",
    "WeightsIncompatible",
]
