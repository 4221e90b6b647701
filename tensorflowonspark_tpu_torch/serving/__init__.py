"""Serving runtime of the port: :mod:`engine` provides slot-based
continuous batching — requests join and leave a persistent decode loop at
token granularity instead of waiting for fixed-batch windows; :mod:`fleet`
+ :mod:`router` own N engine replicas behind one health-routed surface
(failover, draining, load shedding — the client sees one engine, the
system owns N). The fleet modules import lazily here: the single-engine
path must not pay for them.

The JAX package's rollout module is not ported yet (ROADMAP A9b, rollout).
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
    "FleetOverloaded",
    "FleetRouter",
    "FleetUnavailable",
    "ReplicaGone",
    "ServingFleet",
    "WeightsIncompatible",
]


def __getattr__(name):
    if name in (
        "ServingFleet",
        "FleetOverloaded",
        "FleetUnavailable",
        "ReplicaGone",
    ):
        from tensorflowonspark_tpu_torch.serving import fleet as _fleet

        return getattr(_fleet, name)
    if name == "FleetRouter":
        from tensorflowonspark_tpu_torch.serving.router import FleetRouter

        return FleetRouter
    raise AttributeError(name)
