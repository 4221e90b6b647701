"""Serving runtime of the port: :mod:`engine` provides slot-based
continuous batching — requests join and leave a persistent decode loop at
token granularity instead of waiting for fixed-batch windows; :mod:`fleet`
+ :mod:`router` own N engine replicas behind one health-routed surface
(failover, draining, load shedding — the client sees one engine, the
system owns N); :mod:`rollout` rolls published weight versions across an
engine or a fleet one replica at a time, with rollback (zero-downtime
weight updates). The fleet and rollout modules import lazily here: the
single-engine path must not pay for them.
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
    "RolloutController",
    "ServingFleet",
    "WeightsIncompatible",
    "WeightsUpdate",
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
    if name in ("RolloutController", "WeightsUpdate"):
        from tensorflowonspark_tpu_torch.serving import rollout as _rollout

        return getattr(_rollout, name)
    raise AttributeError(name)
