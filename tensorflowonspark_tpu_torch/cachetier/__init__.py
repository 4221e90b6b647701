"""tfos.cachetier — disaggregated read-through cache tier.

One byte-budgeted LRU store (:class:`~.service.CacheTier`), one TCP
daemon (:class:`~.service.CacheServer`), two client spellings
(:class:`~.service.LocalClient` / :class:`~.service.CacheClient`), and
two planes riding them: the fleet-global prefix L2 for serving
(:class:`~.prefix.PrefixL2`) and the shared columnar frame cache for
training (the ``frames`` namespace + :class:`~.frames.FrameCache`).
See docs/SERVING.md "Cache tier".
"""

from tensorflowonspark_tpu_torch.cachetier.frames import FrameCache
from tensorflowonspark_tpu_torch.cachetier.prefix import PrefixL2
from tensorflowonspark_tpu_torch.cachetier.service import (
    CacheClient,
    CacheServer,
    CacheTier,
    LocalClient,
)

__all__ = [
    "CacheClient",
    "CacheServer",
    "CacheTier",
    "FrameCache",
    "LocalClient",
    "PrefixL2",
]
