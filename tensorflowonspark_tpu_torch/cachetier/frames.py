"""Shared frame cache — the training plane's cachetier client.

N co-located readers (grain ``ColumnarFrameDataSource`` workers,
``ShardReader``/``IngestFeed`` drains) over one columnar dataset used
to cost N full passes over backing storage. :class:`FrameCache` fronts
the cachetier ``frames`` namespace so each frame is fetched from
backing storage ONCE — the read-through pread happens in the service
(:meth:`~.service.CacheTier.get_frame`), and every subsequent reader
gets the cached bytes.

Coherence is trivial by construction: ``scan_frames`` header offsets
over immutable frame files are the key space (``frame_key``), and a
frame's bytes at ``(path, off, span)`` never change once written.

Failure is a fallback, never an error: :meth:`get` returns None on any
cache-side problem (service down, timeout, dropped lookup+failed
backing read) and the caller reads its local mmap/pread path exactly
as it did before the cache existed.
"""

from __future__ import annotations

import logging
from typing import Any

logger = logging.getLogger(__name__)

__all__ = ["FrameCache"]


class FrameCache:
    """Reader-facing facade over a cachetier client (``LocalClient`` or
    ``CacheClient``) for the ``frames`` namespace."""

    def __init__(self, client: Any, *, timeout_s: float = 0.5):
        self.client = client
        self.timeout_s = float(timeout_s)

    def get(self, path: str, off: int, span: int) -> bytes | None:
        """One frame's bytes via the cache tier, or None (caller falls
        back to its local read path). Never raises."""
        try:
            return self.client.get_frame(
                path, int(off), int(span), timeout_s=self.timeout_s
            )
        except Exception:  # noqa: BLE001 - cache failure = local fallback
            logger.warning("frame cache get failed", exc_info=True)
            return None

    def stats(self) -> dict | None:
        try:
            return self.client.stats()
        except Exception:  # noqa: BLE001 - stats are best-effort
            return None

    def close(self) -> None:
        try:
            self.client.close()
        except Exception:  # noqa: BLE001 - teardown is best-effort
            pass
