"""Fleet-global prefix L2 — the serving plane's cachetier client (port of
:mod:`tensorflowonspark_tpu.cachetier.prefix`, rewritten for torch).

The per-engine ``_PrefixStore`` (serving/engine.py) stays L1: device-
resident and scheduler-thread-only. This module is the L2 behind it — a
:class:`PrefixL2` wraps a cachetier client (in-process ``LocalClient``
for `InProcessReplica`s, TCP ``CacheClient`` for subprocess ones) so a
prefix prefilled by ANY replica is reusable by all of them.

Keying — the exactness contract::

    prefix|<weights_version>|<adapter>|<t0,t1,...,tk>

``weights_version`` and adapter are baked into every key, so a rollout
invalidates EXACTLY (drop the old version's key prefix, touch nothing
else) and a stale-version cache can never extend a new-version decode.

Latency contract (the cache is never a liveness dependency):

- :meth:`lookup` runs on the engine scheduler thread, so it carries a
  TOTAL deadline across its depth probes (miss-on-timeout, default
  50 ms) and never raises;
- :meth:`offer` is fire-and-forget: the scheduler thread records a CUDA
  event behind the entry and enqueues the tensors; a background filler
  thread pays the device→host copy, the serialization and the
  transport, with a bounded drop-oldest queue so a slow or dead service
  sheds offers instead of backpressure.

What differs from the JAX package's module, and why:

- **Ordering.** The reference's filler reads device leaves with
  ``np.asarray`` and relies on JAX arrays being immutable. The port's
  entries are torch tensors written by work queued on the scheduler's
  stream, so :meth:`offer` records an event on the caller's current
  stream, and the filler's own stream waits on that event before it
  copies the leaves into pinned host buffers (non-blocking, then the
  filler waits for its own copy's event). Nothing here synchronizes the
  scheduler's thread. The filler keeps the tensors referenced until its
  copy has finished, so the allocator cannot hand their memory to other
  work while it is read.
- **Serialization.** bfloat16 has no numpy dtype, so a value is one
  blob: a magic tag, a pickled list of ``(dtype name, shape, nbytes)``,
  then every leaf's raw bytes in order. :meth:`lookup` returns CPU
  tensors (in one pinned buffer when CUDA is there, so the engine's
  upload is one asynchronous copy); a blob that is not in this format is
  skipped like a miss. Whether the leaves fit the engine's cache is the
  engine's check (``ContinuousBatcher._l2_reconstruct``): a foreign
  config's entry is a miss there.
"""

from __future__ import annotations

import logging
import pickle
import struct
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Sequence

logger = logging.getLogger(__name__)

__all__ = ["PrefixL2", "decode_leaves", "encode_leaves", "prefix_key", "version_prefix"]

NS = "prefix"
_MAGIC = b"TPL2"
_LEN = struct.Struct("!I")


def prefix_key(version: Any, adapter: str | None, tokens: Sequence[int]) -> str:
    """The L2 key of one ``(weights_version, adapter, token-prefix)``."""
    toks = ",".join(str(int(t)) for t in tokens)
    return f"{version}|{adapter or ''}|{toks}"


def version_prefix(version: Any) -> str:
    """The key prefix owned by one weights version — the argument a
    rollout passes to ``invalidate`` to reclaim that version exactly."""
    return f"{version}|"


def encode_leaves(host: list) -> bytes:
    """One blob of CPU tensors: the magic tag, the pickled ``(dtype,
    shape, nbytes)`` of each, then their raw bytes in order."""
    import torch

    raws = [t.contiguous().reshape(-1).view(torch.uint8).numpy() for t in host]
    meta = pickle.dumps(
        [(str(t.dtype).rpartition(".")[2], tuple(t.shape), int(r.nbytes))
         for t, r in zip(host, raws)],
        protocol=pickle.HIGHEST_PROTOCOL,
    )
    return b"".join([_MAGIC, _LEN.pack(len(meta)), meta, *(r.tobytes() for r in raws)])


def decode_leaves(blob: bytes, pin: bool = False) -> list | None:
    """The CPU tensors of an :func:`encode_leaves` blob (views of one
    buffer, pinned with ``pin``), or None when the blob is not one."""
    import numpy as np
    import torch

    try:
        if blob[:4] != _MAGIC:
            return None
        (n,) = _LEN.unpack_from(blob, 4)
        meta = pickle.loads(blob[8:8 + n])
        off = 8 + n
        total = sum(int(nb) for _, _, nb in meta)
        if off + total != len(blob):
            return None
        buf = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
        buf.numpy()[:] = np.frombuffer(blob, np.uint8, total, off)
        out, at = [], 0
        for name, shape, nb in meta:
            dtype = getattr(torch, str(name), None)
            if not isinstance(dtype, torch.dtype):
                return None
            out.append(buf[at:at + nb].view(dtype).reshape(shape))
            at += nb
        return out
    except Exception:  # noqa: BLE001 - a malformed blob is a miss
        return None


class PrefixL2:
    """The engine-facing L2 facade over a cachetier client."""

    def __init__(
        self,
        client: Any,
        *,
        chunk: int,
        lookup_timeout_s: float = 0.05,
        fill_queue: int = 32,
        dedup_window: int = 256,
        own_client: bool = False,
    ):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.client = client
        self._own_client = bool(own_client)
        self.chunk = int(chunk)
        self.lookup_timeout_s = float(lookup_timeout_s)
        self._lock = threading.Lock()
        self._hits = 0  # guarded-by: self._lock
        self._misses = 0  # guarded-by: self._lock
        self._offered = 0  # guarded-by: self._cv
        self._offer_drops = 0  # guarded-by: self._cv
        self._offer_dedups = 0  # guarded-by: self._cv
        self._closed = False  # guarded-by: self._cv
        # Offer dedup: a key's value is a pure function of (version,
        # adapter, tokens), so re-publishing a recently offered key buys
        # nothing and costs a device→host copy per repeat. Bounded, and
        # self-healing: a lookup MISS on a key evicts it here, so an
        # entry the tier dropped (LRU pressure, daemon respawn) is
        # offered again the next time a request completes it.
        self._recent: "OrderedDict[str, None]" = OrderedDict()  # guarded-by: self._cv
        self._dedup_window = max(0, int(dedup_window))
        # (key, tensors, ready event or None): the scheduler thread
        # appends, the filler thread pays the rest
        self._q: deque[tuple[str, list, Any]] = deque(maxlen=fill_queue)  # guarded-by: self._cv
        self._cv = threading.Condition()
        self._stream = None  # the filler's CUDA stream, made on first use
        self._filler = threading.Thread(
            target=self._fill_loop, name="prefix-l2-filler", daemon=True
        )
        self._filler.start()

    # -- lookup (scheduler thread; bounded, never raises) --------------

    def _depths(self, n: int) -> list[int]:
        """Candidate stored depths for an ``n``-token prompt, longest
        first: the full prompt plus the L1 boundary-insert ladder
        (``chunk * 2**k``) — exactly the depths any engine inserts at."""
        out = {n}
        d = self.chunk
        while d < n:
            out.add(d)
            d *= 2
        return sorted(out, reverse=True)

    def lookup(
        self, tokens: Sequence[int], adapter: str | None, version: Any
    ) -> tuple[list, int] | None:
        """Longest cached prefix of ``tokens`` under this version —
        ``(CPU tensors, depth)`` — or None. Spends at most
        ``lookup_timeout_s`` across ALL depth probes; a slow or dead
        service is a miss, never a stall."""
        n = len(tokens)
        if n < 2:
            return None
        deadline = time.monotonic() + self.lookup_timeout_s
        try:
            import torch

            pin = torch.cuda.is_available()
            for depth in self._depths(n):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                key = prefix_key(version, adapter, tokens[:depth])
                blob = self.client.lookup(NS, key, timeout_s=remaining)
                if blob is None:
                    # the tier does not have this key: clear it from the
                    # dedup window so the next completion re-publishes it
                    with self._cv:
                        self._recent.pop(key, None)
                    continue
                leaves = decode_leaves(blob, pin=pin)
                if leaves is None:
                    continue
                with self._lock:
                    self._hits += 1
                return leaves, depth
        except Exception:  # noqa: BLE001 - L2 failure IS a miss
            logger.warning("prefix L2 lookup failed", exc_info=True)
        with self._lock:
            self._misses += 1
        return None

    # -- offer (scheduler thread enqueues; filler thread pays) ---------

    def offer(
        self,
        tokens: Sequence[int],
        leaves: list,
        adapter: str | None,
        version: Any,
    ) -> None:
        """Publish one prefix's cache tensors, fire-and-forget. They must
        not be written again (the engine's prefix entries are not); the
        copy to the host happens on the filler thread, ordered after
        the work the calling thread has queued so far."""
        import torch

        key = prefix_key(version, adapter, tokens)
        with self._cv:
            if self._closed:
                return
            if self._dedup_window:
                if key in self._recent:
                    self._recent.move_to_end(key)
                    self._offer_dedups += 1
                    return
                self._recent[key] = None
                while len(self._recent) > self._dedup_window:
                    self._recent.popitem(last=False)
        leaves = [x if isinstance(x, torch.Tensor) else torch.as_tensor(x) for x in leaves]
        ready = None
        on_card = [x for x in leaves if x.is_cuda]
        if on_card:
            # after the producer's work on this thread's stream; the
            # filler's stream waits on it (no host sync here)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(on_card[0].device))
        with self._cv:
            if self._closed:
                return
            if len(self._q) == self._q.maxlen:
                self._offer_drops += 1
            self._q.append((key, leaves, ready))
            self._offered += 1
            self._cv.notify()

    def _to_host(self, leaves: list, ready) -> list:
        """CPU copies of ``leaves``: device tensors through pinned
        buffers on the filler's own stream, after ``ready``."""
        import torch

        if ready is None:
            return leaves  # CPU tensors of an entry nobody writes
        dev = next(x.device for x in leaves if x.is_cuda)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        side = self._stream
        side.wait_event(ready)  # the entry is written before it is read
        with torch.cuda.stream(side):
            host = []
            for x in leaves:
                if x.is_cuda:
                    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    h.copy_(x, non_blocking=True)
                    host.append(h)
                else:
                    host.append(x)
            done = torch.cuda.Event()
            done.record(side)
        done.synchronize()  # this thread only; `leaves` stay referenced until here
        return host

    def _fill_loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait(timeout=0.5)
                if self._closed and not self._q:
                    return
                key, leaves, ready = self._q.popleft()
            try:
                blob = encode_leaves(self._to_host(leaves, ready))
                del leaves
                self.client.fill(NS, key, blob)
            except Exception:  # noqa: BLE001 - a lost offer is a miss later
                logger.warning("prefix L2 offer failed", exc_info=True)

    # -- maintenance ---------------------------------------------------

    def invalidate_version(self, version: Any) -> int:
        """Exact-by-key reclamation of one weights version (the rollout
        hook); returns entries dropped (0 when the service is down —
        harmless: the old version's keys can never be looked up again)."""
        try:
            return self.client.invalidate(NS, version_prefix(version))
        except Exception:  # noqa: BLE001 - reclamation is best-effort
            logger.warning("prefix L2 invalidate failed", exc_info=True)
            return 0

    def stats(self) -> dict[str, int]:
        with self._lock:
            hits, misses = self._hits, self._misses
        with self._cv:
            offered, drops = self._offered, self._offer_drops
            dedups = self._offer_dedups
        return {
            "l2_hits": hits,
            "l2_misses": misses,
            "l2_offered": offered,
            "l2_offer_drops": drops,
            "l2_offer_dedups": dedups,
        }

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._filler.join(timeout=2.0)
        if self._own_client:
            try:
                self.client.close()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                logger.warning("prefix L2 client close failed",
                               exc_info=True)
