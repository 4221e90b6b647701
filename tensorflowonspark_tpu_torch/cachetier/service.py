"""tfos.cachetier — disaggregated read-through cache: store, daemon,
clients.

The tf.data-service result (PAPERS.md, arXiv 2101.12127) is that the
cache belongs in its own service, not in each consumer: N consumers hit
backing storage/compute ONCE instead of N times. This module is that
shape for both planes — one byte-budgeted LRU KV store
(:class:`CacheTier`) with a thin TCP daemon (:class:`CacheServer`) and
two client spellings (:class:`LocalClient` for co-resident consumers,
:class:`CacheClient` over TCP for subprocess ones). The serving plane
rides it as the fleet-global prefix L2 (``cachetier/prefix.py``); the
training plane rides it as the shared columnar frame cache (the
``frames`` namespace, read-through against the frame files on disk).

The load-bearing design rule, proven by the chaos tests: **the cache is
an optimization, never a liveness dependency.** Every client operation
is bounded-latency and failure-is-a-miss — a SIGKILL'd daemon, a
saturated socket, or an armed ``cachetier.lookup`` drop all degrade to
hit-rate zero, never to a hang or an error on the consumer's hot path.
Concretely:

- lookups carry a deadline (socket timeout); timeout/reset/refused →
  close the connection, back off (``_DOWN_BACKOFF_S``), report miss;
- fills are fire-and-forget through a bounded drop-oldest queue on a
  background filler thread — the producing thread never blocks;
- the store itself never read-blocks on backing storage for KV
  namespaces; only the ``frames`` namespace is read-through, and that
  read happens IN the service (the whole point: one pread per frame
  however many readers want it).

Keys are caller-structured strings; the prefix plane bakes
``weights_version`` and adapter into its keys (see ``prefix.py``) so
weight rollout invalidation is an exact by-key drop
(:meth:`CacheTier.invalidate` with a version prefix), never a flush.

Fixed in the port: :meth:`CacheServer.close` shuts down and closes every
accepted connection that is still open, not only the listener (the
server keeps a lock-guarded set of them). A connection thread checks
``_stop`` only between requests, so without this a lookup sent on an
open connection after ``close()`` could still be answered; now it is
always a miss within the client's timeout. And a :class:`CacheClient`
whose connection the server closed (idle past the server's 30 s read
timeout) reconnects once within the request's bound, where the JAX
package's dropped that request and, in the down window that followed,
every fill and lookup of the next second.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import socket
import struct
import threading
import time
from collections import OrderedDict, deque
from typing import Any

from tensorflowonspark_tpu_torch.cluster import wire
from tensorflowonspark_tpu_torch.utils.failpoints import failpoint

logger = logging.getLogger(__name__)

__all__ = [
    "CacheClient",
    "CacheServer",
    "CacheTier",
    "LocalClient",
    "frame_key",
]

_LEN = struct.Struct("!I")
_MAX_HEADER = 1 << 20  # a pickled request header beyond 1 MiB is garbage
# Per-entry admission cap as a fraction of capacity: one huge blob must
# not evict the entire working set to buy a single future hit.
_MAX_ENTRY_FRACTION = 0.5
# After a transport error the client treats the service as down for this
# long: every lookup in the window is an instant miss (no connect storm,
# no per-request timeout tax while the daemon respawns).
_DOWN_BACKOFF_S = 1.0
_DEFAULT_TIMEOUT_S = 0.05
_DEFAULT_CAPACITY = 256 << 20


# -- obs ---------------------------------------------------------------------

_metrics_lock = threading.Lock()
_metrics: dict[str, Any] | None = None


def metrics() -> dict[str, Any]:
    """Cache-tier counters/gauges in the process-global obs registry
    (lazy: importing this module never drags in the obs package)."""
    global _metrics
    if _metrics is None:
        with _metrics_lock:
            if _metrics is None:
                from tensorflowonspark_tpu_torch.obs.registry import default_registry

                r = default_registry()
                _metrics = {
                    "hits": r.counter(
                        "cachetier_hits_total",
                        "cache-tier lookup hits, by namespace",
                    ),
                    "misses": r.counter(
                        "cachetier_misses_total",
                        "cache-tier lookup misses, by namespace "
                        "(timeouts and dropped lookups count here)",
                    ),
                    "evictions": r.counter(
                        "cachetier_evictions_total",
                        "cache-tier LRU evictions, by namespace",
                    ),
                    "fill_bytes": r.counter(
                        "cachetier_fill_bytes_total",
                        "bytes admitted into the cache tier, by namespace",
                    ),
                    "backing_read_bytes": r.counter(
                        "cachetier_backing_read_bytes_total",
                        "bytes the tier read through to backing storage "
                        "on a frames-namespace miss",
                    ),
                    "bytes": r.gauge(
                        "cachetier_bytes",
                        "current bytes resident in the cache tier",
                    ),
                    "hit_rate": r.gauge(
                        "cachetier_hit_rate",
                        "lifetime lookup hit fraction of the cache tier",
                    ),
                }
    return _metrics


def frame_key(path: str, off: int, span: int) -> str:
    """The ``frames``-namespace key of one columnar frame. Frames are
    immutable once written (the format has no in-place rewrite), so
    (absolute path, byte offset, span) identifies the bytes forever —
    coherence is trivial by construction."""
    return f"{os.path.abspath(path)}:{int(off)}:{int(span)}"


class CacheTier:
    """Byte-budgeted LRU KV store — the one store behind every
    transport. Namespaced string keys → immutable byte blobs.

    Thread-safe: servers fan requests out across connection handler
    threads and :class:`LocalClient` calls arrive from engine scheduler
    and reader threads concurrently, so every piece of mutable state
    here is lock-guarded.
    """

    def __init__(self, capacity_bytes: int = _DEFAULT_CAPACITY):
        if capacity_bytes < 1:
            raise ValueError(f"capacity_bytes must be >= 1, got {capacity_bytes}")
        self._lock = threading.Lock()
        # insertion/refresh order IS recency: move_to_end on hit, pop
        # from the front to evict
        self._entries: OrderedDict[tuple[str, str], bytes] = OrderedDict()  # guarded-by: self._lock
        self._bytes = 0  # guarded-by: self._lock
        self._capacity_bytes = int(capacity_bytes)  # guarded-by: self._lock
        self._hits = 0  # guarded-by: self._lock
        self._misses = 0  # guarded-by: self._lock
        self._fills = 0  # guarded-by: self._lock
        self._evictions = 0  # guarded-by: self._lock
        self._backing_read_bytes = 0  # guarded-by: self._lock

    # -- core KV ------------------------------------------------------

    def lookup(self, ns: str, key: str) -> bytes | None:
        """The blob, refreshing recency — or None. A dropped
        ``cachetier.lookup`` failpoint IS a miss (never a hang)."""
        t0 = time.perf_counter()
        if failpoint("cachetier.lookup") == "drop":
            self._count_miss(ns)
            return None
        with self._lock:
            blob = self._entries.get((ns, key))
            if blob is not None:
                self._entries.move_to_end((ns, key))
                self._hits += 1
                rate = self._hits / (self._hits + self._misses)
            else:
                self._misses += 1
                rate = self._hits / (self._hits + self._misses)
        m = metrics()
        (m["hits"] if blob is not None else m["misses"]).inc(ns=ns)
        m["hit_rate"].set(rate)
        _spans().record("cachetier.lookup", time.perf_counter() - t0)
        return blob

    def fill(self, ns: str, key: str, blob: bytes) -> bool:
        """Admit one entry (idempotent — refills refresh recency and
        replace bytes). Returns False when refused: a dropped
        ``cachetier.fill`` failpoint, or a blob too large to admit
        without evicting most of the working set."""
        t0 = time.perf_counter()
        if failpoint("cachetier.fill") == "drop":
            return False
        blob = bytes(blob)
        n = len(blob)
        with self._lock:
            if n > self._capacity_bytes * _MAX_ENTRY_FRACTION:
                return False
            old = self._entries.pop((ns, key), None)
            if old is not None:
                self._bytes -= len(old)
            self._entries[(ns, key)] = blob
            self._bytes += n
            self._fills += 1
            self._evict_locked()
            cur = self._bytes
        m = metrics()
        m["fill_bytes"].inc(n, ns=ns)
        m["bytes"].set(cur)
        _spans().record("cachetier.fill", time.perf_counter() - t0)
        return True

    def invalidate(self, ns: str, prefix: str = "") -> int:
        """Drop every ``ns`` entry whose key starts with ``prefix`` —
        the exact-by-key reclamation path (a rollout drops the old
        ``weights_version`` prefix; nothing else is touched)."""
        with self._lock:
            doomed = [
                k for k in self._entries
                if k[0] == ns and k[1].startswith(prefix)
            ]
            for k in doomed:
                self._bytes -= len(self._entries.pop(k))
            cur = self._bytes
        metrics()["bytes"].set(cur)
        return len(doomed)

    def _evict_locked(self) -> None:  # lint: holds-lock
        """LRU-evict down to budget. Caller holds ``_lock``. A dropped
        ``cachetier.evict`` failpoint ends the round — the store runs
        transiently over budget (the next fill resumes), never
        corrupts."""
        evicted = 0
        while self._bytes > self._capacity_bytes and self._entries:
            if failpoint("cachetier.evict") == "drop":
                break
            (ns, key), blob = self._entries.popitem(last=False)
            self._bytes -= len(blob)
            self._evictions += 1
            evicted += 1
            metrics()["evictions"].inc(ns=ns)
        if evicted:
            logger.debug("cachetier evicted %d entries", evicted)

    # -- frames namespace: read-through -------------------------------

    def get_frame(self, path: str, off: int, span: int) -> bytes | None:
        """One columnar frame's bytes, read-through: a miss preads the
        backing file HERE — in the service — so N readers cost one
        backing read. Returns None only when the backing read itself
        fails (caller falls back to its local path)."""
        key = frame_key(path, off, span)
        blob = self.lookup("frames", key)
        if blob is not None:
            return blob
        try:
            fd = os.open(path, os.O_RDONLY)
            try:
                blob = os.pread(fd, int(span), int(off))
            finally:
                os.close(fd)
        except OSError:
            logger.warning("cachetier backing read failed: %s", path,
                           exc_info=True)
            return None
        if len(blob) != int(span):
            logger.warning(
                "cachetier short backing read %s@%d: %d of %d bytes",
                path, off, len(blob), span,
            )
            return None
        with self._lock:
            self._backing_read_bytes += len(blob)
        metrics()["backing_read_bytes"].inc(len(blob))
        self.fill("frames", key, blob)
        return blob

    # -- knob plane ---------------------------------------------------

    @property
    def capacity_bytes(self) -> int:
        with self._lock:
            return self._capacity_bytes

    def set_capacity(self, capacity_bytes: int) -> None:
        """Resize the byte budget (the autotune actuation path —
        ``cachetier_capacity`` knob). Shrinking evicts immediately."""
        capacity_bytes = int(capacity_bytes)
        if capacity_bytes < 1:
            raise ValueError(f"capacity_bytes must be >= 1, got {capacity_bytes}")
        with self._lock:
            self._capacity_bytes = capacity_bytes
            self._evict_locked()
            cur = self._bytes
        metrics()["bytes"].set(cur)

    def _count_miss(self, ns: str) -> None:
        with self._lock:
            self._misses += 1
            rate = self._hits / (self._hits + self._misses)
        m = metrics()
        m["misses"].inc(ns=ns)
        m["hit_rate"].set(rate)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "fills": self._fills,
                "evictions": self._evictions,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "capacity_bytes": self._capacity_bytes,
                "backing_read_bytes": self._backing_read_bytes,
            }


def _spans():
    from tensorflowonspark_tpu_torch.obs import spans as obs_spans

    return obs_spans.get_tracer()


# ---------------------------------------------------------------------------
# TCP daemon
# ---------------------------------------------------------------------------
#
# Framing, both directions: u32 header length, pickled wire-encoded
# header dict, then exactly header["nbytes"] raw payload bytes (lookup
# replies and fill requests; every other message has no payload). The
# header dicts go through cluster/wire.py encode/decode — the protocol
# is declared in WIRE_SCHEMAS ("cachetier.*") and gated by wirecheck.


def _send_msg(sock: socket.socket, header: dict, payload: bytes = b"") -> None:
    raw = pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(raw)) + raw + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("cachetier peer closed mid-message")
        buf += chunk
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> tuple[dict, bytes]:
    (hlen,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if hlen > _MAX_HEADER:
        raise ConnectionError(f"cachetier header too large ({hlen} bytes)")
    header = pickle.loads(_recv_exact(sock, hlen))
    if not isinstance(header, dict):
        raise ConnectionError("cachetier header is not a dict")
    nbytes = header.get("nbytes")
    payload = b""
    if isinstance(nbytes, int) and nbytes > 0 and wire.message_kind(header) in (
        "CFILL",
        "COK",
    ):
        payload = _recv_exact(sock, nbytes)
    return header, payload


class CacheServer:
    """The daemon: one accept loop, one handler thread per connection,
    all requests answered from a single :class:`CacheTier`. Runnable
    in-process (fleet supervision spawns it as a subprocess via
    ``python -m tensorflowonspark_tpu_torch.cachetier.service``) and built to
    die rudely: every client treats a vanished server as a miss."""

    def __init__(self, tier: CacheTier, host: str = "127.0.0.1",
                 port: int = 0):
        self.tier = tier
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(64)
        self.host, self.port = self._lsock.getsockname()[:2]
        self._stop = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self._conns_lock = threading.Lock()
        self._conns: set[socket.socket] = set()  # guarded-by: self._conns_lock

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "CacheServer":
        t = threading.Thread(
            target=self._accept_loop, name="cachetier-accept", daemon=True
        )
        t.start()
        self._accept_thread = t
        return self

    def _accept_loop(self) -> None:
        self._lsock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # closed under us
            with self._conns_lock:
                if self._stop.is_set():  # close() ran after the accept
                    conn.close()
                    break
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="cachetier-conn", daemon=True,
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(30.0)
            while not self._stop.is_set():
                try:
                    header, payload = _recv_msg(conn)
                except (ConnectionError, socket.timeout, OSError,
                        pickle.UnpicklingError, EOFError):
                    return
                try:
                    reply, body = self._handle(header, payload)
                except wire.WireError:
                    logger.warning("cachetier malformed request",
                                   exc_info=True)
                    return  # protocol breach: drop the connection
                _send_msg(conn, reply, body)
        except OSError:
            pass  # client vanished mid-reply; nothing to clean up
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, header: dict, payload: bytes) -> tuple[dict, bytes]:
        kind = wire.message_kind(header)
        if kind == "CLOOKUP":
            req = wire.decode("cachetier.LOOKUP", header)
            blob = None
            path = req.get("path")
            if req["ns"] == "frames" and path:
                blob = self.tier.get_frame(
                    path, req.get("off") or 0, req.get("span") or 0
                )
            else:
                blob = self.tier.lookup(req["ns"], req["key"])
            if blob is None:
                return wire.encode(
                    "cachetier.LOOKUP.reply", hit=False, nbytes=0
                ), b""
            return wire.encode(
                "cachetier.LOOKUP.reply", hit=True, nbytes=len(blob)
            ), blob
        if kind == "CFILL":
            req = wire.decode("cachetier.FILL", header)
            stored = self.tier.fill(req["ns"], req["key"], payload)
            return wire.encode("cachetier.FILL.reply", stored=stored), b""
        if kind == "CINVAL":
            req = wire.decode("cachetier.INVALIDATE", header)
            n = self.tier.invalidate(req["ns"], req["prefix"])
            return wire.encode("cachetier.INVALIDATE.reply", dropped=n), b""
        if kind == "CSTATS":
            wire.decode("cachetier.STATS", header)
            st = self.tier.stats()
            return wire.encode(
                "cachetier.STATS.reply",
                hits=st["hits"],
                misses=st["misses"],
                fills=st["fills"],
                evictions=st["evictions"],
                entries=st["entries"],
                bytes=st["bytes"],
                capacity_bytes=st["capacity_bytes"],
                backing_read_bytes=st["backing_read_bytes"],
            ), b""
        raise wire.WireDecodeError(f"cachetier: unknown kind {kind!r}")

    def close(self) -> None:
        with self._conns_lock:
            self._stop.set()
            conns, self._conns = list(self._conns), set()
        for conn in conns:  # a thread between requests never sees _stop
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        try:
            self._lsock.shutdown(socket.SHUT_RDWR)  # wakes the accept loop now
        except OSError:
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------


class LocalClient:
    """In-process client: direct calls into a shared :class:`CacheTier`
    (the `InProcessReplica` / co-resident-reader spelling — same
    interface as :class:`CacheClient`, zero transport)."""

    def __init__(self, tier: CacheTier):
        self.tier = tier

    def lookup(self, ns: str, key: str,
               timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes | None:
        return self.tier.lookup(ns, key)

    def fill(self, ns: str, key: str, blob: bytes) -> None:
        self.tier.fill(ns, key, blob)

    def get_frame(self, path: str, off: int, span: int,
                  timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes | None:
        return self.tier.get_frame(path, off, span)

    def invalidate(self, ns: str, prefix: str = "",
                   timeout_s: float = 5.0) -> int:
        return self.tier.invalidate(ns, prefix)

    def stats(self, timeout_s: float = 5.0) -> dict | None:
        return self.tier.stats()

    def close(self) -> None:
        pass


class CacheClient:
    """TCP client with the failure-is-a-miss contract baked in.

    One connection, serialized request/reply under ``_lock`` (the
    protocol is strictly ping-pong per connection; concurrency comes
    from multiple clients, one per consumer thread pool is unnecessary
    because lookups are sub-ms and fills ride the filler thread).
    Every transport error closes the socket, arms a down-window
    (``_DOWN_BACKOFF_S`` — instant misses, no connect storm while the
    daemon respawns), and surfaces as a miss/no-op. Nothing here ever
    raises into the consumer's hot path.
    """

    def __init__(self, address: str, *, fill_queue: int = 64,
                 connect_timeout_s: float = 1.0):
        host, _, port = address.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self._connect_timeout_s = connect_timeout_s
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None  # guarded-by: self._lock
        self._down_until = 0.0  # guarded-by: self._lock (monotonic)
        self._closed = threading.Event()  # thread-safe; no guard needed
        # fire-and-forget fills: bounded drop-oldest queue drained by
        # one filler thread — the producing thread never blocks on the
        # network
        self._fill_q: deque[tuple[str, str, bytes]] = deque(maxlen=fill_queue)  # guarded-by: self._fill_cv
        self._fill_cv = threading.Condition()
        self._fill_dropped = 0  # guarded-by: self._fill_cv
        self._filler = threading.Thread(
            target=self._fill_loop, name="cachetier-filler", daemon=True
        )
        self._filler.start()

    # -- transport ----------------------------------------------------

    def _connect_locked(self) -> socket.socket | None:  # lint: holds-lock
        """Caller holds ``_lock``."""
        if self._sock is not None:
            return self._sock
        if self._closed.is_set() or time.monotonic() < self._down_until:
            return None
        try:
            s = socket.create_connection(
                (self.host, self.port), timeout=self._connect_timeout_s
            )
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            self._down_until = time.monotonic() + _DOWN_BACKOFF_S
            return None
        self._sock = s
        return s

    def _drop_conn_locked(self) -> None:  # lint: holds-lock
        """Caller holds ``_lock``."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._down_until = time.monotonic() + _DOWN_BACKOFF_S

    def _roundtrip(self, header: dict, payload: bytes,
                   timeout_s: float) -> tuple[dict, bytes] | None:
        """One request/reply; None on ANY failure (that IS the miss)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while True:
                reused = self._sock is not None
                s = self._connect_locked()
                if s is None:
                    return None
                try:
                    s.settimeout(max(deadline - time.monotonic(), 1e-3))
                    _send_msg(s, header, payload)
                    return _recv_msg(s)  # lint: blocking-ok: the socket carries the caller's timeout (settimeout above) — recv is deadline-bounded, and the lock serializes the ping-pong protocol by design
                except socket.timeout:
                    self._drop_conn_locked()
                    return None
                except (OSError, ConnectionError,
                        pickle.UnpicklingError, EOFError):
                    self._drop_conn_locked()
                    if not reused or time.monotonic() >= deadline:
                        return None
                    # the server closes a connection idle past its read
                    # timeout; a reused one that fails at once is that,
                    # not a dead service: reconnect once, in the bound
                    self._down_until = 0.0

    # -- the client surface -------------------------------------------

    def lookup(self, ns: str, key: str,
               timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes | None:
        out = self._roundtrip(
            wire.encode("cachetier.LOOKUP", ns=ns, key=key), b"", timeout_s
        )
        if out is None:
            return None
        try:
            reply = wire.decode("cachetier.LOOKUP.reply", out[0])
        except wire.WireError:
            return None
        return out[1] if reply["hit"] else None

    def get_frame(self, path: str, off: int, span: int,
                  timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes | None:
        out = self._roundtrip(
            wire.encode(
                "cachetier.LOOKUP",
                ns="frames",
                key=frame_key(path, off, span),
                path=os.path.abspath(path),
                off=int(off),
                span=int(span),
            ),
            b"",
            timeout_s,
        )
        if out is None:
            return None
        try:
            reply = wire.decode("cachetier.LOOKUP.reply", out[0])
        except wire.WireError:
            return None
        if not reply["hit"] or len(out[1]) != int(span):
            return None
        return out[1]

    def fill(self, ns: str, key: str, blob: bytes) -> None:
        """Fire-and-forget: enqueue and return. A full queue drops the
        OLDEST pending fill (freshest data wins under pressure)."""
        with self._fill_cv:
            if len(self._fill_q) == self._fill_q.maxlen:
                self._fill_dropped += 1
            self._fill_q.append((ns, key, bytes(blob)))
            self._fill_cv.notify()

    def _fill_loop(self) -> None:
        while True:
            with self._fill_cv:
                while not self._fill_q and not self._closed.is_set():
                    self._fill_cv.wait(timeout=0.5)
                if self._closed.is_set() and not self._fill_q:
                    return
                ns, key, blob = self._fill_q.popleft()
            header = wire.encode(
                "cachetier.FILL", ns=ns, key=key, nbytes=len(blob)
            )
            # a failed fill is simply not cached; the roundtrip already
            # armed the down-window
            self._roundtrip(header, blob, timeout_s=2.0)

    def invalidate(self, ns: str, prefix: str = "",
                   timeout_s: float = 5.0) -> int:
        out = self._roundtrip(
            wire.encode("cachetier.INVALIDATE", ns=ns, prefix=prefix),
            b"", timeout_s,
        )
        if out is None:
            return 0
        try:
            return wire.decode("cachetier.INVALIDATE.reply", out[0])["dropped"]
        except wire.WireError:
            return 0

    def stats(self, timeout_s: float = 5.0) -> dict | None:
        out = self._roundtrip(wire.encode("cachetier.STATS"), b"", timeout_s)
        if out is None:
            return None
        try:
            return wire.decode("cachetier.STATS.reply", out[0])
        except wire.WireError:
            return None

    def pending_fills(self) -> int:
        with self._fill_cv:
            return len(self._fill_q)

    def close(self) -> None:
        self._closed.set()
        with self._fill_cv:
            self._fill_cv.notify_all()
        self._filler.join(timeout=2.0)
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


# ---------------------------------------------------------------------------
# standalone daemon entry (the fleet's spawn target; SIGKILL-able)
# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="tfos cachetier daemon")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--port-file", default=None,
                    help="write the bound port here once listening "
                    "(the spawn barrier)")
    ap.add_argument("--capacity-bytes", type=int, default=_DEFAULT_CAPACITY)
    args = ap.parse_args(argv)
    server = CacheServer(
        CacheTier(capacity_bytes=args.capacity_bytes),
        host=args.host, port=args.port,
    ).start()
    logger.info("cachetier daemon listening on %s", server.address)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(server.port))
        os.replace(tmp, args.port_file)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
