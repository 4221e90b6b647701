"""Per-request distributed tracing with tail-sampled retention.

Spans (``obs.spans``) answer "where does the *process* spend time";
this module answers "where did *this request* spend time" — across the
router, a failover hop, the subprocess boundary, and the engine's
scheduler phases, as ONE timeline.

A trace id is minted at the first surface a request touches (serve_model
HTTP ingress or ``FleetRouter.submit/stream``) and propagated in-process
as a ``trace=`` keyword and across the subprocess boundary as the
:data:`HEADER` (``X-TFOS-Trace``) request header, so the child
serve_model's engine stamps its segments onto the SAME trace id the
parent minted. Each participant appends:

- **events** — points in time (placement, failover hop, shed, swap);
- **segments** — durations (queue wait, prefill, per-decode-block
  share, emit), the substrate for wall-time attribution;
- **flags** — retention hints (``failover``, ``propagated``, ``error``).

**Tail sampling**: the keep/drop decision happens at :meth:`finish`,
when the outcome is known — full timelines are retained for error,
failover, slow (>= ``slow_s``), propagated (a parent holds the other
half), and 1-in-``sample_every`` requests; the rest are dropped. Both
the live map and the retained ring are bounded, so the ring never
exceeds ``capacity`` regardless of load.

Retained traces are served by ``GET /debugz/trace/<id>`` (serve_model
and the node metrics endpoint) as Chrome-trace JSON whose
``trace_context`` metadata makes them mergeable by
``tools/trace_merge.py`` into a clock-aligned cluster timeline.

Module-level helpers (the ``flightrec`` pattern) keep call sites one
line and make the untraced path nearly free: every helper returns
immediately when the trace id is ``None``, and the engine guards its
per-token stamps on ``p.trace is not None`` (cost asserted
failpoint-bar style in tests/test_reqtrace.py). ``TFOS_REQTRACE=0``
disables minting entirely.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any

from tensorflowonspark_tpu_torch.obs.registry import default_registry

__all__ = [
    "HEADER",
    "TraceRing",
    "begin",
    "enabled",
    "ensure",
    "event",
    "finish",
    "flag",
    "get_record",
    "get_ring",
    "install",
    "mark",
    "mint",
    "segment",
    "to_chrome",
]

#: The cross-process propagation header: a parent (router host) sends
#: it on /generate and /generate_stream; the child serve_model adopts
#: the id instead of minting, so both halves share one trace.
HEADER = "X-TFOS-Trace"

_ENV_ENABLE = "TFOS_REQTRACE"
_ENV_CAP = "TFOS_REQTRACE_CAP"
_ENV_SAMPLE = "TFOS_REQTRACE_SAMPLE"
_ENV_SLOW_MS = "TFOS_REQTRACE_SLOW_MS"


def enabled() -> bool:
    """Minting enabled? (``TFOS_REQTRACE=0`` to disable; default on.)"""
    return os.environ.get(_ENV_ENABLE, "1") != "0"


class TraceRing:
    """Bounded live + tail-sampled retained per-request timelines.

    ``capacity`` bounds the retained ring; the live map is bounded at
    ``4 * capacity`` (an abandoned begin — a caller that died before
    ``finish`` — is evicted oldest-first, not leaked). ``max_events``
    bounds each record's event and segment lists, so one pathological
    request cannot grow without bound either.
    """

    def __init__(
        self,
        capacity: int | None = None,
        sample_every: int | None = None,
        slow_s: float | None = None,
        max_events: int = 512,
    ):
        if capacity is None:
            capacity = int(os.environ.get(_ENV_CAP, "256"))
        if sample_every is None:
            sample_every = int(os.environ.get(_ENV_SAMPLE, "64"))
        if slow_s is None:
            slow_s = float(os.environ.get(_ENV_SLOW_MS, "1000")) / 1e3
        self.capacity = max(1, int(capacity))
        self.sample_every = max(0, int(sample_every))
        self.slow_s = float(slow_s)
        self.max_events = max(16, int(max_events))
        self._lock = threading.Lock()
        self._live: OrderedDict[str, dict] = OrderedDict()  # guarded-by: self._lock
        self._retained: OrderedDict[str, dict] = OrderedDict()  # guarded-by: self._lock
        self._seq = 0  # finish() count, for 1-in-N sampling  # guarded-by: self._lock
        self._evicted = 0  # abandoned live records  # guarded-by: self._lock
        reg = default_registry()
        self._m_retained = reg.counter(
            "reqtrace_retained_total",
            "finished request traces kept by tail sampling, by reason",
        )
        self._m_dropped = reg.counter(
            "reqtrace_dropped_total",
            "finished request traces dropped by tail sampling",
        )

    # -- write surface ------------------------------------------------

    @staticmethod
    def mint() -> str:
        return uuid.uuid4().hex[:16]

    def begin(self, trace_id: str | None = None, **meta: Any) -> str:
        """Open a live record (minting an id when none given); evicts
        the oldest abandoned live record past the live bound."""
        tid = trace_id or self.mint()
        rec = {
            "trace_id": tid,
            "started_unix": time.time(),
            "_t0": time.monotonic(),
            "meta": dict(meta),
            "events": [],
            "segments": [],
            "flags": {},
            "outcome": None,
            "duration_s": None,
        }
        with self._lock:
            self._live[tid] = rec
            while len(self._live) > 4 * self.capacity:
                self._live.popitem(last=False)
                self._evicted += 1
        return tid

    def ensure(self, trace_id: str | None, **meta: Any) -> tuple[str, bool]:
        """(trace_id, began_now): begin a record unless one is already
        open/retained for ``trace_id`` — the owner (whoever began it)
        is the one who should :meth:`finish` it."""
        if trace_id is not None:
            with self._lock:
                if trace_id in self._live or trace_id in self._retained:
                    return trace_id, False
        return self.begin(trace_id, **meta), True

    def _rec(self, trace_id: str):  # lint: holds-lock
        """Live record first, retained second (late events from a slow
        participant still land). Callers hold ``self._lock``."""
        return self._live.get(trace_id) or self._retained.get(trace_id)

    def event(self, trace_id: str, name: str, **detail: Any) -> None:
        with self._lock:
            rec = self._rec(trace_id)
            if rec is None or len(rec["events"]) >= self.max_events:
                return
            rec["events"].append(
                {
                    "name": name,
                    "t_s": round(time.monotonic() - rec["_t0"], 6),
                    **detail,
                }
            )

    def segment(
        self,
        trace_id: str,
        name: str,
        dur_s: float,
        t_s: float | None = None,
        **meta: Any,
    ) -> None:
        """A duration on the timeline; ``t_s`` (segment start, seconds
        from trace start) defaults to "ended just now"."""
        with self._lock:
            rec = self._rec(trace_id)
            if rec is None or len(rec["segments"]) >= self.max_events:
                return
            if t_s is None:
                t_s = time.monotonic() - rec["_t0"] - dur_s
            rec["segments"].append(
                {
                    "name": name,
                    "t_s": round(max(0.0, t_s), 6),
                    "dur_s": round(float(dur_s), 6),
                    **meta,
                }
            )

    def flag(self, trace_id: str, **flags: Any) -> None:
        """Retention hints (``failover=True``, ``error=...``): any
        truthy flag keeps the trace at finish."""
        with self._lock:
            rec = self._rec(trace_id)
            if rec is not None:
                rec["flags"].update(flags)

    def mark(self, name: str, **detail: Any) -> int:
        """Append one event to EVERY live trace — fleet-scoped moments
        (a rollout weight swap) that belong on the timeline of every
        request they overlapped. Returns the number marked."""
        with self._lock:
            live = list(self._live.values())
            t = time.monotonic()
            n = 0
            for rec in live:
                if len(rec["events"]) >= self.max_events:
                    continue
                rec["events"].append(
                    {"name": name, "t_s": round(t - rec["_t0"], 6), **detail}
                )
                n += 1
            return n

    def finish(self, trace_id: str, outcome: str = "ok", **detail: Any) -> bool:
        """Close the record and make the tail-sampling call; returns
        whether the timeline was retained."""
        with self._lock:
            rec = self._live.pop(trace_id, None)
            if rec is None:
                # double-finish / unknown id: annotate if retained
                kept = self._retained.get(trace_id)
                if kept is not None and kept["outcome"] is None:
                    kept["outcome"] = outcome
                return kept is not None
            dur = time.monotonic() - rec["_t0"]
            rec["outcome"] = outcome
            rec["duration_s"] = round(dur, 6)
            if detail:
                rec["meta"].update(detail)
            reason = None
            if outcome != "ok":
                reason = "error"
            else:
                for k, v in rec["flags"].items():
                    if v:
                        reason = str(k)
                        break
                if reason is None and dur >= self.slow_s:
                    reason = "slow"
                if (
                    reason is None
                    and self.sample_every
                    and self._seq % self.sample_every == 0
                ):
                    reason = "sampled"
            self._seq += 1
            if reason is None:
                kept_now = False
            else:
                rec["kept"] = reason
                self._retained[trace_id] = rec
                while len(self._retained) > self.capacity:
                    self._retained.popitem(last=False)
                kept_now = True
        # counters outside our lock: the metric's own lock never nests
        # under the ring's
        if kept_now:
            self._m_retained.inc(reason=reason)
        else:
            self._m_dropped.inc()
        return kept_now

    # -- read surface -------------------------------------------------

    def get(self, trace_id: str) -> dict | None:
        """A JSON-safe copy of one record (live or retained)."""
        with self._lock:
            rec = self._rec(trace_id)
            if rec is None:
                return None
            out = {k: v for k, v in rec.items() if k != "_t0"}
            out["events"] = list(rec["events"])
            out["segments"] = list(rec["segments"])
            out["flags"] = dict(rec["flags"])
            out["meta"] = dict(rec["meta"])
            return out

    def ids(self) -> list[str]:
        """Retained trace ids, oldest first."""
        with self._lock:
            return list(self._retained)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "live": len(self._live),
                "retained": len(self._retained),
                "finished": self._seq,
                "evicted_live": self._evicted,
                "capacity": self.capacity,
            }

    def to_chrome(self, trace_id: str, process_name: str = "reqtrace") -> dict | None:
        """One record as Chrome-trace JSON. The ``trace_context``
        metadata stamps ``epoch_unix`` = the trace's start on THIS
        process's wall clock (plus the node's clock-offset estimate via
        ``obs.cluster.export_meta``), so ``trace_merge`` rebases the
        parent's and the child's halves onto one driver-clock
        timeline."""
        from tensorflowonspark_tpu_torch.obs import cluster as obs_cluster

        rec = self.get(trace_id)
        if rec is None:
            return None
        events: list[dict] = [
            {
                "ph": "M",
                "pid": 0,
                "name": "process_name",
                "args": {"name": process_name},
            },
            {
                "ph": "M",
                "pid": 0,
                "name": "trace_context",
                "args": {
                    "epoch_unix": rec["started_unix"],
                    **obs_cluster.export_meta(),
                },
            },
        ]
        for seg in rec["segments"]:
            args = {
                k: v for k, v in seg.items() if k not in ("name", "t_s", "dur_s")
            }
            args["trace"] = trace_id
            events.append(
                {
                    "ph": "X",
                    "pid": 0,
                    "tid": f"req:{trace_id[:8]}",
                    "name": seg["name"],
                    "ts": round(seg["t_s"] * 1e6, 3),
                    "dur": round(seg["dur_s"] * 1e6, 3),
                    "args": args,
                }
            )
        for ev in rec["events"]:
            args = {k: v for k, v in ev.items() if k not in ("name", "t_s")}
            args["trace"] = trace_id
            events.append(
                {
                    "ph": "i",
                    "s": "t",
                    "pid": 0,
                    "tid": f"req:{trace_id[:8]}",
                    "name": ev["name"],
                    "ts": round(ev["t_s"] * 1e6, 3),
                    "args": args,
                }
            )
        return {
            "traceEvents": events,
            "metadata": {
                "trace_id": trace_id,
                "outcome": rec["outcome"],
                "duration_s": rec["duration_s"],
                "flags": rec["flags"],
                "meta": rec["meta"],
            },
        }

    def attribution(self, trace_id: str) -> dict[str, Any] | None:
        """Wall-time attribution for one finished trace: per-segment-
        name totals and the covered fraction of ``duration_s`` — the
        number the end-to-end trace proof gates on. Segment
        overlap is merged (union, not sum) so double-stamped intervals
        cannot claim > 100%."""
        rec = self.get(trace_id)
        if rec is None or not rec.get("duration_s"):
            return None
        by_name: dict[str, float] = {}
        ivals: list[tuple[float, float]] = []
        for seg in rec["segments"]:
            by_name[seg["name"]] = by_name.get(seg["name"], 0.0) + seg["dur_s"]
            ivals.append((seg["t_s"], seg["t_s"] + seg["dur_s"]))
        ivals.sort()
        covered = 0.0
        cur_lo = cur_hi = None
        for lo, hi in ivals:
            if cur_hi is None or lo > cur_hi:
                if cur_hi is not None:
                    covered += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        if cur_hi is not None:
            covered += cur_hi - cur_lo
        dur = rec["duration_s"]
        return {
            "trace_id": trace_id,
            "duration_s": dur,
            "covered_s": round(covered, 6),
            "covered_fraction": round(min(1.0, covered / dur), 4),
            "segments_s": {k: round(v, 6) for k, v in sorted(by_name.items())},
        }


# -- process-global ring ------------------------------------------------------

_install_lock = threading.Lock()
_ring: TraceRing | None = None  # guarded-by: _install_lock


def install(**kwargs: Any) -> TraceRing:
    """Install (or replace) the process-global ring — tests and
    processes that want non-default caps."""
    global _ring
    ring = TraceRing(**kwargs)
    with _install_lock:
        _ring = ring
    return ring


def get_ring() -> TraceRing:
    """The process-global ring, created on first use."""
    global _ring
    with _install_lock:
        if _ring is None:
            _ring = TraceRing()
        return _ring


def mint(**meta: Any) -> str | None:
    """Begin a new trace on the global ring; ``None`` when tracing is
    disabled (callers pass the id straight through — every other
    helper no-ops on ``None``)."""
    if not enabled():
        return None
    return get_ring().begin(**meta)


def ensure(trace_id: str | None, **meta: Any) -> tuple[str | None, bool]:
    """Adopt ``trace_id`` (begin it here if unknown) or mint one;
    ``(None, False)`` when disabled and no id was handed in."""
    if trace_id is None and not enabled():
        return None, False
    return get_ring().ensure(trace_id, **meta)


def begin(trace_id: str | None = None, **meta: Any) -> str | None:
    if trace_id is None and not enabled():
        return None
    return get_ring().begin(trace_id, **meta)


def event(trace_id: str | None, name: str, **detail: Any) -> None:
    if trace_id is None:
        return
    get_ring().event(trace_id, name, **detail)


def segment(
    trace_id: str | None,
    name: str,
    dur_s: float,
    t_s: float | None = None,
    **meta: Any,
) -> None:
    if trace_id is None:
        return
    get_ring().segment(trace_id, name, dur_s, t_s, **meta)


def flag(trace_id: str | None, **flags: Any) -> None:
    if trace_id is None:
        return
    get_ring().flag(trace_id, **flags)


def mark(name: str, **detail: Any) -> int:
    with _install_lock:
        ring = _ring
    if ring is None:  # nothing traced yet: nothing to mark
        return 0
    return ring.mark(name, **detail)


def finish(trace_id: str | None, outcome: str = "ok", **detail: Any) -> bool:
    if trace_id is None:
        return False
    return get_ring().finish(trace_id, outcome, **detail)


def get_record(trace_id: str) -> dict | None:
    return get_ring().get(trace_id)


def to_chrome(trace_id: str, process_name: str = "reqtrace") -> dict | None:
    return get_ring().to_chrome(trace_id, process_name)


def _reset_for_tests() -> None:
    global _ring
    with _install_lock:
        _ring = None
