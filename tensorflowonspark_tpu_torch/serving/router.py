"""Health-routed request router over a :class:`ServingFleet`.

The client-facing half of the fleet plane: one object with the
engine's surface (``submit`` / ``submit_many`` / ``stream`` /
``stats`` / ``metrics`` / ``close``) that owns N replicas behind it —
``serve_model --gen-replicas N`` drops it in where the single engine
sat. Three policies live here:

- **Placement** is prefix-aware, then load-balanced: the router keeps
  an adapter-bucketed prefix index (:class:`_AffinityIndex`, the
  ``_PrefixStore`` lookup technique applied to routing) mapping every
  dispatched prompt to its replica, probed longest-prefix-first — a
  request extending a prompt some replica already served goes back to
  the replica whose ``_PrefixStore`` is warm. Ties (and misses) break
  on the per-replica load signal — queue depth + busy slots from the
  fleet's probe stats plus the router's own outstanding-dispatch
  count, the MetricsAggregator-style merged view — then
  deterministically on replica id.

- **Admission / shedding** makes the per-request ``deadline_s`` a
  policy, not just a timeout: from queue-depth estimates and an EWMA
  of observed request durations the router rejects ON ARRIVAL
  (:class:`FleetOverloaded` → HTTP 429 + Retry-After) any request no
  replica can finish inside its deadline — p99 of ADMITTED requests
  stays bounded under overload instead of the whole queue collapsing.
  During a full-fleet drain every request sheds with
  :class:`FleetUnavailable` (→ HTTP 503).

- **Failover** retries an IDEMPOTENT request exactly once on a
  different healthy replica. Idempotent means no sampling side-effect
  has been consumed yet: a blocking ``submit``/``submit_many`` whose
  reply never arrived, or a stream that has not yielded its first
  token. A mid-stream failure is never silently retried (the consumer
  already observed tokens) and never hangs: it delivers exactly one
  terminal error. Every failover also reports the replica to the
  fleet, which drains and respawns it.

Failpoint ``fleet.dispatch`` sits on the dispatch edge; its ``drop``
action simulates a dispatch lost in flight, which MUST surface as a
loud terminal/failover — the router treats it as :class:`ReplicaGone`.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict

from tensorflowonspark_tpu_torch.obs import flightrec, reqtrace

from tensorflowonspark_tpu_torch.serving.engine import (
    EngineOverloaded,
    EngineWedged,
)
from tensorflowonspark_tpu_torch.serving.fleet import (
    READY,
    FleetOverloaded,
    FleetUnavailable,
    ReplicaGone,
    ServingFleet,
)
from tensorflowonspark_tpu_torch.utils.failpoints import (
    FailpointError,
    failpoint,
)

logger = logging.getLogger(__name__)

__all__ = ["FleetRouter"]

# Failures that mean "this replica, not this request": eligible for
# one transparent failover while the request is still idempotent.
# FailpointError/ConnectionError cover armed chaos and severed
# transports the handle layer didn't already wrap.
_FAILOVER_ERRORS = (
    EngineWedged,
    ReplicaGone,
    FailpointError,
    ConnectionError,
)


class _AffinityIndex:
    """Prompt-prefix → replica map, adapter-bucketed with per-length
    hash probes (the ``_PrefixStore`` index structure, reused for
    routing): ``lookup`` probes the prompt's prefixes longest-first,
    one tuple hash per distinct stored length, so a warm index costs
    O(distinct lengths) per placement, not O(entries). LRU-capped;
    entries for a respawned (cold) replica are dropped wholesale.
    Callers hold the router lock."""

    def __init__(self, capacity: int = 512):
        self.capacity = max(1, int(capacity))
        self._d: "OrderedDict[tuple, int]" = OrderedDict()
        # adapter -> {prefix_length -> set of stored key tuples}
        self._by_adapter: dict[int, dict[int, set]] = {}

    def lookup(self, tokens, adapter: int) -> int | None:
        n = len(tokens)
        by_len = self._by_adapter.get(adapter)
        if not by_len:
            return None
        for lk in sorted(by_len, reverse=True):
            if lk > n:
                continue
            cand = tuple(tokens[:lk])
            if cand in by_len[lk]:
                k = (adapter, cand)
                self._d.move_to_end(k)
                return self._d[k]
        return None

    def record(self, tokens, adapter: int, rid: int) -> None:
        key = tuple(tokens)
        k = (adapter, key)
        if k not in self._d:
            self._by_adapter.setdefault(adapter, {}).setdefault(
                len(key), set()
            ).add(key)
        self._d[k] = rid
        self._d.move_to_end(k)
        while len(self._d) > self.capacity:
            (ad, old), _ = self._d.popitem(last=False)
            self._unindex(ad, old)

    def _unindex(self, adapter: int, key: tuple) -> None:
        by_len = self._by_adapter[adapter]
        bucket = by_len[len(key)]
        bucket.discard(key)
        if not bucket:
            del by_len[len(key)]
            if not by_len:
                del self._by_adapter[adapter]

    def drop_replica(self, rid: int) -> None:
        stale = [k for k, v in self._d.items() if v == rid]
        for k in stale:
            del self._d[k]
            self._unindex(*k)

    def __len__(self) -> int:
        return len(self._d)


class _MetricsView:
    """Duck-typed stand-in for an engine's ``.metrics`` registry:
    ``render()`` returns the MERGED exposition (fleet/router series +
    every replica's engine series re-labelled ``replica="<rid>"``) so
    ``serve_model``'s ``/metrics`` handler works unchanged."""

    def __init__(self, router: "FleetRouter"):
        self._router = router

    def render(self) -> str:
        return self._router.metrics_text()


class FleetRouter:
    """See the module docstring. Shared state (`_outstanding`,
    `_est_req_s`, the affinity index, shed/failover tallies) is
    guarded by ``self._lock``; nothing blocking runs under it."""

    #: serve_model switches its /stats mode label on this
    IS_FLEET = True

    def __init__(
        self,
        fleet: ServingFleet,
        *,
        default_temperature: float = 0.0,
        affinity_capacity: int = 512,
        affinity_load_slack: float = 1.0,
        service_time_hint_s: float | None = None,
        ewma_alpha: float = 0.3,
    ):
        self._fleet = fleet
        # serve_model's n>1 greedy check reads the configured default
        # temperature off the engine object it fronts; mirror it
        self._temperature = float(default_temperature)
        self._service_time_hint = (
            None
            if service_time_hint_s is None
            else float(service_time_hint_s)
        )
        self._ewma_alpha = float(ewma_alpha)
        self._lock = threading.Lock()
        self._affinity = _AffinityIndex(affinity_capacity)  # guarded-by: self._lock
        self._outstanding: dict[int, int] = {}  # guarded-by: self._lock
        self._est_req_s: dict[int, float] = {}  # guarded-by: self._lock
        # Measured fleet-wide service-time seed (history percentile or
        # an autotune install); beats the ctor's hardcoded hint in the
        # cold-start estimate chain — see _wait_estimate.
        self._seed_est_s: float | None = None  # guarded-by: self._lock
        self._shed_counts: dict[str, int] = {}  # guarded-by: self._lock
        self._failovers = 0  # guarded-by: self._lock
        self._affinity_hits = 0  # guarded-by: self._lock
        self._affinity_misses = 0  # guarded-by: self._lock
        self._affinity_bypasses = 0  # guarded-by: self._lock
        # With a fleet-global prefix L2 behind every replica
        # (tfos.cachetier), a "cold" replica recovers a warm prefix
        # from L2 instead of re-prefilling — so prefix affinity demotes
        # from placement-correctness to a cache-LOCALITY hint, and the
        # warm pick yields to the least-loaded replica whenever the
        # normalized load skew exceeds this slack.
        self._affinity_is_hint = (
            getattr(fleet, "_l2_spec", None) is not None
        )
        self._affinity_load_slack = float(affinity_load_slack)

        reg = fleet.metrics
        self._m_requests = reg.counter(
            "router_requests_total",
            "routed requests by replica and outcome",
        )
        self._m_shed = reg.counter(
            "router_shed_total",
            "requests rejected at admission, by reason",
        )
        self._m_failover = reg.counter(
            "router_failover_total",
            "idempotent requests transparently retried on another "
            "replica",
        )
        self._m_affinity = reg.counter(
            "router_affinity_total",
            "prefix-affinity placements by outcome (hit/miss/bypass — "
            "bypass = warm replica yielded to least-loaded because a "
            "prefix L2 makes the miss recoverable)",
        )
        self._g_depth = reg.gauge(
            "router_queue_depth",
            "requests dispatched by the router and not yet resolved",
        )
        self._h_latency = reg.histogram(
            "router_request_seconds",
            "end-to-end latency of successfully routed requests "
            "(placement through reply) — the fleet_latency SLO "
            "substrate",
        )

        def _collect(depth=self._g_depth):
            with self._lock:
                depth.set(sum(self._outstanding.values()))

        reg.add_collector(_collect)
        self._collector = _collect
        fleet.listener = self

    # -- fleet callbacks ----------------------------------------------

    def replica_reset(self, rid: int) -> None:
        """A seat's engine was replaced (respawn): everything the
        router learned about the OLD engine — prefix warmth, service
        rate — is stale."""
        with self._lock:
            self._affinity.drop_replica(rid)
            self._est_req_s.pop(rid, None)

    # -- service estimate (autotune actuation / cold-start seed) ------

    def set_service_estimate(self, seconds: float) -> float:
        """Install a measured fleet-wide service-time seed — the
        autotune actuation path for the ``router.service_estimate_s``
        knob. It replaces the ctor's ``service_time_hint_s`` guess in
        the admission estimate chain for replicas with no per-replica
        EWMA yet; replicas with observed completions keep their own
        EWMAs (this is a cold-start floor, not an override)."""
        v = float(seconds)
        if v <= 0:
            raise ValueError(
                f"service estimate must be > 0 seconds, got {seconds}"
            )
        with self._lock:
            self._seed_est_s = v
        return v

    def service_estimate(self) -> float:
        """The cold-start service estimate currently in effect (the
        knob readback): the measured seed when installed, else the
        ctor hint, else 0.0 (no estimate — admission can't judge)."""
        with self._lock:
            return self._seed_est_s or self._service_time_hint or 0.0

    def seed_from_history(
        self,
        history,
        *,
        metric: str = "router_request_seconds",
        q: float = 0.9,
        window_s: float = 60.0,
        now: float | None = None,
    ) -> float | None:
        """Seed the admission estimate from the measured duration
        distribution: the ``q``-quantile of the request-latency
        histogram over the trailing window, when one exists. Returns
        the installed seed, or None (no in-window signal — the chain
        keeps its current fallbacks). The percentile scan runs OUTSIDE
        ``self._lock`` (History takes its own lock; nothing blocking
        runs under ours)."""
        est = history.percentile(metric, q, window_s=window_s, now=now)
        if est is None or est <= 0.0:
            return None
        with self._lock:
            self._seed_est_s = float(est)
        return float(est)

    # -- placement / admission ----------------------------------------

    @staticmethod
    def _load(view: dict, outstanding: int) -> float:
        st = view["stats"] or {}
        slots = max(1, int(st.get("slots") or 1))
        return (
            int(st.get("queue_depth") or 0)
            + int(st.get("slots_busy") or 0)
            + outstanding
        ) / slots

    def _wait_estimate(self, view: dict, outstanding: int) -> float:  # lint: holds-lock
        """Expected completion latency of a NEW request on this
        replica, from queue-depth + an EWMA of observed request
        durations. Before any completion lands on a replica the chain
        falls back to the MEASURED fleet-wide seed (history percentile
        via ``seed_from_history`` / ``set_service_estimate``) and only
        then to the ctor's hardcoded ``service_time_hint_s`` guess —
        a stale pessimistic hint otherwise sheds feasible requests on
        every cold start (fresh replica, respawn, or router restart).
        0.0 = no estimate yet — admit (can't judge). Callers hold
        ``self._lock``."""
        rate = (
            self._est_req_s.get(view["rid"])
            or self._seed_est_s
            or self._service_time_hint
        )
        if not rate:
            return 0.0
        st = view["stats"] or {}
        slots = max(1, int(st.get("slots") or 1))
        depth = int(st.get("queue_depth") or 0) + int(
            st.get("slots_busy") or 0
        )
        depth = max(depth, outstanding)
        return rate * (depth / slots + 1.0)

    def _shed(self, reason: str, trace: str | None = None) -> None:  # lint: holds-lock
        # callers hold self._lock (counter inc nests the metric's own
        # lock under ours; nothing ever nests the other way)
        self._m_shed.inc(reason=reason)
        first = reason not in self._shed_counts
        self._shed_counts[reason] = self._shed_counts.get(reason, 0) + 1
        # the shed decision is attributed on the victim's trace (and
        # the trace id rides the flight-recorder event, so a
        # postmortem joins the two planes by id)
        flightrec.note("fleet_shed", reason=reason, trace=trace)
        reqtrace.event(trace, "router.shed", reason=reason)
        if first:
            # shedding beginning (per reason) is an incident: persist
            # the record — on a daemon thread, the dump's IO must not
            # sit on the request path (or under self._lock)
            threading.Thread(
                target=flightrec.dump_now,
                args=(f"fleet_shed:{reason}",),
                daemon=True,
            ).start()

    def _place(self, tokens, adapter: int, deadline_s, exclude, trace=None):
        """Pick the replica for one request: affinity first, then
        least-loaded; deadline admission on the pick (affinity yields
        to feasibility). Bumps the pick's outstanding count and
        records the prompt in the affinity index before returning."""
        if self._fleet.draining or self._fleet.closed:
            with self._lock:
                self._shed("drain", trace=trace)
            raise FleetUnavailable(
                "fleet is draining; no new requests are admitted"
            )
        ready = [
            v
            for v in self._fleet.ready_views()
            if v["rid"] not in exclude
        ]
        if not ready:
            with self._lock:
                self._shed("no_ready", trace=trace)
            raise FleetUnavailable("no ready replica")
        with self._lock:
            outstanding = {
                v["rid"]: self._outstanding.get(v["rid"], 0)
                for v in ready
            }
            hit_rid = self._affinity.lookup(tokens, adapter)
            pick = None
            if hit_rid is not None:
                for v in ready:
                    if v["rid"] == hit_rid:
                        pick = v
                        break
            bypassed = False
            if pick is not None and self._affinity_is_hint:
                # L2 configured: a miss here is recoverable, so the
                # warm replica only wins while roughly as idle as the
                # least-loaded one (see the ctor comment).
                least = min(
                    ready,
                    key=lambda v: (
                        self._load(v, outstanding[v["rid"]]),
                        v["rid"],
                    ),
                )
                skew = self._load(
                    pick, outstanding[pick["rid"]]
                ) - self._load(least, outstanding[least["rid"]])
                if (
                    least["rid"] != pick["rid"]
                    and skew > self._affinity_load_slack
                ):
                    bypassed = True
                    pick = least
            if bypassed:
                self._affinity_bypasses += 1
                self._m_affinity.inc(outcome="bypass")
            elif pick is not None:
                self._affinity_hits += 1
                self._m_affinity.inc(outcome="hit")
            else:
                self._affinity_misses += 1
                self._m_affinity.inc(outcome="miss")
                pick = min(
                    ready,
                    key=lambda v: (
                        self._load(v, outstanding[v["rid"]]),
                        v["rid"],
                    ),
                )
            if deadline_s is not None:
                est = self._wait_estimate(
                    pick, outstanding[pick["rid"]]
                )
                if est > float(deadline_s):
                    # the warm replica can't make it — feasibility
                    # beats affinity
                    waits = {
                        v["rid"]: self._wait_estimate(
                            v, outstanding[v["rid"]]
                        )
                        for v in ready
                    }
                    alt = min(
                        ready,
                        key=lambda v: (waits[v["rid"]], v["rid"]),
                    )
                    est_alt = waits[alt["rid"]]
                    if est_alt > float(deadline_s):
                        self._shed("deadline", trace=trace)
                        raise FleetOverloaded(
                            f"deadline_s={deadline_s} cannot be met: "
                            f"best replica's estimated completion is "
                            f"{est_alt:.2f}s",
                            retry_after=est_alt - float(deadline_s),
                        )
                    pick = alt
            rid = pick["rid"]
            self._outstanding[rid] = self._outstanding.get(rid, 0) + 1
            self._affinity.record(tokens, adapter, rid)
        return pick

    def _resolve(self, rid: int, outcome: str, t0=None) -> None:
        self._m_requests.inc(replica=str(rid), outcome=outcome)
        dur = None
        if outcome == "ok" and t0 is not None:
            dur = time.monotonic() - t0
            self._h_latency.observe(dur)
        with self._lock:
            n = self._outstanding.get(rid, 0)
            if n > 0:
                self._outstanding[rid] = n - 1
            if dur is not None:
                prev = self._est_req_s.get(rid)
                self._est_req_s[rid] = (
                    dur
                    if prev is None
                    else (1 - self._ewma_alpha) * prev
                    + self._ewma_alpha * dur
                )

    def _note_failover(self) -> None:
        self._m_failover.inc()
        with self._lock:
            self._failovers += 1

    # -- request surface ----------------------------------------------

    def submit(self, tokens, max_new_tokens, **kw):
        want_lp = bool(kw.pop("return_logprobs", False))
        out = self.submit_many(
            [tokens], max_new_tokens, return_logprobs=want_lp, **kw
        )
        if want_lp:
            comps, lps = out
            return comps[0], lps[0]
        return out[0]

    def submit_many(self, prompts, max_new_tokens, **kw):
        """Blocking decode of a request's rows on ONE replica (the
        engine's atomic-admission contract is per replica). Failures
        before the reply (wedge, severed replica, armed dispatch
        failpoint) fail over exactly once — no token ever reached the
        caller, so the retry is invisible; the failing replica drains
        and respawns.

        A ``trace=`` kwarg (or a fresh mint when tracing is on) rides
        the whole routed lifetime: placement, each failover hop, and
        the dispatch to the replica happen on the SAME trace — the
        replica handle forwards the id to the engine (in-process) or
        across the wire as ``X-TFOS-Trace`` (subprocess)."""
        if not prompts:
            raise ValueError("prompts must be a non-empty list")
        tid, owned = reqtrace.ensure(kw.pop("trace", None), route="submit")
        if tid is not None:
            kw["trace"] = tid
        t_req = time.monotonic()
        try:
            out = self._submit_many_routed(prompts, max_new_tokens, tid, kw)
        except BaseException as e:
            reqtrace.flag(tid, error=type(e).__name__)
            if owned:
                reqtrace.finish(
                    tid, outcome="error", error=type(e).__name__
                )
            raise
        reqtrace.segment(tid, "router.submit", time.monotonic() - t_req)
        if owned:
            reqtrace.finish(tid, outcome="ok")
        return out

    def _submit_many_routed(self, prompts, max_new_tokens, tid, kw):
        adapter = int(kw.get("adapter") or 0)
        deadline_s = kw.get("deadline_s")
        tried: set[int] = set()
        last_err: BaseException | None = None
        for attempt in (0, 1):
            try:
                pick = self._place(
                    prompts[0], adapter, deadline_s, tried, trace=tid
                )
            except FleetUnavailable:
                if isinstance(last_err, EngineOverloaded):
                    with self._lock:
                        self._shed("queue_full", trace=tid)
                    raise FleetOverloaded(
                        "every routable replica's queue is full"
                    ) from last_err
                if last_err is not None:
                    raise last_err from None
                raise
            reqtrace.event(
                tid, "router.place",
                replica=pick["rid"], attempt=attempt,
            )
            t0 = time.monotonic()
            try:
                if failpoint("fleet.dispatch") == "drop":
                    # a dropped dispatch must be a LOUD terminal (or a
                    # transparent failover), never a hang
                    raise ReplicaGone(
                        f'dispatch to replica {pick["rid"]} dropped '
                        "(failpoint fleet.dispatch)"
                    )
                out = pick["handle"].submit_many(
                    prompts, max_new_tokens, **kw
                )
            except _FAILOVER_ERRORS as e:
                self._resolve(
                    pick["rid"], "failover" if attempt == 0 else "error"
                )
                self._fleet.report_failure(
                    pick["rid"], repr(e),
                    generation=pick["generation"],
                )
                tried.add(pick["rid"])
                last_err = e
                if attempt == 0:
                    self._note_failover()
                    reqtrace.event(
                        tid, "router.failover",
                        replica=pick["rid"], error=type(e).__name__,
                    )
                    reqtrace.flag(tid, failover=True)
                    continue
                raise
            except EngineOverloaded as e:
                self._resolve(pick["rid"], "overloaded")
                tried.add(pick["rid"])
                last_err = e
                if attempt == 0:
                    continue
                with self._lock:
                    self._shed("queue_full", trace=tid)
                raise FleetOverloaded(
                    f"every routable replica's queue is full: {e}"
                ) from e
            except BaseException:
                self._resolve(pick["rid"], "error")
                raise
            else:
                self._resolve(pick["rid"], "ok", t0)
                return out
        raise last_err  # pragma: no cover - loop always returns/raises

    def stream(self, tokens, max_new_tokens, **kw):
        """Streaming decode with pre-first-token failover: connect (and
        anything before the first yielded token) may transparently
        retry ONCE on another replica; once a token has been consumed
        the request is no longer idempotent and any failure delivers
        exactly one terminal error."""
        return _RoutedStream(self, tokens, max_new_tokens, kw)

    # -- observability -------------------------------------------------

    @property
    def fleet(self) -> ServingFleet:
        """The fleet behind this router (rollout controllers target
        it; the router stays the request-path surface)."""
        return self._fleet

    def health(self) -> dict:
        return self._fleet.health()

    def stats(self) -> dict:
        with self._lock:
            router = {
                "outstanding": {
                    str(k): v
                    for k, v in sorted(self._outstanding.items())
                    if v
                },
                "est_request_s": {
                    str(k): round(v, 4)
                    for k, v in sorted(self._est_req_s.items())
                },
                "failovers": self._failovers,
                "shed": dict(self._shed_counts),
                "affinity_hits": self._affinity_hits,
                "affinity_misses": self._affinity_misses,
                "affinity_bypasses": self._affinity_bypasses,
                "affinity_entries": len(self._affinity),
            }
        return {"fleet": self._fleet.stats(), "router": router}

    @property
    def metrics(self) -> _MetricsView:
        return _MetricsView(self)

    def metrics_text(self) -> str:
        """Fleet/router series + every replica's engine series merged
        into ONE exposition, each sample re-labelled
        ``replica="<rid>"`` — the MetricsAggregator merge discipline
        applied to replicas instead of cluster nodes."""
        from tensorflowonspark_tpu_torch.obs.cluster import (
            merge_families,
            parse_prometheus_text,
        )

        per: dict[str, dict] = {}
        for v in self._fleet.views():
            try:
                per[str(v["rid"])] = parse_prometheus_text(
                    v["handle"].metrics_text()
                )
            except Exception as e:  # noqa: BLE001 - a dead replica's
                # series are simply absent this round
                logger.debug(
                    "replica %s metrics unavailable: %s", v["rid"], e
                )
        return self._fleet.metrics.render() + merge_families(
            per, label="replica"
        )

    # -- lifecycle -----------------------------------------------------

    def begin_drain(self) -> None:
        self._fleet.begin_drain()

    def close(self, drain: bool = False, drain_timeout: float = 300.0):
        self._fleet.metrics.remove_collector(self._collector)
        self._fleet.close(drain=drain, timeout=drain_timeout)


class _RoutedStream:
    """Router-side stream handle mirroring the engine ``_Stream``
    surface (``close`` / ``result`` / ``logprobs``)."""

    def __init__(self, router: FleetRouter, tokens, max_new, kw):
        self._router = router
        self._tokens = list(tokens)
        self._max_new = max_new
        # adopt (or mint) the request trace before kw is forwarded —
        # the id rides kw into the replica handle so connect retries
        # and the eventual engine segments land on the SAME trace
        self._trace, self._trace_owned = reqtrace.ensure(
            kw.pop("trace", None), route="stream"
        )
        self._trace_done = False
        if self._trace is not None:
            kw["trace"] = self._trace
        self._kw = kw
        self._adapter = int(kw.get("adapter") or 0)
        self._deadline = kw.get("deadline_s")
        self._tried: set[int] = set()
        self._failed_over = False
        self._overload_err: EngineOverloaded | None = None
        self._yielded = 0
        # _resolved means: the outstanding count _place bumped for the
        # CURRENT _rid has been released (exactly-once accounting).
        # True while no dispatch is held — _open flips it False after
        # each successful placement.
        self._resolved = True
        self._inner = None
        self._rid: int | None = None
        self._gen: int | None = None
        self._t0: float | None = None
        self._t_req = time.monotonic()
        try:
            self._open()
        except BaseException as e:
            self._trace_finish("error", error=type(e).__name__)
            raise

    def _open(self) -> None:
        """Place + connect. Failover-eligible connect failures consume
        the single failover budget; an overloaded replica is retried
        once on another (stream/submit parity — nothing has been sent
        to the client yet at open time); anything else propagates
        eagerly (the HTTP caller needs its 400/429/503 before
        committing a 200)."""
        while True:
            try:
                pick = self._router._place(
                    self._tokens, self._adapter, self._deadline,
                    self._tried, trace=self._trace,
                )
            except FleetUnavailable:
                if isinstance(self._overload_err, EngineOverloaded):
                    with self._router._lock:
                        self._router._shed(
                            "queue_full", trace=self._trace
                        )
                    raise FleetOverloaded(
                        "every routable replica's queue is full"
                    ) from self._overload_err
                if self._failed_over:
                    # the failover target pool ran dry: terminal
                    raise ReplicaGone(
                        "no replica left to fail over to"
                    ) from None
                raise
            reqtrace.event(
                self._trace, "router.place", replica=pick["rid"]
            )
            self._rid = pick["rid"]
            self._gen = pick["generation"]
            self._t0 = time.monotonic()
            self._resolved = False  # one outstanding held for _rid
            try:
                if failpoint("fleet.dispatch") == "drop":
                    raise ReplicaGone(
                        f'dispatch to replica {pick["rid"]} dropped '
                        "(failpoint fleet.dispatch)"
                    )
                self._inner = pick["handle"].stream(
                    self._tokens, self._max_new, **self._kw
                )
            except _FAILOVER_ERRORS as e:
                self._router._fleet.report_failure(
                    pick["rid"], repr(e),
                    generation=pick["generation"],
                )
                self._tried.add(pick["rid"])
                if not self._failed_over:
                    self._router._resolve(pick["rid"], "failover")
                    self._resolved = True
                    self._failed_over = True
                    self._router._note_failover()
                    reqtrace.event(
                        self._trace, "router.failover",
                        replica=pick["rid"],
                        error=type(e).__name__,
                    )
                    reqtrace.flag(self._trace, failover=True)
                    continue
                self._router._resolve(pick["rid"], "error")
                self._resolved = True
                raise
            except EngineOverloaded as e:
                # submit_many parity: one retry on another replica,
                # then a 429-class FleetOverloaded (not a bare 503)
                self._router._resolve(pick["rid"], "overloaded")
                self._resolved = True
                self._tried.add(pick["rid"])
                if self._overload_err is None:
                    self._overload_err = e
                    continue
                with self._router._lock:
                    self._router._shed(
                        "queue_full", trace=self._trace
                    )
                raise FleetOverloaded(
                    f"every routable replica's queue is full: {e}"
                ) from e
            except BaseException:
                self._router._resolve(pick["rid"], "error")
                self._resolved = True
                raise
            return

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = next(self._inner)
            except StopIteration:
                self._finish("ok")
                raise
            except _FAILOVER_ERRORS as e:
                self._router._fleet.report_failure(
                    self._rid, repr(e), generation=self._gen
                )
                if self._yielded == 0 and not self._failed_over:
                    # still idempotent: no token reached the consumer.
                    # The failed dispatch's outstanding is released
                    # HERE; _open re-arms _resolved only when it holds
                    # a new one — a terminal raise out of _open (e.g.
                    # no replica left) must not let close() release
                    # this rid a second time.
                    self._router._resolve(self._rid, "failover")
                    self._resolved = True
                    self._failed_over = True
                    self._router._note_failover()
                    reqtrace.event(
                        self._trace, "router.failover",
                        replica=self._rid,
                        error=type(e).__name__,
                    )
                    reqtrace.flag(self._trace, failover=True)
                    self._tried.add(self._rid)
                    try:
                        self._open()  # raises terminally if it can't
                    except BaseException as te:
                        self._trace_finish(
                            "error", error=type(te).__name__
                        )
                        raise
                    continue
                # mid-stream (or budget spent): exactly ONE terminal
                self._finish("error")
                raise
            except BaseException:
                self._finish("error")
                raise
            else:
                self._yielded += 1
                return item

    def _finish(self, outcome: str) -> None:
        if not self._resolved:
            self._resolved = True
            self._router._resolve(
                self._rid, outcome,
                self._t0 if outcome == "ok" else None,
            )
        self._trace_finish(outcome)

    def _trace_finish(self, outcome: str, **detail) -> None:
        """Terminal trace stamp — idempotent, because the accounting
        terminal (:meth:`_finish`) and the exception terminals (a
        raise out of ``_open``) can both fire for one stream."""
        if self._trace is None or self._trace_done:
            return
        self._trace_done = True
        reqtrace.segment(
            self._trace, "router.stream",
            time.monotonic() - self._t_req,
        )
        if outcome == "error":
            reqtrace.flag(
                self._trace, error=detail.get("error", True)
            )
        if self._trace_owned:
            reqtrace.finish(
                self._trace, outcome=outcome,
                tokens=self._yielded, **detail,
            )

    @property
    def result(self):
        return None if self._inner is None else self._inner.result

    @property
    def logprobs(self):
        return None if self._inner is None else self._inner.logprobs

    @property
    def weights_version(self):
        """The serving replica's per-request weights stamp (rollout
        coherence surface) — None until the stream resolves."""
        return (
            None
            if self._inner is None
            else getattr(self._inner, "weights_version", None)
        )

    def close(self) -> None:
        if self._inner is not None:
            self._inner.close()
        if not self._resolved and self._rid is not None:
            self._finish("cancelled")

    __del__ = close
