"""Fault-tolerant serving fleet: health-routed engine replicas.

``serve_model`` fronted ONE :class:`ContinuousBatcher` — a single
``EngineWedged`` or SIGKILL took down serving for every user. This
module owns N engine replicas the way the TensorFlow paper composes
workers behind a coordinator (TF-Replicator's framing: the client sees
one engine, the system owns N):

- **Replica handles** — :class:`InProcessReplica` (a factory-built
  engine in this process; each has its own scheduler + watchdog) and
  :class:`SubprocessReplica` (a ``serve_model`` child process reached
  over HTTP; the unit a SIGKILL can take out without touching its
  peers). Both expose the same surface: ``submit_many`` / ``stream`` /
  ``stats`` / ``health`` / ``metrics_text``.

- **Health plane** — a probe loop on the liveness cadence (the node
  heartbeat discipline applied to replicas): each round reads
  ``health()`` (liveness vs readiness, the split ``/healthz`` now
  serves) and ``/stats``; consecutive misses, a dead liveness bit, or
  a watchdog-fire delta (the ``EngineWedged`` signal) flip the replica
  to DRAINING — in-flight requests run out or fail over at the router,
  new load reroutes — and the supervisor respawns it. Rejoin is gated
  on warmup-complete READINESS, never on process existence: a replica
  that is still compiling serves nobody.

- **States** — ``STARTING → READY ⇄ DRAINING → (respawn) → STARTING``,
  terminally ``DEAD`` after ``max_respawns`` failed spawns. Exposed as
  the ``fleet_replica_state`` gauge (labels ``replica``, ``state``) and
  as flightrec events ``replica_drain`` / ``replica_respawn`` (dumped
  on incident, so a postmortem reads the transition log).

The router (:mod:`tensorflowonspark_tpu_torch.serving.router`) consumes the
fleet's snapshots for placement/admission and reports request-path
failures back through :meth:`ServingFleet.report_failure`.

Locking: each seat's mutable state is guarded by its OWN lock (fine-
grained — a slow probe of one replica must not serialize placement);
the fleet lock guards only the fleet-wide flags. Seat locks and the
fleet lock are never held together.

Failpoints: ``fleet.replica_probe`` (a raised probe is a missed beat),
``fleet.replica_spawn`` (a raised spawn exercises the respawn retry /
DEAD path); ``fleet.dispatch`` lives in the router.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

from tensorflowonspark_tpu_torch.obs import flightrec, reqtrace
from tensorflowonspark_tpu_torch.obs import registry as obs_registry
from tensorflowonspark_tpu_torch.serving.engine import (
    DeadlineExceeded,
    EngineOverloaded,
    EngineWedged,
)
from tensorflowonspark_tpu_torch.utils.failpoints import failpoint

logger = logging.getLogger(__name__)

__all__ = [
    "DEAD",
    "DRAINING",
    "READY",
    "STARTING",
    "FleetOverloaded",
    "FleetUnavailable",
    "InProcessReplica",
    "ReplicaGone",
    "ServingFleet",
    "SubprocessReplica",
]

# Replica lifecycle states (strings: they label the state gauge and
# ride JSON health bodies verbatim).
STARTING = "starting"  # spawned, warming up — not yet routable
READY = "ready"  # serving traffic
DRAINING = "draining"  # unhealthy or retiring: no new load, in-flight
# runs out or fails over, supervisor respawn in progress
DEAD = "dead"  # respawn budget exhausted — operator attention
_STATES = (STARTING, READY, DRAINING, DEAD)


class FleetOverloaded(RuntimeError):
    """Admission shed: no replica can meet the request's deadline (or
    every replica's queue is full). Retryable after ``retry_after``
    seconds — ``serve_model`` maps this to HTTP 429 + Retry-After."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = max(1.0, float(retry_after))


class FleetUnavailable(RuntimeError):
    """No READY replica exists (full-fleet drain, or everything is
    respawning/dead). ``serve_model`` maps this to HTTP 503."""


class ReplicaGone(RuntimeError):
    """The replica died under a request (process SIGKILLed, transport
    cut, engine closed mid-flight). Failover-eligible at the router
    while the request is still idempotent; terminal otherwise."""


# -- replica handles ---------------------------------------------------------


class InProcessReplica:
    """One factory-built :class:`ContinuousBatcher` in this process.

    The factory runs at :meth:`start` (and again on every respawn — a
    respawned replica is a FRESH engine: cold prefix cache, fresh
    scheduler/watchdog, compiled programs rebuilt), so a wedged
    engine's state can never leak into its successor.
    """

    kind = "inproc"

    def __init__(self, rid: int, factory, *, warmup: bool = True):
        self.rid = int(rid)
        self._factory = factory
        self._warmup = bool(warmup)
        self.engine = None

    def start(self) -> None:
        failpoint("fleet.replica_spawn")
        engine = self._factory()
        try:
            if self._warmup:
                engine.warmup()
        except BaseException:
            engine.close()
            raise
        self.engine = engine

    # -- health/obs ----------------------------------------------------

    def health(self) -> dict:
        if self.engine is None:
            return {"live": False, "ready": False}
        return self.engine.health()

    def stats(self) -> dict:
        if self.engine is None:
            raise ReplicaGone(f"replica {self.rid} has no engine")
        return self.engine.stats()

    def metrics_text(self) -> str:
        if self.engine is None:
            return ""
        return self.engine.metrics.render()

    # -- request path --------------------------------------------------

    def submit_many(self, prompts, max_new_tokens, **kw):
        eng = self.engine
        if eng is None:
            raise ReplicaGone(f"replica {self.rid} has no engine")
        try:
            return eng.submit_many(prompts, max_new_tokens, **kw)
        except RuntimeError as e:
            if isinstance(e, (EngineWedged, EngineOverloaded)):
                raise
            if "shutting down" in str(e):
                # raced the drain/close: the request was never accepted
                # — idempotent by construction, let the router fail over
                raise ReplicaGone(
                    f"replica {self.rid} closed during dispatch"
                ) from e
            raise

    def stream(self, tokens, max_new_tokens, **kw):
        eng = self.engine
        if eng is None:
            raise ReplicaGone(f"replica {self.rid} has no engine")
        try:
            return eng.stream(tokens, max_new_tokens, **kw)
        except RuntimeError as e:
            if isinstance(e, (EngineWedged, EngineOverloaded)):
                raise
            if "shutting down" in str(e):
                raise ReplicaGone(
                    f"replica {self.rid} closed during dispatch"
                ) from e
            raise

    # -- lifecycle -----------------------------------------------------

    def unresolved(self) -> int:
        return 0 if self.engine is None else self.engine.unresolved()

    def terminate(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Retire the engine: ``drain=True`` lets accepted requests run
        out (the watchdog has already aborted them with terminal
        ``EngineWedged`` if it fired — drain then returns fast)."""
        eng, self.engine = self.engine, None
        if eng is not None:
            eng.close(drain=drain, drain_timeout=timeout)

    def kill(self) -> None:
        self.terminate(drain=False)


class SubprocessReplica:
    """One ``serve_model`` child process reached over HTTP.

    The process-isolation unit: a SIGKILL (OOM kill, operator
    ``kill -9``, chaos test) takes out exactly one replica; the fleet's
    probe loop sees the missed beats and respawns it. ``spawn_argv``
    is the child's ``serve_model`` CLI (checkpoint, engine knobs);
    ``--port 0 --port-file`` are appended here — the child binds an
    ephemeral port AFTER its engine is built (and warmed, with
    ``--gen-warmup``), so the port file doubles as the spawn barrier.
    """

    kind = "subprocess"

    def __init__(
        self,
        rid: int,
        spawn_argv: list[str],
        *,
        spawn_timeout: float = 180.0,
        request_timeout: float = 120.0,
        probe_timeout: float = 2.0,
        env: dict | None = None,
        admin_token: str | None = None,
    ):
        self.rid = int(rid)
        self._argv = list(spawn_argv)
        self._spawn_timeout = float(spawn_timeout)
        self._request_timeout = float(request_timeout)
        self._probe_timeout = float(probe_timeout)
        self._env = dict(env) if env is not None else None
        # shared secret for the child's /admin/reload (weight hot-swap);
        # injected into the child env at spawn so only this supervisor
        # can drive reloads
        self._admin_token = admin_token
        self.proc: subprocess.Popen | None = None
        self.port: int | None = None

    def start(self) -> None:
        failpoint("fleet.replica_spawn")
        fd, port_file = tempfile.mkstemp(prefix="tfos-replica-port-")
        os.close(fd)
        os.remove(port_file)  # the child creates it at bind time
        argv = [
            sys.executable,
            "-m",
            "tensorflowonspark_tpu_torch.tools.serve_model",
            *self._argv,
            "--port",
            "0",
            "--port-file",
            port_file,
        ]
        env = dict(os.environ if self._env is None else self._env)
        if self._admin_token is not None:
            env["TFOS_ADMIN_TOKEN"] = self._admin_token
        self.proc = subprocess.Popen(
            argv,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            env=env,
        )
        deadline = time.monotonic() + self._spawn_timeout
        try:
            while True:
                if self.proc.poll() is not None:
                    raise ReplicaGone(
                        f"replica {self.rid} child exited rc="
                        f"{self.proc.returncode} before binding"
                    )
                try:
                    with open(port_file, "r", encoding="utf-8") as f:
                        text = f.read().strip()
                    if text:
                        self.port = int(text)
                        return
                except OSError:
                    pass
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"replica {self.rid} child did not bind within "
                        f"{self._spawn_timeout}s"
                    )
                time.sleep(0.05)
        except BaseException:
            self.kill()
            raise
        finally:
            try:
                os.remove(port_file)
            except OSError:
                pass

    # -- HTTP plumbing -------------------------------------------------

    def _url(self, path: str) -> str:
        if self.port is None:
            raise ReplicaGone(f"replica {self.rid} is not running")
        return f"http://127.0.0.1:{self.port}{path}"

    def _get_json(self, path: str, timeout: float) -> dict:
        try:
            with urllib.request.urlopen(
                self._url(path), timeout=timeout
            ) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except ReplicaGone:
            raise
        except Exception as e:  # noqa: BLE001 - transport = replica gone
            raise ReplicaGone(
                f"replica {self.rid} GET {path} failed: "
                f"{type(e).__name__}: {e}"
            ) from e

    def _post(
        self,
        path: str,
        payload: dict,
        timeout: float,
        headers: dict | None = None,
    ):
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            self._url(path),
            data=body,
            headers={
                "Content-Type": "application/json",
                **(headers or {}),
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, json.loads(
                    resp.read().decode("utf-8")
                )
        except urllib.error.HTTPError as e:
            try:
                err_payload = json.loads(e.read().decode("utf-8"))
            except Exception:  # noqa: BLE001 - torn error body
                err_payload = {"error": str(e)}
            return e.code, err_payload
        except Exception as e:  # noqa: BLE001 - transport = replica gone
            raise ReplicaGone(
                f"replica {self.rid} POST {path} failed: "
                f"{type(e).__name__}: {e}"
            ) from e

    @staticmethod
    def _raise_mapped(status: int, payload: dict) -> None:
        """Reconstruct the engine-typed error a replica's HTTP status
        encodes (``serve_model`` stamps ``error_type`` beside the
        message for exactly this round trip)."""
        msg = str(payload.get("error", f"HTTP {status}"))
        etype = payload.get("error_type", "")
        if status == 400:
            raise ValueError(msg)
        if status == 504 or etype == "DeadlineExceeded":
            raise DeadlineExceeded(msg)
        if etype == "EngineWedged":
            raise EngineWedged(msg)
        if etype == "EngineOverloaded" or "queue full" in msg:
            raise EngineOverloaded(msg)
        raise ReplicaGone(f"HTTP {status}: {msg}")

    # -- health/obs ----------------------------------------------------

    def health(self) -> dict:
        try:
            h = self._get_json("/healthz", self._probe_timeout)
        except ReplicaGone:
            return {"live": False, "ready": False}
        h.setdefault("live", True)
        h.setdefault("ready", True)
        return h

    def stats(self) -> dict:
        return self._get_json("/stats", self._probe_timeout)

    def metrics_text(self) -> str:
        try:
            with urllib.request.urlopen(
                self._url("/metrics"), timeout=self._probe_timeout
            ) as resp:
                return resp.read().decode("utf-8", "replace")
        except ReplicaGone:
            raise
        except Exception as e:  # noqa: BLE001 - transport = replica gone
            raise ReplicaGone(
                f"replica {self.rid} GET /metrics failed: "
                f"{type(e).__name__}: {e}"
            ) from e

    # -- request path --------------------------------------------------

    @staticmethod
    def _request_body(prompts, max_new_tokens, kw) -> dict:
        body = {"prompts": prompts, "max_new_tokens": int(max_new_tokens)}
        for key in (
            "temperature",
            "eos_id",
            "adapter",
            "stop",
            "top_k",
            "top_p",
            "seed",
            "min_p",
            "frequency_penalty",
            "presence_penalty",
            "deadline_s",
        ):
            if kw.get(key) is not None:
                body[key] = kw[key]
        if kw.get("logit_bias") is not None:
            body["logit_bias"] = {
                str(t): v for t, v in kw["logit_bias"].items()
            }
        if kw.get("return_logprobs") or kw.get("yield_logprobs"):
            body["logprobs"] = True
        if kw.get("return_versions"):
            body["versions"] = True
        return body

    def submit_many(self, prompts, max_new_tokens, **kw):
        # the trace id crosses the process boundary as a header, not a
        # body field — the child's ingress adopts it exactly like any
        # external caller's X-TFOS-Trace
        trace = kw.pop("trace", None)
        body = self._request_body(prompts, max_new_tokens, kw)
        timeout = self._request_timeout
        if kw.get("deadline_s") is not None:
            # the HTTP wait must outlive the engine's own deadline so
            # the typed 504 (not a socket timeout) is what comes back
            timeout = max(timeout, float(kw["deadline_s"]) + 30.0)
        status, payload = self._post(
            "/generate",
            body,
            timeout,
            headers={reqtrace.HEADER: trace} if trace else None,
        )
        if status != 200:
            self._raise_mapped(status, payload)
        out: tuple = (payload["completions"],)
        if kw.get("return_logprobs"):
            out += (payload["logprobs"],)
        if kw.get("return_versions"):
            out += (payload.get("weights_versions"),)
        return out if len(out) > 1 else out[0]

    def stream(self, tokens, max_new_tokens, **kw):
        trace = kw.pop("trace", None)
        body = self._request_body([tokens], max_new_tokens, kw)
        body["stream"] = True
        timeout = self._request_timeout
        if kw.get("deadline_s") is not None:
            # like submit_many: a long-deadline request whose first
            # token legitimately waits must come back as the typed
            # DeadlineExceeded, not a socket timeout masquerading as
            # a dead replica (which would drain a healthy one)
            timeout = max(timeout, float(kw["deadline_s"]) + 30.0)
        return _HTTPStream(
            self, body, bool(kw.get("yield_logprobs")), timeout,
            trace=trace,
        )

    def reload(
        self,
        *,
        version: str,
        kind: str = "full",
        path: str,
        step: int | None = None,
        timeout: float = 600.0,
    ) -> dict:
        """Hot-swap the child's serving weights through its
        authenticated ``/admin/reload`` (the child loads ``path`` — an
        orbax checkpoint directory — itself, swaps between decode
        blocks, and re-warms before answering). Raises
        :class:`~tensorflowonspark_tpu_torch.serving.engine.WeightsIncompatible`
        on a shape/layout mismatch (HTTP 409) so a rollout controller
        can trigger rollback, :class:`ReplicaGone` on transport death."""
        if self._admin_token is None:
            raise RuntimeError(
                f"replica {self.rid} has no admin token; spawn it "
                "through a ServingFleet (or pass admin_token=)"
            )
        body: dict = {"version": str(version), "kind": kind, "path": path}
        if step is not None:
            body["step"] = int(step)
        status, payload = self._post(
            "/admin/reload",
            body,
            timeout,
            headers={"Authorization": f"Bearer {self._admin_token}"},
        )
        if status != 200:
            from tensorflowonspark_tpu_torch.serving.engine import (
                WeightsIncompatible,
            )

            msg = str(payload.get("error", f"HTTP {status}"))
            if (
                status == 409
                or payload.get("error_type") == "WeightsIncompatible"
            ):
                raise WeightsIncompatible(msg)
            raise RuntimeError(
                f"replica {self.rid} reload failed: HTTP {status}: {msg}"
            )
        return payload

    # -- lifecycle -----------------------------------------------------

    def unresolved(self) -> int:
        try:
            st = self.stats()
        except ReplicaGone:
            return 0  # a dead process resolves nothing further
        # the engine's own accounting (accepted - completed - failed),
        # served at /stats — queued requests are accepted but not yet
        # "admitted", and cancelled/wedged requests resolve through
        # completed/failed, so deriving this from the admission
        # counters here would be wrong on both ends
        return max(0, int(st.get("unresolved", 0)))

    def terminate(self, drain: bool = True, timeout: float = 30.0) -> None:
        proc = self.proc
        if proc is None:
            self.port = None
            return
        if drain and proc.poll() is None:
            # the child has no graceful-SIGTERM path (serve_model's
            # drain hook runs on KeyboardInterrupt only), so draining
            # means WAITING: poll the engine's /stats unresolved count
            # down to zero (bounded) before the terminate — a dead or
            # unreachable child reads 0 and falls straight through
            deadline = time.monotonic() + timeout
            while (
                time.monotonic() < deadline
                and proc.poll() is None
                and self.unresolved() > 0
            ):
                time.sleep(0.1)
        self.proc = None
        self.port = None
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)
        else:
            proc.wait()  # reap

    def kill(self) -> None:
        proc, self.proc = self.proc, None
        self.port = None
        if proc is not None:
            if proc.poll() is None:
                proc.kill()
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass

    @property
    def pid(self) -> int | None:
        return None if self.proc is None else self.proc.pid


class _HTTPStream:
    """Iterator over a subprocess replica's NDJSON ``/generate``
    stream, mirroring the engine's ``_Stream`` surface (``close`` /
    ``result`` / ``logprobs``). A severed connection or an EOF without
    the done-trailer is a LOUD :class:`ReplicaGone` — a SIGKILLed
    replica's consumers get exactly one terminal, never a silent
    hang."""

    _conn = None  # class default: __del__ must be safe when the
    # constructor raised before the connection existed

    def __init__(self, replica, body, yield_logprobs, timeout, trace=None):
        self._rid = replica.rid
        self._yield_logprobs = yield_logprobs
        self._done = False
        self.result = None
        self.logprobs = None
        self.weights_version = None  # from the done-trailer
        headers = {"Content-Type": "application/json"}
        if trace:
            headers[reqtrace.HEADER] = trace
        try:
            self._conn = http.client.HTTPConnection(
                "127.0.0.1", replica.port, timeout=timeout
            )
            self._conn.request(
                "POST",
                "/generate",
                json.dumps(body),
                headers,
            )
            self._resp = self._conn.getresponse()
        except Exception as e:  # noqa: BLE001 - transport = replica gone
            raise ReplicaGone(
                f"replica {replica.rid} stream connect failed: "
                f"{type(e).__name__}: {e}"
            ) from e
        if self._resp.status != 200:
            try:
                payload = json.loads(self._resp.read().decode("utf-8"))
            except Exception:  # noqa: BLE001 - torn error body
                payload = {"error": f"HTTP {self._resp.status}"}
            self._conn.close()
            SubprocessReplica._raise_mapped(self._resp.status, payload)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        try:
            raw = self._resp.readline()
        except Exception as e:  # noqa: BLE001 - severed mid-stream
            self._done = True
            self._conn.close()
            raise ReplicaGone(
                f"replica {self._rid} stream severed: "
                f"{type(e).__name__}: {e}"
            ) from e
        if not raw:
            self._done = True
            self._conn.close()
            raise ReplicaGone(
                f"replica {self._rid} stream ended without a terminal"
            )
        try:
            line = json.loads(raw)
        except ValueError as e:
            # a torn line (the replica died mid-write) is the SAME
            # severed-stream verdict as an EOF — it must surface as
            # the failover-eligible ReplicaGone, not a JSONDecodeError
            # that bypasses failure reporting
            self._done = True
            self._conn.close()
            raise ReplicaGone(
                f"replica {self._rid} stream severed mid-line: "
                f"{raw[:64]!r}"
            ) from e
        if line.get("done"):
            self._done = True
            self.result = line.get("completion")
            self.logprobs = line.get("logprobs")
            self.weights_version = line.get("weights_version")
            self._conn.close()
            raise StopIteration
        if "error" in line:
            self._done = True
            self._conn.close()
            etype = line.get("error_type", "")
            msg = str(line["error"])
            if etype == "EngineWedged" or msg.startswith("EngineWedged"):
                raise EngineWedged(msg)
            if etype == "DeadlineExceeded" or msg.startswith(
                "DeadlineExceeded"
            ):
                raise DeadlineExceeded(msg)
            raise ReplicaGone(msg)
        if self._yield_logprobs:
            return line["token"], line.get("logprob")
        return line["token"]

    def close(self) -> None:
        # closing the connection is the cancel signal: the server's
        # stream writer hits BrokenPipe and closes the engine stream
        if not getattr(self, "_done", True):
            self._done = True
            try:
                if self._conn is not None:
                    self._conn.close()
            except Exception:  # noqa: BLE001 - already gone
                pass

    __del__ = close


# -- the fleet ---------------------------------------------------------------


class _ReplicaSlot:
    """Fleet-side bookkeeping for one replica seat, guarded by the
    seat's OWN lock (fine-grained: one slow seat must not serialize
    the others). The seat is stable (rid never changes); the handle
    behind it is replaced on respawn (``generation`` bumps)."""

    def __init__(self, rid: int, handle):
        self.rid = rid
        self._lock = threading.Lock()
        self.handle = handle  # guarded-by: self._lock
        self.state = STARTING  # guarded-by: self._lock
        self.misses = 0  # guarded-by: self._lock
        self.last_stats: dict = {}  # guarded-by: self._lock
        self.last_watchdog = 0  # guarded-by: self._lock
        self.generation = 0  # guarded-by: self._lock
        self.respawns = 0  # lifetime respawn attempts  # guarded-by: self._lock
        # CONSECUTIVE failed spawn attempts — the DEAD budget counts
        # these, reset on every successful install, so a seat that
        # respawns successfully N times over weeks never goes DEAD
        self.spawn_failures = 0  # guarded-by: self._lock
        # True while a rollout controller holds the seat in DRAINING
        # (hold_seat/release_seat): the respawn supervisor must leave a
        # held seat alone — the holder owns its lifecycle
        self.hold = False  # guarded-by: self._lock
        self.last_reason: str | None = None  # guarded-by: self._lock
        # last probe-round health verdict (fleet.health() serves THIS
        # instead of re-probing every replica per call)
        self.last_health: dict = {"live": True, "ready": True}  # guarded-by: self._lock

    def view(self) -> dict:
        """Point-in-time snapshot, handed out as a plain dict
        (``rid`` / ``state`` / ``stats`` / ``handle`` /
        ``generation``) — the router and observability surfaces never
        touch live slot fields."""
        with self._lock:
            return {
                "rid": self.rid,
                "state": self.state,
                "stats": dict(self.last_stats),
                "handle": self.handle,
                "generation": self.generation,
            }

    def seat_info(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "generation": self.generation,
                "respawns": self.respawns,
                "misses": self.misses,
                "last_reason": self.last_reason,
                "stats": dict(self.last_stats),
            }

    def health_view(self) -> dict:
        """Per-seat liveness/readiness from the CACHED probe verdict —
        no replica IO (a /healthz against the front-end must not pay
        probe_timeout per sick replica; the probe loop already did).
        Non-READY seats derive from the state machine: STARTING is
        alive-but-compiling, DRAINING/DEAD are not routable."""
        with self._lock:
            if self.state == READY:
                return {
                    "state": READY,
                    "live": bool(self.last_health.get("live", True)),
                    "ready": bool(self.last_health.get("ready", True)),
                }
            return {
                "state": self.state,
                "live": self.state == STARTING,
                "ready": False,
            }


def _normalize_l2_spec(prefix_l2) -> dict | None:
    """Canonical ``{"mode", "capacity_bytes", "lookup_timeout_s"}`` for
    the fleet's ``prefix_l2=`` argument, or None (off)."""
    if prefix_l2 is None:
        return None
    spec = {
        "mode": "inproc",
        "capacity_bytes": 256 << 20,
        "lookup_timeout_s": 0.05,
    }
    if isinstance(prefix_l2, str):
        spec["mode"] = prefix_l2
    elif isinstance(prefix_l2, dict):
        spec.update(prefix_l2)
    else:
        raise ValueError(
            f"prefix_l2 must be None, 'inproc', 'spawn', or a dict; "
            f"got {prefix_l2!r}"
        )
    if spec["mode"] not in ("inproc", "spawn"):
        raise ValueError(
            f"prefix_l2 mode must be 'inproc' or 'spawn', got "
            f"{spec['mode']!r}"
        )
    if int(spec["capacity_bytes"]) < 1:
        raise ValueError(
            f"prefix_l2 capacity_bytes must be >= 1, got "
            f"{spec['capacity_bytes']}"
        )
    return spec


class ServingFleet:
    """N replica seats + the health/supervision plane over them.

    Exactly one of ``factory`` (in-process engines) or ``spawn_argv``
    (``serve_model`` subprocess children) selects the replica kind.
    The probe loop runs every ``probe_interval`` seconds;
    ``miss_limit`` consecutive failed probes (or one watchdog-fire
    delta) flip a replica to DRAINING and trigger a respawn, retried
    up to ``max_respawns`` times per seat before the seat goes DEAD.
    """

    def __init__(
        self,
        factory=None,
        *,
        spawn_argv: list[str] | None = None,
        replicas: int = 2,
        probe_interval: float = 1.0,
        miss_limit: int = 3,
        warmup: bool = True,
        respawn: bool = True,
        max_respawns: int = 8,
        respawn_backoff_s: float = 0.5,
        drain_timeout: float = 30.0,
        wait_ready: bool = True,
        start_timeout: float = 600.0,
        registry: obs_registry.Registry | None = None,
        spawn_kwargs: dict | None = None,
        prefix_l2=None,
    ):
        if (factory is None) == (spawn_argv is None):
            raise ValueError(
                "exactly one of factory= (in-process) or spawn_argv= "
                "(subprocess) selects the replica kind"
            )
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self._factory = factory
        self._spawn_argv = spawn_argv
        self._spawn_kwargs = dict(spawn_kwargs or {})
        self._warmup = bool(warmup)
        self.probe_interval = max(0.05, float(probe_interval))
        self.miss_limit = max(1, int(miss_limit))
        self._respawn = bool(respawn)
        self.max_respawns = int(max_respawns)
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.drain_timeout = float(drain_timeout)
        self._lock = threading.Lock()
        self._closed = False  # guarded-by: self._lock
        self._draining = False  # guarded-by: self._lock
        self._stop = threading.Event()
        # set at the END of __init__; close() must tolerate being
        # called from a cold-start failure before it exists
        self._probe_thread: threading.Thread | None = None
        # the router registers itself here to be told when a seat's
        # engine is replaced (its affinity/load state for it is stale)
        self.listener = None
        # a rollout controller registers itself here: called with
        # (rid, handle) after a respawned replica passes readiness but
        # BEFORE it is installed/routable, so a seat respawned
        # mid-rollout rejoins at the fleet's target weights version
        # instead of resurrecting the boot checkpoint
        self.rollout_hook = None
        # shared secret for subprocess children's /admin/reload —
        # generated per fleet, injected into each child's env at spawn
        self.admin_token: str | None = None
        if spawn_argv is not None:
            token = self._spawn_kwargs.pop("admin_token", None)
            if token is None:
                import secrets

                token = secrets.token_hex(16)
            self.admin_token = token

        # -- fleet-global prefix L2 (cachetier) ------------------------
        # prefix_l2: None (off), "inproc" (one shared in-process
        # CacheTier — the InProcessReplica spelling), "spawn" (a
        # supervised cachetier daemon subprocess — survives nothing,
        # needs to survive nothing: clients degrade to L1-only on any
        # outage), or a dict with {"mode", "capacity_bytes",
        # "lookup_timeout_s"} overrides.
        self._l2_spec = _normalize_l2_spec(prefix_l2)
        self.cache_tier = None  # inproc mode: the shared store
        self.cachetier_address: str | None = None  # spawn mode: host:port
        self._cache_lock = threading.Lock()
        self._cache_proc = None  # guarded-by: self._cache_lock
        self._cache_respawns = 0  # guarded-by: self._cache_lock
        self._cache_admin = None  # invalidate/stats client (fleet-owned)
        if self._l2_spec is not None:
            self._start_prefix_l2()
            if self._factory is not None:
                self._factory = self._wrap_factory_with_l2(self._factory)
            elif self.cachetier_address is not None:
                # subprocess replicas learn the daemon address via the
                # serve_model flag; each child builds its own CacheClient
                self._spawn_argv = list(self._spawn_argv) + [
                    "--cachetier-l2", self.cachetier_address,
                ]

        self.metrics = (
            registry if registry is not None else obs_registry.Registry()
        )
        self._g_state = self.metrics.gauge(
            "fleet_replica_state",
            "replica lifecycle state (1 for the current state)",
        )
        self._m_respawns = self.metrics.counter(
            "fleet_respawns_total", "replica respawn attempts, by outcome"
        )
        self._m_probe_misses = self.metrics.counter(
            "fleet_probe_misses_total", "failed replica health probes"
        )

        # seat map: built once, never mutated (seats are stable; only
        # the state BEHIND a seat changes, under that seat's lock)
        self._slots: dict[int, _ReplicaSlot] = {
            rid: _ReplicaSlot(rid, self._new_handle(rid))
            for rid in range(int(replicas))
        }
        for rid in self._slots:
            self._g_state.set(1, replica=str(rid), state=STARTING)

        # parallel spawn: replicas start independently (one slow
        # compile must not serialize the fleet's cold start)
        errors: dict[int, BaseException] = {}

        def _boot(slot: _ReplicaSlot) -> None:
            try:
                with slot._lock:
                    handle = slot.handle
                handle.start()
                self._await_readiness(handle)
            except BaseException as e:  # noqa: BLE001 - per-seat verdict
                errors[slot.rid] = e
                # the seat enters the ORDINARY respawn path regardless
                # of wait_ready — a stranded STARTING seat that nobody
                # supervises would silently halve the fleet forever
                logger.warning(
                    "replica %d failed cold start: %s", slot.rid, e
                )
                self._flip_draining(slot, f"cold start failed: {e}")
                return
            # same install-vs-close ordering as _respawn_seat: close()
            # flips _closed before sweeping, so either we see it here
            # (and retire the fresh engine ourselves) or the sweep
            # runs after us and collects it
            with slot._lock:
                installed = not self.closed
                if installed:
                    slot.state = READY
            if not installed:
                handle.kill()
                return
            self._set_state_gauge(slot.rid, STARTING, READY)

        boot_threads = [
            threading.Thread(target=_boot, args=(s,), daemon=True)
            for s in self._slots.values()
        ]
        for t in boot_threads:
            t.start()
        if wait_ready:
            deadline = time.monotonic() + float(start_timeout)
            for t in boot_threads:
                t.join(max(0.1, deadline - time.monotonic()))
            if errors and len(errors) == len(self._slots):
                # nothing came up: fail construction with the root
                # cause (close() also stops the respawn threads)
                self.close()
                raise next(iter(errors.values()))
        self._probe_thread = threading.Thread(
            target=self._probe_loop, daemon=True, name="fleet-probe"
        )
        self._probe_thread.start()

    # -- construction helpers ------------------------------------------

    def _new_handle(self, rid: int):
        if self._factory is not None:
            return InProcessReplica(
                rid, self._factory, warmup=self._warmup
            )
        return SubprocessReplica(
            rid,
            self._spawn_argv,
            admin_token=self.admin_token,
            **self._spawn_kwargs,
        )

    # -- prefix L2 plumbing (cachetier) --------------------------------

    def _start_prefix_l2(self) -> None:
        from tensorflowonspark_tpu_torch.cachetier import CacheTier, LocalClient

        spec = self._l2_spec
        if spec["mode"] == "inproc":
            self.cache_tier = CacheTier(
                capacity_bytes=spec["capacity_bytes"]
            )
            self._cache_admin = LocalClient(self.cache_tier)
            return
        self._spawn_cache_daemon(port=0)
        from tensorflowonspark_tpu_torch.cachetier import CacheClient

        self._cache_admin = CacheClient(self.cachetier_address)
        threading.Thread(
            target=self._cache_supervise_loop,
            daemon=True,
            name="fleet-cachetier-supervise",
        ).start()

    def _spawn_cache_daemon(self, port: int) -> None:
        """Spawn the cachetier daemon and wait out its port-file barrier.
        Respawns pass the ORIGINAL bound port so every client's cached
        address stays valid across a daemon death."""
        pf = tempfile.mktemp(prefix="tfos-cachetier-port-")
        argv = [
            sys.executable,
            "-m",
            "tensorflowonspark_tpu_torch.cachetier.service",
            "--port", str(port),
            "--port-file", pf,
            "--capacity-bytes", str(self._l2_spec["capacity_bytes"]),
        ]
        proc = subprocess.Popen(argv)
        deadline = time.monotonic() + 30.0
        try:
            while not os.path.exists(pf):
                if proc.poll() is not None:
                    raise RuntimeError(
                        "cachetier daemon exited during startup "
                        f"(rc={proc.returncode})"
                    )
                if time.monotonic() > deadline:
                    proc.kill()
                    raise TimeoutError(
                        "cachetier daemon did not publish its port "
                        "within 30s"
                    )
                time.sleep(0.02)
            with open(pf) as f:
                bound = int(f.read().strip())
        finally:
            try:
                os.unlink(pf)
            except OSError:
                pass
        with self._cache_lock:
            self._cache_proc = proc
        self.cachetier_address = f"127.0.0.1:{bound}"
        flightrec.note("cachetier_spawn", address=self.cachetier_address)

    def _cache_supervise_loop(self) -> None:
        """Respawn a dead cachetier daemon (warm state is lost — that
        is fine, it is a CACHE). While it is down, every client is
        already degrading to L1-only misses; nothing here is urgent or
        load-bearing, so failures just log and retry next round."""
        while not self._stop.wait(self.probe_interval):
            with self._cache_lock:
                proc = self._cache_proc
                respawns = self._cache_respawns
            if proc is None or proc.poll() is None:
                continue
            if respawns >= self.max_respawns:
                logger.error(
                    "cachetier daemon dead and respawn budget (%d) "
                    "spent; fleet continues L1-only",
                    self.max_respawns,
                )
                return
            with self._cache_lock:
                self._cache_respawns += 1
            port = int(self.cachetier_address.rpartition(":")[2])
            try:
                self._spawn_cache_daemon(port=port)
                flightrec.note("cachetier_respawn", port=port)
                logger.warning(
                    "cachetier daemon respawned on port %d", port
                )
            except Exception:  # noqa: BLE001 - retry next round
                logger.warning(
                    "cachetier daemon respawn failed", exc_info=True
                )

    def _new_l2(self, chunk: int):
        """One PrefixL2 facade for one replica (own filler thread; the
        underlying store/daemon is fleet-shared)."""
        from tensorflowonspark_tpu_torch.cachetier import (
            CacheClient,
            LocalClient,
            PrefixL2,
        )

        spec = self._l2_spec
        if spec["mode"] == "inproc":
            client, own = LocalClient(self.cache_tier), False
        else:
            client, own = CacheClient(self.cachetier_address), True
        return PrefixL2(
            client,
            chunk=chunk,
            lookup_timeout_s=spec["lookup_timeout_s"],
            own_client=own,
        )

    def _wrap_factory_with_l2(self, inner):
        """Attach a fresh PrefixL2 to every factory-built engine
        (including respawns). Attach failure degrades to L1-only —
        never blocks a replica from serving."""

        def factory(*a, **kw):
            eng = inner(*a, **kw)
            try:
                chunk = getattr(eng, "_prefill_chunk", None)
                has_l1 = getattr(eng, "_prefix_store", None) is not None
                if chunk and has_l1 and hasattr(eng, "attach_prefix_l2"):
                    eng.attach_prefix_l2(self._new_l2(int(chunk)))
                else:
                    logger.warning(
                        "prefix_l2 configured but the engine has no "
                        "prefix cache (prefix_cache/prefill_chunk "
                        "unset); replica continues without L2"
                    )
            except Exception:  # noqa: BLE001 - L2 is optional
                logger.warning("prefix L2 attach failed", exc_info=True)
            return eng

        return factory

    def invalidate_prefix_version(self, version) -> int:
        """Drop one weights version's prefix entries from the fleet L2
        (the rollout reclamation hook) — exact by key construction;
        returns entries dropped (0 when no L2 / service down: harmless,
        the old version's keys can never be looked up again)."""
        if self._cache_admin is None:
            return 0
        from tensorflowonspark_tpu_torch.cachetier import prefix as _prefix

        try:
            n = self._cache_admin.invalidate(
                _prefix.NS, _prefix.version_prefix(version)
            )
        except Exception:  # noqa: BLE001 - reclamation is best-effort
            logger.warning("prefix L2 invalidate failed", exc_info=True)
            return 0
        if n:
            flightrec.note(
                "cachetier_invalidate", version=str(version), dropped=n
            )
        return n

    def cache_stats(self) -> dict | None:
        """The shared cache tier's counters (None when no L2 is
        configured or the daemon is unreachable)."""
        if self._cache_admin is None:
            return None
        try:
            return self._cache_admin.stats()
        except Exception:  # noqa: BLE001 - stats are best-effort
            return None

    def _await_readiness(self, handle, timeout: float = 120.0) -> None:
        """The rejoin gate: a (re)spawned replica joins the routable
        set only once its OWN health says ready (warmup complete) — a
        compiling replica that "exists" is not a replica."""
        deadline = time.monotonic() + timeout
        while True:
            h = handle.health()
            if h.get("ready"):
                return
            if not h.get("live", True):
                raise ReplicaGone(
                    f"replica {handle.rid} died before readiness"
                )
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replica {handle.rid} not ready within {timeout}s"
                )
            time.sleep(0.05)

    def _set_state_gauge(self, rid: int, old: str, new: str) -> None:
        if old != new:
            self._g_state.remove(replica=str(rid), state=old)
        self._g_state.set(1, replica=str(rid), state=new)

    # -- snapshots (router + /stats surface) ---------------------------

    def views(self) -> list[dict]:
        return [s.view() for s in self._slots.values()]

    def ready_views(self) -> list[dict]:
        return [v for v in self.views() if v["state"] == READY]

    @property
    def draining(self) -> bool:
        return self._draining  # lint: lockfree-read: advisory one-bool admission flag; a stale read only delays one shed by a poll

    @property
    def closed(self) -> bool:
        return self._closed  # lint: lockfree-read: advisory one-bool flag, same as draining

    def states(self) -> dict[int, str]:
        return {rid: s.view()["state"] for rid, s in self._slots.items()}

    def health(self) -> dict:
        """Fleet-aggregated liveness/readiness + the per-replica split
        (the ``/healthz`` body in fleet mode). Served from the probe
        loop's CACHED verdicts (freshness = one ``probe_interval``):
        a front-end health check must answer fast even when a replica
        is hung — re-probing N replicas serially per call would make
        the aggregate /healthz flap exactly when one replica is sick."""
        per = {
            str(rid): s.health_view()
            for rid, s in self._slots.items()
        }
        draining = self.draining
        return {
            "live": any(h["live"] for h in per.values()),
            "ready": (
                not draining
                and any(
                    h["ready"] and h["state"] == READY
                    for h in per.values()
                )
            ),
            "draining": draining,
            "replicas": per,
        }

    def stats(self) -> dict:
        seats = {
            str(rid): s.seat_info() for rid, s in self._slots.items()
        }
        return {
            "replicas": len(seats),
            "ready": sum(
                1 for s in seats.values() if s["state"] == READY
            ),
            "draining": self.draining,
            "seats": seats,
        }

    # -- probe loop ----------------------------------------------------

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval):
            try:
                self.probe_now()
            except Exception:  # pragma: no cover - probe_now guards
                logger.exception("fleet probe round failed")

    def probe_now(self) -> None:
        """One health round over every seat (also callable from tests
        for a deterministic refresh). READY seats accumulate misses /
        watchdog deltas here; STARTING and DRAINING seats belong to
        their spawn/respawn threads and are left alone."""
        for slot in self._slots.values():
            view = slot.view()
            if view["state"] != READY:
                continue
            ok = True
            h: dict = {"live": False, "ready": False}
            answered = False  # the replica POSITIVELY answered live
            st: dict = {}
            try:
                failpoint("fleet.replica_probe")
                h = view["handle"].health()
                if h.get("live"):
                    answered = True
                    st = view["handle"].stats()
                else:
                    ok = False
            except Exception:  # noqa: BLE001 - a failed probe is a miss
                ok = False
                h = {"live": False, "ready": False}
            if ok and not h.get("ready"):
                # alive but no longer ready (engine closed under us, or
                # warmup regressed — neither is routable)
                ok = False
            reason = None
            with slot._lock:
                if slot.state != READY:
                    continue
                if slot.generation != view["generation"]:
                    continue  # respawned under us; stale verdict
                if answered:
                    # only a POSITIVE verdict replaces the cached
                    # health: a single unanswered probe (a GC pause, a
                    # long compile) below miss_limit must not flap the
                    # reported /healthz to dead while the replica is
                    # still serving — the drain threshold IS the
                    # debounce, and reaching it flips the seat out of
                    # READY anyway
                    slot.last_health = dict(h)
                if not ok:
                    slot.misses += 1
                    misses = slot.misses
                    if misses >= self.miss_limit:
                        reason = (
                            f"missed {misses} probes "
                            f"(interval {self.probe_interval}s)"
                        )
                else:
                    misses = 0
                    slot.misses = 0
                    slot.last_stats = st
                    fires = int(st.get("watchdog_fires") or 0)
                    if fires > slot.last_watchdog:
                        reason = (
                            f"engine watchdog fired ({fires} total) — "
                            "EngineWedged"
                        )
                    slot.last_watchdog = fires
            if not ok:
                self._m_probe_misses.inc(replica=str(slot.rid))
            if reason is not None:
                self._flip_draining(
                    slot, reason, generation=view["generation"]
                )

    # -- failure handling / supervision --------------------------------

    def report_failure(
        self, rid: int, reason: str, generation: int | None = None
    ) -> None:
        """Request-path verdict from the router: a dispatch came back
        ``EngineWedged``/:class:`ReplicaGone`. Flips the replica to
        DRAINING and respawns — faster than waiting out the probe
        interval, and the router has already rerouted the request.
        ``generation`` scopes the verdict: a stale failure from a
        replica's OLD engine must not drain the freshly respawned one
        behind the same seat."""
        slot = self._slots.get(int(rid))
        if slot is not None:
            self._flip_draining(
                slot, f"request path: {reason}", generation=generation
            )

    def _flip_draining(
        self,
        slot: _ReplicaSlot,
        reason: str,
        generation: int | None = None,
    ) -> None:
        if self.closed:
            return
        with slot._lock:
            if slot.state in (DRAINING, DEAD):
                return
            if generation is not None and slot.generation != generation:
                return  # verdict about a generation already replaced
            old = slot.state
            slot.state = DRAINING
            slot.last_reason = reason
            gen = slot.generation
        self._set_state_gauge(slot.rid, old, DRAINING)
        logger.warning(
            "replica %d -> draining (%s)", slot.rid, reason
        )
        flightrec.note(
            "replica_drain", replica=slot.rid, reason=reason,
            generation=gen,
        )
        # off-thread: _flip_draining runs on the REQUEST path (the
        # router reports failures before retrying), and the dump's
        # file IO must not sit under the failover it races
        threading.Thread(
            target=flightrec.dump_now,
            args=(f"replica_drain:{slot.rid}",),
            daemon=True,
        ).start()
        threading.Thread(
            target=self._respawn_seat,
            args=(slot, reason),
            daemon=True,
            name=f"fleet-respawn-{slot.rid}",
        ).start()

    def _respawn_seat(self, slot: _ReplicaSlot, reason: str) -> None:
        """Drain the seat's old engine, then (optionally) respawn a
        fresh one, rejoin gated on readiness. Runs on its own daemon
        thread — supervision must not block the probe loop."""
        with slot._lock:
            old_handle = slot.handle
        try:
            # in-flight work runs out (or was already aborted by the
            # watchdog / died with the process) before the seat flips
            old_handle.terminate(drain=True, timeout=self.drain_timeout)
        except Exception:  # noqa: BLE001 - a dead handle drains itself
            logger.exception("replica %d drain failed", slot.rid)
        if not self._respawn or self.closed:
            self._mark_dead(slot, f"respawn disabled ({reason})")
            return
        attempts = 0
        while not self.closed:
            attempts += 1
            with slot._lock:
                budget_spent = slot.spawn_failures >= self.max_respawns
                if not budget_spent:
                    slot.respawns += 1
                    slot.generation += 1
                    slot.state = STARTING
                    slot.misses = 0
                    slot.last_watchdog = 0
                    slot.last_stats = {}
                    # the fresh engine starts with a clean verdict —
                    # the dead generation's cached {live: False} must
                    # not gate the respawned seat's readiness until
                    # the next probe round
                    slot.last_health = {"live": True, "ready": True}
                    gen = slot.generation
            if budget_spent:
                self._mark_dead(
                    slot, f"respawn budget ({self.max_respawns}) spent"
                )
                return
            self._set_state_gauge(slot.rid, DRAINING, STARTING)
            handle = self._new_handle(slot.rid)
            try:
                handle.start()
                self._await_readiness(handle)
                hook = self.rollout_hook
                if hook is not None:
                    # mid-rollout respawn: bring the fresh replica (it
                    # boots on the ORIGINAL checkpoint) to the fleet's
                    # current target weights BEFORE it becomes routable
                    try:
                        hook(slot.rid, handle)
                    except Exception:  # noqa: BLE001 - rejoin anyway
                        logger.exception(
                            "replica %d rollout re-sync failed; seat "
                            "rejoins on its boot weights",
                            slot.rid,
                        )
            except Exception as e:  # noqa: BLE001 - retried with backoff
                self._m_respawns.inc(outcome="failed")
                logger.warning(
                    "replica %d respawn attempt %d failed: %s",
                    slot.rid,
                    attempts,
                    e,
                )
                try:
                    handle.kill()
                except Exception:  # noqa: BLE001 - best-effort cleanup
                    pass
                with slot._lock:
                    slot.state = DRAINING
                    slot.spawn_failures += 1
                self._set_state_gauge(slot.rid, STARTING, DRAINING)
                time.sleep(self.respawn_backoff_s * attempts)
                continue
            # install-vs-close ordering: close() flips _closed BEFORE
            # sweeping the seats, so checking it inside the seat lock
            # means either we see closed (no install) or close()'s
            # sweep runs after us and collects THIS handle — a fresh
            # replica can never leak past close() either way
            with slot._lock:
                installed = not self.closed
                if installed:
                    slot.handle = handle
                    slot.state = READY
                    slot.spawn_failures = 0
            if not installed:
                handle.kill()
                return
            self._set_state_gauge(slot.rid, STARTING, READY)
            self._m_respawns.inc(outcome="ok")
            listener = self.listener
            if listener is not None:
                # the new engine is COLD: affinity/load learned about
                # the old one is stale
                listener.replica_reset(slot.rid)
            flightrec.note(
                "replica_respawn", replica=slot.rid, generation=gen,
                reason=reason,
            )
            flightrec.dump_now(f"replica_respawn:{slot.rid}")
            logger.info(
                "replica %d respawned (generation %d)", slot.rid, gen
            )
            return
        self._mark_dead(slot, "fleet closed during respawn")

    def _mark_dead(self, slot: _ReplicaSlot, reason: str) -> None:
        with slot._lock:
            old = slot.state
            if old == DEAD:
                return
            slot.state = DEAD
            slot.last_reason = reason
        self._set_state_gauge(slot.rid, old, DEAD)
        flightrec.note("replica_dead", replica=slot.rid, reason=reason)
        logger.error("replica %d is DEAD: %s", slot.rid, reason)

    # -- rollout seat holds (serving/rollout.py drives these) ----------

    def hold_seat(self, rid: int, reason: str = "rollout") -> None:
        """Flip a READY seat to DRAINING **without** scheduling a
        respawn — the caller (a rollout controller) owns the seat until
        :meth:`release_seat` or :meth:`force_respawn`. The router stops
        placing new load the moment the state flips; in-flight requests
        keep running on the handle (drain by polling
        ``handle.unresolved()``)."""
        slot = self._slots[int(rid)]
        with slot._lock:
            if slot.state != READY:
                raise RuntimeError(
                    f"replica {rid} is {slot.state}, not ready"
                )
            slot.state = DRAINING
            slot.hold = True
            slot.last_reason = reason
            gen = slot.generation
        self._set_state_gauge(slot.rid, READY, DRAINING)
        flightrec.note(
            "replica_drain", replica=slot.rid, reason=reason,
            generation=gen, hold=True,
        )

    def release_seat(self, rid: int) -> None:
        """Return a held seat to the routable set — the rejoin gate.
        Callers verify readiness FIRST (the rollout controller gates on
        the replica's own ``/readyz``-equivalent health); a fresh clean
        verdict is installed so a stale cached probe cannot shadow-fail
        the rejoined seat until the next round."""
        slot = self._slots[int(rid)]
        with slot._lock:
            if not slot.hold:
                raise RuntimeError(f"replica {rid} is not held")
            slot.hold = False
            if self.closed:
                return  # close() already swept the seat
            slot.state = READY
            slot.misses = 0
            slot.last_health = {"live": True, "ready": True}
        self._set_state_gauge(slot.rid, DRAINING, READY)

    def force_respawn(self, rid: int, reason: str) -> None:
        """Last-resort seat recovery for a holder whose restore failed
        (e.g. rollback could not re-install the prior weights): clear
        the hold and run the ordinary respawn path — a FRESH replica
        from the factory/spawn argv, serving its boot weights."""
        slot = self._slots[int(rid)]
        with slot._lock:
            slot.hold = False
            if slot.state == DEAD:
                return
            old = slot.state if slot.state != DRAINING else None
            slot.state = DRAINING
            slot.last_reason = reason
        if old is not None:
            self._set_state_gauge(slot.rid, old, DRAINING)
        flightrec.note("replica_drain", replica=slot.rid, reason=reason)
        threading.Thread(
            target=self._respawn_seat,
            args=(slot, reason),
            daemon=True,
            name=f"fleet-respawn-{slot.rid}",
        ).start()

    # -- drain / shutdown ----------------------------------------------

    def begin_drain(self) -> None:
        """Full-fleet drain: the router sheds every new request with
        503 (``FleetUnavailable``) while accepted work runs out —
        the rolling-restart front half."""
        with self._lock:
            self._draining = True
        flightrec.note("fleet_drain")

    def close(self, drain: bool = False, timeout: float = 60.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._draining = True
        self._stop.set()
        handles = []
        for slot in self._slots.values():
            with slot._lock:
                old = slot.state
                slot.state = DRAINING
                handles.append((slot.rid, old, slot.handle))
        for rid, old, h in handles:
            self._set_state_gauge(rid, old, DRAINING)
            try:
                h.terminate(drain=drain, timeout=timeout)
            except Exception:  # noqa: BLE001 - teardown is best-effort
                logger.exception("replica %s teardown failed", rid)
        if self._probe_thread is not None and self._probe_thread.is_alive():
            self._probe_thread.join(timeout=self.probe_interval + 5.0)
        # cache tier teardown AFTER the replicas: their engines' close
        # paths may still flush L2 offers, all of which tolerate a dead
        # service anyway
        with self._cache_lock:
            proc, self._cache_proc = self._cache_proc, None
        if proc is not None and proc.poll() is None:
            proc.kill()
            try:
                proc.wait(timeout=5.0)
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass
        if self._cache_admin is not None:
            try:
                self._cache_admin.close()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass
