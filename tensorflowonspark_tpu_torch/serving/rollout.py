"""Zero-downtime weight rollout: health-gated rolling hot-swap with
automatic rollback across the serving fleet (port of
:mod:`tensorflowonspark_tpu.serving.rollout`, same names and contract).

Training publishes a checkpoint, live engines pick it up without
restarting or dropping a request. Three layers:

- **Publication channel** — a directory holding an atomically-written
  ``LATEST`` pointer (tmp + ``os.replace``, body CRC) naming a committed
  checkpoint directory plus a version label. :func:`read_latest` REJECTS
  torn pointers (bad JSON / CRC mismatch) and partial or in-progress
  checkpoints (``compute.checkpoint.checkpoint_complete``, which reads
  both orbax's tmp-name marker and ``_CHECKPOINT_METADATA``). In-process
  sources (tests, a co-located trainer) skip the filesystem via
  :meth:`RolloutController.publish`. The pointer's bytes are the JAX
  package's: either package reads the other's ``LATEST``.

- **Rolling hot-swap** — :class:`RolloutController` rolls a new version
  across the fleet **one replica at a time under router health**: hold
  the seat (READY→DRAINING, no new load, no respawn), wait for in-flight
  quiescence, swap the weights between decode blocks
  (``ContinuousBatcher.swap_weights`` for in-process replicas;
  ``SubprocessReplica.reload`` → the child's authenticated
  ``/admin/reload`` otherwise), run a bounded warm-up probe, then gate
  rejoin on the replica's own readiness before touching the next seat.
  The fleet serves MIXED versions mid-rollout by design: every
  completion is stamped with the weights version it resolved under,
  per-replica versions ride the ``fleet_weights_version`` gauge, and the
  router's affinity entries for a swapped replica are dropped
  (``replica_reset``) together with the engine's own prefix cache.

- **Automatic rollback** — a failed checkpoint load, a
  :class:`~tensorflowonspark_tpu_torch.serving.engine.WeightsIncompatible`
  name/shape mismatch, a failed warm-up probe, or a health regression
  after the swap rolls every already-swapped replica back to its
  **retained per-seat prior** (for in-process seats the tensors the seat
  served; for subprocess seats the previously applied published path, or
  a respawn back to the boot checkpoint when none exists). Every rollout
  ends ``completed`` or ``rolled_back`` (or ``failed`` before any seat
  was touched), never a mixed wedge. A replica respawned MID-rollout
  re-syncs to the fleet's current target through
  ``ServingFleet.rollout_hook`` before it becomes routable.

Where torch differs from JAX, three rules keep the reference's contract:

1. **The loader never writes the live weights.** :func:`checkpoint_loader`
   restores into fresh host tensors (``compute.checkpoint`` restores in
   place when given a target), checks names and shapes against the
   running set and casts floating leaves once to its dtypes (an fp32
   trainer checkpoint serves on a bf16 engine).
2. **A published payload is a snapshot.** The port's optimizer updates
   params in place, so :class:`WeightsUpdate` copies any in-process
   ``params`` when it is built (cast to the engine's dtype by
   :meth:`RolloutController.publish`); a respawned seat re-synced later
   gets exactly the published weights.
3. **The retained prior is the seat's own tensors, by reference.** It
   stays valid because ``swap_weights`` installs newly copied tensors and
   never writes the ones it replaces.

Failpoints: ``rollout.publish`` (channel write; "drop" = lost
publication — bounded staleness, never corruption), ``rollout.swap``
(before each seat), ``rollout.verify`` (post-swap verification; a raise =
health regression → rollback).

Obs: ``fleet_weights_version{replica}`` gauge (value = the version's
monotonic ordinal), ``rollout_swap_seconds`` histogram,
``rollout_total{outcome=completed|rolled_back|failed}`` counter;
flightrec ``rollout_begin`` / ``replica_swap`` / ``rollout_rollback``
(dumped on rollback) / ``rollout_complete``.

Not ported yet: LoRA adapter-only updates (``kind='lora'``,
:func:`lora_state`) raise ``NotImplementedError`` naming ROADMAP A10.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import zlib

import numpy as np
import torch

from tensorflowonspark_tpu_torch.cluster import wire
from tensorflowonspark_tpu_torch.obs import flightrec, reqtrace
from tensorflowonspark_tpu_torch.obs import registry as obs_registry
from tensorflowonspark_tpu_torch.serving.engine import WeightsIncompatible
from tensorflowonspark_tpu_torch.serving.fleet import READY
from tensorflowonspark_tpu_torch.utils.failpoints import failpoint

logger = logging.getLogger(__name__)

__all__ = [
    "MANIFEST_NAME",
    "RolloutController",
    "WeightsUpdate",
    "checkpoint_loader",
    "lora_state",
    "publish_checkpoint",
    "publish_params",
    "read_latest",
]

MANIFEST_NAME = "LATEST"
_LORA = "LoRA adapter updates (kind='lora') are not ported yet: ROADMAP A10"


class _ByReference:
    """A weight set handed to :class:`WeightsUpdate` without a copy: only
    for tensors nobody writes (a seat's retained prior, a snapshot taken
    by :meth:`RolloutController.publish`)."""

    def __init__(self, params):
        self.params = params


def _snapshot(tree, dtype):
    """A copy of ``tree`` that no later write to the caller's tensors
    reaches: tensors (and numpy arrays) are copied, floating ones cast to
    ``dtype`` in the same copy; containers are rebuilt, other leaves
    kept."""
    if isinstance(tree, np.ndarray):
        t = torch.tensor(tree)  # a copy of its own
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if dtype is not None and t.is_floating_point():
            return t.to(dtype=dtype, copy=True)
        return t.clone()
    if isinstance(tree, dict):
        return {k: _snapshot(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v, dtype) for v in tree)
    return tree


@dataclasses.dataclass(frozen=True)
class WeightsUpdate:
    """One publishable weights version. ``params`` is the in-process
    payload (a name -> tensor dict in the layout of ``models.convert``);
    it never crosses a process boundary and is SNAPSHOTTED here: the
    update owns a copy (:meth:`RolloutController.publish` hands it one
    already cast to the engines' dtype). ``path`` names a committed
    checkpoint directory that subprocess replicas (and path-only
    in-process loaders) read."""

    version: str
    kind: str = "full"  # 'full' ('lora' is not ported: ROADMAP A10)
    path: str | None = None
    step: int | None = None
    params: object = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.kind == "lora":
            raise NotImplementedError(_LORA)
        if self.kind != "full":
            raise ValueError(f"kind must be 'full' or 'lora', got {self.kind!r}")
        if self.params is None and self.path is None:
            raise ValueError(
                "a WeightsUpdate needs params= (in-process) and/or path= (a published "
                "checkpoint directory)"
            )
        if isinstance(self.params, _ByReference):
            object.__setattr__(self, "params", self.params.params)
        elif self.params is not None:
            object.__setattr__(self, "params", _snapshot(self.params, None))


def _retained(version, params) -> WeightsUpdate:
    """A seat's live weights as an update, by reference (see rule 3 of the
    module docstring)."""
    return WeightsUpdate(version=str(version), params=_ByReference(params))


# ---------------------------------------------------------------------------
# the publication channel
# ---------------------------------------------------------------------------


def _manifest_body(manifest: dict) -> bytes:
    return json.dumps(manifest, sort_keys=True).encode("utf-8")


def publish_checkpoint(channel_dir: str, *, version: str, path: str, kind: str = "full",
                       step: int | None = None) -> dict:
    """Atomically point the channel's ``LATEST`` at a committed checkpoint
    directory. Write order is tmp + ``os.replace`` so a reader never sees a
    torn pointer on posix; the body additionally carries its own CRC so a
    reader on a filesystem without rename atomicity (or a partially copied
    channel) still rejects torn content. Publish AFTER the checkpoint
    itself is fully written (``CheckpointManager.wait()`` for async saves)
    — :func:`read_latest` independently refuses incomplete checkpoint
    directories."""
    if kind == "lora":
        raise NotImplementedError(_LORA)
    manifest = wire.encode(
        "rollout.manifest",
        version=str(version),
        kind=str(kind),
        path=os.path.abspath(path) if "://" not in path else path,
        step=None if step is None else int(step),
    )
    if failpoint("rollout.publish") == "drop":
        # a LOST publication: watchers keep serving the prior version
        # until the next publish — staleness, never corruption
        logger.warning("rollout.publish dropped (failpoint): %s not published",
                       manifest["version"])
        return manifest
    body = _manifest_body(manifest)
    record = json.dumps(wire.encode("rollout.latest", crc=zlib.crc32(body), manifest=manifest))
    os.makedirs(channel_dir, exist_ok=True)
    tmp = os.path.join(channel_dir, f".{MANIFEST_NAME}.tmp.{os.getpid()}")
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(record + "\n")
    os.replace(tmp, os.path.join(channel_dir, MANIFEST_NAME))
    return manifest


def publish_params(channel_dir: str, params, *, version: str, kind: str = "full",
                   step: int | None = None) -> WeightsUpdate:
    """Write ``params`` (name -> tensor) as a checkpoint under the channel
    through ``compute.checkpoint.save_checkpoint`` and publish the pointer
    — the one-call path for a trainer (or a test harness) shipping a
    version to a fleet whose replicas live in other processes. The
    returned update carries a snapshot of ``params`` for in-process
    seats."""
    from tensorflowonspark_tpu_torch.compute.checkpoint import save_checkpoint

    if kind == "lora":
        raise NotImplementedError(_LORA)
    path = os.path.join(channel_dir, "versions", str(version))
    save_checkpoint(path, params)
    publish_checkpoint(channel_dir, version=version, path=path, kind=kind, step=step)
    return WeightsUpdate(version=str(version), kind=kind, path=path, step=step, params=params)


def read_latest(channel_dir: str) -> WeightsUpdate | None:
    """The channel's current publication, or ``None`` when there is nothing
    VALID to serve: no pointer yet, a torn/corrupt pointer (bad JSON, CRC
    mismatch, missing fields), or a pointer naming a missing/incomplete
    checkpoint directory. Rejection is silent by design — the watcher
    polls; a torn write is mid-publish, not an incident. A LoRA pointer
    raises ``NotImplementedError`` (ROADMAP A10)."""
    try:
        with open(os.path.join(channel_dir, MANIFEST_NAME), encoding="utf-8") as f:
            raw = f.read()
    except OSError:
        return None
    try:
        doc = wire.decode("rollout.latest", json.loads(raw))
        # CRC over the manifest AS WRITTEN (extras included) — a newer
        # add-only publisher's pointer still verifies on this reader
        raw_manifest = doc["manifest"]
        if int(doc["crc"]) != zlib.crc32(_manifest_body(raw_manifest)):
            logger.warning("rollout channel %s: LATEST pointer CRC mismatch (torn write) — "
                           "ignored", channel_dir)
            return None
        manifest = wire.decode("rollout.manifest", raw_manifest)
        version = str(manifest["version"])
        kind = str(manifest.get("kind") or "full")
        path = manifest.get("path")
        step = manifest.get("step")
    except (ValueError, KeyError, TypeError):
        logger.warning("rollout channel %s: unparsable LATEST pointer — ignored", channel_dir)
        return None
    if kind not in ("full", "lora") or not path:
        return None
    from tensorflowonspark_tpu_torch.compute.checkpoint import checkpoint_complete

    if not checkpoint_complete(path):
        logger.warning("rollout channel %s: %s points at an incomplete checkpoint %s — ignored",
                       channel_dir, version, path)
        return None
    return WeightsUpdate(version=version, kind=kind, path=path,
                         step=None if step is None else int(step))


# ---------------------------------------------------------------------------
# payload helpers
# ---------------------------------------------------------------------------


def lora_state(params):
    """The adapter-only update payload of a LoRA-ified tree: not ported
    yet (the port has no LoRA banks), ROADMAP A10."""
    raise NotImplementedError(_LORA)


def checkpoint_loader(target_params: dict):
    """Loader for path-published updates applied to IN-PROCESS replicas.

    ``target_params`` is the running weight set (name -> tensor). The
    checkpoint is restored into FRESH host tensors — never into
    ``target_params``, which may be serving, or be the prior a rollback
    re-installs — from a ``CheckpointManager`` step directory or a bare
    ``save_checkpoint`` root, through a ``TrainState``, ``{'state': ...}``
    or ``{'params': ...}`` wrapper. Every name and shape must match the
    running set's (else :class:`WeightsIncompatible`, as for a tree that
    is not a Llama's); floating leaves are cast once to the running
    leaf's dtype. IO and format errors (a truncated file) propagate as
    they are: the controller rolls back on either."""

    def load(update: WeightsUpdate) -> dict:
        from tensorflowonspark_tpu_torch.compute.checkpoint import restore_checkpoint
        from tensorflowonspark_tpu_torch.tools.generate_text import llama_params_of

        if update.kind == "lora":
            raise NotImplementedError(_LORA)
        tree = restore_checkpoint(update.path)  # no target: host tensors of its own
        try:
            tree = llama_params_of(tree, update.path)
        except ValueError as e:
            raise WeightsIncompatible(f"published checkpoint {update.version!r}: {e}") from e
        if set(tree) != set(target_params):
            missing = sorted(set(target_params) - set(tree))
            extra = sorted(set(tree) - set(target_params))
            raise WeightsIncompatible(
                f"published checkpoint {update.version!r} does not fit the running weights: "
                f"missing {missing[:5]}, unknown {extra[:5]}"
            )
        out = {}
        for name, want in target_params.items():
            got = tree[name]
            if tuple(got.shape) != tuple(want.shape):
                raise WeightsIncompatible(
                    f"published checkpoint {update.version!r}: {name} has shape "
                    f"{tuple(got.shape)}, the running weights {tuple(want.shape)}"
                )
            out[name] = got.to(want.dtype) if got.is_floating_point() else got
        return out

    return load


# ---------------------------------------------------------------------------
# the rollout controller
# ---------------------------------------------------------------------------


class _SeatFailure(Exception):
    """Internal: one seat's swap failed. ``held`` = the seat is still held
    in DRAINING; ``swapped`` = the new weights may already be installed on
    it (restore required, not just release); ``prior`` = the retained
    prior captured under the hold (None when the seat was never held)."""

    def __init__(self, rid, stage, cause, held, swapped, prior=None):
        super().__init__(f"replica {rid} {stage}: {cause!r}")
        self.rid = rid
        self.stage = stage
        self.cause = cause
        self.held = held
        self.swapped = swapped
        self.prior = prior


class RolloutController:
    """Rolls published weight versions across a serving target.

    ``target`` is a :class:`~tensorflowonspark_tpu_torch.serving.fleet.ServingFleet`
    (one replica at a time under router health) or a bare
    :class:`~tensorflowonspark_tpu_torch.serving.engine.ContinuousBatcher`
    (single-engine ``serve_model``: swap in place between decode blocks,
    verify, roll back on failure).

    One rollout runs at a time (``_roll_lock``); :meth:`publish` and the
    channel watcher both funnel through :meth:`roll`.

    ``loader`` turns a path-published update into an in-process params
    payload (see :func:`checkpoint_loader`); subprocess replicas load their
    own path via ``/admin/reload`` and never need it.
    """

    def __init__(self, target, *, channel_dir: str | None = None, loader=None,
                 poll_interval: float = 2.0, drain_timeout: float = 60.0,
                 verify_timeout: float = 120.0, swap_timeout: float = 600.0,
                 warmup_probe: bool = True, registry: obs_registry.Registry | None = None):
        if hasattr(target, "views") and hasattr(target, "hold_seat"):
            self._fleet = target
            self._engine = None
        elif hasattr(target, "swap_weights"):
            self._fleet = None
            self._engine = target
        else:
            raise TypeError(
                "target must be a ServingFleet or an engine with swap_weights(), got "
                f"{type(target).__name__}"
            )
        self._channel_dir = channel_dir
        self._loader = loader
        self._poll_interval = max(0.05, float(poll_interval))
        self._drain_timeout = float(drain_timeout)
        self._verify_timeout = float(verify_timeout)
        self._swap_timeout = float(swap_timeout)
        self._warmup_probe = bool(warmup_probe)

        # one rollout at a time; never nested with self._lock
        self._roll_lock = threading.Lock()
        self._lock = threading.Lock()
        self._applied: dict[int, WeightsUpdate] = {}  # guarded-by: self._lock
        self._target_update: WeightsUpdate | None = None  # guarded-by: self._lock
        self._ords: dict[str, int] = {}  # guarded-by: self._lock
        self._outcomes: dict[str, int] = {}  # guarded-by: self._lock
        # {"type", "error", "stage"} of the most recent failed/rolled-back
        # rollout, None after a completed one — serve_model's
        # /admin/reload maps it onto HTTP status codes
        self._last_error: dict | None = None  # guarded-by: self._lock
        self._last_seen: str | None = None  # watcher thread only
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

        reg = registry
        if reg is None:
            src = self._fleet if self._fleet is not None else self._engine
            reg = getattr(src, "metrics", None)
            if reg is None or not hasattr(reg, "gauge"):
                reg = obs_registry.Registry()
        self.metrics = reg
        self._g_version = reg.gauge(
            "fleet_weights_version",
            "serving weights version per replica (value = the version's monotonic "
            "publication ordinal)",
        )
        self._h_swap = reg.histogram(
            "rollout_swap_seconds",
            "per-replica hot-swap latency (drain wait excluded): load + install + re-warm + "
            "readiness gate",
        )
        self._m_total = reg.counter("rollout_total", "rollouts by outcome")

        if self._fleet is not None:
            self._fleet.rollout_hook = self._on_respawn
            for view in self._fleet.views():
                ver = self._handle_version(view["handle"])
                if ver is not None:
                    self._set_version_gauge(view["rid"], ver)
        else:
            self._set_version_gauge(0, self._engine.weights_version)

    # -- observability -------------------------------------------------

    @staticmethod
    def _handle_version(handle):
        try:
            return handle.health().get("weights_version")
        except Exception:  # noqa: BLE001 - a sick seat has no version
            return None

    def _set_version_gauge(self, rid: int, version: str) -> None:
        with self._lock:
            ordv = self._ords.setdefault(str(version), len(self._ords) + 1)
        self._g_version.set(ordv, replica=str(rid))

    def _record_applied(self, rid: int, update: WeightsUpdate) -> None:
        with self._lock:
            self._applied[rid] = update
            ordv = self._ords.setdefault(update.version, len(self._ords) + 1)
        self._g_version.set(ordv, replica=str(rid))

    def stats(self) -> dict:
        with self._lock:
            return {
                "target_version": (None if self._target_update is None
                                   else self._target_update.version),
                "applied": {str(rid): u.version for rid, u in sorted(self._applied.items())},
                "outcomes": dict(self._outcomes),
                "version_ordinals": dict(self._ords),
                "last_error": self._last_error,
            }

    def _count_outcome(self, outcome: str) -> None:
        self._m_total.inc(outcome=outcome)
        with self._lock:
            self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1

    @property
    def last_error(self) -> dict | None:
        with self._lock:
            return None if self._last_error is None else dict(self._last_error)

    def _note_error(self, cause: BaseException | None, stage: str) -> None:
        with self._lock:
            if cause is None:
                self._last_error = None
            else:
                self._last_error = {"type": type(cause).__name__, "error": str(cause),
                                    "stage": stage}

    # -- public API ----------------------------------------------------

    def publish(self, params=None, *, version: str, kind: str = "full", path: str | None = None,
                step: int | None = None) -> str:
        """In-process publication: roll ``params`` (and/or a published
        ``path`` for subprocess seats) across the target NOW, synchronously.
        ``params`` is snapshotted here, cast to the serving engines' dtype:
        the caller may go on writing its tensors (a trainer's next step),
        and a seat re-synced after a respawn still gets these weights.
        Returns the rollout outcome (``completed`` / ``rolled_back`` /
        ``failed``)."""
        if params is not None:
            params = _ByReference(_snapshot(params, self._serving_dtype()))
        return self.roll(WeightsUpdate(version=str(version), kind=kind, path=path, step=step,
                                       params=params))

    def _serving_dtype(self) -> torch.dtype | None:
        """The floating dtype of the weights an in-process engine of the
        target serves (None when no seat runs in this process)."""
        if self._fleet is None:
            engines = [self._engine]
        else:
            engines = [getattr(v["handle"], "engine", None) for v in self._fleet.views()]
        for eng in engines:
            if eng is None or not hasattr(eng, "current_weights"):
                continue
            params = eng.current_weights()[1]
            for t in params.values() if isinstance(params, dict) else ():
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    return t.dtype
        return None

    def roll(self, update: WeightsUpdate) -> str:
        with self._roll_lock:
            return self._roll(update)

    def start(self) -> None:
        """Watch the publication channel; each NEW valid version rolls out on
        the watcher thread. A version that fails to roll is not retried
        until a different version (or a re-publish under a new label)
        appears — retry loops on a poisoned checkpoint would drain/re-warm
        the fleet forever."""
        if self._channel_dir is None:
            raise ValueError("start() requires channel_dir=")
        if self._thread is not None:
            return
        # restartable: a prior stop() left the event set and the respawn
        # hook deregistered
        self._stop.clear()
        if self._fleet is not None and self._fleet.rollout_hook is None:
            self._fleet.rollout_hook = self._on_respawn
        # seed with the channel's current content: the fleet just booted
        # from the newest checkpoint lineage; re-rolling the same bytes at
        # startup would churn every replica for nothing
        cur = read_latest(self._channel_dir)
        self._last_seen = None if cur is None else cur.version
        self._thread = threading.Thread(target=self._watch_loop, daemon=True,
                                        name="rollout-watch")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._poll_interval + 5.0)
            self._thread = None
        if self._fleet is not None and self._fleet.rollout_hook == self._on_respawn:
            self._fleet.rollout_hook = None

    def _watch_loop(self) -> None:
        while not self._stop.wait(self._poll_interval):
            try:
                upd = read_latest(self._channel_dir)
            except Exception:  # noqa: BLE001 - keep watching
                logger.exception("rollout channel read failed")
                continue
            if upd is None or upd.version == self._last_seen:
                continue
            self._last_seen = upd.version
            try:
                outcome = self.roll(upd)
                logger.info("rollout of %r: %s", upd.version, outcome)
            except Exception:  # noqa: BLE001 - keep watching
                logger.exception("rollout of %r crashed", upd.version)

    # -- the rolling swap ----------------------------------------------

    def _roll(self, update: WeightsUpdate) -> str:
        flightrec.note("rollout_begin", version=update.version, swap_kind=update.kind)
        logger.info("rollout begin: version=%r kind=%s", update.version, update.kind)
        if self._fleet is None:
            return self._roll_single(update)
        seats = sorted((v for v in self._fleet.views() if v["state"] == READY),
                       key=lambda v: v["rid"])
        if not seats:
            logger.error("rollout failed: no ready replica")
            self._note_error(RuntimeError("no ready replica"), "place")
            self._count_outcome("failed")
            return "failed"
        if update.path is None and any(self._seat_needs_path(v["handle"]) for v in seats):
            # a pure configuration error: fail BEFORE any seat is held or
            # drained (half a fleet must not go through the rollback/respawn
            # machinery for an update that could never reach its children)
            err = WeightsIncompatible(
                "params-only update cannot reach subprocess replicas — publish it to disk "
                "(publish_params/publish_checkpoint) so the children can load a path"
            )
            logger.error("rollout of %r failed: %s", update.version, err)
            self._note_error(err, "place")
            self._count_outcome("failed")
            return "failed"
        swapped: list[tuple[int, WeightsUpdate | None]] = []
        skipped: list[int] = []
        failure: _SeatFailure | None = None
        for view in seats:
            rid = view["rid"]
            try:
                failpoint("rollout.swap")
                prior = self._swap_seat(rid, update)
            except _SeatFailure as f:
                if f.stage == "hold":
                    # the seat left READY under us (probe drain, a SIGKILLed
                    # replica respawning): its supervisor owns it — skip;
                    # the respawn hook (and the straggler sweep below)
                    # re-syncs it. A dead seat must not roll back the
                    # healthy ones.
                    logger.warning("rollout of %r skipping replica %d: %s", update.version,
                                   f.rid, f.cause)
                    skipped.append(f.rid)
                    continue
                failure = f
                break
            except Exception as e:  # noqa: BLE001 - e.g. an armed rollout.swap
                # failpoint before the seat was ever touched
                failure = _SeatFailure(rid, "pre-swap", e, False, False)
                break
            swapped.append((rid, prior))
        if failure is None and not swapped:
            # nothing was actually rolled (every seat skipped away
            # mid-rollout) — a failure, not a completion
            err = RuntimeError(f"no replica could be swapped (skipped: {skipped})")
            logger.error("rollout of %r failed: %s", update.version, err)
            self._note_error(err, "place")
            self._count_outcome("failed")
            return "failed"
        if failure is not None:
            f = failure
            logger.error("rollout of %r failed at replica %d (%s): %r — rolling back %d "
                         "swapped replica(s)", update.version, f.rid, f.stage, f.cause,
                         len(swapped))
            flightrec.note("rollout_rollback", version=update.version, failed_replica=f.rid,
                           stage=f.stage, error=repr(f.cause), swapped=[r for r, _ in swapped])
            # the failed seat first (it may hold half-applied state), then
            # the successfully swapped seats newest-first
            self._restore_seat(f.rid, f.prior, held=f.held, swapped=f.swapped)
            for rid, pr in reversed(swapped):
                self._restore_seat(rid, pr, held=False, swapped=True)
            self._note_error(f.cause, f.stage)
            self._count_outcome("rolled_back")
            flightrec.dump_now(f"rollout_rollback:{update.version}")
            return "rolled_back"
        with self._lock:
            self._target_update = update
        # Convergence pass, ALWAYS: a seat that was skipped — or that was
        # respawning at rollout start and rejoined on its boot weights
        # before _target_update became visible to the respawn hook — is
        # swapped in place here (a no-op sweep when every READY seat
        # already reports the target version).
        self._sync_stragglers(update)
        self._reclaim_l2(update, swapped)
        self._note_error(None, "")
        self._count_outcome("completed")
        flightrec.note("rollout_complete", version=update.version,
                       replicas=[r for r, _ in swapped], skipped=skipped)
        logger.info("rollout of %r completed across %d replica(s)%s", update.version,
                    len(swapped),
                    f" ({len(skipped)} skipped to their respawn path)" if skipped else "")
        return "completed"

    def _reclaim_l2(self, update: WeightsUpdate,
                    swapped: list[tuple[int, WeightsUpdate | None]]) -> None:
        """After a COMPLETED roll, reclaim the replaced versions' prefix
        entries from the fleet L2 — exact by key construction, never a
        flush. Runs only once every seat serves the target; mid-rollout the
        old version's keys are still live on unswapped seats. Best-effort:
        a down cache service means the dead keys age out via LRU (they can
        never be looked up again — the version is in every key)."""
        fleet = self._fleet
        if fleet is None:
            return
        old = {str(pr.version) for _, pr in swapped
               if pr is not None and str(pr.version) != str(update.version)}
        for ver in sorted(old):
            dropped = fleet.invalidate_prefix_version(ver)
            if dropped:
                logger.info("rollout of %r reclaimed %d prefix L2 entrie(s) of prior version "
                            "%r", update.version, dropped, ver)

    def _sync_stragglers(self, update: WeightsUpdate) -> None:
        """Post-completion convergence pass: any READY seat still serving a
        different version (a respawn that rejoined before the target was
        set) is swapped in place. Failures are logged, never rolled back —
        the fleet-wide outcome already stands, and the gauge shows any seat
        left diverged."""
        for view in self._fleet.views():
            if view["state"] != READY:
                continue
            cur = self._handle_version(view["handle"])
            if cur is None or str(cur) == update.version:
                continue
            try:
                self._swap_seat(view["rid"], update)
            except _SeatFailure as f:
                logger.warning("straggler re-sync of replica %d to %r failed (%s): %s — seat "
                               "stays on %r", f.rid, update.version, f.stage, f.cause, cur)
                if f.held and not f.swapped:
                    try:
                        self._fleet.release_seat(f.rid)
                    except Exception:  # noqa: BLE001 - closed race
                        pass
                elif f.swapped:
                    # half-applied straggler: a respawn is the clean recovery
                    # (boot weights, then the hook re-applies the target)
                    try:
                        self._fleet.force_respawn(f.rid, "straggler re-sync failed")
                    except Exception:  # noqa: BLE001 - closed race
                        logger.exception("straggler respawn of replica %d failed", f.rid)

    @staticmethod
    def _seat_needs_path(handle) -> bool:
        """Subprocess-style seats can only consume PATH-published updates
        (the child loads the checkpoint in its own process; in-memory
        params never cross the boundary)."""
        return getattr(handle, "engine", None) is None and not hasattr(handle, "swap_weights")

    def _prior_of(self, view) -> WeightsUpdate | None:
        """The retained per-seat prior a rollback re-installs. For an
        in-process seat: the tensors it serves, by reference (a swap
        installs new tensors and never writes these). For a subprocess
        seat: the last path-published update this controller applied, or
        ``None`` (rollback then respawns to the boot checkpoint, which IS
        the prior version)."""
        eng = getattr(view["handle"], "engine", None)
        if eng is not None and hasattr(eng, "current_weights"):
            return _retained(*eng.current_weights())
        with self._lock:
            return self._applied.get(view["rid"])

    def _swap_seat(self, rid: int, update: WeightsUpdate) -> WeightsUpdate | None:
        """Hold → drain → swap → verify → release ONE seat; returns the
        retained prior (captured under the hold). The hold comes FIRST and
        everything after it works on a FRESH view: a seat that drained and
        respawned between rollout placement and its turn would otherwise be
        swapped through its orphaned old handle."""
        fleet = self._fleet
        try:
            fleet.hold_seat(rid, reason=f"rollout to {update.version}")
        except Exception as e:  # noqa: BLE001 - seat flipped under us
            raise _SeatFailure(rid, "hold", e, False, False) from e
        try:
            view = next(v for v in fleet.views() if v["rid"] == rid)
            handle = view["handle"]
            prior = self._prior_of(view)
            self._await_quiescent(handle)
        except Exception as e:  # noqa: BLE001 - drain timed out
            raise _SeatFailure(rid, "drain", e, True, False) from e
        t0 = time.monotonic()
        try:
            self._apply(handle, update)
        except _SeatFailure as f:
            f.prior = prior
            raise
        except Exception as e:  # noqa: BLE001 - per-seat verdict
            # conservative `swapped`: a subprocess reload may have installed
            # before the child's warm-up probe failed, and an in-process
            # swap_weights TIMEOUT means the scheduler may still install
            # the prepared weights after we gave up — both need the restore
            # path, not a bare release (the mixed wedge)
            swapped_flag = (getattr(handle, "engine", None) is None
                            or isinstance(e, TimeoutError))
            raise _SeatFailure(rid, "swap", e, True, swapped_flag, prior=prior) from e
        try:
            failpoint("rollout.verify")
            self._verify(handle)
        except Exception as e:  # noqa: BLE001 - health regression
            raise _SeatFailure(rid, "verify", e, True, True, prior=prior) from e
        dur = time.monotonic() - t0
        self._h_swap.observe(dur)
        fleet.release_seat(rid)
        listener = fleet.listener
        if listener is not None:
            # the swapped engine's prefix cache was cleared; the router's
            # affinity entries describe the OLD weights
            listener.replica_reset(rid)
        self._record_applied(rid, update)
        flightrec.note("replica_swap", replica=rid, version=update.version,
                       swap_kind=update.kind, seconds=round(dur, 3),
                       generation=view["generation"])
        # every request in flight DURING the swap gets the rollout on its
        # own timeline
        reqtrace.mark("rollout.replica_swap", replica=rid, version=update.version)
        logger.info("replica %d -> %r in %.2fs", rid, update.version, dur)
        return prior

    def _restore_seat(self, rid: int, prior: WeightsUpdate | None, *, held: bool,
                      swapped: bool) -> bool:
        """Bring one seat back to its retained prior after a failed rollout.
        Escalates to a full respawn (boot weights — the prior lineage) when
        the restore itself fails or no prior is retained."""
        fleet = self._fleet
        if not swapped:
            # weights never changed on this seat: just un-hold it
            if held:
                try:
                    fleet.release_seat(rid)
                except Exception:  # noqa: BLE001 - closed mid-rollback
                    logger.exception("rollback: releasing replica %d failed", rid)
                    return False
            return True
        try:
            view = next(v for v in fleet.views() if v["rid"] == rid)
            if not held:
                if view["state"] != READY:
                    # the seat changed hands (probe drain/respawn) — its
                    # supervisor owns it now, and the respawn hook re-syncs
                    # it to the pre-roll target
                    return True
                fleet.hold_seat(rid, reason="rollout rollback")
                self._await_quiescent(view["handle"])
            if prior is None:
                raise RuntimeError("no retained prior for this seat (boot version lives in "
                                   "the spawn argv) — respawning")
            self._apply(view["handle"], prior)
            self._verify(view["handle"])
            fleet.release_seat(rid)
            listener = fleet.listener
            if listener is not None:
                listener.replica_reset(rid)
            self._record_applied(rid, prior)
            logger.info("rollback: replica %d restored to %r", rid, prior.version)
            return True
        except Exception:  # noqa: BLE001 - escalate to respawn
            logger.exception("rollback: restoring replica %d failed — respawning to boot "
                             "weights", rid)
            try:
                fleet.force_respawn(rid, "rollout rollback failed")
            except Exception:  # noqa: BLE001 - teardown race
                logger.exception("rollback: respawn of replica %d failed", rid)
            return False

    # -- seat plumbing -------------------------------------------------

    def _await_quiescent(self, handle) -> None:
        deadline = time.monotonic() + self._drain_timeout
        while handle.unresolved() > 0:
            if time.monotonic() > deadline:
                raise TimeoutError(f"seat did not quiesce within {self._drain_timeout}s "
                                   f"(unresolved={handle.unresolved()})")
            time.sleep(0.05)

    def _resolve_params(self, update: WeightsUpdate):
        if update.params is not None:
            return update.params
        if self._loader is None:
            raise RuntimeError("path-published update needs loader= for in-process replicas "
                               "(see rollout.checkpoint_loader)")
        return self._loader(update)

    def _apply(self, handle, update: WeightsUpdate) -> None:
        """Install ``update`` on one replica handle (or bare engine),
        including the warm-up probe. Raises :class:`_SeatFailure` with
        ``swapped`` set precisely for in-process seats (an install that
        never happened must not trigger a restore)."""
        eng = getattr(handle, "engine", None)
        if eng is None and hasattr(handle, "swap_weights"):
            eng = handle  # bare engine target
        if eng is not None:
            params = self._resolve_params(update)  # not yet swapped
            eng.swap_weights(params, version=update.version, kind=update.kind,
                             timeout=self._swap_timeout)
            if self._warmup_probe:
                try:
                    # one throwaway decode proves the new weights actually
                    # run; BOUNDED like every other stage: a decode that
                    # hangs under the new weights must become a rollback,
                    # not a forever-held seat and a wedged _roll_lock
                    eng.submit([0], 2, eos_id=-1, deadline_s=self._verify_timeout)
                except Exception as e:
                    raise _SeatFailure(getattr(handle, "rid", 0), "warmup", e, True,
                                       True) from e
            return
        if update.path is None:
            raise WeightsIncompatible(
                "subprocess replicas need a path-published update (use publish_params/"
                "publish_checkpoint so the child can load it)"
            )
        handle.reload(version=update.version, kind=update.kind, path=update.path,
                      step=update.step, timeout=self._swap_timeout)

    def _verify(self, handle) -> None:
        """The rejoin gate: the replica's OWN readiness (its ``/readyz``
        equivalent), bounded. A replica that cannot verify does not rejoin
        — it rolls back."""
        deadline = time.monotonic() + self._verify_timeout
        while True:
            h = handle.health()
            if h.get("ready"):
                return
            if not h.get("live", True):
                raise RuntimeError("replica died during post-swap verification")
            if time.monotonic() > deadline:
                raise TimeoutError(f"replica not ready within {self._verify_timeout}s after swap")
            time.sleep(0.05)

    # -- single-engine target ------------------------------------------

    def _roll_single(self, update: WeightsUpdate) -> str:
        eng = self._engine
        prior = _retained(*eng.current_weights())
        t0 = time.monotonic()
        swapped = False
        try:
            failpoint("rollout.swap")
            self._apply(eng, update)
            swapped = True
            failpoint("rollout.verify")
            self._verify(eng)
        except Exception as e:  # noqa: BLE001 - roll back in place
            if isinstance(e, _SeatFailure):
                cause = e.cause
                # _apply's warm-up probe fails AFTER the install
                swapped = swapped or e.swapped
            else:
                cause = e
            logger.error("single-engine rollout of %r failed: %r — rolling back to %r",
                         update.version, cause, prior.version)
            flightrec.note("rollout_rollback", version=update.version, failed_replica=0,
                           stage="swap", error=repr(cause), swapped=[0] if swapped else [])
            if swapped:
                try:
                    eng.swap_weights(prior.params, version=prior.version, kind="full",
                                     timeout=self._swap_timeout)
                except Exception:  # noqa: BLE001 - keep the engine's word
                    logger.exception("single-engine rollback failed; engine may be serving a "
                                     "partially verified version")
            # not swapped: the engine was never touched (load failure /
            # WeightsIncompatible) — re-installing the prior would only
            # drain the pipeline window and flush the warm prefix cache
            self._note_error(cause, "swap")
            self._count_outcome("rolled_back")
            flightrec.dump_now(f"rollout_rollback:{update.version}")
            return "rolled_back"
        self._h_swap.observe(time.monotonic() - t0)
        self._record_applied(0, update)
        with self._lock:
            self._target_update = update
        if str(prior.version) != str(update.version):
            # same reclamation contract as the fleet path — the engine's own
            # L2 facade, when one is attached
            l2 = getattr(eng, "_prefix_l2", None)
            if l2 is not None:
                l2.invalidate_version(prior.version)
        self._note_error(None, "")
        self._count_outcome("completed")
        flightrec.note("replica_swap", replica=0, version=update.version, swap_kind=update.kind)
        reqtrace.mark("rollout.replica_swap", replica=0, version=update.version)
        flightrec.note("rollout_complete", version=update.version)
        return "completed"

    # -- respawn re-sync (ServingFleet.rollout_hook) -------------------

    def _on_respawn(self, rid: int, handle) -> None:
        """A seat respawned (SIGKILL chaos, watchdog wedge) while this
        controller owns the fleet's target version: bring the fresh replica
        — booted on the original checkpoint — to the current target BEFORE
        it becomes routable. Runs on the fleet's respawn thread; failures
        are logged by the fleet and the seat rejoins on its boot weights
        (the gauge shows the divergence)."""
        with self._lock:
            target = self._target_update
        if target is None:
            return
        cur = self._handle_version(handle)
        if cur is not None and str(cur) == target.version:
            return
        self._apply(handle, target)
        self._verify(handle)
        self._record_applied(rid, target)
        logger.info("respawned replica %d re-synced to %r", rid, target.version)
