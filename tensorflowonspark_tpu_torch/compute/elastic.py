"""Elastic training: survive a membership change mid-run — reshard, don't
restart (port of :mod:`tensorflowonspark_tpu.compute.elastic`).

When membership changes, the surviving processes *reconfigure*:

1. the driver bumps a monotonic **membership epoch** and publishes the new
   roster (``cluster/reservation.py``); every node learns of it within one
   heartbeat (the beat reply piggybacks the epoch);
2. survivors copy their state to an **in-memory host snapshot**
   (:func:`host_snapshot`), rebind ``torch.distributed`` to the new
   topology (``TFNodeContext.reinitialize_distributed``), re-form the mesh
   (:func:`fit_axis_shapes <tensorflowonspark_tpu_torch.compute.mesh.fit_axis_shapes>`
   + ``make_mesh``), and commit params + optimizer state onto the new
   placements (:func:`reshard_state`) — byte-identical values, new
   placement;
3. a **joining** node hydrates its state from a peer's published in-memory
   snapshot (:meth:`ElasticTrainer.hydrate`), falling back to the latest
   checkpoint only when in-memory recovery is impossible — the checkpoint
   is the fallback, not the recovery path.

Every decision is failpoint-injectable (``elastic.epoch_bump``,
``elastic.reshard_gather``, ``elastic.rejoin_init``) and recorded as obs
events + flight-recorder entries: ``cluster_membership_epoch`` (gauge),
``elastic_reshard_seconds`` (histogram), ``elastic_recoveries_total{outcome=}``
(counter).

Changes from the JAX package, where JAX arrays become torch tensors:

- A snapshot's leaves are CPU tensors of the state's own dtypes (bf16
  moments have no numpy dtype). A DTensor is copied locally when every
  placement is ``Replicate`` or its mesh has one rank; a leaf sharded over
  more ranks raises :class:`InMemoryRecoveryUnavailable` before any
  collective (a gather with a dead peer in the group would hang) — the
  counterpart of a JAX array that is not fully addressable.
- A placement is a ``compute.layout.Sharding`` (the leaf becomes a DTensor
  through ``compute.train.place``) or a ``torch.device`` (a plain tensor
  there: what a mesh of one device holds). A placement given for a
  subtree applies to each of its tensors.
- The mesh spans ranks, one device each: ``devices_fn(roster)`` returns the
  rank count to fit (or a list of that length). Multi-controller nodes use
  the world size after the rebind; a single-controller node is a world of
  one on its own device.
- The checkpoint fallback restores into host tensors shaped like the state
  (``checkpoint.hydration_restore``), never into the live state, whose
  mesh may belong to the group that was just destroyed.
- The snapshot a reconfigure publishes is labelled with the step the loop
  last handed to :meth:`ElasticTrainer.publish`, published or not. The JAX
  package labels it with the last step it *published*, which with
  ``publish_steps > 1`` is older than the state: a joiner would replay
  steps the state already holds.
- A single-controller node is a world of one on its own device, and its
  default placement is that device: its state stays plain tensors there.
  The JAX package places it on a mesh of the node's local devices; on
  one rank a DTensor holds the same values and only adds dispatch cost.
- A reconfigure publishes the host snapshot it resharded from (the
  placed state holds the same bytes); the JAX package copies the state
  to the host a second time.

The driver-side half lives in ``TFCluster.supervise()`` (elastic mode):
instead of raising on a dead node, it removes the node, bumps the epoch,
and keeps supervising the survivors.
"""

from __future__ import annotations

import dataclasses
import logging
import pickle
import threading
import time
from typing import Any, Callable, Mapping

import torch

from tensorflowonspark_tpu_torch.cluster import wire
from tensorflowonspark_tpu_torch.obs import flightrec
from tensorflowonspark_tpu_torch.obs import spans as obs_spans
from tensorflowonspark_tpu_torch.obs.registry import default_registry
from tensorflowonspark_tpu_torch.utils.failpoints import failpoint

logger = logging.getLogger(__name__)

__all__ = [
    "ElasticTrainer",
    "InMemoryRecoveryUnavailable",
    "MembershipWatcher",
    "current_epoch",
    "host_snapshot",
    "membership",
    "notify_membership",
    "reshard_state",
    "wait_for_epoch",
]

# Default manager-KV key a survivor publishes its host snapshot under
# (what a joiner's peer hydration reads). Declared in cluster/wire.py
# WIRE_SCHEMAS ("kv.elastic_state").
STATE_KEY = wire.ELASTIC_STATE_KEY


class InMemoryRecoveryUnavailable(RuntimeError):
    """A state leaf is sharded over more than one rank (its shards live on
    peers' devices, some maybe departed), so the in-memory recovery path
    cannot produce a complete snapshot — fall back to the latest
    checkpoint."""


def _metrics():
    reg = default_registry()
    return (
        reg.gauge(
            "cluster_membership_epoch",
            "current membership epoch (bumped on every reconfigure)",
        ),
        reg.histogram(
            "elastic_reshard_seconds",
            "wall seconds spent resharding state on a membership change",
        ),
        reg.counter(
            "elastic_recoveries_total",
            "elastic recovery attempts, by outcome",
        ),
    )


# ---------------------------------------------------------------------------
# membership watcher (node side)
# ---------------------------------------------------------------------------


class MembershipWatcher:
    """Process-local view of the cluster membership epoch.

    The node heartbeater calls :meth:`notify` when a beat reply shows
    the epoch moved (after refetching the roster via ``QEPOCH``);
    training loops poll :meth:`current` / ``ElasticTrainer.changed()``
    — one integer compare per step — and tests block on
    :meth:`wait_for_epoch`. Epochs only move forward; a stale notify
    (reordered beat replies) is ignored.
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._epoch = 0  # guarded-by: self._cond
        self._roster: list[dict[str, Any]] | None = None  # guarded-by: self._cond

    def notify(self, epoch: int, roster: list[dict[str, Any]]) -> bool:
        """Record a membership change; returns False for stale epochs."""
        epoch = int(epoch)
        with self._cond:
            if epoch <= self._epoch and self._roster is not None:
                return False
            self._epoch = max(self._epoch, epoch)
            self._roster = list(roster)
            self._cond.notify_all()
        _metrics()[0].set(epoch)
        flightrec.note(
            "membership_epoch",
            epoch=epoch,
            nodes=[n.get("executor_id") for n in roster],
        )
        return True

    def current(self) -> tuple[int, list[dict[str, Any]] | None]:
        with self._cond:
            return self._epoch, (
                None if self._roster is None else list(self._roster)
            )

    def wait_for_epoch(self, min_epoch: int, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._epoch < min_epoch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 1.0))
            return True

    def reset(self) -> None:
        """Back to the never-notified state (tests; a fresh cluster in
        the same process)."""
        with self._cond:
            self._epoch = 0
            self._roster = None
            self._cond.notify_all()


_watcher = MembershipWatcher()


def notify_membership(epoch: int, roster: list[dict[str, Any]]) -> bool:
    """Entry point for the heartbeater: publish a membership change to
    this process's training loop."""
    return _watcher.notify(epoch, roster)


def membership() -> tuple[int, list[dict[str, Any]] | None]:
    """(epoch, roster) as last notified; roster None before any notify."""
    return _watcher.current()


def current_epoch() -> int:
    """The membership epoch alone: the SAME heartbeat-fed watcher
    ``ElasticTrainer.changed()`` reads."""
    return _watcher.current()[0]


def wait_for_epoch(min_epoch: int, timeout: float = 30.0) -> bool:
    return _watcher.wait_for_epoch(min_epoch, timeout)


# ---------------------------------------------------------------------------
# deterministic resharding
# ---------------------------------------------------------------------------


def _tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to each tensor: through dataclasses
    (``TrainState``), named tuples, tuples, lists and dicts; other leaves
    (a step count) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, getattr(tree, f)) for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _is_placement(x: Any) -> bool:
    from tensorflowonspark_tpu_torch.compute.layout import Sharding

    return isinstance(x, (Sharding, torch.device))


def _tree_place(fn, tree: Any, placements: Any) -> Any:
    """``fn(tensor, placement)`` over ``tree``; a placement at an inner
    node of ``placements`` applies to every tensor below it."""
    if _is_placement(placements):
        return _tree_map(lambda t: fn(t, placements), tree)
    if isinstance(tree, torch.Tensor):
        raise TypeError(f"no placement for a tensor of shape {tuple(tree.shape)}: {placements!r}")
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_place(fn, getattr(tree, f.name), getattr(placements, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_place(fn, getattr(tree, f), getattr(placements, f))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_place(fn, v, p) for v, p in zip(tree, placements))
    if isinstance(tree, dict):
        return {k: _tree_place(fn, v, placements[k]) for k, v in tree.items()}
    return tree


def _local_whole(x: torch.Tensor) -> torch.Tensor:
    """The whole value of ``x`` from this process, with no collective."""
    from tensorflowonspark_tpu_torch.parallel.context import is_dtensor

    if not is_dtensor(x):
        return x.detach()
    if x.device_mesh.size() > 1 and not all(p.is_replicate() for p in x.placements):
        raise InMemoryRecoveryUnavailable(
            "state leaf is sharded over other ranks "
            f"({tuple(x.placements)} on {x.device_mesh.size()} ranks); in-memory "
            "recovery needs every shard locally — falling back to the latest "
            "checkpoint is the supported path"
        )
    return x.to_local().detach()


def host_snapshot(state: Any) -> Any:
    """In-memory host copy of ``state``: same tree, CPU tensor leaves of
    the same dtypes, each an independent copy (the training step updates
    the state in place).

    THE recovery artifact of the elastic plane — byte-exact, so a reshard
    built from it is byte-identical to the pre-change state. Raises
    :class:`InMemoryRecoveryUnavailable` when a leaf is sharded over more
    than one rank (its shards live on peers), without a collective: that is
    the precise condition under which the checkpoint fallback is the only
    honest recovery.
    """
    leaves = []
    _tree_map(lambda x: leaves.append(_local_whole(x)), state)  # refuse before copying
    it = iter(leaves)
    return _tree_map(lambda _x: next(it).to("cpu", copy=True), state)


def _host_template(state: Any) -> Any:
    """Empty CPU tensors of ``state``'s global shapes and dtypes (what a
    checkpoint is restored into; no collective, no copy)."""
    return _tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype), state)


def _place_leaf(t: torch.Tensor, placement) -> torch.Tensor:
    from tensorflowonspark_tpu_torch.compute.train import place

    if isinstance(placement, torch.device):
        return t.to(placement, copy=True)
    mesh = placement.mesh
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    return place(t.to(device, copy=True), placement)


def reshard_state(state: Any, shardings: Any) -> Any:
    """Commit ``state`` onto ``shardings`` through host memory: each leaf
    whole on the host (a no-op for an existing :func:`host_snapshot`; a
    sharded DTensor is gathered, a collective every rank joins), then a
    fresh copy placed by its target (``compute.train.place``, or a plain
    tensor on a ``torch.device``). Values are untouched — an N→N−1→N round
    trip is byte-identical."""
    from tensorflowonspark_tpu_torch.parallel.context import is_dtensor

    host = _tree_map(lambda x: (x.full_tensor() if is_dtensor(x) else x).detach().to("cpu"),
                     state)
    return _tree_place(_place_leaf, host, shardings)


def default_shardings_fn(state: Any, mesh) -> Any:
    """Placements for a (re-formed) mesh: FSDP over params via
    :func:`~tensorflowonspark_tpu_torch.compute.train.fsdp_shardings`, the
    optimizer tree mirrored — ZeRO data-axis partitioned by
    ``state_shardings``'s default, so a reconfigure re-derives the same
    cross-replica weight update layout training ran with, for the NEW rank
    count — and scalars replicated. Model-table consumers pass
    ``shardings_fn=lambda s, m: state_shardings(s, m,
    layout.param_shardings(s.params, m, "<table>"))`` instead; either way
    the reshard round trip is byte-identical."""
    from tensorflowonspark_tpu_torch.compute.train import (
        fsdp_shardings,
        state_shardings,
    )

    if hasattr(state, "params"):
        psh = fsdp_shardings(state.params, mesh)
        return state_shardings(state, mesh, psh)
    return fsdp_shardings(state, mesh)


# ---------------------------------------------------------------------------
# the node-side state machine
# ---------------------------------------------------------------------------


class ElasticTrainer:
    """Node-side reshard/epoch state machine.

    Usage (the shape ``tests/torch_elastic_fns.elastic_train_fn`` follows)::

        trainer = ElasticTrainer(ctx, axis_shapes={"data": -1})
        mesh = trainer.mesh()
        step_fn = build_train_step(loss_fn, tx, mesh)
        step = start
        while step < total:
            if trainer.changed():                      # one int compare
                state, mesh = trainer.reconfigure(state)
                step_fn = build_train_step(loss_fn, tx, mesh)
                if trainer.resume_step is not None:    # ckpt fallback:
                    step = trainer.resume_step         # rewind + replay
            state, loss = step_fn(state, batch_for(step))
            trainer.publish(state, step + 1)           # peers can hydrate
            step += 1

    A single-controller node (``ctx.distributed`` false) keeps its state
    plain on its own device, so its step is
    ``build_train_step(loss_fn, tx, device=...)``.

    ``axis_shapes`` follows ``make_mesh`` (the elastic axis absorbs
    rank-count changes — :func:`fit_axis_shapes`); ``shardings_fn(state,
    mesh)`` derives the new placement (default: FSDP params + mirrored
    optimizer tree in multi-controller mode, the node's own device
    otherwise); ``checkpoint_dir`` arms the fallback;
    ``publish_steps`` throttles peer-hydration snapshots;
    ``devices_fn(roster)`` overrides the rank count (tests).
    """

    # Max wall-clock a rejoiner waits for its own admission bump while
    # excluded from the roster (see changed()); admission normally
    # lands within one driver supervise poll (seconds). On expiry the
    # exclusion is treated as a real removal — the loud error, never a
    # silent wedge.
    ADMISSION_GRACE_S = 120.0

    def __init__(
        self,
        ctx,
        axis_shapes: Mapping[str, int] | None = None,
        elastic_axis: str = "fsdp",
        shardings_fn: Callable[[Any, Any], Any] | None = None,
        checkpoint_dir: str | None = None,
        publish_steps: int = 1,
        state_key: str = STATE_KEY,
        devices_fn: Callable[[list[dict[str, Any]]], Any] | None = None,
    ):
        self._ctx = ctx
        self._axis_shapes = dict(axis_shapes) if axis_shapes else None
        self._elastic_axis = elastic_axis
        self._shardings_fn = shardings_fn or (
            default_shardings_fn if getattr(ctx, "distributed", False) else self._own_device)
        self._checkpoint_dir = checkpoint_dir
        self._publish_steps = max(1, int(publish_steps))
        self._state_key = state_key
        self._devices_fn = devices_fn
        self._last_published: int | None = None
        # the step of the state last handed to publish(), published or
        # not: the label of the snapshot a reconfigure publishes
        self._last_step: int | None = None
        epoch, roster = membership()
        self._cur_epoch = epoch
        self._cur_roster = (
            roster
            if roster is not None
            else list(getattr(ctx, "cluster_info", None) or [])
        )
        self._mesh = None
        # True between hydrate() (the rejoin path) and this node's own
        # admission bump landing: a replacement's _cur_roster can
        # contain its executor id only because its dead PREDECESSOR was
        # in it, which defeats changed()'s not-yet-admitted guard — a
        # stale departure bump arriving before the admit bump would make
        # the rejoiner reconfigure onto a roster excluding itself and die
        # loudly. The wait is BOUNDED (one excluded epoch, one grace
        # window) so a rejoiner that really was removed still fails
        # loudly instead of wedging silently.
        self._awaiting_admission = False
        self._await_excluded_epoch: int | None = None
        self._await_since: float | None = None
        # Set by reconfigure: None after an in-memory reshard (resume
        # where you were), or the restored checkpoint step after a
        # checkpoint_fallback — the training loop MUST rewind its step
        # counter to it (replaying the same data order) or it silently
        # skips the steps between the checkpoint and the failure.
        self.resume_step: int | None = None

    # -- cheap per-step surface ---------------------------------------

    @property
    def epoch(self) -> int:
        return self._cur_epoch

    @property
    def roster(self) -> list[dict[str, Any]]:
        return list(self._cur_roster)

    def _is_member(self, roster: list[dict[str, Any]]) -> bool:
        eid = getattr(self._ctx, "executor_id", None)
        return any(n.get("executor_id") == eid for n in roster)

    def changed(self) -> bool:
        """True when the cluster membership moved past the epoch this
        trainer last reconfigured for — one integer compare on the hot
        path, safe to call every step.

        One refinement for joiners: a freshly-registered node may see a
        bump it is in NEITHER side of (the departure bump published
        just before its own admission). Reconfiguring onto a roster
        that excludes it would be wrong either way, so such bumps are
        not "changes" — its own admission bump follows within a poll.
        A REPLACEMENT needs the explicit ``_awaiting_admission`` flag
        for this (set by :meth:`hydrate`): its ``_cur_roster`` is the
        original cluster roster, which contains its executor id via
        the dead predecessor, so roster membership alone cannot tell
        "was admitted" from "inherited the dead node's seat". The wait
        is bounded two ways — the driver folds concurrent removals and
        admissions into one bump per supervise poll, so a SECOND
        distinct epoch that still excludes this node means the admit
        bump is not coming (return True; reconfigure raises the loud
        "was removed"); and ADMISSION_GRACE_S caps the wall-clock wait
        against a wedged driver, so a genuinely-removed rejoiner can
        never wedge silently on a stale mesh."""
        epoch, roster = _watcher.current()
        if epoch <= self._cur_epoch:
            return False
        if roster is not None and not self._is_member(roster):
            if self._awaiting_admission:
                if self._await_excluded_epoch is None:
                    self._await_excluded_epoch = epoch
                waited = time.monotonic() - (
                    self._await_since or time.monotonic()
                )
                if (
                    epoch == self._await_excluded_epoch
                    and waited < self.ADMISSION_GRACE_S
                ):
                    return False  # the predecessor's departure bump
                return True  # excluded again/too long: really removed
            if not self._is_member(self._cur_roster):
                return False  # registered but not yet admitted
        return True

    def mesh(self):
        """The device mesh for the current epoch (cached until the next
        :meth:`reconfigure`), on the node's device type."""
        if self._mesh is None:
            from tensorflowonspark_tpu_torch import resolve_device
            from tensorflowonspark_tpu_torch.compute.mesh import (
                fit_axis_shapes,
                make_mesh,
            )

            shapes = fit_axis_shapes(
                self._axis_shapes, self._devices(), self._elastic_axis
            )
            device_type = resolve_device(getattr(self._ctx, "device", None)).type
            self._mesh = make_mesh(shapes, device_type=device_type)
        return self._mesh

    def _devices(self) -> int:
        """The rank count the mesh spans."""
        if self._devices_fn is not None:
            n = self._devices_fn(self._cur_roster)
            return n if isinstance(n, int) else len(n)
        # Multi-controller: the world after the rebind (exactly the
        # surviving processes). Single-controller-per-node: a world of
        # one on the node's own device, whatever the membership.
        if getattr(self._ctx, "distributed", False):
            import torch.distributed as dist

            return dist.get_world_size()
        return 1

    def _own_device(self, _state: Any, _mesh) -> torch.device:
        """The default placement of a single-controller node: every leaf
        whole on the node's own device."""
        from tensorflowonspark_tpu_torch import resolve_device

        device = resolve_device(getattr(self._ctx, "device", None))
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device

    # -- the reconfigure ----------------------------------------------

    def reconfigure(self, state: Any) -> tuple[Any, Any]:
        """Drive one membership reconfigure; returns ``(state, mesh)``.

        Order matters: (1) copy the in-memory snapshot while the OLD
        tensors are still healthy, (2) rebind the distributed runtime
        to the new roster, (3) re-form the mesh, (4) commit the
        snapshot onto the new placements. A failed gather (shards on
        other ranks; an armed ``elastic.reshard_gather``) falls back
        to the latest checkpoint — outcome ``checkpoint_fallback``,
        with :attr:`resume_step` set to the restored step so the
        training loop rewinds to it (replaying the same data order)
        instead of silently skipping the steps between the checkpoint
        and the failure — and with no ``checkpoint_dir`` the
        reconfigure fails loudly (outcome ``failed``): training on
        silently-stale state is the one unacceptable result.
        """
        gauge, hist, recoveries = _metrics()
        epoch, roster = membership()
        if roster is None:
            roster = self._cur_roster
        if not self._is_member(roster):
            # The driver removed THIS node (a false-positive death
            # verdict — e.g. a GC pause outliving the grace — or a
            # voluntary leave). Continuing to train outside membership
            # is zombie work; rejoining goes through registration, not
            # reconfigure.
            raise RuntimeError(
                f"executor {getattr(self._ctx, 'executor_id', '?')} is "
                f"not in membership epoch {epoch} "
                f"({[n.get('executor_id') for n in roster]}): this node "
                "was removed — re-register to rejoin instead of "
                "reconfiguring"
            )
        # admitted: this roster includes us — future exclusions are
        # real removals again, not a pending admission
        self._awaiting_admission = False
        self._await_excluded_epoch = None
        self._await_since = None
        t0 = time.monotonic()
        outcome = "resharded"
        restored_step: int | None = None
        with obs_spans.span(
            "elastic.reshard", epoch=epoch, nodes=len(roster)
        ):
            snapshot = None
            gather_err: BaseException | None = None
            try:
                failpoint("elastic.reshard_gather")
                snapshot = host_snapshot(state)
            except BaseException as e:  # noqa: BLE001 - fallback decides
                gather_err = e
                logger.warning(
                    "elastic: in-memory gather failed (%s); trying the "
                    "checkpoint fallback",
                    e,
                )
            reinit = getattr(self._ctx, "reinitialize_distributed", None)
            if reinit is not None:
                reinit(roster)
            self._cur_epoch, self._cur_roster, self._mesh = epoch, roster, None
            mesh = self.mesh()
            if snapshot is None:
                snapshot, outcome, restored_step = self._fallback_snapshot(
                    state, gather_err
                )
            shardings = self._shardings_fn(snapshot, mesh)
            state = reshard_state(snapshot, shardings)
        self.resume_step = restored_step
        dt = time.monotonic() - t0
        hist.observe(dt)
        recoveries.inc(outcome=outcome)
        gauge.set(epoch)
        flightrec.note(
            "elastic_reconfigure",
            epoch=epoch,
            outcome=outcome,
            nodes=len(roster),
            resume_step=restored_step,
            seconds=round(dt, 3),
        )
        logger.info(
            "elastic: reconfigured to epoch %d (%d node(s), %s, %.3fs)",
            epoch,
            len(roster),
            outcome,
            dt,
        )
        # The snapshot published for joiners must reflect the new epoch
        # — and, after a fallback, the step it was actually rewound to.
        # Otherwise it is labelled with the step the loop last handed to
        # publish(): with publish_steps > 1 the last *published* step can
        # be older than the state, and a joiner would replay steps the
        # state already holds. The snapshot resharded from holds the
        # placed state's bytes: it is published as it is.
        self._last_step = (
            restored_step if restored_step is not None else (self._last_step or 0)
        )
        self._publish(self._last_step, lambda: snapshot)
        return state, mesh

    def _fallback_snapshot(
        self, state: Any, gather_err: BaseException | None
    ) -> tuple[Any, str, int]:
        if self._checkpoint_dir is None:
            _metrics()[2].inc(outcome="failed")
            flightrec.note(
                "elastic_reconfigure_failed", error=repr(gather_err)
            )
            flightrec.dump_now("elastic_reconfigure_failed")
            raise RuntimeError(
                "elastic reconfigure: in-memory recovery impossible and "
                "no checkpoint_dir configured"
            ) from gather_err
        from tensorflowonspark_tpu_torch.compute import checkpoint as ckpt

        step, restored = ckpt.hydration_restore(
            self._checkpoint_dir, target=_host_template(state)
        )
        if restored is None:
            _metrics()[2].inc(outcome="failed")
            flightrec.note(
                "elastic_reconfigure_failed",
                error=repr(gather_err),
                checkpoint_dir=self._checkpoint_dir,
            )
            flightrec.dump_now("elastic_reconfigure_failed")
            raise RuntimeError(
                f"elastic reconfigure: in-memory recovery impossible and "
                f"no checkpoint found under {self._checkpoint_dir!r}"
            ) from gather_err
        logger.warning(
            "elastic: recovered from checkpoint step %s (in-memory "
            "snapshot unavailable); the training loop must rewind to it",
            step,
        )
        # restored into fresh host tensors: already a host snapshot
        return restored, "checkpoint_fallback", int(step)

    # -- peer hydration (the joiner path) ------------------------------

    def publish(self, state: Any, step: int, force: bool = False) -> None:
        """Publish this node's host snapshot to its manager KV so a
        joiner can hydrate from in-memory state instead of a checkpoint.
        Throttled to every ``publish_steps`` steps; best-effort (a
        failed publish degrades the joiner to the checkpoint fallback,
        it never fails training)."""
        self._last_step = int(step)
        if (
            not force
            and self._last_published is not None
            and step - self._last_published < self._publish_steps
        ):
            return
        self._publish(int(step), lambda: host_snapshot(state))

    def _publish(self, step: int, snapshot: Callable[[], Any]) -> None:
        """Pickle ``(epoch, step, snapshot())`` into the manager KV, when
        this node has a manager."""
        mgr = getattr(self._ctx, "mgr", None)
        if mgr is None:
            return
        try:
            blob = pickle.dumps(
                (self._cur_epoch, step, snapshot()),
                protocol=pickle.HIGHEST_PROTOCOL,
            )
            mgr.set(self._state_key, blob)
            self._last_published = step
        except Exception as e:  # noqa: BLE001 - best-effort by contract
            logger.debug("elastic publish skipped: %s", e)

    def hydrate(self, default: Any = None) -> tuple[int | None, Any]:
        """Joining-node recovery: ``(step, state)`` from the freshest
        peer-published in-memory snapshot, else the latest checkpoint
        (outcome ``checkpoint_fallback``), else ``(None, default)``
        (outcome ``fresh_init`` — a genuinely new cluster). The
        returned state is committed onto this node's current mesh via
        ``shardings_fn``. Peer snapshots ride the authkey-authenticated
        manager channel the data plane already trusts.

        Calling this marks the trainer as awaiting its own admission
        bump: membership bumps whose roster excludes this node are not
        "changes" until the driver has admitted it (see
        :meth:`changed`) — the stale departure bump of the seat it is
        replacing must not trigger a reconfigure."""
        self._awaiting_admission = True
        self._await_excluded_epoch = None
        self._await_since = time.monotonic()
        failpoint("elastic.rejoin_init")
        from tensorflowonspark_tpu_torch.cluster.node import connect_manager

        recoveries = _metrics()[2]
        best: tuple[int, Any] | None = None
        for node in sorted(
            self._cur_roster, key=lambda n: n.get("executor_id", -1)
        ):
            if node.get("executor_id") == getattr(
                self._ctx, "executor_id", None
            ):
                continue
            try:
                blob = connect_manager(node).get(self._state_key)
                if not blob:
                    continue
                _ep, step, snap = pickle.loads(blob)
                del blob
            except Exception as e:  # noqa: BLE001 - peers may be dying
                logger.debug(
                    "elastic hydrate: peer %s unavailable (%s)",
                    node.get("executor_id"),
                    e,
                )
                continue
            if best is None or int(step) > best[0]:
                best = (int(step), snap)
            del snap
        outcome = "peer_hydrate"
        if best is None:
            step_snap = self._checkpoint_hydrate(default)
            if step_snap is None:
                recoveries.inc(outcome="fresh_init")
                flightrec.note("elastic_hydrate", outcome="fresh_init")
                return None, default
            best, outcome = step_snap, "checkpoint_fallback"
        step, snap = best
        del best
        state = reshard_state(
            snap, self._shardings_fn(snap, self.mesh())
        )
        del snap
        recoveries.inc(outcome=outcome)
        flightrec.note("elastic_hydrate", outcome=outcome, step=step)
        logger.info(
            "elastic: hydrated at step %d via %s", step, outcome
        )
        return step, state

    def _checkpoint_hydrate(self, default: Any) -> tuple[int, Any] | None:
        if self._checkpoint_dir is None:
            return None
        from tensorflowonspark_tpu_torch.compute import checkpoint as ckpt

        step, restored = ckpt.hydration_restore(
            self._checkpoint_dir,
            target=None if default is None else _host_template(default),
        )
        if restored is None:
            return None
        return int(step), restored
