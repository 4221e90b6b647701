"""Checkpoint / restore of any tree of tensors (a ``TrainState``, a dict of
params), in a torch-native format.

Port of :mod:`tensorflowonspark_tpu.compute.checkpoint`, which writes
orbax checkpoints. The contract is the same; the format is the port's:

- **Layout.** A step is a directory. It is written under a temporary name
  (``<name>.orbax-checkpoint-tmp-<n>``, orbax's marker, so the same probe
  :func:`checkpoint_complete` reads both) and renamed to its final name at
  commit. It holds ``state.pt``, one ``torch.save`` file of a flat
  ``{path: tensor}`` dict (paths like ``params/embed`` or
  ``opt_state/0/mu/embed``); ``tree.json``, the tree's spec (containers,
  the ``TrainState`` fields, the ``NamedTuple`` classes of the optimizer
  state, and every leaf that is not a tensor, such as the int ``step``);
  and, written last, the ``_CHECKPOINT_METADATA`` marker.
- **Restore** is into a ``target`` of the same structure, as orbax's target
  restore is: the file loads with ``weights_only=True`` (which refuses
  custom classes, hence the flat dict), every name, shape and dtype must
  match the target's (the error names the first that does not), and each
  tensor is copied into the target's tensor in place, so it keeps its
  device. Leaves that are not tensors come from the spec.
- **Async save** (``CheckpointManager(async_save=True)``, the default):
  the port's optimizer updates the params in place
  (``compute/optim.py:apply_updates``), so ``save`` first copies the state
  to pinned host buffers on a side CUDA stream (plain host copies on the
  CPU) and synchronizes on that copy before it returns; only the file
  write runs on a background thread. The next step may then change the
  tensors without tearing the checkpoint.
- **Processes.** A state of plain tensors is a whole replica in every
  process, so only the chief saves it (:func:`saves_on_this_process`).
- **Sharded state.** A state that holds DTensors (placed on a device mesh
  by ``compute.train.shard_state``) is saved by every rank together with
  ``torch.distributed.checkpoint``: each rank writes its own shards into
  the step's temporary directory (a name every rank derives alike), then
  rank 0 writes ``tree.json`` and, last, the marker, and renames the
  directory. Such a save is synchronous: it has returned on every rank
  when the step is committed. Restore reads the shards into the target's
  own placements, on a mesh of another shape or into plain tensors in one
  process, as the JAX package's orbax restore reshards.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
import json
import os
import shutil
import threading
import time
from typing import Any

import torch

from tensorflowonspark_tpu_torch.obs import spans as obs_spans
from tensorflowonspark_tpu_torch.utils.failpoints import FailpointError, failpoint
from tensorflowonspark_tpu_torch.utils.retry import RetryPolicy

# Checkpoint IO rides shared filesystems (GCS/NFS) whose transient errors are
# routine at pod scale; retry them with backoff rather than failing a
# multi-hour training step. Injected FailpointErrors are retryable here
# so chaos runs can exercise exactly this path.
_IO_RETRY = RetryPolicy(max_attempts=3, base_delay=0.2, max_delay=5.0)
_IO_RETRYABLE = (OSError, ConnectionError, TimeoutError, FailpointError)

_TMP_MARK = ".orbax-checkpoint-tmp-"
_STATE_FILE = "state.pt"
_TREE_FILE = "tree.json"
_METRICS_FILE = "metrics.json"
_MARKER = "_CHECKPOINT_METADATA"
_SHARDED_FILE = ".metadata"  # torch.distributed.checkpoint's index of the shards
_tmp_ids = itertools.count()


def _abs(path: str) -> str:
    if "://" in path:
        return path
    return os.path.abspath(path)


def checkpoint_complete(path: str) -> bool:
    """True iff ``path`` holds a COMMITTED checkpoint.

    The serving rollout channel publishes checkpoint directories to live
    engines; a torn or in-progress write must never be hot-swapped into a
    serving fleet. Two signals, both required: the directory exists under
    its FINAL name (a save writes into a ``*.orbax-checkpoint-tmp-*``
    directory and renames at commit — on posix the final name existing IS
    the commit), and the ``_CHECKPOINT_METADATA`` finalization marker is
    present (guards partially-copied directories, e.g. an interrupted
    rsync between filesystems, where the rename atomicity did not travel).

    Remote URIs (``gs://...`` and friends) cannot be probed with local
    filesystem calls: the tmp-name rejection still applies, but a
    final-named remote path is TRUSTED — the publisher's contract is to
    publish only after the save fully landed (``CheckpointManager.wait()``)."""
    path = _abs(path)
    if "orbax-checkpoint-tmp" in os.path.basename(path.rstrip("/")):
        return False
    if "://" in path:
        return True
    if not os.path.isdir(path):
        return False
    return os.path.exists(os.path.join(path, _MARKER))


# -- the tree <-> (spec, flat tensors) -----------------------------------------


def _flatten(tree: Any, path: str, flat: dict) -> Any:
    """The JSON spec of ``tree``; its tensors go into ``flat`` by path."""
    if isinstance(tree, torch.Tensor):
        flat[path] = tree
        return {"t": "tensor"}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        cls = type(tree)
        fields = [f.name for f in dataclasses.fields(tree)]
        return {"t": "dataclass", "cls": f"{cls.__module__}:{cls.__qualname__}",
                "items": {f: _flatten(getattr(tree, f), _join(path, f), flat) for f in fields}}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = type(tree)
        return {"t": "namedtuple", "cls": f"{cls.__module__}:{cls.__qualname__}",
                "items": {f: _flatten(getattr(tree, f), _join(path, f), flat)
                          for f in tree._fields}}
    if isinstance(tree, (tuple, list)):
        return {"t": type(tree).__name__,
                "items": [_flatten(v, _join(path, str(i)), flat) for i, v in enumerate(tree)]}
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str) or "/" in k:
                raise TypeError(f"checkpoint dict keys must be str without '/': {k!r}")
        return {"t": "dict", "items": {k: _flatten(v, _join(path, k), flat)
                                       for k, v in tree.items()}}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"t": "value", "v": tree}
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__} at {path!r}")


def _join(path: str, key: str) -> str:
    return f"{path}/{key}" if path else key


def _port_class(name: str):
    """A container class named in a spec; only the port's own classes are
    imported (anything else rebuilds as a plain container)."""
    module, qualname = name.split(":")
    if not module.startswith("tensorflowonspark_tpu_torch."):
        return None
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _build(spec: dict, path: str, leaf) -> Any:
    """The tree of ``spec``, its tensors from ``leaf(path)``."""
    kind = spec["t"]
    if kind == "tensor":
        return leaf(path)
    if kind == "value":
        return spec["v"]
    if kind in ("tuple", "list"):
        items = [_build(s, _join(path, str(i)), leaf) for i, s in enumerate(spec["items"])]
        return tuple(items) if kind == "tuple" else items
    items = {k: _build(s, _join(path, k), leaf) for k, s in spec["items"].items()}
    if kind == "dict":
        return items
    cls = _port_class(spec["cls"])
    if cls is None:
        return items if kind == "dataclass" else tuple(items.values())
    return cls(**items)


def _like(target: Any, spec: dict) -> Any:
    """``target`` rebuilt with its own container classes, its tensors as
    they are (restored in place) and its other leaves from ``spec``."""
    kind = spec["t"]
    if kind == "tensor":
        return target
    if kind == "value":
        return spec["v"]
    items = spec["items"]
    if kind == "dataclass":
        return dataclasses.replace(
            target, **{k: _like(getattr(target, k), s) for k, s in items.items()})
    if kind == "namedtuple":
        return type(target)(**{k: _like(getattr(target, k), s) for k, s in items.items()})
    if kind == "dict":
        return {k: _like(target[k], s) for k, s in items.items()}
    return type(target)(_like(t, s) for t, s in zip(target, items))


def _shape_of(spec: dict, path: str = "") -> list[str]:
    """Every leaf path of a spec, in order (names of a structure)."""
    if spec["t"] in ("tensor", "value"):
        return [path]
    items = spec["items"]
    pairs = enumerate(items) if isinstance(items, list) else items.items()
    return [p for k, s in pairs for p in _shape_of(s, _join(path, str(k)))]


def _host_copy(flat: dict, pinned: dict | None = None) -> dict:
    """Every tensor of ``flat`` copied to host memory, done when this
    returns. CUDA tensors go to pinned buffers (reused from ``pinned`` when
    their shape and dtype match) on a side stream; CPU tensors are cloned."""
    pinned = {} if pinned is None else pinned
    out, streams = {}, {}
    for path, t in flat.items():
        t = t.detach()
        if t.device.type != "cuda":
            out[path] = t.clone()
            continue
        buf = pinned.get(path)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = pinned[path] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        side = streams.get(t.device)
        if side is None:
            side = streams[t.device] = torch.cuda.Stream(t.device)
            side.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(side):
            buf.copy_(t, non_blocking=True)
        out[path] = buf
    for side in streams.values():
        side.synchronize()
    return out


def _write_step(path: str, spec: dict, flat: dict, metrics: dict | None, force: bool) -> None:
    """Write one step directory under a temporary name, then commit it."""
    parent, name = os.path.split(path.rstrip("/"))
    os.makedirs(parent or ".", exist_ok=True)
    tmp = os.path.join(parent, f"{name}{_TMP_MARK}{os.getpid()}-{next(_tmp_ids)}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(flat, os.path.join(tmp, _STATE_FILE))
    with open(os.path.join(tmp, _TREE_FILE), "w") as f:
        json.dump(spec, f)
    if metrics is not None:
        with open(os.path.join(tmp, _METRICS_FILE), "w") as f:
            json.dump(metrics, f)
    with open(os.path.join(tmp, _MARKER), "w") as f:
        json.dump({"format": "tensorflowonspark_tpu_torch", "time": time.time()}, f)
    if os.path.exists(path):
        if not force:
            shutil.rmtree(tmp, ignore_errors=True)
            raise FileExistsError(f"checkpoint {path} exists (pass force=True)")
        shutil.rmtree(path)
    os.replace(tmp, path)


def _read_spec(path: str) -> dict:
    with open(os.path.join(path, _TREE_FILE)) as f:
        return json.load(f)


def _restore_into(path: str, target: Any | None) -> Any:
    """Load a committed step directory, into ``target`` when one is given."""
    if not checkpoint_complete(path):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    spec = _read_spec(path)
    if os.path.exists(os.path.join(path, _SHARDED_FILE)):
        return _restore_sharded(path, spec, target)
    stored = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                        weights_only=True, mmap=True)
    if target is None:
        return _build(spec, "", lambda p: stored[p])
    want: dict = {}
    target_spec = _flatten(target, "", want)
    names, target_names = _shape_of(spec), _shape_of(target_spec)
    for a, b in zip(names + [None], target_names + [None]):
        if a != b:
            raise ValueError(
                f"checkpoint {path} does not match the target: first "
                f"difference at {a!r} (stored) vs {b!r} (target)"
            )
    for p, t in want.items():
        got = stored.get(p)
        if got is None:
            raise ValueError(f"checkpoint {path}: {p!r} is not a tensor there")
        if got.shape != t.shape or got.dtype != t.dtype:
            raise ValueError(
                f"checkpoint {path}: {p!r} is {got.dtype} {tuple(got.shape)} "
                f"but the target's is {t.dtype} {tuple(t.shape)}"
            )
    with torch.no_grad():
        for p, t in want.items():
            t.copy_(stored[p])
    return _like(target, spec)


# -- sharded states (DTensors) ---------------------------------------------------


def is_sharded(state: Any) -> bool:
    """Whether ``state`` holds DTensors (a state placed on a mesh)."""
    from tensorflowonspark_tpu_torch.parallel.context import is_dtensor

    flat: dict = {}
    _flatten(state, "", flat)
    return any(is_dtensor(t) for t in flat.values())


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def _write_sharded(path: str, spec: dict, flat: dict, metrics: dict | None, force: bool) -> None:
    """Every rank writes its shards of ``flat`` into the step's temporary
    directory; rank 0 then writes the spec and the marker and commits."""
    import torch.distributed.checkpoint as dcp

    parent, name = os.path.split(path.rstrip("/"))
    tmp = os.path.join(parent, f"{name}{_TMP_MARK}sharded")
    rank = _rank()
    if rank == 0:
        os.makedirs(parent or ".", exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _barrier()
    dcp.save(flat, checkpoint_id=tmp)
    if rank == 0:
        with open(os.path.join(tmp, _TREE_FILE), "w") as f:
            json.dump(spec, f)
        if metrics is not None:
            with open(os.path.join(tmp, _METRICS_FILE), "w") as f:
                json.dump(metrics, f)
        with open(os.path.join(tmp, _MARKER), "w") as f:
            json.dump({"format": "tensorflowonspark_tpu_torch", "sharded": True,
                       "time": time.time()}, f)
        if os.path.exists(path):
            if not force:
                shutil.rmtree(tmp, ignore_errors=True)
                raise FileExistsError(f"checkpoint {path} exists (pass force=True)")
            shutil.rmtree(path)
        os.replace(tmp, path)
    _barrier()


def _restore_sharded(path: str, spec: dict, target: Any | None) -> Any:
    """Read a sharded step into ``target``'s tensors, in their own
    placements (DTensors on any mesh, or plain tensors)."""
    import torch.distributed.checkpoint as dcp

    if target is None:
        raise ValueError(f"checkpoint {path} is sharded: restore it into a target")
    stored = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    want: dict = {}
    target_spec = _flatten(target, "", want)
    names, target_names = _shape_of(spec), _shape_of(target_spec)
    for a, b in zip(names + [None], target_names + [None]):
        if a != b:
            raise ValueError(
                f"checkpoint {path} does not match the target: first "
                f"difference at {a!r} (stored) vs {b!r} (target)"
            )
    for p, t in want.items():
        meta = stored.get(p)
        if meta is None or not hasattr(meta, "size"):
            raise ValueError(f"checkpoint {path}: {p!r} is not a tensor there")
        if tuple(meta.size) != tuple(t.shape) or meta.properties.dtype != t.dtype:
            raise ValueError(
                f"checkpoint {path}: {p!r} is {meta.properties.dtype} {tuple(meta.size)} "
                f"but the target's is {t.dtype} {tuple(t.shape)}"
            )
    with torch.no_grad():
        dcp.load(want, checkpoint_id=path)
    return _like(target, spec)


def save_checkpoint(path: str, state: Any, force: bool = True) -> str:
    """Synchronously write ``state`` (any tree of tensors) to ``path``."""
    path = _abs(path)
    flat: dict = {}
    spec = _flatten(state, "", flat)
    if is_sharded(state):
        with obs_spans.span("train.checkpoint"):
            _IO_RETRY.call(lambda: _write_sharded(path, spec, flat, None, force),
                           retry_on=_IO_RETRYABLE, site="checkpoint.save")
        return path
    with obs_spans.span("train.checkpoint"):
        host = _host_copy(flat)

        def do_save():
            failpoint("checkpoint.save")
            _write_step(path, spec, host, None, force)

        _IO_RETRY.call(do_save, retry_on=_IO_RETRYABLE, site="checkpoint.save")
    return path


def restore_checkpoint(path: str, target: Any | None = None) -> Any:
    """Restore a tree; ``target`` pins structure, shapes, dtypes and — as
    the tensors are copied into it — devices. Without a target the tensors
    come back on the CPU."""
    path = _abs(path)

    def do_restore():
        failpoint("checkpoint.restore")
        return _restore_into(path, target)

    return _IO_RETRY.call(do_restore, retry_on=_IO_RETRYABLE, site="checkpoint.restore")


class CheckpointManager:
    """Step-numbered checkpoints with retention + async write.

    The async writer overlaps checkpoint I/O with the next training steps —
    part of the MFU recipe (SURVEY.md §7 "hard parts"). ``save`` returns
    once the state is copied to host memory (see the module docstring).
    """

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        async_save: bool = True,
        save_interval_steps: int = 1,
        keep_best_metric: str | None = None,
        keep_best_mode: str = "min",
    ):
        """``save_interval_steps``: calls to :meth:`save` off the interval
        are no-ops returning False (callers can save unconditionally every
        step and let the policy decide). ``keep_best_metric``: retain the
        ``max_to_keep`` checkpoints with the best value of that key in the
        metrics dict passed to :meth:`save` (``keep_best_mode`` 'min' for
        losses, 'max' for accuracies) instead of the most recent ones.
        """
        self.directory = _abs(directory)
        if keep_best_mode not in ("min", "max"):
            raise ValueError("keep_best_mode must be 'min' or 'max'")
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.save_interval_steps = max(1, int(save_interval_steps))
        self.keep_best_metric = keep_best_metric
        self.keep_best_mode = keep_best_mode
        # timings of the last save: host snapshot and file write, seconds
        self.last_save: dict[str, float] = {}
        self._pinned: dict = {}  # host buffers of the last snapshot, reused
        self._pending: int | None = None  # step being written in the background
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        """Committed steps, in order."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and checkpoint_complete(os.path.join(self.directory, name)):
                steps.append(int(name))
        return sorted(steps)

    def _should_save(self, step: int, force: bool) -> bool:
        if force:
            return True
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        return step % self.save_interval_steps == 0

    def save(
        self,
        step: int,
        state: Any,
        metrics: dict[str, Any] | None = None,
        force: bool = False,
    ) -> bool:
        """``force=True`` bypasses the save-interval policy (use for the
        end-of-training save, which must land regardless of interval)."""
        step = int(step)
        if not self._should_save(step, force):
            return False
        # The span measures the BLOCKING portion only: with async_save
        # the file write overlaps subsequent steps, and the interesting
        # host cost is exactly how long the training loop stalled here.
        with obs_spans.span("train.checkpoint", step=step):
            self.wait()  # the previous write owns the host buffers
            flat: dict = {}
            spec = _flatten(state, "", flat)
            if is_sharded(state):
                return self._save_sharded(step, spec, flat, metrics)
            t0 = time.perf_counter()
            host = _host_copy(flat, self._pinned)
            self.last_save = {"snapshot_s": time.perf_counter() - t0}
            path = self.step_path(step)

            def write():
                t1 = time.perf_counter()

                def do_save():
                    failpoint("checkpoint.save")
                    _write_step(path, spec, host, metrics, force=True)

                _IO_RETRY.call(do_save, retry_on=_IO_RETRYABLE, site="checkpoint.save")
                self._retain()
                self.last_save["write_s"] = time.perf_counter() - t1

            if not self.async_save:
                write()
                return True
            self._pending = step

            def background():
                try:
                    write()
                except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                    self._error = e

            self._thread = threading.Thread(target=background, daemon=True,
                                            name=f"checkpoint-{step}")
            self._thread.start()
        return True

    def _save_sharded(self, step: int, spec: dict, flat: dict, metrics) -> bool:
        """Every rank's shards, written before this returns (see the
        module docstring); ``last_save`` has the write's seconds."""
        t0 = time.perf_counter()

        def do_save():
            failpoint("checkpoint.save")
            _write_sharded(self.step_path(step), spec, flat, metrics, force=True)

        _IO_RETRY.call(do_save, retry_on=_IO_RETRYABLE, site="checkpoint.save")
        if _rank() == 0:
            self._retain()
        _barrier()
        self.last_save = {"snapshot_s": None, "write_s": time.perf_counter() - t0}
        return True

    def _retain(self) -> None:
        steps = self.all_steps()
        if self.max_to_keep is None or len(steps) <= self.max_to_keep:
            return
        if self.keep_best_metric is not None:
            def score(s):
                try:
                    with open(os.path.join(self.step_path(s), _METRICS_FILE)) as f:
                        v = float(json.load(f)[self.keep_best_metric])
                except (OSError, KeyError, ValueError):
                    return float("inf")
                return v if self.keep_best_mode == "min" else -v

            keep = set(sorted(steps, key=lambda s: (score(s), -s))[: self.max_to_keep])
        else:
            keep = set(steps[-self.max_to_keep:])
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.step_path(s), ignore_errors=True)

    def restore(self, step: int | None = None, target: Any | None = None) -> Any:
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return restore_checkpoint(self.step_path(step), target)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        if self._pending is not None:
            steps.append(self._pending)
        return max(steps) if steps else None

    def step_path(self, step: int) -> str:
        """Directory of one saved step (the unit the rollout channel
        publishes: ``serving.rollout.publish_checkpoint(path=
        mgr.step_path(step), ...)`` after :meth:`wait`)."""
        return os.path.join(self.directory, str(int(step)))

    def wait(self) -> None:
        """Block until the background write (if any) has committed; raise
        its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()
        self._pinned = {}

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.wait()
        self.close()


def restore_latest(ckpt: CheckpointManager, target: Any):
    """Resume convention: restore the newest checkpoint into ``target``'s
    structure. Returns ``(step, restored)``, or ``(None, target)`` when
    the directory has no checkpoints. A structure mismatch (e.g. a
    directory written by different code) fails with a clear error."""
    step = ckpt.latest_step()
    if step is None:
        return None, target
    try:
        return step, ckpt.restore(step, target=target)
    except Exception as e:
        # Only claim "wrong trainer" when the stored tree's top-level
        # keys genuinely differ from the target's; any other failure
        # (IO, partial step dir, truncated arrays) propagates unchanged
        # so operators retry instead of deleting good checkpoints.
        stored_keys = _stored_top_level_keys(ckpt, step)
        target_keys = _top_level_keys(target)
        if (
            target_keys is not None
            and stored_keys is not None
            and stored_keys != target_keys
        ):
            raise ValueError(
                f"checkpoint step {step} in {ckpt.directory} has keys "
                f"{sorted(stored_keys)} but this trainer expects "
                f"{sorted(target_keys)}; it was written by a different trainer "
                "— delete the directory or point the model dir elsewhere"
            ) from e
        raise


def _top_level_keys(tree: Any) -> set | None:
    if isinstance(tree, dict):
        return set(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name for f in dataclasses.fields(tree)}
    return None


def _stored_top_level_keys(ckpt: CheckpointManager, step: int):
    """Top-level keys of a stored checkpoint's tree, or None if the spec
    cannot be read (caller treats that as 'unknown')."""
    try:
        spec = _read_spec(ckpt.step_path(step))
        items = spec.get("items")
        return set(items) if isinstance(items, dict) else None
    except Exception:
        return None


def hydration_restore(directory: str, target: Any):
    """Elastic-rejoin fallback: restore the newest checkpoint under
    ``directory`` into ``target``'s structure. Returns ``(step,
    state)`` or ``(None, None)`` when the directory holds no
    checkpoints (including a directory that does not exist yet — a
    joiner probing an optional fallback must not crash on it)."""
    with CheckpointManager(directory) as ckpt:
        step, state = restore_latest(ckpt, target)
        if step is None:
            return None, None
        return step, state


def saves_on_this_process(is_chief: bool, state: Any = None) -> bool:
    """Which processes must call ``save`` (and ``wait``): every process
    for a sharded ``state`` (each writes its shards, the JAX package's
    multi-controller rule), else the chief only, since each process holds
    a whole replica and concurrent saves of it to one directory would
    race. Gate *logging* on ``is_chief`` either way."""
    return is_chief or (state is not None and is_sharded(state))


def _final_save_needed(ckpt: CheckpointManager, step: int) -> bool:
    """Whether the final save still needs to run, read from the step
    directories (the same answer on every process that saves)."""
    return ckpt.latest_step() != step


def chief_final_save(
    ckpt: CheckpointManager, state: Any, step: int, is_chief: bool
) -> None:
    """End-of-training save convention: forced past any save-interval
    policy, and skipped when a previous attempt (e.g. a
    ``run_with_restarts`` relaunch or an in-loop interval save) already
    landed this step (``force=True`` also makes a redundant save on a
    stale-FS miss an overwrite, not an error). Every process closes the
    manager (which waits for the write). A sharded state is saved by every
    process, which all read the same directory to decide."""
    if saves_on_this_process(is_chief, state):
        ckpt.wait()  # async in-loop saves may still be landing
        if _final_save_needed(ckpt, step):
            ckpt.save(step, state, force=True)
    ckpt.close()
