"""The port's ``serving/rollout.py`` against the JAX package's: the
publication channel and the rollout controller.

- **The channel.** A ``LATEST`` pointer written by either package's
  ``publish_checkpoint`` is read by the other's ``read_latest`` into the
  same fields, and both reject alike what must be rejected: a torn
  pointer, a CRC mismatch, a tmp-named or marker-less checkpoint
  directory, a missing one; a "drop" of the ``rollout.publish`` failpoint
  writes nothing.
- **The controller.** The reference's scripted stub engines (the doubles
  of ``tests/test_rollout.py``) run the same script through both
  packages' ``ServingFleet`` + ``RolloutController``: the outcome, the
  order of holds, releases and swaps, each stub's version and swap log,
  the seats' states, the ``fleet_weights_version`` gauge and the
  controller's stats must be the same.

Engines, the loader and the server are held in
``tests/test_torch_rollout_serve.py``. ``chip_smoke.py``'s phase rollout
is rehearsed here on the CPU at a tiny size, its four parts whole.
"""

import json
import time
import types

import pytest
import torch

from tensorflowonspark_tpu.serving import engine as j_engine
from tensorflowonspark_tpu.serving import fleet as j_fleet
from tensorflowonspark_tpu.serving import rollout as j_rollout
from tensorflowonspark_tpu.utils import failpoints as j_failpoints
from tensorflowonspark_tpu_torch.serving import engine as t_engine
from tensorflowonspark_tpu_torch.serving import fleet as t_fleet
from tensorflowonspark_tpu_torch.serving import rollout as t_rollout
from tensorflowonspark_tpu_torch.utils import failpoints as t_failpoints

PKGS = {
    "jax": types.SimpleNamespace(rollout=j_rollout, fleet=j_fleet, failpoints=j_failpoints,
                                 WeightsIncompatible=j_engine.WeightsIncompatible),
    "port": types.SimpleNamespace(rollout=t_rollout, fleet=t_fleet, failpoints=t_failpoints,
                                  WeightsIncompatible=t_engine.WeightsIncompatible),
}


@pytest.fixture(autouse=True)
def _no_failpoints():
    yield
    j_failpoints.disarm_all()
    t_failpoints.disarm_all()


# -- the channel ----------------------------------------------------------------


def _committed(root, name="ck"):
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "_CHECKPOINT_METADATA").write_text("{}")
    return str(d)


def _fields(upd):
    return None if upd is None else (upd.version, upd.kind, upd.path, upd.step)


def _tamper(ch):
    raw = json.loads((ch / "LATEST").read_text())
    raw["manifest"]["version"] = "v2-tampered"
    (ch / "LATEST").write_text(json.dumps(raw))


def _partial(root):
    d = root / "partial"
    d.mkdir()
    (d / "state.pt").write_text("x")
    return str(d)


def _tmp_named(root):
    d = root / "step.orbax-checkpoint-tmp-123"
    d.mkdir()
    (d / "_CHECKPOINT_METADATA").write_text("{}")
    return str(d)


# name -> (path of the pointer, how the written pointer is damaged, whether a
# reader must accept it)
CHANNEL = {
    "committed": (_committed, None, True),
    "remote_final_name": (lambda root: "gs://bucket/ckpt/50", None, True),
    "remote_tmp_name": (lambda root: "gs://bucket/ckpt/50.orbax-checkpoint-tmp-1", None, False),
    "marker_missing": (_partial, None, False),
    "tmp_named": (_tmp_named, None, False),
    "path_missing": (lambda root: str(root / "gone"), None, False),
    "crc_mismatch": (_committed, _tamper, False),
    "torn_json": (_committed, lambda ch: (ch / "LATEST").write_text('{"crc": 1, "manifest": {"ve'),
                  False),
    "dropped": (_committed, "drop", False),
}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", list(CHANNEL))
def test_channel_is_read_alike_by_both_packages(writer, case, tmp_path):
    """Either package's pointer reads into the same fields through both
    readers, and both refuse a damaged pointer or an uncommitted
    checkpoint alike."""
    make_path, damage, accepted = CHANNEL[case]
    w = PKGS[writer]
    ch = tmp_path / "chan"
    path = make_path(tmp_path)
    if damage == "drop":
        w.failpoints.arm("rollout.publish", "drop", count=1)
    w.rollout.publish_checkpoint(str(ch), version="v7", path=path, step=7)
    if callable(damage):
        damage(ch)
    got = {name: _fields(p.rollout.read_latest(str(ch))) for name, p in PKGS.items()}
    assert got["jax"] == got["port"]
    assert (got["port"] is not None) == accepted, got
    if accepted:
        assert got["port"] == ("v7", "full", path, 7)
    if damage == "drop":  # the next publish lands
        w.rollout.publish_checkpoint(str(ch), version="v8", path=path)
        assert {p.rollout.read_latest(str(ch)).version for p in PKGS.values()} == {"v8"}


def test_lora_publications_are_refused_naming_a10(tmp_path):
    """LoRA pointers are no longer refused: one the JAX package publishes
    reads in the port as kind 'lora' and the other way round, a LoRA
    update builds, and a weight set without adapters has no LoRA payload.
    Only an unknown kind is refused."""
    ch, ck = str(tmp_path / "chan"), _committed(tmp_path)
    j_rollout.publish_checkpoint(ch, version="a1", path=ck, kind="lora")
    assert j_rollout.read_latest(ch).kind == "lora"
    got = t_rollout.read_latest(ch)
    assert (got.version, got.kind, got.path) == ("a1", "lora", ck)
    t_rollout.publish_checkpoint(ch, version="a2", path=ck, kind="lora")
    assert j_rollout.read_latest(ch).kind == t_rollout.read_latest(ch).kind == "lora"
    assert t_rollout.WeightsUpdate(version="a3", kind="lora", path=ck).kind == "lora"
    assert t_rollout.lora_state({}) is None
    with pytest.raises(ValueError, match="kind"):
        t_rollout.WeightsUpdate(version="a4", kind="delta", path=ck)
    with pytest.raises(ValueError, match="kind"):
        t_rollout.publish_checkpoint(ch, version="a5", path=ck, kind="delta")


def test_update_owns_a_snapshot_cast_once():
    """A WeightsUpdate copies its params: later in-place writes of the
    caller's tensors or arrays do not reach it, and dtypes are kept. The
    snapshot ``publish`` takes casts floating leaves to the engines' dtype
    and keeps the others'."""
    import numpy as np

    live = {"w": torch.ones(3), "ids": torch.arange(3), "host": np.full(2, 2.0, np.float32)}
    upd = t_rollout.WeightsUpdate(version="v1", params=live)
    snap = t_rollout._snapshot(live, torch.bfloat16)
    live["w"].add_(5)
    live["ids"].add_(5)
    live["host"] += 5
    assert upd.params["w"].dtype == torch.float32 and torch.equal(upd.params["w"], torch.ones(3))
    assert upd.params["w"].data_ptr() != live["w"].data_ptr()
    assert torch.equal(upd.params["ids"], torch.arange(3))
    assert torch.equal(upd.params["host"], torch.full((2,), 2.0))
    assert snap["w"].dtype == torch.bfloat16 and torch.equal(snap["w"],
                                                             torch.ones(3, dtype=torch.bfloat16))
    assert snap["ids"].dtype == torch.int64 and torch.equal(snap["ids"], torch.arange(3))
    assert torch.equal(snap["host"], torch.full((2,), 2.0, dtype=torch.bfloat16))


# -- the controller over scripted stubs (the reference's doubles) ----------------


class _StubMetrics:
    def render(self):
        return "# TYPE stub_up gauge\nstub_up 1\n"


class _StubEngine:
    """Engine-shaped double with a scriptable hot-swap surface (the
    reference test's ``_StubEngine``)."""

    def __init__(self, events, label, version="v0"):
        self.label = label  # the seat, or the order of a later build
        self.version = str(version)
        self.live = True
        self.ready = True
        self.swap_log = []
        self.swap_error = None
        self.swap_error_once = None
        self.probe_error = None
        self.probe_kwargs = []
        self.not_ready_health_calls = 0
        self._pending_not_ready = 0
        self.health_calls = 0
        self.unresolved_count = 0
        self.closed = False
        self.metrics = _StubMetrics()
        self._events = events

    def warmup(self):
        pass

    def health(self):
        self.health_calls += 1
        ready = self.ready
        if self._pending_not_ready > 0:
            self._pending_not_ready -= 1
            ready = False
        return {"live": self.live, "ready": ready, "weights_version": self.version}

    def stats(self):
        return {"slots": 2, "slots_busy": 0, "queue_depth": 0, "watchdog_fires": 0,
                "weights_version": self.version, "unresolved": self.unresolved_count}

    def unresolved(self):
        return self.unresolved_count

    def current_weights(self):
        return self.version, {"w": self.version}

    def swap_weights(self, new_params, *, version, kind="full", timeout=120.0):
        if self.swap_error_once is not None:
            err, self.swap_error_once = self.swap_error_once, None
            raise err
        if self.swap_error is not None:
            raise self.swap_error
        self.swap_log.append((str(version), kind))
        self._events.append(("swap", self.label, str(version)))
        self.version = str(version)
        self._pending_not_ready = self.not_ready_health_calls
        return self.version

    def submit(self, tokens, max_new_tokens, **kw):
        self.probe_kwargs.append(dict(kw))
        if self.probe_error is not None:
            raise self.probe_error
        return [7] * int(max_new_tokens)

    def submit_many(self, prompts, max_new_tokens, **kw):
        return [[7] * min(int(max_new_tokens), 3) for _ in prompts]

    def stream(self, tokens, max_new_tokens, **kw):
        raise NotImplementedError

    def close(self, drain=False, drain_timeout=300.0):
        self.closed = True
        self.live = False
        self.ready = False


class _FakeSubprocHandle:
    """Subprocess-shaped replica double: a reload()-only weight surface."""

    kind = "subprocess"

    def __init__(self, rid):
        self.rid = rid
        self.reloads = []
        self.metrics = _StubMetrics()
        self.version = "v0"

    def start(self):
        pass

    def health(self):
        return {"live": True, "ready": True, "weights_version": self.version}

    def stats(self):
        return {"slots": 2, "watchdog_fires": 0, "unresolved": 0}

    def unresolved(self):
        return 0

    def reload(self, *, version, kind="full", path, step=None, timeout=600.0):
        self.reloads.append((version, kind, path))
        self.version = str(version)
        return {"status": "completed", "version": version}

    def terminate(self, drain=True, timeout=30.0):
        pass

    def kill(self):
        pass


class _Run:
    """One scripted run on one package: a stub fleet, its stubs, the event
    log and a controller."""

    def __init__(self, pkg, n=2, **ctl_kw):
        self.pkg = pkg
        self.events = []
        self.stubs = []

        def factory():
            e = _StubEngine(self.events, f"built-{len(self.stubs)}")
            self.stubs.append(e)
            return e

        self.fleet = pkg.fleet.ServingFleet(factory=factory, replicas=n, probe_interval=5.0,
                                            warmup=False, respawn_backoff_s=0.01,
                                            drain_timeout=2.0)
        # the seats boot in parallel: name and order the first stubs by seat
        self.stubs[:] = [v["handle"].engine for v in sorted(self.fleet.views(),
                                                            key=lambda v: v["rid"])]
        for rid, e in enumerate(self.stubs):
            e.label = rid
        orig_hold, orig_release = self.fleet.hold_seat, self.fleet.release_seat

        def hold(rid, reason="rollout"):
            self.events.append(("hold", rid))
            return orig_hold(rid, reason)

        def release(rid):
            self.events.append(("release", rid))
            return orig_release(rid)

        self.fleet.hold_seat, self.fleet.release_seat = hold, release
        ctl_kw.setdefault("drain_timeout", 2.0)
        ctl_kw.setdefault("verify_timeout", 2.0)
        self.ctl_kw = ctl_kw
        self._ctl = None

    @property
    def ctl(self):
        if self._ctl is None:
            self._ctl = self.pkg.rollout.RolloutController(self.fleet, **self.ctl_kw)
        return self._ctl

    def wait(self, pred, timeout=10.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not pred():
            time.sleep(0.02)
        return pred()

    def record(self, **extra):
        gauge = {}
        for line in self.fleet.metrics.render().splitlines():
            if line.startswith("fleet_weights_version{"):
                labels, val = line[len("fleet_weights_version"):].rsplit(" ", 1)
                gauge[labels] = float(val)
        st = self.ctl.stats()
        err = st["last_error"]
        return {**extra, "events": list(self.events),
                "versions": [s.version for s in self.stubs],
                "swap_logs": [s.swap_log for s in self.stubs],
                "states": self.fleet.states(), "gauge": gauge,
                "stats": {**st, "last_error": err and err["type"]}}


def _order(run):
    return {"outcome": run.ctl.publish({"w": 1}, version="v1")}


def _rejoin_gated(run):
    for s in run.stubs:
        s.not_ready_health_calls = 3
    out = run.ctl.publish({"w": 1}, version="v1")
    return {"outcome": out, "polled": all(s.health_calls >= 3 for s in run.stubs)}


def _drain_waits(run):
    run.stubs[0].unresolved_count = 1

    def finish():
        time.sleep(0.3)
        run.stubs[0].unresolved_count = 0

    import threading

    threading.Thread(target=finish, daemon=True).start()
    t0 = time.monotonic()
    out = run.ctl.publish({"w": 1}, version="v1")
    return {"outcome": out, "waited": time.monotonic() - t0 >= 0.25}


def _drain_timeout(run):
    run.ctl_kw["drain_timeout"] = 0.3
    run.stubs[0].unresolved_count = 7
    return {"outcome": run.ctl.publish({"w": 1}, version="v1")}


def _failed_warmup(run):
    run.stubs[1].probe_error = RuntimeError("decode exploded")
    return {"outcome": run.ctl.publish({"w": 1}, version="v1")}


def _health_regression(run):
    run.ctl_kw["verify_timeout"] = 0.4
    run.stubs[1].not_ready_health_calls = 10_000
    out = run.ctl.publish({"w": 1}, version="v1")
    # the regressed seat's restore cannot verify either: it is respawned
    ready = run.pkg.fleet.READY
    settled = run.wait(lambda: run.fleet.states() == {0: ready, 1: ready} and len(run.stubs) == 3)
    return {"outcome": out, "settled": settled}


def _incompatible(run):
    run.stubs[0].swap_error = run.pkg.WeightsIncompatible("shape mismatch")
    return {"outcome": run.ctl.publish({"w": 1}, version="v1")}


def _mixed_version(run):
    run.fleet.hold_seat(1, reason="test")
    out = run.ctl.publish({"w": 1}, version="v1")
    rec = {"outcome": out}
    run.fleet.release_seat(1)
    return rec


def _swap_failpoint(run):
    run.pkg.failpoints.arm("rollout.swap", "raise", count=1)
    return {"outcome": run.ctl.publish({"w": 1}, version="v1")}


def _verify_failpoint(run):
    run.pkg.failpoints.arm("rollout.verify", "raise", count=1)
    return {"outcome": run.ctl.publish({"w": 1}, version="v1")}


def _respawn_resync(run):
    out = run.ctl.publish({"w": 1}, version="v1")
    run.fleet.report_failure(0, "test kill", generation=0)
    synced = run.wait(lambda: run.fleet.states()[0] == run.pkg.fleet.READY
                      and len(run.stubs) >= 3 and run.stubs[-1].version == "v1")
    return {"outcome": out, "synced": synced}


def _lost_seat_skipped(run):
    orig = run.fleet.hold_seat

    def hold(rid, reason="rollout"):
        if rid == 0:
            raise RuntimeError("replica 0 is draining, not ready")
        return orig(rid, reason)

    run.fleet.hold_seat = hold
    return {"outcome": run.ctl.publish({"w": 1}, version="v1")}


def _fresh_handle(run):
    fresh = _StubEngine(run.events, "fresh")
    orig = run.fleet.hold_seat
    done = []

    def hold(rid, reason="rollout"):
        if rid == 0 and not done:
            done.append(True)
            slot = run.fleet._slots[0]
            nh = run.pkg.fleet.InProcessReplica(0, lambda: fresh, warmup=False)
            nh.engine = fresh
            with slot._lock:
                slot.handle = nh
                slot.generation += 1
        return orig(rid, reason)

    run.fleet.hold_seat = hold
    out = run.ctl.publish({"w": 1}, version="v1")
    return {"outcome": out, "fresh": fresh.version, "orphan_log": run.stubs[0].swap_log}


def _straggler(run):
    real = run.fleet.views
    calls = [0]

    def views():
        out = real()
        calls[0] += 1
        if calls[0] == 1:
            for v in out:
                if v["rid"] == 1:
                    v["state"] = run.pkg.fleet.DRAINING
        return out

    run.fleet.views = views
    return {"outcome": run.ctl.publish({"w": 1}, version="v1")}


def _warmup_deadline(run):
    run.ctl_kw["verify_timeout"] = 3.0
    out = run.ctl.publish({"w": 1}, version="v1")
    return {"outcome": out, "deadlines": [s.probe_kwargs[-1].get("deadline_s")
                                          for s in run.stubs]}


def _swap_timeout(run):
    run.stubs[0].swap_error_once = TimeoutError("weight swap not applied within 0.1s")
    return {"outcome": run.ctl.publish({"w": 1}, version="v1")}


def _subprocess_params_only(run, tmp_path):
    fakes = []
    for slot in run.fleet._slots.values():
        with slot._lock:
            fake = _FakeSubprocHandle(slot.rid)
            fakes.append(fake)
            slot.handle = fake
    first = run.ctl.publish({"w": 1}, version="v1")
    touched = [list(f.reloads) for f in fakes]
    ck = _committed(tmp_path)
    second = run.ctl.publish(version="v2", path=ck)
    return {"outcome": (first, second), "touched_first": touched,
            "reloads": [[(v, k, p == ck) for v, k, p in f.reloads] for f in fakes]}


def _nothing_swappable(run):
    run.fleet.hold_seat(0, reason="test")
    run.fleet.hold_seat(1, reason="test")
    out = run.ctl.publish({"w": 1}, version="v1")
    run.fleet.release_seat(0)
    run.fleet.release_seat(1)
    return {"outcome": out}


def _watcher(run, tmp_path, restart):
    ch = str(tmp_path / "chan")
    ck = _committed(tmp_path)
    run.ctl_kw.update(channel_dir=ch, loader=lambda upd: {"path": upd.path}, poll_interval=0.05)
    hooks = []
    run.ctl.start()
    if restart:
        run.ctl.stop()
        hooks.append(run.fleet.rollout_hook is None)
        run.ctl.start()
        hooks.append(run.fleet.rollout_hook is not None)
    run.pkg.rollout.publish_checkpoint(ch, version="v1", path=ck)
    rolled = run.wait(lambda: all(s.version == "v1" for s in run.stubs))
    run.ctl.stop()
    return {"outcome": rolled, "hooks": hooks}


SCRIPTS = {
    "one_seat_at_a_time_under_hold": _order,
    "rejoin_gated_on_readiness": _rejoin_gated,
    "drain_waits_for_quiescence": _drain_waits,
    "drain_timeout_rolls_back": _drain_timeout,
    "failed_warmup_rolls_back": _failed_warmup,
    "health_regression_rolls_back": _health_regression,
    "weights_incompatible_rolls_back": _incompatible,
    "mixed_version_fleet": _mixed_version,
    "swap_failpoint_before_any_seat": _swap_failpoint,
    "verify_failpoint_restores_swapped_seat": _verify_failpoint,
    "respawned_replica_resyncs": _respawn_resync,
    "lost_seat_skipped_not_rolled_back": _lost_seat_skipped,
    "swap_uses_fresh_handle": _fresh_handle,
    "straggler_converges": _straggler,
    "warmup_probe_deadline_bounded": _warmup_deadline,
    "swap_timeout_takes_restore_path": _swap_timeout,
    "params_only_on_subprocess_fleet_fails_fast": _subprocess_params_only,
    "no_swappable_seat_is_failed": _nothing_swappable,
    "watcher_rolls_new_versions": lambda run, tmp: _watcher(run, tmp, restart=False),
    "watcher_restarts_after_stop": lambda run, tmp: _watcher(run, tmp, restart=True),
}
CONVERGED = ("one_seat_at_a_time_under_hold", "rejoin_gated_on_readiness",
             "drain_waits_for_quiescence", "respawned_replica_resyncs", "straggler_converges",
             "swap_uses_fresh_handle", "warmup_probe_deadline_bounded")
WANT = {  # the reference test's verdicts, held on both packages
    "one_seat_at_a_time_under_hold": "completed",
    "rejoin_gated_on_readiness": "completed",
    "drain_waits_for_quiescence": "completed",
    "drain_timeout_rolls_back": "rolled_back",
    "failed_warmup_rolls_back": "rolled_back",
    "health_regression_rolls_back": "rolled_back",
    "weights_incompatible_rolls_back": "rolled_back",
    "mixed_version_fleet": "completed",
    "swap_failpoint_before_any_seat": "rolled_back",
    "verify_failpoint_restores_swapped_seat": "rolled_back",
    "respawned_replica_resyncs": "completed",
    "lost_seat_skipped_not_rolled_back": "completed",
    "swap_uses_fresh_handle": "completed",
    "straggler_converges": "completed",
    "warmup_probe_deadline_bounded": "completed",
    "swap_timeout_takes_restore_path": "rolled_back",
    "params_only_on_subprocess_fleet_fails_fast": ("failed", "completed"),
    "no_swappable_seat_is_failed": "failed",
    "watcher_rolls_new_versions": True,
    "watcher_restarts_after_stop": True,
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_controller_matches_the_reference_on_stub_fleets(script, tmp_path):
    """The same stub script through both packages' fleet and controller:
    the same outcome (the reference test's verdict), the same holds,
    releases and swaps in the same order, the same versions, states,
    gauge values and stats."""
    fn = SCRIPTS[script]
    records = {}
    for name, pkg in PKGS.items():
        run = _Run(pkg)
        try:
            args = (run, tmp_path / name) if fn.__code__.co_argcount == 2 else (run,)
            records[name] = run.record(**fn(*args))
        finally:
            run.fleet.close()
    assert records["port"] == records["jax"]
    rec = records["port"]
    assert rec["outcome"] == WANT[script], rec
    assert all(v is not False for k, v in rec.items()
               if k in ("polled", "waited", "synced", "settled"))
    if script in CONVERGED:
        assert set(rec["gauge"].values()) == {rec["stats"]["version_ordinals"]["v1"]}
    if script == "one_seat_at_a_time_under_hold":
        assert [e for e in rec["events"] if e[0] != "swap"] == [
            ("hold", 0), ("release", 0), ("hold", 1), ("release", 1)]
    if WANT[script] == "rolled_back":
        assert rec["versions"][:2] == ["v0", "v0"] and rec["stats"]["target_version"] is None


def test_chip_smoke_rollout_phase_rehearses_on_cpu(capsys):
    """chip_smoke's phase rollout, parts (a) and (b), runs on the CPU at a
    tiny size: every check passes — the trainer's checkpoint rolled across
    an in-process fleet under traffic, the L2 under the new version, the
    five rollback cases — and no kernel is launched. Parts (c) and (d)
    start servers and children; the server tests of
    ``tests/test_torch_rollout_serve.py`` hold their surfaces here."""
    import importlib.util
    from pathlib import Path

    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sizes = {"min_len": 4, "max_len": 30, "widths": (8, 16, 32), "slots": 3, "block": 4,
             "chunk": 8, "prefix": 4, "budget": 24, "l2_prompt": 24, "l2_tail": 4, "l2_new": 6,
             "probe_s": 0.2, "drain_s": 20.0, "ready_wait_s": 120.0, "train_batch": 2,
             "train_seq": 32, "lr": 3e-2, "roll_requests": 6, "roll_threads": 2, "roll_new": 6,
             "fixed": 6, "fixed_len": (4, 20), "fixed_new": 8, "poll_s": 0.05,
             "torn_wait_s": 1.0, "roll_wait_s": 120.0, "truncate_bytes": 4096}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops; the other xdist workers share the cores
    try:
        launches = smoke.phase_rollout(fa, layers=2, parts="ab",
                                       rehearse={"device": "cpu", "tiny": True, "sizes": sizes})
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    check = lines[-1]
    assert check["case"] == "rollout_checks" and check["ok"]
    assert sorted(check["checks"]) == [
        "a_l2", "a_roll", "b1_shape_cut", "b2_truncated", "b3_verify_seat1", "b4_torn_latest",
        "b5_publish_snapshot", "tokens_changed", "train"]
    assert check["err"]["a_roll"]["stamps"].get("v1", 0) >= 1
    assert lines[-2]["part"] == "numbers"
    assert launches == {"fwd": 0, "dq": 0, "dkv": 0, "pair": 0, "cross": 0}
