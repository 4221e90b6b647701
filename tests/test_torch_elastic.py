"""The port's elastic membership (``compute/elastic.py``, the context's
rebind, ``run(elastic=True)``) against the JAX package's.

- The membership watcher: the same notify sequence (stale and duplicate
  epochs included) gives the same returns, views and waits on both sides.
- Host snapshots and reshards round-trip byte for byte, every dtype kept
  (fp32 params, bf16 moments, an int32 count), for plain tensors, for
  DTensors on a one-rank mesh, and on 2 gloo ranks under ZeRO, where a
  sharded leaf refuses the in-memory path without a collective and the
  trainer falls back to the sharded checkpoint onto ``fsdp=2``. A
  single-controller trainer keeps its state plain on its own device and
  publishes the snapshot its reconfigure resharded from.
- Each ``ElasticTrainer`` scenario of the JAX package's
  ``tests/test_elastic.py`` runs on both sides with a fake context: the
  same outcomes, epochs, ``resume_step`` and recovery-counter deltas.
- A tiny fp32 Llama trains across a reconfigure (in memory, and by the
  checkpoint fallback with its rewind): its losses equal the port's
  uninterrupted run bit for bit and JAX's elastic run of the same weights
  within rtol 1e-5 (the tolerance of ``test_torch_train.py``).
- Two CPU nodes of the port's ``tfcluster.run(elastic=True)``: one is
  SIGKILLed, the survivor reshards at epoch 1 and runs every step once;
  its final params equal the port's uninterrupted run bit for bit and JAX's
  ``elastic_reference_params`` within 1e-6.
- 3 → 2 gloo ranks with ``distributed=True``: executor 2, then executor 0,
  leaves; the survivors rebind to a world of 2 and restore a ZeRO
  checkpoint onto ``fsdp=2``.
"""

import json
import os
import pickle
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu.cluster import manager as jmanager
from tensorflowonspark_tpu.compute import TrainState as JTrainState
from tensorflowonspark_tpu.compute import build_train_step as jbuild_train_step
from tensorflowonspark_tpu.compute import elastic as jelastic
from tensorflowonspark_tpu.compute import optim as joptim
from tensorflowonspark_tpu.compute.checkpoint import CheckpointManager as JCheckpointManager
from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu.obs.registry import default_registry as jregistry
from tensorflowonspark_tpu.utils import failpoints as jfp
from tensorflowonspark_tpu_torch.cluster import context as tcontext
from tensorflowonspark_tpu_torch.cluster import manager as tmanager
from tensorflowonspark_tpu_torch.cluster import tfcluster
from tensorflowonspark_tpu_torch.cluster.tfcluster import InputMode
from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step, sgd
from tensorflowonspark_tpu_torch.compute import elastic as telastic
from tensorflowonspark_tpu_torch.compute.checkpoint import CheckpointManager
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models.convert import params_from_jax
from tensorflowonspark_tpu_torch.obs.registry import default_registry as tregistry
from tensorflowonspark_tpu_torch.parallel.context import is_dtensor
from tensorflowonspark_tpu_torch.utils import failpoints as tfp
from tensorflowonspark_tpu_torch.utils.util import cpu_only_env

from tests import cluster_fns, torch_elastic_fns

NODE_ENV = {**cpu_only_env(), "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def _clean_elastic_state():
    for mod in (jelastic, telastic):
        mod._watcher.reset()
    jfp.disarm_all()
    tfp.disarm_all()
    group_before = torch.distributed.is_initialized()
    yield
    for mod in (jelastic, telastic):
        mod._watcher.reset()
    jfp.disarm_all()
    tfp.disarm_all()
    # a trainer's mesh starts a group of one in this process: end it
    if not group_before and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _meta(eid, port=1):
    return {"executor_id": eid, "host": "127.0.0.1", "port": port,
            "job_name": "chief" if eid == 0 else "worker", "task_index": max(0, eid - 1),
            "addr": ["127.0.0.1", port], "authkey": "00"}


class _FakeCtx:
    distributed = False
    device = "cpu"

    def __init__(self, mgr=None, executor_id=0, cluster_info=()):
        self.mgr = mgr
        self.executor_id = executor_id
        self.cluster_info = list(cluster_info)
        self.reinit_calls = []

    def reinitialize_distributed(self, roster):
        self.reinit_calls.append(list(roster))


# -- the membership watcher ------------------------------------------------------


def _watcher_trace(mod):
    w = mod.MembershipWatcher()
    r = lambda *ids: [{"executor_id": i} for i in ids]  # noqa: E731
    trace = [w.current(), w.wait_for_epoch(0, 0.01), w.wait_for_epoch(1, 0.01)]
    for epoch, roster in [(0, r(0, 1)), (0, r(7)), (1, r(0)), (1, r(9)), (1, r(0)),
                          (3, r(0, 2)), (2, r(5)), (3, r(0, 2)), (4, [])]:
        trace.append(w.notify(epoch, roster))
        trace.append(w.current())
        trace.append([w.wait_for_epoch(e, 0.01) for e in (1, 3, 4, 5)])
    waited = []
    t = threading.Thread(target=lambda: waited.append(w.wait_for_epoch(6, timeout=10)))
    t.start()
    time.sleep(0.05)
    trace.append(w.notify(6, r(0, 1)))
    t.join(10)
    trace.append(waited)
    w.reset()
    trace.append(w.current())
    # the module-level surface over the process watcher
    trace.append([mod.membership(), mod.current_epoch()])
    trace.append(mod.notify_membership(2, r(0)))
    trace.append([mod.membership(), mod.current_epoch(), mod.wait_for_epoch(2, 0.01),
                  mod.wait_for_epoch(3, 0.01)])
    return trace


def test_watcher_matches_jax():
    """Tolerance: equal (returns, rosters, epochs and waits)."""
    assert _watcher_trace(telastic) == _watcher_trace(jelastic)
    assert "cluster_membership_epoch 2" in tregistry().render()


# -- host snapshots and reshards -------------------------------------------------


def _leaves(tree) -> list[torch.Tensor]:
    out: list = []
    telastic._tree_map(lambda t: out.append(t.to_local() if is_dtensor(t) else t), tree)
    return out


def _bytes(tree) -> list:
    return [(str(t.dtype), t.detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
            for t in _leaves(tree)]


def _adam_state():
    """fp32 params, bf16 moments after one update (nonzero), int32 count."""
    params = {"w": torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16) / 9,
              "b": torch.arange(16, dtype=torch.float32) / 7}
    tx = adamw(1e-2, moment_dtype=torch.bfloat16)
    state = TrainState.create(params, tx)
    grads = {k: torch.full_like(v, 0.3) for k, v in params.items()}
    _, state.opt_state = tx.update(grads, state.opt_state, state.params)
    return state, tx, grads


def test_snapshot_roundtrip_keeps_every_dtype_and_byte():
    """Tolerance: byte-identical. The snapshot is a copy (a later in-place
    update leaves it as it was), bf16 stays bf16, and the bf16 leaves'
    bytes equal the JAX package's snapshot of the same values."""
    state, tx, grads = _adam_state()
    before = _bytes(state)
    snap = telastic.host_snapshot(state)
    assert _bytes(snap) == before
    assert sorted({dt for dt, _ in before}) == ["torch.bfloat16", "torch.float32", "torch.int32"]
    updates, _ = tx.update(grads, state.opt_state, state.params)
    for k in state.params:
        state.params[k].add_(updates[k])
    assert _bytes(snap) == before != _bytes(state)
    back = telastic.reshard_state(snap, torch.device("cpu"))
    assert _bytes(back) == before
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(_leaves(back), _leaves(snap)))
    mu = snap.opt_state[0].mu
    jsnap = jelastic.host_snapshot(
        {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) for k, v in mu.items()})
    assert {k: np.asarray(v).tobytes() for k, v in jsnap.items()} == \
        {k: v.reshape(-1).view(torch.uint8).numpy().tobytes() for k, v in mu.items()}


def test_snapshot_roundtrip_of_dtensors_on_one_rank():
    """Tolerance: byte-identical; the placed state is DTensors."""
    from tensorflowonspark_tpu_torch.compute.mesh import make_mesh

    state, _, _ = _adam_state()
    before = _bytes(state)
    mesh = make_mesh({"fsdp": -1}, device_type="cpu")
    placed = telastic.reshard_state(state, telastic.default_shardings_fn(state, mesh))
    assert is_dtensor(placed.params["w"]) and is_dtensor(placed.opt_state[0].mu["w"])
    snap = telastic.host_snapshot(placed)
    assert not any(is_dtensor(t) for t in _leaves(snap))
    assert _bytes(snap) == _bytes(placed) == before
    again = telastic.reshard_state(snap, telastic.default_shardings_fn(snap, mesh))
    assert _bytes(again) == before


class _KV(dict):
    """A manager's KV: ``set`` and ``get``."""

    def set(self, key, value):
        self[key] = value


def test_single_controller_reconfigure_keeps_plain_state_and_publishes_its_snapshot(monkeypatch):
    """Tolerance: byte-identical. A single-controller trainer places
    state whole on its own device (plain tensors, not one-rank DTensors),
    and a reconfigure copies the state to the host once: the snapshot it
    publishes is the one it resharded from, labelled with the last step
    handed to ``publish``."""
    kv = _KV()
    trainer = telastic.ElasticTrainer(_FakeCtx(mgr=kv, cluster_info=[_meta(0), _meta(1)]))
    state, _, _ = _adam_state()
    before = _bytes(state)
    trainer.publish(state, 4)
    copies = []
    snapshot = telastic.host_snapshot
    monkeypatch.setattr(telastic, "host_snapshot", lambda s: copies.append(1) or snapshot(s))
    telastic.notify_membership(1, [_meta(0)])
    assert trainer.changed()
    state, _ = trainer.reconfigure(state)
    assert all(not is_dtensor(t) and t.device.type == "cpu" for t in _leaves(state))
    assert _bytes(state) == before
    epoch, step, published = pickle.loads(kv[telastic.STATE_KEY])
    assert (epoch, step, len(copies)) == (1, 4, 1)
    assert _bytes(published) == before


def test_zero_leaf_refuses_snapshot_and_falls_back_to_sharded_checkpoint():
    """2 gloo ranks, ZeRO on ``data=2``: rank 0 alone asks for a snapshot,
    which refuses at once (no collective: rank 1 is not in one); the
    trainer then restores the sharded checkpoint onto ``fsdp=2``, every
    tensor byte-identical."""
    r0, r1 = torch_elastic_fns.run_ranks(torch_elastic_fns.zero_refusal_fn, 2)
    assert r0["refused"] is True and r0["seconds"] < 5
    for r in (r0, r1):
        assert r["outcome"] == "checkpoint_fallback" and r["resume_step"] == 3
        assert r["mesh"]["fsdp"] == 2 and r["mesh"]["data"] == 1
        assert r["unequal"] == []


# -- ElasticTrainer scenarios on both sides ----------------------------------------


class _Side:
    """What a scenario needs of one package."""

    def __init__(self, name):
        self.name = name
        self.elastic = jelastic if name == "jax" else telastic
        self.fp = jfp if name == "jax" else tfp
        self.registry = jregistry if name == "jax" else tregistry
        self.manager = jmanager if name == "jax" else tmanager

    def devices(self, n_per_node=None, fixed=None):
        """``devices_fn``: JAX takes device lists (of the virtual CPU
        devices), the port a rank count (a world of one here)."""
        if self.name == "jax":
            if fixed is not None:
                return lambda roster: jax.devices()[:fixed]
            return lambda roster: jax.devices()[: n_per_node * len(roster)]
        return lambda roster: 1

    def tx(self, kind):
        if self.name == "jax":
            return {"adamw": optax.adamw(1e-2), "momentum": optax.sgd(0.1, momentum=0.9),
                    "sgd": optax.sgd(0.1)}[kind]
        return {"adamw": adamw(1e-2), "momentum": sgd(0.1, momentum=0.9),
                "sgd": sgd(0.1)}[kind]

    def state(self, trainer, kind):
        e = self.elastic
        if self.name == "jax":
            params = {"w": jnp.arange(8 * 16, dtype=jnp.float32).reshape(8, 16),
                      "b": jnp.arange(16, dtype=jnp.float32)}
            state = JTrainState.create(params, self.tx(kind))
        else:
            params = {"w": torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16),
                      "b": torch.arange(16, dtype=torch.float32)}
            state = TrainState.create(params, self.tx(kind))
        return e.reshard_state(state, e.default_shardings_fn(state, trainer.mesh()))

    def save(self, directory, step, state):
        cls = JCheckpointManager if self.name == "jax" else CheckpointManager
        with cls(directory, async_save=False) as ck:
            ck.save(step, state, force=True)

    def hex(self, tree):
        if self.name == "jax":
            return [np.asarray(x).tobytes().hex() for x in jax.tree.leaves(jax.device_get(tree))]
        return [b.hex() for _, b in _bytes(tree)]

    def count(self, outcome):
        for line in self.registry().render().splitlines():
            if line.startswith("elastic_recoveries_total") and f'"{outcome}"' in line:
                return float(line.rsplit(" ", 1)[1])
        return 0.0


def sc_reconfigure_reshards(S, tmp_path, monkeypatch):
    roster2 = [_meta(0), _meta(1)]
    ctx = _FakeCtx(cluster_info=roster2)
    trainer = S.elastic.ElasticTrainer(ctx, axis_shapes={"fsdp": -1},
                                       devices_fn=S.devices(n_per_node=2))
    state = S.state(trainer, "adamw")
    before = S.hex(state)
    obs = {"changed_before": trainer.changed()}
    base = S.count("resharded")
    S.elastic.notify_membership(1, [_meta(0)])
    obs["changed"] = trainer.changed()
    state, _ = trainer.reconfigure(state)
    obs.update(epoch=trainer.epoch, resume_step=trainer.resume_step,
               reinit=[[n["executor_id"] for n in r] for r in ctx.reinit_calls],
               identical=S.hex(state) == before, delta=S.count("resharded") - base)
    S.elastic.notify_membership(2, roster2)
    state, _ = trainer.reconfigure(state)
    obs.update(epoch2=trainer.epoch, identical2=S.hex(state) == before,
               delta2=S.count("resharded") - base,
               histogram="elastic_reshard_seconds" in S.registry().render())
    return obs


def sc_gather_failure_falls_back(S, tmp_path, monkeypatch):
    ctx = _FakeCtx(cluster_info=[_meta(0)])
    trainer = S.elastic.ElasticTrainer(ctx, axis_shapes={"fsdp": -1},
                                       checkpoint_dir=str(tmp_path / "ckpt"),
                                       devices_fn=S.devices(fixed=2))
    state = S.state(trainer, "momentum")
    S.save(str(tmp_path / "ckpt"), 7, state)
    before = S.hex(state)
    base = S.count("checkpoint_fallback")
    S.fp.arm("elastic.reshard_gather", "raise", count=1)
    S.elastic.notify_membership(1, [_meta(0)])
    state, _ = trainer.reconfigure(state)
    return {"identical": S.hex(state) == before, "resume_step": trainer.resume_step,
            "epoch": trainer.epoch, "delta": S.count("checkpoint_fallback") - base}


def sc_no_checkpoint_is_loud(S, tmp_path, monkeypatch):
    trainer = S.elastic.ElasticTrainer(_FakeCtx(cluster_info=[_meta(0)]),
                                       devices_fn=S.devices(fixed=2))
    state = S.state(trainer, "sgd")
    base = S.count("failed")
    S.fp.arm("elastic.reshard_gather", "raise", count=1)
    S.elastic.notify_membership(1, [_meta(0)])
    with pytest.raises(RuntimeError, match="no checkpoint_dir") as e:
        trainer.reconfigure(state)
    return {"raised": type(e.value).__name__, "delta": S.count("failed") - base,
            "epoch": trainer.epoch}


def sc_removed_node_refuses(S, tmp_path, monkeypatch):
    trainer = S.elastic.ElasticTrainer(_FakeCtx(executor_id=1, cluster_info=[_meta(0), _meta(1)]),
                                       devices_fn=S.devices(fixed=2))
    state = S.state(trainer, "sgd")
    S.elastic.notify_membership(1, [_meta(0)])
    changed = trainer.changed()
    with pytest.raises(RuntimeError, match="was removed"):
        trainer.reconfigure(state)
    return {"changed": changed, "epoch": trainer.epoch}


def sc_preadmission_bump_is_not_a_change(S, tmp_path, monkeypatch):
    trainer = S.elastic.ElasticTrainer(_FakeCtx(executor_id=2, cluster_info=[_meta(0)]),
                                       devices_fn=S.devices(fixed=2))
    S.elastic.notify_membership(1, [_meta(0)])
    first = trainer.changed()
    S.elastic.notify_membership(2, [_meta(0), _meta(2)])
    return {"departure": first, "admission": trainer.changed()}


def sc_replacement_ignores_departure_bump(S, tmp_path, monkeypatch):
    trainer = S.elastic.ElasticTrainer(_FakeCtx(executor_id=1, cluster_info=[_meta(0), _meta(1)]),
                                       devices_fn=S.devices(fixed=2))
    step, state = trainer.hydrate()
    obs = {"hydrated": (step, state)}
    S.elastic.notify_membership(1, [_meta(0)])
    obs["departure"] = trainer.changed()
    S.elastic.notify_membership(2, [_meta(0), _meta(1)])
    obs["admission"] = trainer.changed()
    st2, _ = trainer.reconfigure(S.state(trainer, "sgd"))
    obs["epoch"] = trainer.epoch
    S.elastic.notify_membership(3, [_meta(0)])
    obs["later_exclusion"] = trainer.changed()
    with pytest.raises(RuntimeError, match="was removed"):
        trainer.reconfigure(st2)
    return obs


def sc_admission_wait_is_bounded(S, tmp_path, monkeypatch):
    trainer = S.elastic.ElasticTrainer(_FakeCtx(executor_id=1, cluster_info=[_meta(0), _meta(1)]),
                                       devices_fn=S.devices(fixed=2))
    trainer.hydrate()
    S.elastic.notify_membership(1, [_meta(0)])
    obs = {"first_excluded": trainer.changed()}
    S.elastic.notify_membership(3, [_meta(0)])
    obs["second_excluded"] = trainer.changed()
    with pytest.raises(RuntimeError, match="was removed"):
        trainer.reconfigure(S.state(trainer, "sgd"))
    # the wall-clock bound alone also lifts the suppression
    S.elastic._watcher.reset()
    monkeypatch.setattr(S.elastic.ElasticTrainer, "ADMISSION_GRACE_S", 1.0)
    trainer2 = S.elastic.ElasticTrainer(
        _FakeCtx(executor_id=1, cluster_info=[_meta(0), _meta(1)]), devices_fn=S.devices(fixed=2))
    trainer2.hydrate()
    S.elastic.notify_membership(1, [_meta(0)])
    obs["within_grace"] = trainer2.changed()
    time.sleep(1.1)
    obs["after_grace"] = trainer2.changed()
    return obs


def sc_hydrate_from_peer_then_fallbacks(S, tmp_path, monkeypatch):
    authkey = b"\x01" * 16
    peer_mgr = S.manager.start(authkey, mode="remote")
    try:
        peer_meta = {**_meta(0), "addr": list(peer_mgr.address), "authkey": authkey.hex()}
        publisher = S.elastic.ElasticTrainer(
            _FakeCtx(mgr=peer_mgr, executor_id=0, cluster_info=[peer_meta]),
            devices_fn=S.devices(fixed=2))
        state = S.state(publisher, "momentum")
        publisher.publish(state, 42)
        joiner = S.elastic.ElasticTrainer(_FakeCtx(executor_id=1, cluster_info=[peer_meta]),
                                          devices_fn=S.devices(fixed=2))
        base = {k: S.count(k) for k in ("peer_hydrate", "fresh_init", "checkpoint_fallback")}
        step, hydrated = joiner.hydrate()
        obs = {"peer": (step, S.hex(hydrated) == S.hex(state))}
        lonely = S.elastic.ElasticTrainer(_FakeCtx(executor_id=1, cluster_info=[]),
                                          devices_fn=S.devices(fixed=2))
        obs["lonely"] = lonely.hydrate(default="sentinel")
        S.save(str(tmp_path / "ckpt"), 5, S.elastic.host_snapshot(state))
        fallback = S.elastic.ElasticTrainer(_FakeCtx(executor_id=1, cluster_info=[]),
                                            checkpoint_dir=str(tmp_path / "ckpt"),
                                            devices_fn=S.devices(fixed=2))
        step, hydrated = fallback.hydrate(default=S.elastic.host_snapshot(state))
        obs["checkpoint"] = (step, S.hex(hydrated) == S.hex(state))
        obs["deltas"] = {k: S.count(k) - v for k, v in base.items()}
        S.fp.arm("elastic.rejoin_init", "raise", count=1)
        with pytest.raises(S.fp.FailpointError):
            joiner.hydrate()
        return obs
    finally:
        peer_mgr.stop()


SCENARIOS = {
    "reconfigure_reshards": (sc_reconfigure_reshards, {
        "changed_before": False, "changed": True, "epoch": 1, "resume_step": None,
        "reinit": [[0]], "identical": True, "delta": 1, "epoch2": 2, "identical2": True,
        "delta2": 2, "histogram": True}),
    "gather_failure_falls_back": (sc_gather_failure_falls_back, {
        "identical": True, "resume_step": 7, "epoch": 1, "delta": 1}),
    "no_checkpoint_is_loud": (sc_no_checkpoint_is_loud, {
        "raised": "RuntimeError", "delta": 1, "epoch": 1}),
    "removed_node_refuses": (sc_removed_node_refuses, {"changed": True, "epoch": 0}),
    "preadmission_bump_is_not_a_change": (sc_preadmission_bump_is_not_a_change, {
        "departure": False, "admission": True}),
    "replacement_ignores_departure_bump": (sc_replacement_ignores_departure_bump, {
        "hydrated": (None, None), "departure": False, "admission": True, "epoch": 2,
        "later_exclusion": True}),
    "admission_wait_is_bounded": (sc_admission_wait_is_bounded, {
        "first_excluded": False, "second_excluded": True, "within_grace": False,
        "after_grace": True}),
    "hydrate_from_peer_then_fallbacks": (sc_hydrate_from_peer_then_fallbacks, {
        "peer": (42, True), "lonely": (None, "sentinel"), "checkpoint": (5, True),
        "deltas": {"peer_hydrate": 1, "fresh_init": 1, "checkpoint_fallback": 1}}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_trainer_scenario_matches_jax(name, tmp_path, monkeypatch):
    """Tolerance: equal observations (outcome, epoch, resume_step, counter
    deltas, byte identity) on both sides, and the expected ones."""
    fn, expected = SCENARIOS[name]
    got = {}
    for side in ("jax", "port"):
        for mod in (jelastic, telastic):
            mod._watcher.reset()
        got[side] = fn(_Side(side), tmp_path / side, monkeypatch)
    assert got["port"] == got["jax"] == expected


# -- training across a reconfigure ------------------------------------------------

SEQ, K, CKPT_STEP = 16, 3, 1


def _llama_setup():
    common = dict(hidden_size=64, intermediate_size=128, num_heads=4, num_kv_heads=2,
                  num_layers=2, max_seq_len=SEQ, remat=False)
    jcfg = jllama.LlamaConfig.tiny(**common, dtype=jnp.float32, attention_impl="xla")
    tcfg = tllama.LlamaConfig.tiny(**common, dtype=torch.float32, attention_impl="flash")
    jmodel = jllama.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    return jmodel, jax.tree.map(np.asarray, params), tcfg


def _tokens(i):
    return np.random.default_rng(100 + i).integers(0, 256, size=(2, SEQ + 1)).astype(np.int32)


def _loop(side, trainer, state, step_fn, mode, ckpt_dir, rebuild):
    """2K steps; at step K a membership change (``mode`` "memory" or
    "fallback", after a checkpoint of step CKPT_STEP), or none."""
    losses, i = [], 0
    while i < 2 * K:
        if i == K and mode != "none" and trainer.epoch == 0:
            if mode == "fallback":
                side.fp.arm("elastic.reshard_gather", "raise", count=1)
            side.elastic.notify_membership(1, [_meta(0)])
            state, mesh = trainer.reconfigure(state)
            step_fn = rebuild(mesh)
            if trainer.resume_step is not None:
                i = trainer.resume_step
        state, loss = step_fn(state, {"tokens": _tokens(i)})
        losses.append((i, float(loss)))
        if mode == "fallback" and i + 1 == CKPT_STEP and trainer.epoch == 0:
            side.save(ckpt_dir, CKPT_STEP, state)
        i += 1
    return losses


def _run_port(params, tcfg, mode, ckpt_dir):
    side = _Side("port")
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    tx = adamw(1e-3, eps=1e-6)
    loss = tllama.llama_loss_fn(model)
    trainer = telastic.ElasticTrainer(_FakeCtx(cluster_info=[_meta(0)]), devices_fn=lambda r: 1,
                                      checkpoint_dir=ckpt_dir)
    # a single-controller node: plain tensors on its own device, whatever the mesh
    state = TrainState.create(model.named_parameters(), tx)

    def rebuild(_mesh):
        return build_train_step(lambda p, b: loss(p, b["tokens"]), tx, device="cpu")

    return _loop(side, trainer, state, rebuild(trainer.mesh()), mode, ckpt_dir, rebuild)


def _run_jax(jmodel, params, mode, ckpt_dir):
    side = _Side("jax")
    tx = joptim.adamw(1e-3, eps=1e-6)
    loss = jllama.llama_loss_fn(jmodel)
    trainer = jelastic.ElasticTrainer(_FakeCtx(cluster_info=[_meta(0)]),
                                      devices_fn=lambda r: jax.devices()[:1],
                                      checkpoint_dir=ckpt_dir)
    state = JTrainState.create(jax.tree.map(jnp.asarray, params), tx)
    state = jelastic.reshard_state(state, jelastic.default_shardings_fn(state, trainer.mesh()))

    def rebuild(mesh):
        return jbuild_train_step(lambda p, b: loss(p, b["tokens"]), tx, mesh)

    return _loop(side, trainer, state, rebuild(trainer.mesh()), mode, ckpt_dir, rebuild)


@pytest.mark.parametrize("mode", ["memory", "fallback"])
def test_llama_losses_across_a_reconfigure(mode, tmp_path):
    """Tolerance: bit-equal to the port's uninterrupted run at every step
    index (the replayed steps included); rtol 1e-5 against JAX's elastic
    run of the same weights."""
    jmodel, params, tcfg = _llama_setup()
    plain = dict(_run_port(params, tcfg, "none", None))
    telastic._watcher.reset()
    got = _run_port(params, tcfg, mode, str(tmp_path / "port"))
    ref = _run_jax(jmodel, params, mode, str(tmp_path / "jax"))
    steps = [i for i, _ in got]
    want = list(range(2 * K)) if mode == "memory" else \
        list(range(K)) + list(range(CKPT_STEP, 2 * K))
    assert steps == want == [i for i, _ in ref]
    assert all(loss == plain[i] for i, loss in got)
    np.testing.assert_allclose([x for _, x in got], [x for _, x in ref], rtol=1e-5)


# -- two nodes, one SIGKILLed ---------------------------------------------------------


def _wait_for(pred, timeout, what):
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, f"timed out waiting: {what}"
        time.sleep(0.05)


def _progress(out_dir, eid) -> int:
    try:
        return int((out_dir / f"progress{eid}").read_text() or 0)
    except (FileNotFoundError, ValueError):
        return 0


def test_sigkill_survivor_reshards_without_restart(tmp_path):
    """The port's copy of the JAX package's elastic acceptance
    (``tests/test_chaos.py:580``) on the port's ``tfcluster.run``: node 1
    is SIGKILLed, ``supervise()`` returns instead of raising, the survivor
    reconfigures in memory (epoch 0 → 1) within the reference's 20 s of
    the kill, runs every step exactly once, and ends bit-equal to the
    port's uninterrupted run and within 1e-6 of JAX's."""
    steps = 40
    args = {"out_dir": str(tmp_path), "steps": steps, "hold_at": 10, "step_sleep": 0.01,
            "device": "cpu"}
    cluster = tfcluster.run(torch_elastic_fns.elastic_train_fn, args, num_executors=2,
                            input_mode=InputMode.TENSORFLOW, elastic=True,
                            reservation_timeout=120, heartbeat_interval=0.5,
                            heartbeat_grace=3.0, env=NODE_ENV)
    try:
        pid = next(n["pid"] for n in cluster.cluster_info if n["executor_id"] == 1)
        kill_at = [0.0]

        def kill():
            try:
                _wait_for(lambda: all(_progress(tmp_path, eid) >= 3 for eid in (0, 1)), 60,
                          "both nodes' first steps")
            finally:
                kill_at[0] = time.time()
                os.kill(pid, signal.SIGKILL)

        threading.Thread(target=kill, daemon=True).start()
        cluster.supervise(poll=0.5)
        assert cluster.membership_epoch() == 1
        cluster.shutdown(timeout=120)
    finally:
        cluster.launcher.terminate()
        cluster.server.stop()

    out = json.loads((tmp_path / "node0.json").read_text())
    assert len(out["losses"]) == steps
    assert out["epochs"][0] == 0 and out["final_epoch"] == 1 and out["roster_size"] == 1
    assert out["outcomes"] == ["resharded"]
    first_e1 = next(i for i, e in enumerate(out["epochs"]) if e == 1)
    assert out["t"][first_e1] - kill_at[0] < 20.0
    assert max(b - a for a, b in zip(out["t"], out["t"][1:])) < 15.0
    assert out["params_hex"] == out["uninterrupted_hex"]
    ref = cluster_fns.elastic_reference_params(steps)
    for k, h in out["params_hex"].items():
        np.testing.assert_allclose(np.frombuffer(bytes.fromhex(h), np.float32),
                                   np.frombuffer(bytes.fromhex(ref[k]), np.float32),
                                   rtol=0, atol=1e-6)


# -- multi-controller rebind ------------------------------------------------------------


@pytest.mark.parametrize("leave", [2, 0])
def test_rebind_three_to_two_ranks(leave):
    """3 gloo ranks with ``distributed=True``; executor ``leave`` leaves.
    The survivors rebind (the store moves to executor 1 when executor 0
    leaves), all_reduce over the world of 2, re-fit the mesh to
    ``fsdp=2`` and restore the ZeRO checkpoint saved on ``data=3`` onto it
    (the sharded moments refuse the in-memory path), byte-identical."""
    results = torch_elastic_fns.run_ranks(torch_elastic_fns.rebind_fn, 3, {"leave": leave})
    survivors = [r for r in results if not r["left"]]
    assert [r["left"] for r in results] == [i == leave for i in range(3)]
    assert all(r["before"] == {"world": 3, "sum": 6.0} for r in results)
    for rank, r in enumerate(survivors):
        assert r["zero_placed"] == ["S(0)"]
        assert (r["world"], r["rank"], r["num_workers"]) == (2, rank, 2)
        assert r["sum"] == sum(i + 1 for i in range(3) if i != leave)
        assert r["coordinator"] == r["lowest_survivor"] == survivors[0]["coordinator"]
        assert r["outcome"] == "checkpoint_fallback" and r["resume_step"] == 5
        assert r["mesh"]["fsdp"] == 2 and r["placements"] == ["S(0)"]
        assert r["unequal"] == []
        assert r["dtypes"] == ["torch.bfloat16", "torch.float32", "torch.int32"]
        # the group's store, kept or new, waits no longer than the rebind timeout
        assert r["store_timeout_s"] == tcontext.REBIND_TIMEOUT_S
