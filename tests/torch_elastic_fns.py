"""Node and rank functions for the port's elastic tests.

Spawned processes import this module, so it imports neither ``jax`` nor
the JAX package.

- ``elastic_train_fn`` is the map_fun of the two-node SIGKILL test (the
  port's copy of the JAX package's ``tests/cluster_fns.elastic_train_fn``
  recipe: a linear model whose batch is a pure function of the step
  index, momentum SGD, an ``ElasticTrainer`` reconfigure whenever the
  membership epoch moves).
- ``run_ranks(fn, world, args)`` starts ``world`` processes, each with a
  ``TFNodeContext`` of ``distributed=True`` on the CPU (gloo) over one
  roster of free localhost ports, and calls ``fn(ctx, args)``; each rank's
  return value comes back. The group meets through the context's own
  store, as a node's does, and a rank that raises fails the run with its
  traceback.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the elastic recipe ---------------------------------------------------------


def recipe():
    """``(loss_fn, tx, make_batch)`` of the JAX package's elastic chaos
    tests, on the port."""
    from tensorflowonspark_tpu_torch.compute import sgd

    def loss_fn(params, batch):
        pred = batch["x"] * params["w"] + params["b"]
        return ((pred - batch["y"]) ** 2).mean()

    def make_batch(i):
        rng = np.random.default_rng(1000 + i)
        x = rng.normal(size=8).astype(np.float32)
        return {"x": x, "y": 3.0 * x + 1.5}

    return loss_fn, sgd(0.1, momentum=0.9), make_batch


def _initial_state(tx):
    """Zero params as a single-controller node keeps them: plain tensors
    on its own device (the CPU)."""
    import torch

    from tensorflowonspark_tpu_torch.compute import TrainState

    return TrainState.create({"w": torch.zeros(()), "b": torch.zeros(())}, tx)


def _hex(params) -> dict[str, str]:
    return {k: v.detach().numpy().tobytes().hex() for k, v in params.items()}


def reference_params(steps: int) -> dict[str, str]:
    """The uninterrupted run of the recipe in this process: the oracle
    of the elastic run's final params."""
    from tensorflowonspark_tpu_torch.compute import build_train_step

    loss_fn, tx, make_batch = recipe()
    state = _initial_state(tx)
    step_fn = build_train_step(loss_fn, tx, device="cpu")
    for i in range(steps):
        state, _ = step_fn(state, make_batch(i))
    return _hex(state.params)


def elastic_train_fn(args, ctx):
    """The elastic training loop of the SIGKILL test. Each step's loss,
    epoch and wall time are recorded; ``progress{id}`` counts the steps
    taken (the test kills a node once it has taken a few). At step
    ``hold_at`` a node still in epoch 0 waits (bounded) for the departure
    bump, so the kill lands mid-run however slowly the host starts the
    nodes. The survivor also computes the uninterrupted run of the same
    steps in its own process, the oracle of its final params."""
    import torch

    from tensorflowonspark_tpu_torch.compute import build_train_step, elastic
    from tensorflowonspark_tpu_torch.compute.elastic import ElasticTrainer

    torch.set_num_threads(1)
    loss_fn, tx, make_batch = recipe()
    trainer = ElasticTrainer(ctx, axis_shapes={"data": -1})
    state = _initial_state(tx)
    step_fn = build_train_step(loss_fn, tx, device="cpu")
    total = int(args["steps"])
    losses, epochs, times, outcomes = [], [], [], []
    progress = os.path.join(args["out_dir"], f"progress{ctx.executor_id}")
    i = 0
    while i < total:
        if i == args.get("hold_at") and trainer.epoch == 0:
            elastic.wait_for_epoch(1, timeout=float(args.get("hold_timeout", 60)))
        if trainer.changed():
            (state, _mesh), outcome = with_outcome(lambda: trainer.reconfigure(state))
            outcomes.append(outcome)
            if trainer.resume_step is not None:
                i = trainer.resume_step
        state, loss = step_fn(state, make_batch(i))
        losses.append(float(loss))
        epochs.append(trainer.epoch)
        times.append(time.time())
        trainer.publish(state, i + 1)
        with open(progress, "w") as f:
            f.write(str(i + 1))
        if args.get("step_sleep"):
            time.sleep(float(args["step_sleep"]))
        i += 1
    out = {
        "losses": losses,
        "epochs": epochs,
        "t": times,
        "outcomes": outcomes,
        "final_epoch": trainer.epoch,
        "roster_size": len(trainer.roster),
        "params_hex": _hex(state.params),
        "uninterrupted_hex": reference_params(total),
    }
    with open(os.path.join(args["out_dir"], f"node{ctx.executor_id}.json"), "w") as f:
        json.dump(out, f)


# -- rank processes with a context of their own ---------------------------------


def run_ranks(fn, world: int, args: dict | None = None, timeout: float = 90.0) -> list:
    """Run ``fn(ctx, args)`` on ``world`` processes whose contexts join
    one gloo group; every rank's return value, by rank."""
    from tensorflowonspark_tpu_torch.utils.util import find_free_port

    roster = [{"executor_id": i, "host": "127.0.0.1", "port": find_free_port("127.0.0.1"),
               "job_name": "chief" if i == 0 else "worker", "task_index": max(0, i - 1),
               "pid": 100000 + i}
              for i in range(world)]
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump({"fn": fn.__name__, "args": {**(args or {}), "tmp": tmp},
                         "roster": roster, "out": tmp}, f)
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        code = ("import sys, tests.torch_elastic_fns as m; "
                "m.rank_entry(sys.argv[1], int(sys.argv[2]))")
        procs = [subprocess.Popen([sys.executable, "-c", code, spec, str(r)], cwd=ROOT, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"ranks failed {failed}:\n" + "\n".join(o[-4000:] for o in outs))
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def rank_entry(spec_path: str, rank: int) -> None:
    """A spawned rank: build its context, run its function, exit 1 with
    the traceback on a raise."""
    try:
        import torch

        from tensorflowonspark_tpu_torch.cluster.context import TFNodeContext

        torch.set_num_threads(1)
        with open(spec_path, "rb") as f:
            spec = pickle.load(f)
        roster = spec["roster"]
        me = roster[rank]
        ctx = TFNodeContext(executor_id=rank, job_name=me["job_name"], task_index=me["task_index"],
                            cluster_info=roster, num_workers=len(roster), default_fs="",
                            working_dir=spec["out"], distributed=True, device="cpu",
                            coordinator_address=f"{roster[0]['host']}:{roster[0]['port']}")
        out = globals()[spec["fn"]](ctx, spec["args"])
        with open(os.path.join(spec["out"], f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)


OUTCOMES = ("resharded", "checkpoint_fallback", "peer_hydrate", "fresh_init", "failed")


def with_outcome(call):
    """``(call(), outcome)``: the recovery outcome that ``call`` (a
    reconfigure or a hydrate) counted in ``elastic_recoveries_total``."""
    from tensorflowonspark_tpu_torch.obs.registry import default_registry

    counter = default_registry().counter("elastic_recoveries_total")
    before = {o: counter.value(outcome=o) for o in OUTCOMES}
    out = call()
    return out, next(o for o in OUTCOMES if counter.value(outcome=o) > before[o])


def _shardings1(state, mesh):
    """The default placements with tiny tensors sharded too (the test
    tensors are far below ``fsdp_shardings``' production minimum)."""
    from tensorflowonspark_tpu_torch.compute.train import fsdp_shardings, state_shardings

    return state_shardings(state, mesh, fsdp_shardings(state.params, mesh, min_shard_elements=1))


def _full(t):
    from tensorflowonspark_tpu_torch.parallel.context import is_dtensor

    return (t.full_tensor() if is_dtensor(t) else t).detach().clone()


def _zero_state(world_axes):
    """A ZeRO-placed ``TrainState`` (bf16 moments) of two params on a mesh
    of every rank: the moments of ``w`` partition over ``data``."""
    import torch

    from tensorflowonspark_tpu_torch.compute import TrainState, adamw
    from tensorflowonspark_tpu_torch.compute.mesh import make_mesh
    from tensorflowonspark_tpu_torch.compute.train import fsdp_shardings, shard_state

    mesh = make_mesh(world_axes, device_type="cpu")
    params = {"w": torch.arange(12 * 8, dtype=torch.float32).reshape(12, 8) / 7,
              "b": torch.arange(8, dtype=torch.float32) / 3}
    tx = adamw(1e-2, moment_dtype=torch.bfloat16)
    state = TrainState.create(params, tx)
    grads = {k: torch.full_like(v, 0.25) for k, v in params.items()}
    _, state.opt_state = tx.update(grads, state.opt_state, state.params)  # nonzero moments
    return mesh, shard_state(state, mesh, fsdp_shardings(params, mesh, min_shard_elements=1))


def _flat(state) -> dict:
    from tensorflowonspark_tpu_torch.compute import elastic

    out: dict = {}
    elastic._tree_map(lambda t: out.__setitem__(len(out), t), state)
    return out


def rebind_fn(ctx, args):
    """3 → 2: every rank joins, a ZeRO state on ``data=3`` is saved
    sharded, executor ``args["leave"]`` leaves; the survivors reconfigure
    through ``ElasticTrainer`` (the sharded leaves refuse the in-memory
    path, the rebind makes a world of 2, the mesh re-fits to ``fsdp=2``
    and the checkpoint restores onto it) and all_reduce over the new
    group."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.compute import elastic
    from tensorflowonspark_tpu_torch.compute.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.compute.layout import axis_sizes

    ctx.initialize_distributed()
    x = torch.tensor([float(ctx.executor_id + 1)])
    dist.all_reduce(x)
    before = {"world": dist.get_world_size(), "sum": float(x)}
    mesh3, state = _zero_state({"data": -1})
    saved = {k: _full(v) for k, v in _flat(state).items()}
    ckpt_dir = os.path.join(args["tmp"], "ckpt")
    with CheckpointManager(ckpt_dir) as mgr:
        mgr.save(5, state, force=True)
    mu_w = state.opt_state[0].mu["w"]
    zero_placed = [str(p) for p in mu_w.placements]
    if ctx.executor_id == args["leave"]:
        ctx.shutdown_distributed()
        return {"left": True, "before": before}
    trainer = elastic.ElasticTrainer(ctx, shardings_fn=_shardings1, checkpoint_dir=ckpt_dir)
    elastic.notify_membership(1, [n for n in ctx.cluster_info if n["executor_id"] != args["leave"]])
    assert trainer.changed()
    (state, mesh), outcome = with_outcome(lambda: trainer.reconfigure(state))
    x = torch.tensor([float(ctx.executor_id + 1)])
    dist.all_reduce(x)
    got = {k: _full(v) for k, v in _flat(state).items()}
    lowest = min((n for n in ctx.cluster_info), key=lambda n: n["executor_id"])
    return {
        "left": False, "before": before, "zero_placed": zero_placed,
        "lowest_survivor": f"{lowest['host']}:{lowest['port']}",
        "world": dist.get_world_size(), "rank": dist.get_rank(), "sum": float(x),
        "coordinator": ctx.coordinator_address, "num_workers": ctx.num_workers,
        "mesh": axis_sizes(mesh), "resume_step": trainer.resume_step, "outcome": outcome,
        "store_timeout_s": ctx._store.timeout.total_seconds(),
        "placements": [str(p) for p in state.params["w"].placements],
        "unequal": [k for k in saved if got[k].dtype != saved[k].dtype
                    or not torch.equal(got[k], saved[k])],
        "dtypes": sorted({str(t.dtype) for t in got.values()}),
    }


def zero_refusal_fn(ctx, args):
    """2 ranks under ZeRO (``data=2``): rank 0 alone asks for a host
    snapshot, which must refuse at once (a collective would wait for rank
    1, which is not calling one); then both reconfigure onto ``fsdp=2``
    from the sharded checkpoint."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.compute import elastic
    from tensorflowonspark_tpu_torch.compute.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.compute.layout import axis_sizes

    ctx.initialize_distributed()
    _mesh, state = _zero_state({"data": -1})
    saved = {k: _full(v) for k, v in _flat(state).items()}
    ckpt_dir = os.path.join(args["tmp"], "ckpt")
    with CheckpointManager(ckpt_dir) as mgr:
        mgr.save(3, state, force=True)
    refused, seconds = None, None
    if ctx.executor_id == 0:
        t0 = time.monotonic()
        try:
            elastic.host_snapshot(state)
            refused = False
        except elastic.InMemoryRecoveryUnavailable:
            refused = True
        seconds = time.monotonic() - t0
    dist.barrier()
    trainer = elastic.ElasticTrainer(ctx, shardings_fn=_shardings1, checkpoint_dir=ckpt_dir)
    elastic.notify_membership(1, list(ctx.cluster_info))
    (state, mesh), outcome = with_outcome(lambda: trainer.reconfigure(state))
    got = {k: _full(v) for k, v in _flat(state).items()}
    return {"refused": refused, "seconds": seconds, "outcome": outcome,
            "resume_step": trainer.resume_step, "mesh": axis_sizes(mesh),
            "unequal": [k for k in saved if got[k].dtype != saved[k].dtype
                        or not got[k].equal(saved[k])]}
