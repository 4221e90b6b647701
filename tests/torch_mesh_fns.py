"""Process groups for the port's mesh tests.

``run_group(fn, world, args)`` starts ``world`` processes that join a gloo
group and call ``fn(rank, world, args)``, a module-level function of this
module, which imports neither ``jax`` nor the JAX package: a spawned rank
stays free of both. The group meets through a file store in its own
temporary directory, so groups that run side by side (xdist workers)
share no port, and its collectives time out after ``timeout`` seconds.
Each rank gets one CPU thread. Rank 0's return value comes back (through a
file); a rank that raises fails the group with its traceback, and the
group has its own time limit.
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import tempfile
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_group(fn, world: int, args: dict | None = None, timeout: float = 240.0):
    """Run ``fn`` on ``world`` gloo ranks; rank 0's result."""
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump({"fn": fn.__name__, "args": args or {}, "world": world,
                         "store": os.path.join(tmp, "store"), "out": tmp,
                         "timeout": timeout}, f)
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        code = "import sys, tests.torch_mesh_fns as m; m.entry(sys.argv[1], int(sys.argv[2]))"
        procs = [subprocess.Popen([sys.executable, "-c", code, spec, str(r)],
                                  cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
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
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)


def entry(spec_path: str, rank: int) -> None:
    """A spawned rank: run its function, exit 1 with the traceback on a raise."""
    try:
        _main(spec_path, rank)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)


def _main(spec_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}",
                            world_size=spec["world"], rank=rank,
                            timeout=datetime.timedelta(seconds=spec["timeout"]))
    try:
        out = globals()[spec["fn"]](rank, spec["world"], spec["args"])
        if rank == 0:
            with open(os.path.join(spec["out"], "rank0.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()



# -- the group functions ----------------------------------------------------


def _full(t):
    """A tensor (or a DTensor gathered whole) as numpy."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().cpu().numpy().copy()


def _llama_cfg(args):
    import torch

    from tensorflowonspark_tpu_torch.models import llama as L

    return L.LlamaConfig.tiny(**args["cfg"], dtype=torch.float32, attention_impl="flash",
                              remat=True, remat_policy="dots")


def _state_arrays(state):
    adam = state.opt_state[0]
    out = {f"params/{k}": _full(v) for k, v in state.params.items()}
    out.update({f"mu/{k}": _full(v) for k, v in adam.mu.items()})
    out.update({f"nu/{k}": _full(v) for k, v in adam.nu.items()})
    out["count"] = _full(adam.count)
    return out


def llama_zero_fn(rank, world, args):
    """A tiny fp32 Llama from the JAX package's weights trained on each mesh
    of ``args["meshes"]`` with ZeRO on and off, the collectives of one step
    counted; the weight update alone on fixed gradients; and a sharded
    checkpoint saved on the first mesh, restored onto ``fsdp=4``."""
    import numpy as np
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from tensorflowonspark_tpu_torch.compute import adamw
    from tensorflowonspark_tpu_torch.compute.checkpoint import CheckpointManager, restore_latest
    from tensorflowonspark_tpu_torch.compute.mesh import make_mesh
    from tensorflowonspark_tpu_torch.compute.train import (TrainState, build_train_step,
                                                           build_update_step, fsdp_shardings,
                                                           shard_state)
    from tensorflowonspark_tpu_torch.models import llama as L
    from tensorflowonspark_tpu_torch.models.convert import params_from_jax

    cfg = _llama_cfg(args)
    weights = params_from_jax(args["params"])
    tokens = args["tokens"]

    def trainer(mesh, zero, weights=weights):
        model = L.Llama(cfg, device="cpu")
        model.load_state_dict(weights)
        tx = adamw(args["lr"], eps=args["eps"])
        psh = L.llama_param_shardings(dict(model.named_parameters()), mesh)
        state = shard_state(TrainState.create(model.named_parameters(), tx), mesh, psh, zero,
                            module=model)
        loss = L.llama_loss_fn(model)
        step = build_train_step(lambda p, b: loss(p, b["tokens"]), tx, mesh, psh,
                                zero_sharding=zero)
        return tx, psh, state, step

    out = {"train": {}, "census": {}, "placements": {}, "bridge": {}, "fsdp": {}}
    for key, shape in args["meshes"].items():
        mesh = make_mesh(shape, device_type="cpu")
        # the JAX tree placed by the bridge, against the placements of shard_state
        placed = params_from_jax(args["params"], mesh, "llama")
        psh = L.llama_param_shardings(weights, mesh)
        out["bridge"][key] = [n for n, t in placed.items()
                              if tuple(t.placements) != psh[n].placements
                              or not torch.equal(t.full_tensor(), weights[n])]
        out["fsdp"][key] = {n: sh.spec for n, sh in fsdp_shardings(weights, mesh).items()}
        for zero in (True, False):
            tx, psh, state, step = trainer(mesh, zero)
            out["placements"][(key, zero)] = {
                "mu/embed": str(state.opt_state[0].mu["embed"].placements),
                "params/embed": str(state.params["embed"].placements)}
            losses = []
            for _ in range(args["steps"]):
                state, loss = step(state, {"tokens": tokens})
                losses.append(loss.item())
            out["train"][(key, zero)] = (losses, _state_arrays(state))
            if key == args["ckpt_mesh"] and zero:
                mgr = CheckpointManager(args["ckpt_dir"])
                mgr.save(state.step, state)
                mgr.close()
                _, _, fresh, _ = trainer(make_mesh({"fsdp": 4}, device_type="cpu"), True,
                                         {n: torch.zeros_like(w) for n, w in weights.items()})
                step_no, restored = restore_latest(CheckpointManager(args["ckpt_dir"]), fresh)
                saved, got = _state_arrays(state), _state_arrays(restored)
                out["restored_fsdp4"] = {
                    "step": (step_no, restored.step, state.step),
                    "placements": str(restored.params["embed"].placements),
                    "unequal": [k for k in saved if not np.array_equal(saved[k], got[k])]}
            if zero:  # one more step, its collectives counted
                with CommDebugMode() as comm:
                    step(state, {"tokens": tokens})
                out["census"][key] = {str(k): v for k, v in comm.get_comm_counts().items()}
            if key == args["update_mesh"] and zero:
                _, psh, fresh, _ = trainer(mesh, True)
                upd = build_update_step(tx, mesh, psh, zero_sharding=True)
                for g in args["grads"]:
                    fresh = upd(fresh, {n: torch.from_numpy(v) for n, v in g.items()})
                out["update"] = _state_arrays(fresh)
    return out


def mesh_ops_fn(rank, world, args):
    """Flash attention's mesh route on ``fsdp=2, model=2`` (forward and
    grads, GQA), its refusals, and the prefetcher on ``data=2, fsdp=2``."""
    import numpy as np
    import torch
    from torch.distributed.tensor import distribute_tensor

    from tensorflowonspark_tpu_torch.compute import layout
    from tensorflowonspark_tpu_torch.compute.mesh import batch_rows, make_mesh
    from tensorflowonspark_tpu_torch.feed.prefetch import DevicePrefetcher
    from tensorflowonspark_tpu_torch.ops import bn_kernels
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.ops.attention import dot_product_attention
    from tensorflowonspark_tpu_torch.parallel.context import MESH_ROUTES

    mesh = make_mesh({"fsdp": 2, "model": 2}, device_type="cpu")
    out = {"tp_only": layout.tp_only(mesh, layout.sharding(mesh, (("data", "fsdp"), "model"))).spec}
    sh = layout.sharding(mesh, layout.activation_spec("attn_bshd"))
    q, k, v, do = (distribute_tensor(torch.from_numpy(a), sh.mesh, sh.placements)
                   for a in args["qkvo"])
    for t in (q, k, v):
        t.requires_grad_(True)
    o = dot_product_attention(q, k, v, causal=True, impl="flash")
    o.backward(do)
    out["attention"] = {"out": o.full_tensor().detach().numpy(),
                        "grads": [t.grad.full_tensor().numpy() for t in (q, k, v)],
                        "out_placements": str(o.placements), "routes": MESH_ROUTES["attention"],
                        "local_heads": o.to_local().shape[2]}
    refused = {}
    for name, call in (("flash_forward", lambda: fa.flash_forward(q, k, v, True)),
                       ("flash_attention", lambda: fa.flash_attention(q, k, v, True)),
                       ("pair_stats", lambda: bn_kernels.pair_stats(q))):
        try:
            call()
        except TypeError as e:
            refused[name] = str(e)
    seq_mesh = make_mesh({"fsdp": 2, "seq": 2}, device_type="cpu")
    sq = layout.sharding(seq_mesh, layout.activation_spec("attn_bshd"))
    qs = distribute_tensor(torch.from_numpy(args["qkvo"][0]), sq.mesh, sq.placements)
    try:
        dot_product_attention(qs, qs, qs, causal=True, impl="flash")
    except NotImplementedError as e:
        refused["seq"] = str(e)
    out["refused"] = refused

    # the prefetcher: every rank stages and copies only its rows
    pmesh = make_mesh({"data": 2, "fsdp": 2}, device_type="cpu")
    batches = args["batches"]

    class Feed:  # the batch_stream contract of DataFeed
        def batch_stream(self, batch_size, multiple_of=1):
            yield from batches

    host_sums, seen = [], []
    pf = DevicePrefetcher.from_feed(
        Feed(), 8, mesh=pmesh, depth=2,
        prepare=lambda cols: host_sums.append(int(cols["tokens"].sum(dtype=np.int64))) or cols)
    for i, batch in enumerate(pf):
        rows = batch_rows(pmesh, batches[i]["tokens"].shape[0])
        local_ok = all(np.array_equal(batch[k].to_local().numpy(), batches[i][k][rows])
                       for k in batches[i])
        seen.append({"local_ok": local_ok,
                     "full_ok": all(np.array_equal(batch[k].full_tensor().numpy(), batches[i][k])
                                    for k in batches[i]),
                     "device_sum": int(batch["tokens"].full_tensor().sum(dtype=torch.int64)),
                     "local_rows": batch["tokens"].to_local().shape[0],
                     "placements": str(batch["tokens"].placements)})
    out["prefetch"] = {"host_sums": host_sums, "seen": seen}
    plain = DevicePrefetcher(iter(batches), mesh=pmesh, depth=2)
    out["prefetch_plain"] = [all(np.array_equal(b[k].full_tensor().numpy(), batches[i][k])
                                 for k in b) for i, b in enumerate(plain)]
    return out


def bn_mesh_fn(rank, world, args):
    """The batch-norm statistics' mesh routes on ``data=2``: even and
    uneven splits, and with the all_reduce dropped (a planted fault); a
    tiny ResNet through the mesh BN step beside the single-device step."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from tensorflowonspark_tpu_torch.compute import TrainState, sgd
    from tensorflowonspark_tpu_torch.compute.mesh import make_mesh
    from tensorflowonspark_tpu_torch.compute.train import build_bn_train_step, shard_state
    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.ops import bn_kernels
    from tensorflowonspark_tpu_torch.ops.batch_norm import set_impl
    from tensorflowonspark_tpu_torch.parallel.context import MESH_ROUTES, reset_mesh_routes

    mesh = make_mesh({"data": 2}, device_type="cpu")
    sub = mesh["data"]

    def stats(x, dy):
        xd = distribute_tensor(torch.from_numpy(x), sub, [Shard(0)])
        dyd = distribute_tensor(torch.from_numpy(dy), sub, [Shard(0)])
        pair = bn_kernels.mesh_pair_stats(xd)
        cross = bn_kernels.mesh_cross_stats(dyd, xd)
        return {"pair": [t.full_tensor().numpy() for t in pair],
                "cross": [t.full_tensor().numpy() for t in cross],
                "local_rows": xd.to_local().shape[0]}

    out = {"even": stats(args["x"], args["dy"]),
           "uneven": stats(args["x_uneven"], args["dy_uneven"])}
    real = dist.all_reduce
    dist.all_reduce = lambda *a, **k: None  # planted: the partial sums stay on their rank
    try:
        out["no_all_reduce"] = stats(args["x"], args["dy"])
    finally:
        dist.all_reduce = real

    runs = {}
    for shape in (None, {"data": 2}):
        model = resnet.ResNet(resnet.ResNetConfig.tiny(dtype=torch.float32), device="cpu", seed=0)
        set_impl(model, "kernel")
        tx = sgd(0.1, momentum=0.9)
        stats_ = {n: b.clone() for n, b in model.named_buffers()}
        state = TrainState.create(model.named_parameters(), tx)
        if shape is None:
            step = build_bn_train_step(resnet.loss_fn(model), tx, device="cpu")
        else:
            m = make_mesh(shape, device_type="cpu")
            psh = resnet.resnet_param_shardings(dict(model.named_parameters()), m)
            state = shard_state(state, m, psh, module=model)
            step = build_bn_train_step(resnet.loss_fn(model), tx, m, psh)
        reset_mesh_routes()
        losses = []
        for _ in range(2):
            state, stats_, loss = step(state, stats_, args["images"])
            losses.append(loss.item())
        runs[str(shape)] = {"losses": losses, "routes": dict(MESH_ROUTES),
                            "stats": {k: v.numpy().copy() for k, v in stats_.items()},
                            "params": {k: _full(v) for k, v in state.params.items()}}
    out["resnet"] = runs
    return out
