"""ResNet-50 image classification on the port's cluster: the counterpart of
the JAX package's ``examples/resnet/resnet_imagenet.py``
(``InputMode.TENSORFLOW``: each node makes its own input).

Each node trains the port's :class:`~tensorflowonspark_tpu_torch.models.
resnet.ResNet` (``--tiny``: the test-size config at 32², else ResNet-50 at
224²) on a device mesh (``ctx.mesh`` from ``--fsdp``, the 'resnet' table's
placements, ``shard_state``) through ``build_bn_train_step`` with
``sgd(0.1, momentum=0.9)``. BatchNorm takes ``impl="auto"``: on CUDA the
statistics run the batch-norm kernels (``ops/bn_kernels.py``, through
their mesh route). It resumes from ``--model-dir`` with ``restore_latest``
(the state and the running statistics), takes one warm-up step and
``--steps`` timed ones on synthetic ImageNet-shaped batches (seeded by the
node's index), prints the JAX example's per-node line (examples/sec) and
saves with ``chief_final_save``.

Not ported yet: ``--tfrecords`` (``data/dfutil.py``, ROADMAP A12) and
``--max-restarts`` (``run_with_restarts``), each raising
``NotImplementedError``.

Usage::

    python -m tensorflowonspark_tpu_torch.launcher --num-executors 1 \\
        tensorflowonspark_tpu_torch/examples/resnet_imagenet.py \\
        [--model-dir DIR] [--steps 50] [--batch-size 64] [--tiny] [--cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

# run as a script: the repository root (two levels up) holds the package
_sys.path.insert(0, _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", "..")))

import argparse  # noqa: E402
import time  # noqa: E402


def refuse_unported(args) -> None:
    refused = [
        (bool(args.tfrecords), "--tfrecords (data/dfutil.py)", "A12"),
        (args.max_restarts > 0, "--max-restarts (tfcluster.run_with_restarts)", "A12"),
    ]
    for hit, what, item in refused:
        if hit:
            raise NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


def main_fun(args, ctx):
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import resolve_device
    from tensorflowonspark_tpu_torch.compute import TrainState, sgd
    from tensorflowonspark_tpu_torch.compute.checkpoint import (
        CheckpointManager,
        chief_final_save,
        restore_latest,
    )
    from tensorflowonspark_tpu_torch.compute.mesh import shard_batch
    from tensorflowonspark_tpu_torch.compute.train import build_bn_train_step, shard_state
    from tensorflowonspark_tpu_torch.models import resnet

    refuse_unported(args)
    mesh = ctx.mesh({"data": -1, "fsdp": args.fsdp})
    device = resolve_device(ctx.device)
    cfg = resnet.ResNetConfig.tiny() if args.tiny else resnet.ResNetConfig.resnet50()
    size = 32 if args.tiny else 224
    model = resnet.ResNet(cfg, device=device, seed=0)
    rng = np.random.default_rng(ctx.executor_id)

    def host_batches():
        """Per-node synthetic input (the InputMode.TENSORFLOW contract:
        nodes make or read their own data)."""
        while True:
            yield {
                "image": rng.normal(size=(args.batch_size, size, size, 3)).astype(np.float32),
                "label": rng.integers(0, cfg.num_classes, size=args.batch_size).astype(np.int32),
            }

    tx = sgd(0.1, momentum=0.9)
    psh = resnet.resnet_param_shardings(dict(model.named_parameters()), mesh)
    state = shard_state(TrainState.create(model.named_parameters(), tx), mesh, psh,
                        module=model)
    batch_stats = {n: t.clone() for n, t in model.named_buffers()}
    step = build_bn_train_step(resnet.loss_fn(model), tx, mesh, psh)

    ckpt = None
    if args.model_dir:
        # every node restores (resume from the latest); only the chief saves
        ckpt = CheckpointManager(ctx.absolute_path(args.model_dir))
        latest, restored = restore_latest(ckpt, {"state": state, "batch_stats": batch_stats})
        if latest is not None:
            if ctx.is_chief:
                print(f"resuming from step {latest}")
            state, batch_stats = restored["state"], restored["batch_stats"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    batches = host_batches()
    # warm-up (first kernel builds and allocations) excluded from timing
    state, batch_stats, loss = step(state, batch_stats, shard_batch(mesh, next(batches)))
    sync()
    t0 = time.time()
    for _ in range(args.steps):
        state, batch_stats, loss = step(state, batch_stats, shard_batch(mesh, next(batches)))
    sync()
    dt = time.time() - t0
    eps = args.steps * args.batch_size / dt
    print(f"node{ctx.executor_id}: {args.steps} steps in {dt:.1f}s -> {eps:.1f} examples/sec "
          f"({eps / mesh.size():.1f} /device), loss {float(loss):.4f}")
    if ckpt is not None:
        # the whole train state and the running statistics: a restored
        # model needs both
        chief_final_save(ckpt, {"state": state, "batch_stats": batch_stats}, state.step,
                         ctx.is_chief)
        if ctx.is_chief:
            print(f"chief checkpointed step {state.step} to {args.model_dir}")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tfrecords", default=None, help="TFRecord dir (not ported: A12)")
    p.add_argument("--model-dir", default=None)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--fsdp", type=int, default=1, help="fsdp axis size")
    p.add_argument("--tiny", action="store_true", help="tiny config (CI)")
    p.add_argument("--max-restarts", type=int, default=0,
                   help="supervised whole-cluster restarts (not ported: A12)")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    # the node's device (cluster/context.py device_of_args): CUDA unless --cpu
    args.device = "cpu" if args.cpu else None
    return args


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch.cluster import tfcluster
    from tensorflowonspark_tpu_torch.cluster.tfcluster import InputMode
    from tensorflowonspark_tpu_torch.launcher import cluster_args_from_env
    from tensorflowonspark_tpu_torch.utils.util import cpu_only_env

    args = parse_args()
    refuse_unported(args)
    largs = cluster_args_from_env()
    cluster = tfcluster.run(
        main_fun,
        args,
        num_executors=largs["num_executors"],
        input_mode=InputMode.TENSORFLOW,
        env=cpu_only_env() if args.cpu else None,
        launcher=largs.get("launcher"),
        distributed=largs.get("distributed", False),
    )
    cluster.shutdown()
    print("resnet_imagenet done")
