"""MNIST training with ``InputMode.SPARK`` on the port's cluster: the
counterpart of the JAX package's ``examples/mnist/mnist_spark.py``, the
canonical push-feed example.

The driver splits its records (synthetic: 784 pixel ints and a label each,
from ``default_rng(0)``) into partitions and pushes them with
``cluster.train(partitions, num_epochs=…)``. Each node reads them through
``ctx.get_data_feed`` → ``DevicePrefetcher.from_feed`` (``prepare`` scales
the pixels to [0, 1) and shapes them ``(n, 28, 28, 1)``) and trains the
port's MNIST CNN with Adam (``adamw`` without decay) on its device (CUDA
unless ``--cpu``); the chief then writes its params with
``ctx.export_saved_model`` (a checkpoint of the port's format). As in the
JAX example, each node trains its own replica on the partitions it is fed.

Not ported yet: ``--tfrecords`` (``data/dfutil.py``, ROADMAP A12), which
raises ``NotImplementedError``.

Usage::

    python -m tensorflowonspark_tpu_torch.launcher --num-executors 2 \\
        tensorflowonspark_tpu_torch/examples/mnist_spark.py \\
        --model-dir /tmp/mnist_model [--epochs 2] [--batch-size 256] [--cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

# run as a script: the repository root (two levels up) holds the package
_sys.path.insert(0, _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", "..")))

import argparse  # noqa: E402


def main_fun(args, ctx):
    """Runs on every node."""
    import numpy as np

    from tensorflowonspark_tpu_torch import resolve_device
    from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step
    from tensorflowonspark_tpu_torch.feed.prefetch import DevicePrefetcher
    from tensorflowonspark_tpu_torch.models import mnist

    device = resolve_device(ctx.device)
    model = mnist.CNN(device=device, seed=0)
    feed = ctx.get_data_feed(train_mode=True, input_mapping={"image": "image", "label": "label"})
    tx = adamw(1e-3, weight_decay=0.0)  # optax.adam
    state = TrainState.create(model.named_parameters(), tx)
    step = build_train_step(mnist.loss_fn(model), tx, device=device)

    def prepare(cols):
        n = len(cols["label"])
        return {
            "image": np.asarray(cols["image"], np.float32).reshape(n, 28, 28, 1) / 255.0,
            "label": np.asarray(cols["label"], np.int64),
        }

    steps, loss = 0, None
    with DevicePrefetcher.from_feed(feed, args.batch_size, prepare=prepare,
                                    device=device) as pf:
        for batch in pf:
            state, loss = step(state, batch)
            steps += 1
            if steps % 20 == 0:
                print(f"node{ctx.executor_id} step {steps} loss {float(loss):.4f}")
    last = float("nan") if loss is None else float(loss)
    print(f"node{ctx.executor_id}: {steps} steps, final loss {last:.4f}")

    if args.model_dir and ctx.is_chief:
        params = {n: t.detach().cpu() for n, t in state.params.items()}
        ctx.export_saved_model({"params": params}, args.model_dir)
        print(f"chief (node{ctx.executor_id}) exported to {args.model_dir}")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tfrecords", default=None, help="TFRecord dir (not ported: A12)")
    p.add_argument("--model-dir", default=None)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--num-records", type=int, default=4096)
    p.add_argument("--cpu", action="store_true", help="CPU-only nodes")
    args = p.parse_args(argv)
    # the node's device (cluster/context.py device_of_args): CUDA unless --cpu
    args.device = "cpu" if args.cpu else None
    return args


def records(args) -> list:
    """The driver's records: (784 pixel ints, label) tuples."""
    import numpy as np

    if args.tfrecords:
        raise NotImplementedError("--tfrecords (data/dfutil.py) is not ported yet: ROADMAP A12")
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 255, size=784), int(rng.integers(0, 10)))
            for _ in range(args.num_records)]


def run(args, num_executors: int = 1, env=None, launcher=None, distributed: bool = False,
        **run_kwargs) -> None:
    """The driver: launch the nodes, push the partitions, shut down."""
    from tensorflowonspark_tpu_torch.cluster import tfcluster
    from tensorflowonspark_tpu_torch.cluster.tfcluster import InputMode

    recs = records(args)
    num_parts = max(4, 2 * num_executors)
    partitions = [recs[i::num_parts] for i in range(num_parts)]
    cluster = tfcluster.run(main_fun, args, num_executors=num_executors,
                            input_mode=InputMode.SPARK, env=env, launcher=launcher,
                            distributed=distributed, **run_kwargs)
    cluster.train(partitions, num_epochs=args.epochs)
    cluster.shutdown()


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch.launcher import cluster_args_from_env
    from tensorflowonspark_tpu_torch.utils.util import cpu_only_env

    args = parse_args()
    largs = cluster_args_from_env()
    run(args, largs["num_executors"], env=cpu_only_env() if args.cpu else None,
        launcher=largs.get("launcher"), distributed=largs.get("distributed", False))
    print("mnist_spark done")
