"""U-Net semantic segmentation on the port's cluster: the counterpart of the
JAX package's ``examples/segmentation/unet_segmentation.py``
(``InputMode.TENSORFLOW``: each node makes its own input).

Synthetic stand-in data, as in the JAX example: random disks rendered into
images, mask {0: background, 1: disk, 2: outline}, so the model has real
structure to learn and the mIoU means something. Each node trains the
port's :class:`~tensorflowonspark_tpu_torch.models.unet.UNet`
(``--tiny``: the test-size config) with Adam on its device (CUDA unless
``--cpu``) through ``build_train_step``, prints the JAX example's per-node
line (steps, seconds, final loss, mIoU on a fresh batch) and the chief
writes its params with ``ctx.export_saved_model``. As in the JAX example
run without ``distributed``, each node trains its own replica.

Usage::

    python -m tensorflowonspark_tpu_torch.launcher --num-executors 1 \\
        tensorflowonspark_tpu_torch/examples/unet_segmentation.py \\
        [--steps 100] [--size 64] [--tiny] [--cpu] [--model-dir DIR]
"""

from __future__ import annotations

import os as _os
import sys as _sys

# run as a script: the repository root (two levels up) holds the package
_sys.path.insert(0, _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", "..")))

import argparse  # noqa: E402
import time  # noqa: E402


def render_circles(rng, n, size):
    """(images, masks): disks with a distinct outline class (the JAX
    example's ``_render_circles``)."""
    import numpy as np

    yy, xx = np.mgrid[0:size, 0:size]
    images = np.zeros((n, size, size, 3), np.float32)
    masks = np.zeros((n, size, size), np.int32)
    for i in range(n):
        cx, cy = rng.uniform(size * 0.25, size * 0.75, size=2)
        r = rng.uniform(size * 0.1, size * 0.3)
        d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        disk = d < r - 1.5
        outline = (d >= r - 1.5) & (d < r + 1.5)
        masks[i][disk] = 1
        masks[i][outline] = 2
        color = rng.uniform(0.3, 1.0, size=3).astype(np.float32)
        images[i][disk] = color
        images[i][outline] = 1.0 - color
        images[i] += rng.normal(0, 0.05, size=(size, size, 3))
    return images, masks


def main_fun(args, ctx):
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import resolve_device
    from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step
    from tensorflowonspark_tpu_torch.models import unet

    device = resolve_device(ctx.device)
    cfg = unet.UNetConfig.tiny() if args.tiny else unet.UNetConfig()
    model = unet.UNet(cfg, device=device, seed=0)
    rng = np.random.default_rng(ctx.executor_id)
    tx = adamw(1e-3, weight_decay=0.0)  # optax.adam
    state = TrainState.create(model.named_parameters(), tx)
    step = build_train_step(unet.loss_fn(model), tx, device=device)

    def batch():
        images, masks = render_circles(rng, args.batch_size, args.size)
        return {"image": images, "mask": masks}

    t0 = time.time()
    loss = None
    for i in range(args.steps):
        state, loss = step(state, batch())
        if (i + 1) % 20 == 0:
            print(f"node{ctx.executor_id} step {i + 1} loss {float(loss):.4f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0

    test = {k: torch.from_numpy(v).to(device) for k, v in batch().items()}
    miou = unet.iou(model, state.params, test, cfg.num_classes)
    print(f"node{ctx.executor_id}: {args.steps} steps in {dt:.1f}s, "
          f"final loss {float(loss):.4f}, mIoU {float(miou):.3f}")
    if args.model_dir and ctx.is_chief:
        params = {n: t.detach().cpu() for n, t in state.params.items()}
        ctx.export_saved_model({"params": params}, args.model_dir)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--model-dir", default=None)
    p.add_argument("--tiny", action="store_true")
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
    print("unet_segmentation done")
