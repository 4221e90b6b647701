"""U-Net for semantic segmentation (port of
:mod:`tensorflowonspark_tpu.models.unet`).

``image (B, H, W, 3) -> fp32 per-pixel logits (B, H, W, num_classes)``,
NHWC at every boundary (``models.conv``). Each stage is a ``_ConvBlock``
(two 3×3 ``SAME`` convs without bias, each followed by GroupNorm in fp32
with ``min(8, features)`` groups and flax's ε = 1e-6, ReLU, cast to
``cfg.dtype``), then a strided 3×3 ``SAME`` conv halves the resolution (to
⌈h/2⌉; flax's asymmetric padding, ``conv.same_pads``). The decoder resizes
to each skip's size, convolves, concatenates the skip and runs a block; a
1×1 fp32 conv gives the logits.

Parameter names are the flax paths (``_ConvBlock_0.Conv_0.weight``,
``_ConvBlock_0.GroupNorm_1.scale``, ``Conv_2.bias`` …), so
:mod:`models.convert` maps the trees leaf by leaf. ``unet_param_shardings``
reads the layout table ``"unet"``.

Divergences: GroupNorm groups the last (channel) axis of the NHWC map, as
flax does, through ``F.group_norm`` on its NCHW view. The upsampling is
``F.interpolate(mode="nearest-exact")``: ``jax.image.resize(…, "nearest")``
samples at half-pixel centres, which torch's ``"nearest"`` does not, and
the two part wherever a skip's size is odd.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.models.conv import (
    Conv, FlaxNamed, GroupNorm, init_weights, per_sample, table_shardings,
)
from tensorflowonspark_tpu_torch.parallel.context import mesh_region


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    features: tuple[int, ...] = (64, 128, 256, 512)  # encoder widths
    bottleneck_features: int = 1024
    num_classes: int = 3  # pet tutorial: foreground/background/outline
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny(**overrides) -> "UNetConfig":
        base = dict(features=(8, 16), bottleneck_features=32, num_classes=3)
        base.update(overrides)
        return UNetConfig(**base)


class _ConvBlock(FlaxNamed):
    def __init__(self, cin: int, features: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        for i in range(2):
            self.child(Conv(cin if i == 0 else features, features, (3, 3), dtype=dtype,
                            device=device))
            self.child(GroupNorm(features, min(8, features), dtype=torch.float32, device=device))

    def forward(self, x):
        for conv, norm in ((self.Conv_0, self.GroupNorm_0), (self.Conv_1, self.GroupNorm_1)):
            x = F.relu(norm(conv(x))).to(self.dtype)
        return x


def _resize_nearest(x, h: int, w: int):
    """``jax.image.resize(x, (n, h, w, c), "nearest")`` on NHWC."""
    y = per_sample(lambda t: F.interpolate(t, size=(h, w), mode="nearest-exact"),
                   x.permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1)


class UNet(FlaxNamed):
    """Built on ``device`` (CUDA unless the caller passes another) with
    weights drawn from ``seed``."""

    def __init__(self, cfg: UNetConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dt = cfg.dtype
        cin, down = 3, []
        for f in cfg.features:
            block = self.child(_ConvBlock(cin, f, dt, device))
            # strided downsample
            down.append((block, self.child(Conv(f, f, (3, 3), (2, 2), dt, device, bias=True))))
            cin = f
        mid = self.child(_ConvBlock(cin, cfg.bottleneck_features, dt, device))
        cin, up = cfg.bottleneck_features, []
        for f in reversed(cfg.features):
            conv = self.child(Conv(cin, f, (3, 3), dtype=dt, device=device, bias=True))
            up.append((conv, self.child(_ConvBlock(2 * f, f, dt, device))))
            cin = f
        # per-pixel logits in fp32 for a stable softmax
        head = self.child(Conv(cin, cfg.num_classes, (1, 1), dtype=torch.float32,
                               device=device, bias=True))
        # the stages in call order (a tuple: each is registered once, under
        # its flax name)
        self.stages = (tuple(down), mid, tuple(up), head)
        init_weights(self, seed, device)

    def forward(self, x):
        x = x.to(self.cfg.dtype)
        down, mid, up, head = self.stages
        skips = []
        for block, conv in down:
            x = block(x)
            skips.append(x)
            x = conv(x)
        x = mid(x)
        for (conv, block), skip in zip(up, reversed(skips)):
            x = conv(_resize_nearest(x, skip.shape[1], skip.shape[2]))
            x = block(torch.cat([x, skip], dim=-1))
        return head(x)


# the layout table's 'unet' rules: conv kernels' output channels over
# 'fsdp' where they divide, the rest replicated
unet_param_shardings = table_shardings("unet")


def loss_fn(model: UNet):
    """``loss(params, batch)`` for batches ``{'image': (n, h, w, c), 'mask':
    (n, h, w) int}``: mean per-pixel softmax cross entropy."""

    def loss(params, batch):
        with mesh_region(batch["image"]):
            logits = torch.func.functional_call(model, params, (batch["image"],))
            return F.cross_entropy(logits.float().flatten(0, 2), batch["mask"].long().flatten())

    return loss


def iou(model: UNet, params, batch, num_classes: int) -> torch.Tensor:
    """Mean intersection-over-union across classes (eval metric); a class
    absent from both prediction and mask counts 1."""
    with torch.no_grad():
        pred = torch.func.functional_call(model, params, (batch["image"],)).argmax(-1)
    mask = batch["mask"].to(pred.device)
    ious = []
    for c in range(num_classes):
        inter = ((pred == c) & (mask == c)).sum()
        union = ((pred == c) | (mask == c)).sum()
        one = torch.ones((), device=pred.device)
        ious.append(torch.where(union > 0, inter / union.clamp_min(1), one))
    return torch.stack(ious).float().mean()
