"""VGG (A/D variants: VGG-11/VGG-16) with BatchNorm (port of
:mod:`tensorflowonspark_tpu.models.vgg`).

NHWC, 3×3 SAME convs in ``cfg.dtype``, each followed by
:class:`ops.batch_norm.FusedBatchNorm` (named ``BatchNorm_<n>`` in order,
as the JAX model pins them) and ReLU; a 2×2 max-pool ends each stage. The
final grid is flattened in H, W, C order (``vgg.py:79``), so fc6's weights
carry over from the flax tree unchanged; fc6/fc7 run in ``cfg.dtype``, the
head in fp32.

``vgg_param_shardings`` waits for ROADMAP A8.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.models.conv import (
    Conv,
    Dense,
    FlaxNamed,
    classifier_loss_fn,
    init_weights,
    max_pool,
)
from tensorflowonspark_tpu_torch.ops.batch_norm import FusedBatchNorm


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    # convs per stage; each stage ends in a 2x2 maxpool
    stage_sizes: tuple[int, ...] = (2, 2, 3, 3, 3)  # VGG-16 (variant D)
    num_classes: int = 1000
    width: int = 64
    fc_features: int = 4096
    dtype: torch.dtype = torch.bfloat16
    # input side; fc6's fan-in is the final grid, (image_size / 2^stages)^2 * C
    image_size: int = 224

    @staticmethod
    def vgg11(**kw) -> "VGGConfig":
        return VGGConfig(stage_sizes=(1, 1, 2, 2, 2), **kw)

    @staticmethod
    def vgg16(**kw) -> "VGGConfig":
        return VGGConfig(**kw)

    @staticmethod
    def tiny(**overrides) -> "VGGConfig":
        base = dict(stage_sizes=(1, 1), width=8, fc_features=32, num_classes=10,
                    image_size=32)
        base.update(overrides)
        return VGGConfig(**base)


class VGG(FlaxNamed):
    """``image (B, S, S, 3) -> fp32 logits``, ``S = cfg.image_size`` (flax
    infers fc6's fan-in from the input; PyTorch needs it at construction)."""

    def __init__(self, cfg: VGGConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        cin, side, layers = 3, cfg.image_size, []
        for stage, size in enumerate(cfg.stage_sizes):
            feats = cfg.width * 2 ** min(stage, 3)  # caps at 512 like the paper
            for _ in range(size):
                conv = self.child(Conv(cin, feats, (3, 3), (1, 1), cfg.dtype, device=device))
                bn = self.child(FusedBatchNorm(feats, 0.9, 1e-5, cfg.dtype, device=device),
                                f"BatchNorm_{len(layers)}")
                layers.append((conv, bn))
                cin = feats
            side //= 2
        self.stages = tuple(
            layers[sum(cfg.stage_sizes[:i]):sum(cfg.stage_sizes[: i + 1])]
            for i in range(len(cfg.stage_sizes))
        )
        self.child(Dense(side * side * cin, cfg.fc_features, cfg.dtype, device))
        self.child(Dense(cfg.fc_features, cfg.fc_features, cfg.dtype, device))
        self.child(Dense(cfg.fc_features, cfg.num_classes, torch.float32, device))
        init_weights(self, seed, device)

    def forward(self, x, train: bool = False):
        x = x.to(self.cfg.dtype)
        for stage in self.stages:
            for conv, bn in stage:
                x = F.relu(bn(conv(x), use_running_average=not train))
            x = max_pool(x, 2, 2)
        x = x.reshape(x.shape[0], -1)  # flatten the final grid in H, W, C order (fc6 input)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


def loss_fn(model: VGG):
    """The shared BN-classifier loss (same contract as ResNet's)."""
    return classifier_loss_fn(model)
