"""ResNet-v1.5 family (port of :mod:`tensorflowonspark_tpu.models.resnet`).

NHWC at the model's boundary (``image`` is ``(B, H, W, 3)``), convs in
``cfg.dtype`` (bf16), BatchNorm statistics in fp32 through
:class:`ops.batch_norm.FusedBatchNorm` (``auto``: the CUDA statistics
kernels on a GPU), fp32 classifier head. v1.5: the stride
of a bottleneck block sits on its 3×3 conv. Parameter names are the flax
paths (``_ConvBN_0.Conv_0.weight``, ``BottleneckBlock_0._ConvBN_1.BatchNorm_0.scale``
…); running statistics are buffers (``….BatchNorm_0.mean``/``var``).

``resnet_param_shardings`` is ``models.conv.conv_param_shardings``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.models.conv import (
    conv_param_shardings,
    Dense,
    FlaxNamed,
    _ConvBN,
    classifier_loss_fn,
    global_avg_pool,
    init_weights,
    max_pool,
)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)
    bottleneck: bool = True
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def resnet18(**kw) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(2, 2, 2, 2), bottleneck=False, **kw)

    @staticmethod
    def resnet34(**kw) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(3, 4, 6, 3), bottleneck=False, **kw)

    @staticmethod
    def resnet50(**kw) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(3, 4, 6, 3), bottleneck=True, **kw)

    @staticmethod
    def resnet101(**kw) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(3, 4, 23, 3), bottleneck=True, **kw)

    @staticmethod
    def tiny(**overrides) -> "ResNetConfig":
        """Test-size config: 2 stages, thin width, bottleneck on."""
        base = dict(stage_sizes=(1, 1), width=8, num_classes=10)
        base.update(overrides)
        return ResNetConfig(**base)


class BasicBlock(FlaxNamed):
    expansion = 1

    def __init__(self, cin, features, strides, dtype, device=None):
        super().__init__()
        cbn = lambda *a, **k: _ConvBN(*a, dtype=dtype, device=device, **k)  # noqa: E731
        self.child(cbn(cin, features, (3, 3), strides))
        self.child(cbn(features, features, (3, 3), (1, 1), act=False))
        # the JAX block projects when the residual's shape differs
        self.project = tuple(strides) != (1, 1) or cin != features
        if self.project:
            self.child(cbn(cin, features, (1, 1), strides, act=False))

    def forward(self, x, train: bool):
        y = self._ConvBN_1(self._ConvBN_0(x, train), train)
        residual = self._ConvBN_2(x, train) if self.project else x
        return F.relu(y + residual)


class BottleneckBlock(FlaxNamed):
    expansion = 4

    def __init__(self, cin, features, strides, dtype, device=None):
        super().__init__()
        cbn = lambda *a, **k: _ConvBN(*a, dtype=dtype, device=device, **k)  # noqa: E731
        self.child(cbn(cin, features, (1, 1), (1, 1)))
        # v1.5: the stride lives on the 3x3, not the first 1x1
        self.child(cbn(features, features, (3, 3), strides))
        self.child(cbn(features, features * 4, (1, 1), (1, 1), act=False))
        self.project = tuple(strides) != (1, 1) or cin != features * 4
        if self.project:
            self.child(cbn(cin, features * 4, (1, 1), strides, act=False))

    def forward(self, x, train: bool):
        y = self._ConvBN_2(self._ConvBN_1(self._ConvBN_0(x, train), train), train)
        residual = self._ConvBN_3(x, train) if self.project else x
        return F.relu(y + residual)


class ResNet(FlaxNamed):
    """``image (B, H, W, 3) -> fp32 logits (B, num_classes)``, built on
    ``device`` (CUDA unless the caller passes another) with weights drawn
    from ``seed``."""

    def __init__(self, cfg: ResNetConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dt = cfg.dtype
        self.child(_ConvBN(3, cfg.width, (7, 7), (2, 2), dt, device=device))
        block = BottleneckBlock if cfg.bottleneck else BasicBlock
        cin, blocks = cfg.width, []
        for stage, size in enumerate(cfg.stage_sizes):
            for i in range(size):
                strides = (2, 2) if stage > 0 and i == 0 else (1, 1)
                feats = cfg.width * 2**stage
                blocks.append(self.child(block(cin, feats, strides, dt, device)))
                cin = feats * block.expansion
        self.blocks = tuple(blocks)
        # classifier head in fp32 for a stable softmax
        self.child(Dense(cin, cfg.num_classes, torch.float32, device))
        init_weights(self, seed, device)

    def forward(self, x, train: bool = False):
        x = x.to(self.cfg.dtype)
        x = self._ConvBN_0(x, train)
        x = max_pool(x, 3, 2, "SAME")
        for blk in self.blocks:
            x = blk(x, train)
        return self.Dense_0(global_avg_pool(x))


def loss_fn(model: ResNet):
    """``loss(params, batch_stats, batch) -> (loss, new_batch_stats)`` for
    batches ``{'image', 'label'}`` (``models/resnet.py:loss_fn``)."""
    return classifier_loss_fn(model)


# the 'resnet' layout table's placements (``models.conv.conv_param_shardings``)
resnet_param_shardings = conv_param_shardings
