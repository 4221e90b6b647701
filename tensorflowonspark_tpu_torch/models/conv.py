"""Layers shared by the BatchNorm conv nets (ResNet, VGG, Inception-v3):
flax's ``nn.Conv``, ``nn.Dense``, pooling and auto-naming in PyTorch.

Activations are NHWC at every function boundary, as in the JAX package.
A convolution views its NHWC input as NCHW (``permute(0, 3, 1, 2)`` of an
NHWC-contiguous tensor is a zero-copy ``channels_last`` tensor) and
permutes its output back, so each BatchNorm input is contiguous NHWC and
its ``(rows, C)`` view is free.

``SAME`` padding is flax's (``lax.padtype_to_pads``): the total padding
``max((out − 1)·s + k − in, 0)`` goes ``total // 2`` before and the rest
after, which is asymmetric on every stride-2 window over an even size. A
symmetric ``padding=`` argument is used where the two sides agree; an
asymmetric one is an explicit ``F.pad`` (a copy of the input).

Weights are stored fp32: conv kernels OIHW (flax: HWIO), dense weights
``(out, in)`` (flax: ``(in, out)``); each layer casts them and its input to
its ``dtype``. A model's ``named_parameters()`` are flax's ``params``, its
``named_buffers()`` (the BatchNorm running statistics) flax's
``batch_stats``; the BatchNorm route of a whole model is set with
:func:`ops.batch_norm.set_impl`. :class:`FlaxNamed` registers children under flax's
auto-names (``_ConvBN_0``, ``Conv_0``, ``BottleneckBlock_3`` …), so
parameter names are the flax paths joined with dots and
:mod:`models.convert` maps the trees leaf by leaf.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.ops.batch_norm import FusedBatchNorm, pop_batch_stats


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """``(before, after)`` padding of one spatial dim under flax ``SAME``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class FlaxNamed(nn.Module):
    """A module whose children get flax's auto-names: ``<Class>_<k>``, ``k``
    counting the children of that class in the order they are added."""

    def __init__(self):
        super().__init__()
        self._auto_names: dict[str, int] = {}

    def child(self, module: nn.Module, name: str | None = None) -> nn.Module:
        if name is None:
            cls = type(module).__name__
            k = self._auto_names.get(cls, 0)
            self._auto_names[cls] = k + 1
            name = f"{cls}_{k}"
        self.add_module(name, module)
        return module


def _pad_nhwc(x, pads_h, pads_w, value=0.0):
    if pads_h == (0, 0) and pads_w == (0, 0):
        return x
    return F.pad(x, (0, 0, *pads_w, *pads_h), value=value)


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel, strides, padding="SAME",
    use_bias=False, dtype)`` on NHWC tensors; weight OIHW."""

    def __init__(self, cin: int, cout: int, kernel, strides=(1, 1), dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.kernel, self.strides, self.dtype = tuple(kernel), tuple(strides), dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, *self.kernel, device=device))

    def forward(self, x):
        x = x.to(self.dtype)
        pad = (0, 0)
        ph, pw = (same_pads(n, k, s) for n, k, s in zip(x.shape[1:3], self.kernel, self.strides))
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x = _pad_nhwc(x, ph, pw)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(self.dtype), stride=self.strides,
                     padding=pad)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``nn.Dense(features, dtype)``: ``x·W + b`` in ``dtype`` (the
    product rounded, then the bias added, as flax does)."""

    def __init__(self, din: int, dout: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dout, din, device=device))
        self.bias = nn.Parameter(torch.zeros(dout, device=device))

    def forward(self, x):
        x = x.to(self.dtype)
        return F.linear(x, self.weight.to(self.dtype)) + self.bias.to(self.dtype)


def max_pool(x, window: int, stride: int, padding: str = "VALID"):
    """flax ``nn.max_pool`` on NHWC; ``SAME`` pads with −inf."""
    if padding == "SAME":
        ph, pw = (same_pads(n, window, stride) for n in x.shape[1:3])
        x = _pad_nhwc(x, ph, pw, value=-math.inf)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def avg_pool(x, window: int, stride: int, padding: str = "VALID"):
    """flax ``nn.avg_pool`` on NHWC (zero padding counted, as flax's
    ``count_include_pad=True``)."""
    ph = pw = (0, 0)
    if padding == "SAME":
        ph, pw = (same_pads(n, window, stride) for n in x.shape[1:3])
    if ph[0] == ph[1] and pw[0] == pw[1]:
        pad = (ph[0], pw[0])
    else:
        x, pad = _pad_nhwc(x, ph, pw), (0, 0)
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride, padding=pad, count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x):
    """``jnp.mean(x, axis=(1, 2))``: summed in fp32, returned in x's dtype."""
    return x.float().mean((1, 2)).to(x.dtype)


class _ConvBN(FlaxNamed):
    """conv → FusedBatchNorm → ReLU (unless ``act`` is off), the unit of
    ResNet and Inception (``models/resnet.py:_ConvBN``,
    ``models/inception.py:_ConvBN``)."""

    def __init__(self, cin: int, cout: int, kernel, strides, dtype, act: bool = True,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.act = act
        self.child(Conv(cin, cout, kernel, strides, dtype, device=device))
        self.child(FusedBatchNorm(cout, 0.9, eps, dtype, device=device), "BatchNorm_0")

    def forward(self, x, train: bool):
        x = self.BatchNorm_0(self.Conv_0(x), use_running_average=not train)
        return F.relu(x) if self.act else x


def init_weights(model: nn.Module, seed: int, device) -> None:
    """Conv and dense weights from ``seed``: normal with std 1/√fan_in (flax's
    lecun_normal, untruncated); BatchNorm scales 1, biases 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight"):
                p.normal_(0.0, (p[0].numel()) ** -0.5, generator=gen)


def classifier_loss_fn(model: nn.Module, aux_weight: float = 0.0, **forward_kwargs):
    """``loss(params, batch_stats, batch) -> (loss, new_batch_stats)`` for
    batches ``{'image': (B, H, W, 3), 'label': (B,)}``: mean softmax cross
    entropy on integer labels, the model run in train mode with ``params``
    and ``batch_stats`` in place of its own tensors. A model that returns
    ``(logits, aux_logits)`` adds ``aux_weight ×`` the aux head's loss."""

    def loss(params, batch_stats, batch):
        out = torch.func.functional_call(
            model, {**params, **batch_stats}, (batch["image"],), {"train": True, **forward_kwargs}
        )
        new_stats = pop_batch_stats(model)
        logits, aux = out if isinstance(out, tuple) else (out, None)
        labels = batch["label"].long()
        total = F.cross_entropy(logits.float(), labels)
        if aux is not None:
            total = total + aux_weight * F.cross_entropy(aux.float(), labels)
        return total, new_stats

    return loss
