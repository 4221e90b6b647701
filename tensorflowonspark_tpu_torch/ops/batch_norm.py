"""Train-mode BatchNorm with exact batch statistics (port of
:mod:`tensorflowonspark_tpu.ops.batch_norm`).

Tensors have their channels last (NHWC, or any ``(..., C)``); the
statistics reduce over every other dim. Forward: one statistics pass, then
``y = x·scale + shift`` in the input dtype, with ``scale`` and ``shift``
computed in fp32 and rounded once. Backward (:class:`BNTrain`, the custom
VJP of the JAX package): one statistics pass over ``(dy, x)``, then
``dx = dy·a − b − x̂·c``, the full BatchNorm gradient; the gradients that
reach the returned mean and var are ignored, as in the JAX package.

``impl`` picks the statistics route:

- ``'kernel'``: the CUDA kernels of :mod:`ops.bn_kernels` (B4 forward, B5
  backward; their plain versions for CPU tensors). The backward derives
  ``Σdy·x̂ = invstd·(Σdy·x − mean·Σdy)`` from raw sums;
- ``'xla'``: plain torch reductions, the counterpart of the JAX package's
  sibling-reduction path (``_channel_stats`` and the XLA branch of
  ``_bn_train_bwd``). Each is a separate pass over fp32 temporaries;
- ``'auto'``: ``'kernel'`` for CUDA tensors, ``'xla'`` otherwise. The JAX
  package resolves ``auto`` to XLA everywhere, because on the TPU an
  opaque ``pallas_call`` severed XLA's fusion of the statistics with the
  producing conv and the kernels lost in context. Eager PyTorch has no such
  fusion to sever: its alternative is the separate passes above, so here
  ``auto`` takes the kernels (PERF.md carries the H100 A/B).

``auto`` is resolved once, at the forward, and the route is saved for the
backward, so a forward and a backward never pair different routes. JAX's
``'pallas'`` is accepted as a name for ``'kernel'``.

On a device mesh (DTensor activations, batch over ``(data, fsdp)``) the
``kernel`` route takes ``bn_kernels.mesh_pair_stats`` and
``mesh_cross_stats``: the kernels on each rank's rows, then an
``all_reduce``. The JAX package routes the statistics through its mesh
only for an explicit ``impl='pallas'``, because its ``auto`` is XLA; the
port's ``auto`` takes the kernels on CUDA, so its mesh route follows its
own ``auto``. ``xla`` on a mesh is DTensor's own reductions.

The port calls no library BatchNorm.
"""

from __future__ import annotations

import torch
from torch import nn

from tensorflowonspark_tpu_torch.ops import bn_kernels
from tensorflowonspark_tpu_torch.parallel.context import is_dtensor

IMPLS = ("xla", "kernel", "auto")


def _checked(impl: str) -> str:
    impl = "kernel" if impl == "pallas" else impl
    if impl not in IMPLS:
        raise ValueError(f"impl must be xla|kernel|auto, got {impl!r}")
    return impl


def resolve_impl(impl: str, x) -> str:
    """``'kernel'`` or ``'xla'`` for this tensor."""
    impl = _checked(impl)
    if impl == "auto":
        return "kernel" if x.device.type == "cuda" else "xla"
    return impl


def _reduce_extent(x) -> int:
    return x.numel() // x.shape[-1]


def _lead_dims(x) -> tuple[int, ...]:
    return tuple(range(x.dim() - 1))


def batch_norm_stats(x, impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """One-pass per-channel ``(mean, var)`` over all but the last dim, fp32;
    ``var = max(E[x²] − mean², 0)``."""
    n = _reduce_extent(x)
    if resolve_impl(impl, x) == "kernel":
        s, s2 = (bn_kernels.mesh_pair_stats if is_dtensor(x) else bn_kernels.pair_stats)(x)
    else:
        xf = x.float()
        dims = _lead_dims(x)
        s, s2 = xf.sum(dims), (xf * xf).sum(dims)
    mean = s / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    return mean, var


def _normalize(x, gamma, beta, mean, invstd):
    gamma_f = gamma.float()
    scale = (invstd * gamma_f).to(x.dtype)
    shift = (beta.float() - mean * invstd * gamma_f).to(x.dtype)
    return x * scale + shift


class BNTrain(torch.autograd.Function):
    """``(x, gamma, beta, eps, impl) -> (y, mean, var)``, ``impl`` already
    resolved; saves ``(x, gamma, mean, invstd)``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, impl):
        mean, var = batch_norm_stats(x, impl)
        invstd = torch.rsqrt(var + eps)
        y = _normalize(x, gamma, beta, mean, invstd)
        ctx.save_for_backward(x, gamma, mean, invstd)
        ctx.impl = impl
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, invstd = ctx.saved_tensors
        n = _reduce_extent(x)
        if ctx.impl == "kernel":
            cross = bn_kernels.mesh_cross_stats if is_dtensor(x) else bn_kernels.cross_stats
            sum_dy, sum_dy_x = cross(dy, x)
            sum_dy_xhat = invstd * (sum_dy_x - mean * sum_dy)
            xhat = ((x.float() - mean) * invstd).to(x.dtype)
        else:
            dims = _lead_dims(x)
            xhat_f = (x.float() - mean) * invstd
            dy_f = dy.float()
            sum_dy, sum_dy_xhat = dy_f.sum(dims), (dy_f * xhat_f).sum(dims)
            xhat = xhat_f.to(x.dtype)
        gamma_f = gamma.float()
        # dx = gamma·invstd·(dy − Σdy/n − x̂·Σdy·x̂/n)
        a = (gamma_f * invstd).to(x.dtype)
        b = (gamma_f * invstd * sum_dy / n).to(x.dtype)
        c = (gamma_f * invstd * sum_dy_xhat / n).to(x.dtype)
        dx = dy * a - b - xhat * c
        return dx, sum_dy_xhat.to(gamma.dtype), sum_dy.to(gamma.dtype), None, None


def bn_train(x, gamma, beta, eps: float, impl: str = "auto"):
    """Train-mode BatchNorm: ``(y, mean, var)`` with exact batch statistics;
    ``mean`` and ``var`` (fp32, for the running averages) take no gradient."""
    return BNTrain.apply(x, gamma, beta, eps, resolve_impl(impl, x))


def fused_batch_norm(x, gamma, beta, eps: float, impl: str = "auto"):
    """Batch-normalize ``x`` with its own statistics (train mode)."""
    y, _, _ = bn_train(x, gamma, beta, eps, impl)
    return y


class FusedBatchNorm(nn.Module):
    """flax ``FusedBatchNorm``: params ``scale``/``bias`` (fp32), running
    statistics ``mean``/``var`` (fp32 buffers, the ``batch_stats``
    collection).

    Train (``use_running_average=False``) normalizes with the batch's
    statistics and leaves the updated running statistics, ``m·running +
    (1 − m)·batch`` with detached batch values, in ``self.updated``; the
    buffers themselves are not written (:func:`pop_batch_stats` collects
    the updates). Eval normalizes with the running statistics.
    """

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 dtype: torch.dtype | None = None, impl: str = "auto", device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.impl = impl
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.updated = None

    def forward(self, x, use_running_average: bool = False):
        dtype = self.dtype or x.dtype
        x = x.to(dtype)
        if use_running_average:
            invstd = torch.rsqrt(self.var + self.epsilon)
            scale = (invstd * self.scale).to(dtype)
            shift = (self.bias - self.mean * invstd * self.scale).to(dtype)
            return x * scale + shift
        y, mean, var = bn_train(x, self.scale, self.bias, self.epsilon, self.impl)
        m = self.momentum
        self.updated = (m * self.mean + (1.0 - m) * mean.detach(),
                        m * self.var + (1.0 - m) * var.detach())
        return y


def pop_batch_stats(model: nn.Module) -> dict[str, torch.Tensor]:
    """The running statistics that the last train-mode forward of ``model``
    computed, named as its buffers (``<module>.mean``, ``<module>.var``);
    each module's record is cleared."""
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, FusedBatchNorm) and mod.updated is not None:
            prefix = f"{name}." if name else ""
            out[prefix + "mean"], out[prefix + "var"] = mod.updated
            mod.updated = None
    return out


def set_impl(model: nn.Module, impl: str) -> None:
    """Route every :class:`FusedBatchNorm` of ``model`` through ``impl``."""
    impl = _checked(impl)
    for mod in model.modules():
        if isinstance(mod, FusedBatchNorm):
            mod.impl = impl
