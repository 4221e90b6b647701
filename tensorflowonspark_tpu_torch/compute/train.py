"""Single-device train and eval steps (port of
:mod:`tensorflowonspark_tpu.compute.train`).

``build_train_step(loss_fn, optimizer)`` returns ``step(state, batch) ->
(state, loss)``: the gradient of ``loss_fn(params, batch)`` with respect to
``state.params``, one optimizer update, ``state.step + 1``. PyTorch runs
eagerly, so nothing is compiled; the params are updated in place
(:func:`optim.apply_updates`) and the returned state holds the same
tensors. Mesh, ZeRO and ``shard_state`` wait for ROADMAP A8.

``build_bn_train_step(loss_fn, optimizer)`` is the same step for models
with BatchNorm running statistics: ``step(state, batch_stats, batch) ->
(state, new_batch_stats, loss)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.compute.optim import GradientTransformation, apply_updates

# Profiler range around the optimizer update (the JAX package's named
# scope of the same name).
WEIGHT_UPDATE_SCOPE = "train.weight_update"


@dataclasses.dataclass
class TrainState:
    """Step counter, params (name -> tensor) and optimizer state."""

    step: int
    params: dict[str, torch.Tensor]
    opt_state: Any

    @classmethod
    def create(cls, params, tx: GradientTransformation) -> "TrainState":
        params = dict(params)
        return cls(step=0, params=params, opt_state=tx.init(params))


def _to_device(batch, device):
    """Move a batch (a tensor, an array, or a dict/tuple of them) to ``device``."""
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_device(v, device) for v in batch)
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch).to(device)
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return batch


def _split(batch, n):
    """The ``n`` microbatches of ``batch`` along its leading dim."""
    if isinstance(batch, dict):
        parts = {k: _split(v, n) for k, v in batch.items()}
        return [{k: parts[k][i] for k in batch} for i in range(n)]
    if isinstance(batch, (tuple, list)):
        parts = [_split(v, n) for v in batch]
        return [type(batch)(p[i] for p in parts) for i in range(n)]
    if batch.shape[0] % n:
        raise ValueError(f"batch dim {batch.shape[0]} not divisible by accum_steps {n}")
    return list(batch.chunk(n, dim=0))


def _value_and_grad(loss_fn, params, *args, has_aux=False):
    """``(loss, grads)``, or ``((loss, aux), grads)`` when ``loss_fn``
    returns ``(loss, aux)``."""
    names = list(params)
    leaves = [params[n] for n in names]
    for p in leaves:
        p.requires_grad_(True)
    out = loss_fn(params, *args)
    loss, aux = out if has_aux else (out, None)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {
        n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, leaves, grads)
    }
    return ((loss.detach(), aux) if has_aux else loss.detach()), grads


def _apply(optimizer, state: "TrainState", grads) -> "TrainState":
    with torch.no_grad(), torch.profiler.record_function(WEIGHT_UPDATE_SCOPE):
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
    return TrainState(step=state.step + 1, params=state.params, opt_state=opt_state)


def build_train_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    optimizer: GradientTransformation,
    device=None,
    accum_steps: int = 1,
    batch_weight_fn: Callable[[Any], torch.Tensor] | None = None,
) -> Callable[[TrainState, Any], tuple[TrainState, torch.Tensor]]:
    """``(state, batch) -> (state, loss)`` on ``device`` (CUDA unless named).

    ``loss_fn(params, batch)`` must mean-reduce over the batch. With
    ``accum_steps > 1`` the batch's leading dim splits into that many
    microbatches whose gradients accumulate in fp32 before ONE update.
    ``batch_weight_fn(microbatch) -> scalar`` (e.g. a valid-token count)
    weights each microbatch's loss and gradients by it and divides once by
    the total, reproducing the full-batch token weighting exactly.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    device = resolve_device(device)

    def grads_of(params, batch):
        if accum_steps == 1:
            return _value_and_grad(loss_fn, params, batch)
        loss_sum = torch.zeros((), device=device)
        w_sum = torch.zeros((), device=device)
        grad_sum = {n: torch.zeros(p.shape, dtype=torch.float32, device=device)
                    for n, p in params.items()}
        for mb in _split(batch, accum_steps):
            loss, grads = _value_and_grad(loss_fn, params, mb)
            w = (torch.ones((), device=device) if batch_weight_fn is None
                 else batch_weight_fn(mb).float())
            loss_sum = loss_sum + loss * w
            for n, g in grads.items():
                grad_sum[n].add_(g.float() * w)
            w_sum = w_sum + w
        # guard a fully masked batch (all counts zero) against 0/0
        inv = 1.0 / w_sum.clamp_min(1e-6)
        return loss_sum * inv, {n: g * inv for n, g in grad_sum.items()}

    def step(state: TrainState, batch):
        batch = _to_device(batch, device)
        loss, grads = grads_of(state.params, batch)
        return _apply(optimizer, state, grads), loss

    return step


def build_bn_train_step(
    loss_fn: Callable[[Any, Any, Any], tuple[torch.Tensor, Any]],
    optimizer: GradientTransformation,
    device=None,
) -> Callable[[TrainState, Any, Any], tuple[TrainState, Any, torch.Tensor]]:
    """``(state, batch_stats, batch) -> (state, new_batch_stats, loss)`` on
    ``device`` (CUDA unless named), for models with BatchNorm running
    statistics.

    The counterpart of the conv-net step of the JAX package's ResNet
    example (``examples/resnet/resnet_imagenet.py:120-133``, the same step
    as ``benchmarks/real_chip.py:131-144``): the gradient of
    ``loss_fn(params, batch_stats, batch) -> (loss, new_batch_stats)`` with
    respect to ``state.params`` (the statistics are an auxiliary output),
    one optimizer update, ``state.step + 1``.
    """
    device = resolve_device(device)

    def step(state: TrainState, batch_stats, batch):
        batch = _to_device(batch, device)
        (loss, new_stats), grads = _value_and_grad(
            loss_fn, state.params, batch_stats, batch, has_aux=True
        )
        return _apply(optimizer, state, grads), new_stats, loss

    return step


def build_eval_step(metric_fn: Callable[[Any, Any], Any], device=None):
    """``(params, batch) -> metrics`` without gradients, on ``device``."""
    device = resolve_device(device)

    def run(params, batch):
        with torch.no_grad():
            return metric_fn(params, _to_device(batch, device))

    return run
