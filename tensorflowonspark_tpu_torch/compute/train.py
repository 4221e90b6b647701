"""Train and eval steps, on one device or on a device mesh (port of
:mod:`tensorflowonspark_tpu.compute.train`).

``build_train_step(loss_fn, optimizer)`` returns ``step(state, batch) ->
(state, loss)``: the gradient of ``loss_fn(params, batch)`` with respect to
``state.params``, one optimizer update, ``state.step + 1``. PyTorch runs
eagerly, so nothing is compiled; the params are updated in place
(:func:`optim.apply_updates`) and the returned state holds the same
tensors.

Without a mesh the step runs on ``device`` (CUDA unless named). With one
(``build_train_step(loss_fn, tx, mesh, param_shardings=…)``) the params
are DTensors placed by a layout table (``compute.layout``), the batch is
sharded on its leading dim over ``(data, fsdp)`` (``compute.mesh``), and:

- FSDP is explicit: a layer gathers a weight's ``fsdp`` shards right
  before it uses it (``parallel.context.gather_fsdp``), and the gather's
  backward reduce-scatters the gradient;
- ZeRO (``zero_sharding=True``, the default): where the mesh's ``data``
  axis is wider than 1, the gradients are redistributed into the
  'optimizer' table's update layout (each leaf's param placement plus its
  dim 0 over ``data`` where that divides), the optimizer state lives and
  updates there on 1/``data`` of each leaf, and the updated params gather
  back to their own placements. The table's rule applies to the port's
  dim 0 (the out dim of a dense weight, where the JAX package's is the in
  dim): either splits an elementwise update, so the update is bit-equal to
  the replicated one (``zero_sharding=False``) on the same gradients.

:func:`shard_state` places a state; with ``module=`` it also puts the
placed params into the module, whose own parameters a remat loss needs.
``build_bn_train_step(loss_fn, optimizer)`` is the same step for models
with BatchNorm running statistics: ``step(state, batch_stats, batch) ->
(state, new_batch_stats, loss)``. ``build_update_step`` is the weight
update alone, the harness of the optimizer's share of a step.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Callable

import numpy as np
import torch

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.compute import layout as _layout
from tensorflowonspark_tpu_torch.compute.optim import GradientTransformation, apply_updates
from tensorflowonspark_tpu_torch.obs import spans as obs_spans
from tensorflowonspark_tpu_torch.parallel.context import is_dtensor, mesh_region, use_mesh

# The span around the optimizer update, which is also its torch.profiler
# range (the JAX package's named scope of the same name).
WEIGHT_UPDATE_SCOPE = "train.weight_update"

# The layout table's per-param optimizer-state roles (Adam moments,
# masters, momentum traces).
_PER_PARAM_STATE_RE = re.compile(_layout.OPTIMIZER_PARAM_STATE_PATTERN)


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


# -- placements ------------------------------------------------------------------


def fsdp_shardings(params, mesh, min_shard_elements: int = 1024,
                   axis: str = "fsdp") -> dict[str, _layout.Sharding]:
    """FSDP placements for a dict of params: shard the largest dim that
    divides over ``axis``; tiny tensors stay replicated."""
    n = _layout.axis_sizes(mesh)[axis]
    return {
        name: _layout.sharding(mesh, _layout.fsdp_leaf_spec(
            tuple(p.shape), n, axis=axis, min_shard_elements=min_shard_elements))
        for name, p in params.items()
    }


def _zero_sharding(mesh, path: str, shape, psh: _layout.Sharding) -> _layout.Sharding:
    spec = _layout.optimizer_state_spec(path, tuple(shape), psh.spec, _layout.axis_sizes(mesh))
    return psh if spec == psh.spec else _layout.sharding(mesh, spec)


def state_shardings(state: TrainState, mesh, param_shardings, zero_sharding: bool = True):
    """Placements for a whole ``TrainState``, from the 'optimizer' table.

    Optimizer-state dicts keyed like the params (Adam moments, momentum
    traces, masters) mirror the param placements; with ``zero_sharding``
    the fields the table declares also partition over ``data``. Anything
    else (Adam's count, the step) is replicated. Returns a ``TrainState``
    whose tensor leaves are :class:`layout.Sharding`.
    """
    names = set(state.params)
    multi_leaf = len(names) > 1

    def mirrors_params(node, path: str) -> bool:
        if not isinstance(node, dict) or set(node) != names:
            return False
        return multi_leaf or bool(_PER_PARAM_STATE_RE.search(path))

    def rec(node, path: str):
        if mirrors_params(node, path):
            if not zero_sharding:
                return {n: param_shardings[n] for n in node}
            return {n: _zero_sharding(mesh, f"{path}/{n}", node[n].shape, param_shardings[n])
                    for n in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(rec(getattr(node, f), f"{path}/{f}" if path else f)
                                for f in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(rec(c, f"{path}/{i}" if path else str(i))
                              for i, c in enumerate(node))
        if isinstance(node, dict):
            return {k: rec(v, f"{path}/{k}" if path else str(k)) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            return _layout.replicated(mesh)
        return None

    return TrainState(step=state.step, params=dict(param_shardings),
                      opt_state=rec(state.opt_state, ""))


def zero_update_shardings(params, mesh, param_shardings) -> dict[str, _layout.Sharding]:
    """Placements of a param-shaped update tree (gradients, optimizer
    deltas) under the table's ZeRO rules: each param's placement plus
    ``data`` on dim 0 where it divides. The gradients are redistributed
    into these and the optimizer computes in them."""
    return {n: _zero_sharding(mesh, f"update/{n}", p.shape, param_shardings[n])
            for n, p in params.items()}


def place(t: torch.Tensor, sh: _layout.Sharding) -> torch.Tensor:
    """``t`` (a plain tensor, the same on every rank, or a DTensor) as a
    DTensor with ``sh``'s placements; a no-op where it already is one."""
    from torch.distributed.tensor import distribute_tensor

    if is_dtensor(t):
        if t.device_mesh == sh.mesh and tuple(t.placements) == sh.placements:
            return t
        return t.redistribute(sh.mesh, sh.placements)
    _layout.check_divisible("tensor", tuple(t.shape), sh.spec, _layout.axis_sizes(sh.mesh))
    return distribute_tensor(t.detach(), sh.mesh, sh.placements)


def _place_tree(node, shardings):
    if isinstance(node, torch.Tensor):
        return place(node, shardings)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_place_tree(getattr(node, f), getattr(shardings, f))
                            for f in node._fields))
    if isinstance(node, (tuple, list)):
        return type(node)(_place_tree(c, s) for c, s in zip(node, shardings))
    if isinstance(node, dict):
        return {k: _place_tree(v, shardings[k]) for k, v in node.items()}
    return node


def _adopt_params(module: torch.nn.Module, params: dict[str, torch.Tensor]) -> None:
    """Make ``params`` (name -> tensor) the parameters of ``module``."""
    for name, p in params.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        setattr(mod, leaf, p if isinstance(p, torch.nn.Parameter) else torch.nn.Parameter(p))


def shard_state(state: TrainState, mesh, param_shardings, zero_sharding: bool = True,
                module: torch.nn.Module | None = None) -> TrainState:
    """Place every tensor of ``state``: params by ``param_shardings``, the
    optimizer state by :func:`state_shardings`, scalars replicated. Every
    rank passes the same values (rank 0's are scattered). With ``module``
    the placed params also become the module's parameters, so a loss that
    recomputes blocks from the module's own parameters (remat) sees them."""
    shs = state_shardings(state, mesh, param_shardings, zero_sharding)
    params = {n: torch.nn.Parameter(place(p, shs.params[n]), requires_grad=True)
              for n, p in state.params.items()}
    if module is not None:
        _adopt_params(module, params)
    return TrainState(step=state.step, params=params,
                      opt_state=_place_tree(state.opt_state, shs.opt_state))


# -- the step ----------------------------------------------------------------


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


def _on_mesh(batch, mesh):
    """A batch as DTensors on ``mesh``: DTensors pass, host arrays and
    tensors are sharded with ``compute.mesh.shard_batch``."""
    from tensorflowonspark_tpu_torch.compute.mesh import shard_batch

    if isinstance(batch, dict):
        return {k: _on_mesh(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_on_mesh(v, mesh) for v in batch)
    if is_dtensor(batch):
        return batch
    return shard_batch(mesh, batch)


def _chunks(x, n):
    if x.shape[0] % n:
        raise ValueError(f"batch dim {x.shape[0]} not divisible by accum_steps {n}")
    if not is_dtensor(x):
        return list(x.chunk(n, dim=0))
    # each rank splits its own rows: microbatch i holds every rank's i-th
    # block, so no row moves between ranks
    from tensorflowonspark_tpu_torch.compute.mesh import from_local_batch

    local = x.to_local()
    if local.shape[0] % n:
        raise ValueError(
            f"microbatch: a rank's {local.shape[0]} rows not divisible by accum_steps {n}"
        )
    return [from_local_batch(x.device_mesh, c, x.shape[0] // n) for c in local.chunk(n, dim=0)]


def _split(batch, n):
    """The ``n`` microbatches of ``batch`` along its leading dim."""
    if isinstance(batch, dict):
        parts = {k: _split(v, n) for k, v in batch.items()}
        return [{k: parts[k][i] for k in batch} for i in range(n)]
    if isinstance(batch, (tuple, list)):
        parts = [_split(v, n) for v in batch]
        return [type(batch)(p[i] for p in parts) for i in range(n)]
    return _chunks(batch, n)


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


def _apply_weight_update(optimizer, state: TrainState, grads) -> TrainState:
    """The optimizer update shared by the train steps and
    :func:`build_update_step`, under the ``train.weight_update`` span
    (which opens the profiler range of the same name)."""
    with torch.no_grad(), obs_spans.span(WEIGHT_UPDATE_SCOPE), mesh_region(*grads.values()):
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
    return TrainState(step=state.step + 1, params=state.params, opt_state=opt_state)


def _grad_layout(mesh, param_shardings, zero_sharding: bool):
    """``grads -> grads`` in the layout the optimizer computes in: the
    table's ZeRO update placements where ``zero_sharding`` and the mesh's
    ``data`` axis is wider than 1, else the params' own (a partial sum
    that autograd left is reduced either way)."""
    if mesh is None:
        return lambda grads: grads
    zero_on = zero_sharding and _layout.axis_sizes(mesh)["data"] > 1

    def to_layout(grads):
        shs = zero_update_shardings(grads, mesh, param_shardings) if zero_on else param_shardings
        return {n: place(g, shs[n]) for n, g in grads.items()}

    return to_layout


def _loss_value(loss):
    return loss.full_tensor() if is_dtensor(loss) else loss


def _param_shardings(mesh, param_shardings, params):
    if param_shardings is not None:
        return param_shardings
    return {n: _layout.replicated(mesh) for n in params}


def make_step_fn(loss_fn, optimizer, mesh=None, accum_steps: int = 1, batch_weight_fn=None,
                 param_shardings=None, zero_sharding: bool = True, device=None):
    """The ``(state, batch) -> (state, loss)`` train step that
    :func:`build_train_step` returns (see there), without its span."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if mesh is None:
        device = resolve_device(device)
    cache: dict = {}

    def grads_of(params, batch):
        if accum_steps == 1:
            return _value_and_grad(loss_fn, params, batch)
        dev = next(iter(params.values())).device
        loss_sum = torch.zeros((), device=dev)
        w_sum = torch.zeros((), device=dev)
        grad_sum = None
        for mb in _split(batch, accum_steps):
            loss, grads = _value_and_grad(loss_fn, params, mb)
            w = (torch.ones((), device=dev) if batch_weight_fn is None
                 else _loss_value(batch_weight_fn(mb)).float())
            loss_sum = loss_sum + _loss_value(loss) * w
            grads = cache["layout"](grads)
            if grad_sum is None:
                grad_sum = {n: g.float() * w for n, g in grads.items()}
            else:
                for n, g in grads.items():
                    grad_sum[n].add_(g.float() * w)
            w_sum = w_sum + w
        # guard a fully masked batch (all counts zero) against 0/0
        inv = 1.0 / w_sum.clamp_min(1e-6)
        return loss_sum * inv, {n: g * inv for n, g in grad_sum.items()}

    def step(state: TrainState, batch):
        if "layout" not in cache:
            psh = None if mesh is None else _param_shardings(mesh, param_shardings, state.params)
            cache["layout"] = _grad_layout(mesh, psh, zero_sharding)
        if mesh is None:
            batch = _to_device(batch, device)
            loss, grads = grads_of(state.params, batch)
            return _apply_weight_update(optimizer, state, grads), loss
        batch = _on_mesh(batch, mesh)
        with use_mesh(mesh), mesh_region(*state.params.values()):
            loss, grads = grads_of(state.params, batch)
            grads = cache["layout"](grads)
        return _apply_weight_update(optimizer, state, grads), _loss_value(loss)

    return step


def build_train_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    optimizer: GradientTransformation,
    mesh=None,
    param_shardings=None,
    accum_steps: int = 1,
    batch_weight_fn: Callable[[Any], torch.Tensor] | None = None,
    zero_sharding: bool = True,
    device=None,
) -> Callable[[TrainState, Any], tuple[TrainState, torch.Tensor]]:
    """``(state, batch) -> (state, loss)``.

    Without ``mesh``: on ``device`` (CUDA unless named). With ``mesh``: the
    state is one placed by :func:`shard_state` with the same
    ``param_shardings`` (default: replicated) and ``zero_sharding``; a host
    batch is sharded over ``(data, fsdp)`` (every rank passes the same
    global batch) and a DTensor batch is taken as it is; the loss comes
    back as a plain scalar, the same on every rank.

    ``loss_fn(params, batch)`` must mean-reduce over the batch. With
    ``accum_steps > 1`` the batch's leading dim splits into that many
    microbatches whose gradients accumulate in fp32 before ONE update (on
    a mesh each rank splits its own rows). ``batch_weight_fn(microbatch)
    -> scalar`` (e.g. a valid-token count) weights each microbatch's loss
    and gradients by it and divides once by the total, reproducing the
    full-batch token weighting exactly.
    """
    step = make_step_fn(loss_fn, optimizer, mesh, accum_steps, batch_weight_fn,
                        param_shardings, zero_sharding, device)
    calls = [0]

    def wrapped(state: TrainState, batch):
        calls[0] += 1
        with obs_spans.get_tracer().step_span("train.step", step_num=calls[0]):
            return step(state, batch)

    return wrapped


def build_bn_train_step(
    loss_fn: Callable[[Any, Any, Any], tuple[torch.Tensor, Any]],
    optimizer: GradientTransformation,
    mesh=None,
    param_shardings=None,
    zero_sharding: bool = True,
    device=None,
) -> Callable[[TrainState, Any, Any], tuple[TrainState, Any, torch.Tensor]]:
    """``(state, batch_stats, batch) -> (state, new_batch_stats, loss)``
    for models with BatchNorm running statistics, on ``device`` (CUDA
    unless named) or on ``mesh`` as :func:`build_train_step` places it.

    The counterpart of the conv-net step of the JAX package's ResNet
    example (``examples/resnet/resnet_imagenet.py:120-133``, the same step
    as ``benchmarks/real_chip.py:131-144``): the gradient of
    ``loss_fn(params, batch_stats, batch) -> (loss, new_batch_stats)`` with
    respect to ``state.params`` (the statistics are an auxiliary output),
    one optimizer update, ``state.step + 1``. On a mesh the statistics are
    reduced over the whole global batch and come back as plain tensors,
    the same on every rank.
    """
    if mesh is None:
        device = resolve_device(device)
    cache: dict = {}

    def step(state: TrainState, batch_stats, batch):
        if mesh is None:
            batch = _to_device(batch, device)
            (loss, new_stats), grads = _value_and_grad(
                loss_fn, state.params, batch_stats, batch, has_aux=True
            )
            return _apply_weight_update(optimizer, state, grads), new_stats, loss
        if "layout" not in cache:
            psh = _param_shardings(mesh, param_shardings, state.params)
            cache["layout"] = _grad_layout(mesh, psh, zero_sharding)
        batch = _on_mesh(batch, mesh)
        with use_mesh(mesh), mesh_region(*state.params.values()):
            (loss, new_stats), grads = _value_and_grad(
                loss_fn, state.params, batch_stats, batch, has_aux=True
            )
            grads = cache["layout"](grads)
        new_stats = {k: _loss_value(v) for k, v in new_stats.items()}
        return _apply_weight_update(optimizer, state, grads), new_stats, _loss_value(loss)

    return step


def build_update_step(
    optimizer: GradientTransformation,
    mesh=None,
    param_shardings=None,
    zero_sharding: bool = True,
) -> Callable[[TrainState, Any], TrainState]:
    """``(state, grads) -> state``: the weight update alone.

    On ``mesh`` the gradients are put in the layout the train step hands
    the optimizer (the ZeRO update placements when ``zero_sharding`` and
    ``data`` is wider than 1; a no-op for gradients already there), so the
    optimizer's share of a step is measurable by itself. Every call runs
    under the ``train.weight_update`` span and is observed into the
    ``train_weight_update_seconds`` histogram; like ``train.step`` it
    measures the host's dispatch, so a caller timing the device
    synchronizes first.
    """
    from tensorflowonspark_tpu_torch.obs.registry import default_registry

    hist = default_registry().histogram(
        "train_weight_update_seconds",
        "wall seconds per optimizer weight-update dispatch",
    )
    cache: dict = {}

    def update(state: TrainState, grads) -> TrainState:
        if "layout" not in cache:
            psh = None if mesh is None else _param_shardings(mesh, param_shardings, state.params)
            cache["layout"] = _grad_layout(mesh, psh, zero_sharding)
        t0 = time.perf_counter()
        out = _apply_weight_update(optimizer, state, cache["layout"](dict(grads)))
        hist.observe(time.perf_counter() - t0)
        return out

    return update


def build_eval_step(metric_fn: Callable[[Any, Any], Any], device=None):
    """``(params, batch) -> metrics`` without gradients, on ``device``."""
    device = resolve_device(device)

    def run(params, batch):
        with torch.no_grad():
            return metric_fn(params, _to_device(batch, device))

    return run
