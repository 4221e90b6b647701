"""Optimizers with narrow stored state (port of
:mod:`tensorflowonspark_tpu.compute.optim`).

The transformations are pure functions over dicts of tensors, shaped like
optax's: ``init(params) -> state`` and ``update(updates, state, params)
-> (updates, state)``; :func:`apply_updates` adds the result to the
params. The state field names ``count``/``mu``/``nu``/``master`` are the
JAX package's.

- :func:`adamw` — AdamW with both moments storable in ``moment_dtype``
  (e.g. bf16). Moment math is fp32; only the stored state is narrow.
- :func:`mixed_precision_adamw` — for bf16-stored params: an fp32 master
  copy lives in the state; params are its rounding every step.
- :func:`sgd` — optax's ``sgd`` (optional momentum ``trace``), which the
  JAX package's conv-net examples call directly.
- :func:`clip_by_global_norm` and :func:`warmup_cosine_decay_schedule` —
  optax's, which the JAX package's Llama example chains in front of the
  optimizer and passes as its learning rate.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable
    # params -> the names of the leaves this transformation freezes (its
    # update of them is zero), or None: it freezes nothing
    frozen: Optional[Callable] = None


def frozen_names(tx: GradientTransformation, params) -> set:
    """The leaves of ``params`` that ``tx`` never changes: the train step
    takes no gradient of them and leaves them out of the update."""
    return set(tx.frozen(params)) if tx.frozen is not None else set()


def _map(fn, *trees):
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def _cast(tree, dtype):
    return tree if dtype is None else _map(lambda x: x.to(dtype), tree)


def _device_of(params):
    return next(iter(params.values())).device


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    def frozen(params):
        return set().union(*(frozen_names(tx, params) for tx in txs))

    return GradientTransformation(init, update, frozen)


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


def _bias_corrections(count, b1, b2):
    c = count.float()
    return 1 - torch.tensor(b1, device=c.device) ** c, 1 - torch.tensor(b2, device=c.device) ** c


def scale_by_adam(
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    moment_dtype: Optional[torch.dtype] = None,
) -> GradientTransformation:
    """Adam's direction with both moments stored in ``moment_dtype``
    (``None``: fp32). All arithmetic runs in fp32."""

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=moment_dtype or torch.float32)  # noqa: E731
        return ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
            mu=_map(zeros, params),
            nu=_map(zeros, params),
        )

    def update(updates, state, params=None):
        del params
        g32 = _cast(updates, torch.float32)
        mu32 = _map(lambda m, g: b1 * m.float() + (1 - b1) * g, state.mu, g32)
        nu32 = _map(lambda v, g: b2 * v.float() + (1 - b2) * g * g, state.nu, g32)
        count = state.count + 1
        c1, c2 = _bias_corrections(count, b1, b2)
        out = _map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps), mu32, nu32)
        return out, ScaleByAdamState(
            count=count, mu=_cast(mu32, moment_dtype), nu=_cast(nu32, moment_dtype)
        )

    return GradientTransformation(init, update)


class EmptyState(NamedTuple):
    pass


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params):
        return _map(lambda u, p: u + weight_decay * p, updates, params), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
    """``updates · (−lr)``; a callable ``learning_rate`` is a schedule of
    the step count (first step at 0), as in optax."""
    if not callable(learning_rate):
        return GradientTransformation(
            lambda params: EmptyState(),
            lambda updates, state, params=None: (
                _map(lambda u: -learning_rate * u, updates), state
            ),
        )

    def init(params):
        return ScaleByScheduleState(torch.zeros((), dtype=torch.int32, device=_device_of(params)))

    def update(updates, state, params=None):
        lr = learning_rate(state.count)
        return _map(lambda u: -lr * u, updates), ScaleByScheduleState(state.count + 1)

    return GradientTransformation(init, update)


def adamw(
    learning_rate=1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    weight_decay: float = 1e-4, moment_dtype: Optional[torch.dtype] = None,
) -> GradientTransformation:
    """AdamW whose stored moments can be bf16: adam, then ``+ wd·p``,
    then ``·(−lr)``, as the JAX package chains them."""
    return chain(
        scale_by_adam(b1, b2, eps, moment_dtype=moment_dtype),
        add_decayed_weights(weight_decay),
        scale_by_learning_rate(learning_rate),
    )


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: EmptyState(),
                                  lambda updates, state, params=None: (updates, state))


class TraceState(NamedTuple):
    trace: Any


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """optax ``trace``: ``t ← g + decay·t``; the update is ``t`` (or, with
    ``nesterov``, ``g + decay·t``). The trace has the params' dtype."""

    def init(params):
        return TraceState(trace=_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        del params
        new_trace = _map(lambda g, t: g + decay * t, updates, state.trace)
        out = _map(lambda g, t: g + decay * t, updates, new_trace) if nesterov else new_trace
        return out, TraceState(trace=new_trace)

    return GradientTransformation(init, update)


def sgd(learning_rate, momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
    """optax ``sgd``: ``trace(momentum)`` (or nothing), then ``·(−lr)``."""
    return chain(
        trace(momentum, nesterov) if momentum is not None else identity(),
        scale_by_learning_rate(learning_rate),
    )


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax ``clip_by_global_norm``: scale the updates by
    ``max_norm / ‖updates‖`` when their global norm exceeds ``max_norm``."""

    def update(updates, state, params=None):
        del params
        norm = torch.sqrt(sum((u.float() ** 2).sum() for u in updates.values()))
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        return _map(lambda u: (u * scale).to(u.dtype), updates), state

    return GradientTransformation(lambda params: EmptyState(), update)


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0, exponent: float = 1.0,
) -> Callable:
    """optax's schedule of the same name (0.2.6), step for step: linear
    from ``init_value`` to ``peak_value`` over ``warmup_steps`` (none when
    that is 0 or less), then cosine down to ``end_value`` at
    ``decay_steps`` (which counts the warm-up), constant after. Values are
    fp32, as optax's. Like optax it raises ``ValueError`` unless
    ``decay_steps > warmup_steps``; and as optax's ``alpha = end/peak``
    reads 0 for a peak of 0, such a schedule is 0 after the warm-up."""
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={cos_steps} (decay_steps {decay_steps} - warmup_steps {warmup_steps})."
        )
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    f32 = torch.float32

    def warm(c):
        if warmup_steps <= 0:
            return torch.full_like(c, init_value)
        frac = 1 - c.clamp(0, warmup_steps) / torch.tensor(float(warmup_steps), dtype=f32)
        return (init_value - peak_value) * frac + peak_value

    def cosine(c):
        c = torch.minimum(c, torch.tensor(float(cos_steps), dtype=f32, device=c.device))
        decay = 0.5 * (1 + torch.cos(torch.pi * c / cos_steps))
        return peak_value * ((1 - alpha) * decay**exponent + alpha)

    def schedule(count):
        c = count.to(f32) if isinstance(count, torch.Tensor) else torch.tensor(float(count), dtype=f32)
        return torch.where(c < warmup_steps, warm(c), cosine(c - warmup_steps))

    return schedule


class MixedPrecisionAdamWState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any
    master: Any  # fp32 copy of the (narrow) params


def mixed_precision_adamw(
    learning_rate=1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    weight_decay: float = 1e-4, moment_dtype: Optional[torch.dtype] = torch.bfloat16,
) -> GradientTransformation:
    """AdamW for bf16-stored params with an fp32 master in the state. The
    emitted update is ``master_new.to(param_dtype) − params`` in fp32, so
    the params land exactly on the master's rounding."""
    adam = scale_by_adam(b1, b2, eps, moment_dtype=moment_dtype)

    def init(params):
        inner = adam.init(params)
        return MixedPrecisionAdamWState(
            count=inner.count, mu=inner.mu, nu=inner.nu, master=_cast(params, torch.float32)
        )

    def update(grads, state, params):
        if params is None:
            raise ValueError("mixed_precision_adamw requires params")
        direction, inner = adam.update(grads, ScaleByAdamState(state.count, state.mu, state.nu))
        lr = learning_rate(state.count) if callable(learning_rate) else learning_rate
        master = _map(lambda w, d: w - lr * (d + weight_decay * w), state.master, direction)
        updates = _map(lambda w, p: w.to(p.dtype).float() - p.float(), master, params)
        return updates, MixedPrecisionAdamWState(
            count=inner.count, mu=inner.mu, nu=inner.nu, master=master
        )

    return GradientTransformation(init, update)


def set_to_zero() -> GradientTransformation:
    """optax ``set_to_zero``: every update zero, no state; it freezes every
    leaf it is given."""
    return GradientTransformation(
        lambda params: EmptyState(),
        lambda updates, state, params=None: (_map(torch.zeros_like, updates), state),
        lambda params: set(params),
    )


class MultiTransformState(NamedTuple):
    inner_states: Any  # label -> the state of that label's transformation


def multi_transform(transforms: dict, param_labels) -> GradientTransformation:
    """optax ``multi_transform``: each leaf goes through the transformation
    of its label (``param_labels``: name -> label, or a function of the
    params giving that), whose state covers its own leaves alone. An
    update that holds only some leaves (the train step leaves the frozen
    ones out) updates only those."""

    def labels_of(params):
        labels = param_labels(params) if callable(param_labels) else param_labels
        unlabelled = [n for n in params if n not in labels]
        if unlabelled:
            raise KeyError(f"multi_transform: no label for {unlabelled[:5]}")
        unknown = {labels[n] for n in params} - set(transforms)
        if unknown:
            raise KeyError(f"multi_transform: no transformation for labels {sorted(unknown)}")
        return labels

    def split(tree, labels, label):
        return {n: t for n, t in tree.items() if labels[n] == label}

    def init(params):
        labels = labels_of(params)
        parts = {label: split(params, labels, label) for label in transforms}
        # a label with no leaves holds no state (its transformation never runs)
        return MultiTransformState({label: tx.init(parts[label]) if parts[label] else None
                                    for label, tx in transforms.items()})

    def update(updates, state, params=None):
        labels = labels_of(updates)
        out, inner = {}, dict(state.inner_states)
        for label, tx in transforms.items():
            part = split(updates, labels, label)
            if not part:
                continue
            sub_params = None if params is None else {n: params[n] for n in part}
            upd, inner[label] = tx.update(part, inner[label], sub_params)
            out.update(upd)
        return {n: out[n] for n in updates}, MultiTransformState(inner)

    def frozen(params):
        labels = labels_of(params)
        return set().union(*(frozen_names(tx, split(params, labels, label))
                             for label, tx in transforms.items()))

    return GradientTransformation(init, update, frozen)


@torch.no_grad()
def apply_updates(params, updates) -> None:
    """``p ← (p + u)`` cast to p's dtype, in place: the port updates the
    params where they lie instead of allocating a second copy. An update
    laid out otherwise than its DTensor param (the ZeRO update layout) is
    gathered to the param's placements first. A leaf with no update (a
    frozen one) is left as it is."""
    for name, u in updates.items():
        p = params[name]
        placements = getattr(p, "placements", None)
        if placements is not None and tuple(u.placements) != tuple(placements):
            u = u.redistribute(p.device_mesh, placements)
        p.copy_(p + u)
