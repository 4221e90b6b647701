"""LoRA: low-rank adapters for parameter-efficient fine-tuning and
multi-tenant serving (port of :mod:`tensorflowonspark_tpu.ops.lora`).

``w_eff = base + (b @ a) · scale`` with the base frozen: only the rank-r
factors train, so gradients and optimizer moments exist for the adapters
alone. The names and semantics are the JAX package's; the layouts are the
port's ``(out, in)``:

- :class:`LoraTensor` — ``base`` ``(out, in)``, ``a`` ``(r, in)`` (the JAX
  package's ``(in, r)``, transposed), ``b`` ``(out, r)`` (``(r, out)``
  there), ``scale = alpha / r``;
- :class:`MultiLoraTensor` — a bank of K adapters over one base: ``a``
  ``(K, r, in)``, ``b`` ``(K, out, r)``, routed per batch row.

The weight set. A model's parameters are one flat ``name -> tensor`` dict;
a dense weight ``n`` with an adapter (or a bank) keeps its base under
``n`` and adds ``n + "_lora_a"``, ``n + "_lora_b"`` and ``n +
"_lora_scale"`` (a 0-d tensor: the JAX package keeps the scale as a
static field that no checkpoint stores, see :func:`rewrap_lora`). The
functions here take and return such dicts; ``models.llama.Dense``
consumes the entries, ``models.convert`` maps them to the JAX package's
nodes. The base enters the products through ``.detach()`` (the JAX
package's ``stop_gradient``), so autograd never builds its gradient
products, and :func:`lora_optimizer` gives the frozen leaves no moments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

DEFAULT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)
# the names of an adapted leaf's factors and scale: the base's name + suffix
A, B, S = "_lora_a", "_lora_b", "_lora_scale"


@dataclasses.dataclass(frozen=True)
class LoraTensor:
    """``w_eff = base + (b @ a) * scale`` with ``base`` frozen; ``b`` starts
    at zero, so a fresh adapter is an exact no-op."""

    base: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    scale: float | torch.Tensor = 1.0

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype


@dataclasses.dataclass(frozen=True)
class MultiLoraTensor:
    """``w_eff(row) = base + (b[id] @ a[id]) * scale``: a bank of K adapters
    over one shared frozen base, routed per batch row by integer id. Slot 0
    is the zero adapter (:func:`multi_lora_bank` makes it so), where plain
    requests route and run the base model exactly."""

    base: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    scale: float | torch.Tensor = 1.0

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def n_adapters(self) -> int:
        return self.a.shape[0]


def lora_apply(x: torch.Tensor, w: LoraTensor) -> torch.Tensor:
    """``x @ w_effᵀ`` without the merged matrix: the base product plus two
    skinny adapter products, the scale applied last."""
    y = F.linear(x, w.base.detach().to(x.dtype))
    lo = F.linear(F.linear(x, w.a.to(x.dtype)), w.b.to(x.dtype))
    return y + lo * w.scale


def multi_lora_apply(x: torch.Tensor, w: MultiLoraTensor,
                     adapter_ids: torch.Tensor) -> torch.Tensor:
    """``x[i] @ w_eff(adapter_ids[i])ᵀ`` for x (B, S, in), ids (B,): one base
    product for every row, then each row's gathered factors ``(B, r, in)``
    and ``(B, out, r)``, never a merged matrix. The same term order as
    :func:`lora_apply`, so a row routed to adapter k matches that adapter
    alone up to rounding. Ids must lie in ``[0, K)``: the callers check."""
    y = F.linear(x, w.base.detach().to(x.dtype))
    a_sel = w.a[adapter_ids].to(x.dtype)
    b_sel = w.b[adapter_ids].to(x.dtype)
    lo = torch.matmul(torch.matmul(x, a_sel.transpose(1, 2)), b_sel.transpose(1, 2))
    return y + lo * w.scale


def lora_names(params: dict) -> list[str]:
    """The base names of a weight set's adapted leaves (single or bank)."""
    return [n[: -len(A)] for n in params if n.endswith(A)]


def lora_of(params: dict, name: str):
    """Leaf ``name`` as a :class:`LoraTensor` or :class:`MultiLoraTensor`,
    or None when it has no adapter."""
    a = params.get(name + A)
    if a is None:
        return None
    cls = MultiLoraTensor if a.dim() == 3 else LoraTensor
    return cls(base=params[name], a=a, b=params[name + B], scale=params[name + S])


def _scale_tensor(scale: float, device) -> torch.Tensor:
    return torch.tensor(float(scale), dtype=torch.float32, device=device)


def add_lora(params: dict, rank: int, generator: torch.Generator,
             targets: Sequence[str] = DEFAULT_TARGETS, alpha: float | None = None,
             dtype=torch.float32) -> dict:
    """Wrap every 2-D leaf whose name contains a target: returns a new
    weight set with each such leaf's ``a`` drawn normal / sqrt(in) from
    ``generator`` (on its device), ``b`` zero and ``scale = alpha / rank``
    (``alpha`` defaults to ``rank``). The wrapped set's forward is exactly
    the base's until the adapters train. The base tensors are the caller's
    own (no copy)."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    scale = (alpha if alpha is not None else float(rank)) / float(rank)
    out = {}
    n_wrapped = 0
    for name, leaf in params.items():
        out[name] = leaf
        if leaf.dim() == 2 and any(t in name for t in targets):
            d_out, d_in = leaf.shape
            if rank > min(d_in, d_out):
                raise ValueError(f"rank {rank} exceeds min dim of {name} {(d_in, d_out)}")
            a = torch.randn(rank, d_in, generator=generator, dtype=dtype,
                            device=generator.device) / math.sqrt(d_in)
            out[name + A] = a.to(leaf.device)
            out[name + B] = torch.zeros(d_out, rank, dtype=dtype, device=leaf.device)
            out[name + S] = _scale_tensor(scale, leaf.device)
            n_wrapped += 1
    if n_wrapped == 0:
        raise ValueError(f"no 2-D params matched targets {tuple(targets)}; nothing to adapt")
    return out


def _factor_names(params: dict) -> set:
    return {n + sfx for n in lora_names(params) for sfx in (A, B, S)}


@torch.no_grad()
def merge_lora(params: dict) -> dict:
    """Fold trained single adapters into plain weights (``base + (b @ a) ·
    s`` in fp32, back in the base's dtype); banks stay as they are, as in
    the JAX package. The merged set drops the factors and is a drop-in for
    every consumer of the original params."""
    out = {}
    drop = set()
    for name in lora_names(params):
        w = lora_of(params, name)
        if isinstance(w, LoraTensor):
            merged = w.base.float() + (w.b.float() @ w.a.float()) * float(w.scale)
            out[name] = merged.to(w.base.dtype)
            drop.update(name + sfx for sfx in (A, B, S))
    return {n: out.get(n, t) for n, t in params.items() if n not in drop}


def lora_labels(params: dict) -> dict[str, str]:
    """``'train'`` / ``'freeze'`` per leaf for ``optim.multi_transform``:
    single adapters' factors train; every other leaf, each base, each
    scale and a bank's factors freeze (as the JAX package labels them)."""
    def label(name, t):
        return "train" if (name.endswith(A) or name.endswith(B)) and t.dim() == 2 else "freeze"

    return {n: label(n, t) for n, t in params.items()}


def lora_optimizer(tx, params: dict):
    """Wrap ``tx`` so that only adapter leaves get optimizer state and
    updates: the frozen leaves carry ``set_to_zero`` (no moments), and the
    train step computes no gradient for them
    (``compute.train``, through ``optim.frozen_names``)."""
    from tensorflowonspark_tpu_torch.compute import optim

    return optim.multi_transform(
        {"train": tx, "freeze": optim.set_to_zero()}, lora_labels(params)
    )


def multi_lora_bank(adapters: Sequence[dict]) -> dict:
    """Stack N single-adapter weight sets (from :func:`add_lora`, trained or
    not) into a served bank over the first set's bases. Slot 0 is the zero
    adapter (the exact base model); the adapters take slots 1..N. Every set
    must adapt the same leaves with the same rank and scale, and wrap the
    same base (the same tensor, else equal first 64 elements)."""
    if not adapters:
        raise ValueError("need at least one adapter tree")
    first = adapters[0]
    names = lora_names(first)
    for i, t in enumerate(adapters[1:], 1):
        if set(t) != set(first) or set(lora_names(t)) != set(names):
            raise ValueError(
                f"adapter {i} has a different tree structure than adapter 0 "
                "(different LoRA targets?)"
            )
    out = {n: t for n, t in first.items() if n not in _factor_names(first)}
    for name in names:
        w0 = lora_of(first, name)
        if not isinstance(w0, LoraTensor):
            raise ValueError(f"{name}: adapter 0 holds a bank, not a single adapter")
        ws = [lora_of(t, name) for t in adapters]
        for i, w in enumerate(ws[1:], 1):
            if w.a.shape != w0.a.shape or float(w.scale) != float(w0.scale):
                raise ValueError(
                    f"adapter {i} rank/scale mismatch: {tuple(w.a.shape)}/{float(w.scale)} "
                    f"vs {tuple(w0.a.shape)}/{float(w0.scale)}"
                )
            if w.base is not w0.base:
                # adapters fine-tuned from different base checkpoints would
                # serve on adapter 0's base: a 64-element sample catches it
                sa = w.base.detach().reshape(-1)[:64].cpu()
                sb = w0.base.detach().reshape(-1)[:64].cpu()
                if not torch.equal(sa, sb):
                    raise ValueError(
                        f"adapter {i} wraps a different base weight than adapter 0 — all bank "
                        "adapters must be fine-tunes of the SAME base checkpoint"
                    )
        out[name + A] = torch.stack([torch.zeros_like(w0.a)] + [w.a for w in ws])
        out[name + B] = torch.stack([torch.zeros_like(w0.b)] + [w.b for w in ws])
        out[name + S] = w0.scale
    return out


def select_adapter(params: dict, k: int) -> dict:
    """Slot ``k`` of every bank as a single adapter: the reference path for
    tests and for exporting one tenant's model (``merge_lora(
    select_adapter(bank, k))``)."""
    out = dict(params)
    for name in lora_names(params):
        if params[name + A].dim() == 3:
            out[name + A] = params[name + A][k]
            out[name + B] = params[name + B][k]
    return out


def bank_size(params: dict) -> int:
    """The adapter slots of a bank weight set (0: no bank)."""
    return max((params[n + A].shape[0] for n in lora_names(params)
                if params[n + A].dim() == 3), default=0)


def rewrap_lora(tree: dict, scale: float = 1.0) -> dict:
    """Re-supply every adapter's scale on a restored weight set, as the
    JAX package's ``rewrap_lora`` does on a checkpoint restored without a
    target (where the static scale is not stored): each adapted leaf (2-D
    ``a``: an adapter, 3-D: a bank) gets ``scale`` as its ``_lora_scale``,
    whether the set held one or not. ``scale`` must be given when the
    fine-tune used ``alpha != rank``; 0.0 turns the adapters off."""
    out = dict(tree)
    for name in lora_names(tree):
        if name + B not in tree:
            raise ValueError(f"{name}: an adapter without its {B} factor")
        out[name + S] = _scale_tensor(scale, tree[name + A].device)
    return out
