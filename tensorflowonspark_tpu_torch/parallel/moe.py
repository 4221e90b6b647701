"""Mixture-of-experts: a top-k routed bank of SwiGLU experts (port of
:mod:`tensorflowonspark_tpu.parallel.moe`).

The routing is the reference's: GShard/Switch top-k with a fixed capacity
per expert, ``C = max(ceil(T·k·capacity_factor / E), k)`` for the ``T``
tokens of the call (so a row's output depends on its batch mates whenever
an expert overflows), priority in token order with a token's own choices
in rank order (the reference flattens ``(T, k)`` token-major), the gates
renormalized over the top k, the Switch load-balancing loss on the top-1
choice. The router runs in fp32, the expert products in ``cfg.dtype``, and
the gates are rounded to ``cfg.dtype`` before the last product, as the
reference rounds its combine tensor.

Where the reference builds dense ``(T, E, C)`` one-hot dispatch and
combine tensors and contracts them with einsums (at llama_1b's training
shape 1.07 GB a layer each, and ~1.1 TFLOP of products by 0 and 1), the
port computes the same function in index form: each kept (token, choice)
gets its expert's slot, the tokens are copied into an ``(E·C, d)`` buffer
(empty slots stay exactly 0), the three expert products run as batched
``torch.bmm`` over ``(E, C, ·)``, and each token gathers its slots back
weighted by its rounded gates. Nothing reads the device from the host.
:func:`top_k_routing` still returns the reference's dense tensors (built
from the index form) for callers and tests that want them.

Ties: ``jax.lax.top_k`` takes the lower expert index first on equal
probabilities; ``torch.topk`` promises no order, so the port takes the
top k of a stable descending sort, which does the same.

Torch has no ``sow``: :class:`MoEMLP` returns its aux loss beside its
output as a :class:`MoEAux` (with the count of dropped assignments), and
``models.llama`` carries it out of the forward explicitly.

Not ported yet: expert parallelism (an ``expert`` mesh axis wider than 1)
and MoE on DTensors, which raise ``NotImplementedError`` naming ROADMAP
A10.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MoEConfig", "MoEMLP", "MoEAux", "top_k_routing", "moe_expert_bank_spec",
           "moe_param_shardings"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    hidden_size: int = 128
    intermediate_size: int = 256
    dtype: torch.dtype = torch.bfloat16
    router_aux_weight: float = 0.01


class MoEAux(NamedTuple):
    """What one :class:`MoEMLP` call reports beside its output: ``loss``,
    the weighted load-balancing loss (0-d fp32, in the autograd graph);
    ``dropped`` (B, S), how many of each token's k choices were over
    capacity, and ``experts`` (B, S, k), the experts it chose (int64, no
    gradient); ``assigned``, the call's B·S·k assignments (a Python int: a
    device tensor made from a host number would wait for the stream in
    every decode step)."""

    loss: torch.Tensor
    dropped: torch.Tensor
    experts: torch.Tensor
    assigned: int


class Routing(NamedTuple):
    """Index form of one call's routing: each (token, choice)'s ``expert``
    and ``slot`` within that expert's buffer, whether it is ``kept`` (slot
    < ``capacity``), its renormalized ``gates`` with dropped ones zeroed
    (T, k), and the unweighted aux loss."""

    expert: torch.Tensor
    slot: torch.Tensor
    kept: torch.Tensor
    gates: torch.Tensor
    capacity: int
    aux: torch.Tensor


def _capacity(num_tokens: int, cfg: MoEConfig) -> int:
    # ceil, per GShard/Switch: capacity_factor=1.0 must mean "exactly
    # enough slots under perfect balance", never fewer
    cap = math.ceil(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(cap, cfg.top_k)


def route(router_logits: torch.Tensor, cfg: MoEConfig, num_tokens: int) -> Routing:
    """The routing of ``router_logits`` (T, E) in index form."""
    t, e = router_logits.shape
    k = cfg.top_k
    probs = torch.softmax(router_logits.float(), dim=-1)
    # the top k of a stable descending sort: ties go to the lower index
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert = srt.values[:, :k], srt.indices[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # each assignment's place in its expert's buffer: the earlier
    # assignments to that expert in priority order, token-major (token 0's
    # choices first)
    order = expert.reshape(t * k)
    onehot = F.one_hot(order, e)  # (T*k, E)
    before = torch.cumsum(onehot, dim=0) - onehot
    slot = before.gather(1, order[:, None]).reshape(t, k)
    c = _capacity(num_tokens, cfg)
    kept = slot < c
    gates = gate_vals * kept
    # Switch load-balancing loss on the top-1 choice
    top1 = F.one_hot(expert[:, 0], e).float()
    aux = e * torch.sum(top1.mean(0) * probs.mean(0))
    return Routing(expert, slot, kept, gates, c, aux)


def top_k_routing(router_logits: torch.Tensor, cfg: MoEConfig, num_tokens: int):
    """The reference's dense form: router_logits (T, E) -> dispatch (T, E,
    C) fp32 0/1, combine (T, E, C) fp32 and the aux loss. :class:`MoEMLP`
    runs the index form (:func:`route`); this builds the dense tensors from
    it."""
    r = route(router_logits, cfg, num_tokens)
    t, e = router_logits.shape
    combine = torch.zeros(t, e * r.capacity + 1, device=router_logits.device)
    dest = torch.where(r.kept, r.expert * r.capacity + r.slot, e * r.capacity)
    combine.scatter_add_(1, dest, r.gates)
    combine = combine[:, :-1].reshape(t, e, r.capacity)
    return (combine > 0).float(), combine, r.aux


class MoEMLP(nn.Module):
    """Drop-in MLP block: x (B, S, d) -> ``(y (B, S, d), MoEAux)``.

    Parameters as the reference names them: ``router.weight`` (E, d) (the
    port's Dense layout, the flax kernel transposed; fp32), ``w_gate`` and
    ``w_up`` (E, d, f), ``w_down`` (E, f, d), each drawn normal(0.02) by
    the owner."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        from tensorflowonspark_tpu_torch.models.llama import Dense

        self.cfg = cfg
        e, d, f = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        self.router = Dense(d, e, torch.float32, device=device)
        self.w_gate = nn.Parameter(torch.empty(e, d, f, device=device))
        self.w_up = nn.Parameter(torch.empty(e, d, f, device=device))
        self.w_down = nn.Parameter(torch.empty(e, f, d, device=device))

    def forward(self, x):
        from tensorflowonspark_tpu_torch.parallel.context import is_dtensor

        if is_dtensor(x) or is_dtensor(self.w_gate):
            raise NotImplementedError(
                "MoE experts on a device mesh (DTensors, an 'expert' axis) are not ported "
                "yet: ROADMAP A10")
        cfg = self.cfg
        b, s, d = x.shape
        t, e, k, dt = b * s, cfg.num_experts, cfg.top_k, cfg.dtype
        tokens = x.reshape(t, d)
        r = route(self.router(tokens), cfg, t)
        c = r.capacity
        # dropped assignments all write one scratch row past the buffer
        dest = torch.where(r.kept, r.expert * c + r.slot, e * c).reshape(t * k)
        src = tokens.to(dt).repeat_interleave(k, dim=0)
        buf = src.new_zeros(e * c + 1, d).index_copy(0, dest, src)
        xs = buf[:-1].view(e, c, d)
        gate = torch.bmm(xs, self.w_gate.to(dt))
        up = torch.bmm(xs, self.w_up.to(dt))
        ys = torch.bmm(F.silu(gate) * up, self.w_down.to(dt)).reshape(e * c, d)
        # the scratch row reads back as zeros (its gate is zero too)
        ys = torch.cat([ys, ys.new_zeros(1, d)])
        picked = ys[dest].view(t, k, d).float()
        out = (r.gates.to(dt).float()[..., None] * picked).sum(1).to(dt)
        dropped = (~r.kept).sum(1).view(b, s)
        aux = MoEAux(cfg.router_aux_weight * r.aux, dropped, r.expert.view(b, s, k), t * k)
        return out.reshape(b, s, d).to(x.dtype), aux


def moe_expert_bank_spec(param_name: str) -> tuple:
    """The spec of one 3-dim expert bank leaf (a flax path): the 'moe'
    table's (:func:`compute.layout.expert_bank_spec`)."""
    from tensorflowonspark_tpu_torch.compute import layout

    return layout.expert_bank_spec(param_name)


def _leaf(name: str, shape: tuple) -> tuple:
    """An :class:`MoEMLP` param's table view: the banks keep their axes
    (the router's spec is replicated, so its transpose does not matter)."""
    return name.replace(".", "/"), tuple(shape), tuple(range(len(shape)))


def moe_param_shardings(params, mesh) -> dict:
    """Placements of an :class:`MoEMLP`'s params (name -> tensor) from the
    'moe' table: expert banks by :func:`moe_expert_bank_spec`, the router
    replicated."""
    from tensorflowonspark_tpu_torch.compute import layout

    return layout.param_shardings(params, mesh, "moe", view=_leaf)
