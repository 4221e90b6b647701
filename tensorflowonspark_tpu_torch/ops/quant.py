"""Int8 weight-only quantization for decode (port of
:mod:`tensorflowonspark_tpu.ops.quant`).

Per-output-channel symmetric int8: ``scale = amax / 127`` over every other
axis, ``q = clip(round(w / scale), -127, 127)``, ``w ≈ q · scale``.

Layout. The port stores a dense weight ``(out, in)`` (``nn.Linear``'s
layout) where the JAX package stores the kernel ``(in, out)``, so the JAX
package's ``axis=-1`` (the output channel) is the port's axis 0. The
embedding ``(vocab, hidden)`` keeps per-row scales on both sides (axis
0); the output head is ``(hidden, vocab)`` at axis -1 there and ``(vocab,
hidden)`` at axis 0 here. So every leaf :func:`quantize_tree` makes
carries its scales on axis 0, shaped ``(rows, 1)``.

The weight set. A model's parameters are one flat ``name -> tensor``
dict (``models.convert``'s names). A quantized leaf ``n`` is two entries:
``n`` holds the int8 codes in the leaf's own shape and ``n + "_scale"``
the fp32 scales (keepdims shape, so they broadcast against the codes). A
:class:`QuantTensor` is the pair as one value, the form
:func:`quantized_dot` takes. ``models.llama`` consumes quantized dense
weights, the embedding gather and the head projection natively;
``models.convert`` maps the pair to the JAX package's ``QuantTensor``
(``{"q", "scale"}``) and back.

Cost. :func:`quantized_dot` is a plain torch product: it widens the int8
codes to a bf16 copy of the weight on each call and multiplies the fp32
accumulator by the scales, where XLA fuses the convert into the dot. The
resident weights are int8, but the bytes a decode step moves are not the
int8 bytes: each step also writes and reads the bf16 copy. A kernel that
reads the int8 codes inside the product is a ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import torch

# the name of a quantized leaf's scales: the leaf's own name + SCALE
SCALE = "_scale"


@dataclasses.dataclass(frozen=True)
class QuantTensor:
    """Symmetric per-channel int8 weight: ``w ≈ q * scale``.

    ``q`` int8 in the weight's shape; ``scale`` fp32 with size 1 on every
    axis but ``axis``, so it broadcasts against ``q``."""

    q: torch.Tensor
    scale: torch.Tensor
    axis: int = 0

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.scale.dtype


def quantize(w: torch.Tensor, axis: int = 0) -> QuantTensor:
    """Per-channel symmetric int8 with one scale per slice along ``axis``
    (the output channel of the port's ``(out, in)`` weights): the max-abs
    reduction runs over every other axis."""
    w32 = w.detach().float()
    channel = axis % w.dim()
    reduce_dims = tuple(i for i in range(w.dim()) if i != channel)
    amax = w32.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantTensor(q=q, scale=scale, axis=channel)


def dequantize(t: QuantTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (t.q.float() * t.scale.float()).to(dtype)


def axis_of(scale: torch.Tensor) -> int:
    """The quantization axis of keepdims ``scale``: its one dim above 1
    (0 for a single-row leaf)."""
    wide = [i for i, n in enumerate(scale.shape) if n != 1]
    return wide[0] if wide else 0


def quant_of(params: dict, name: str) -> QuantTensor | None:
    """Leaf ``name`` of a weight set as a :class:`QuantTensor`, or None
    when it is not quantized."""
    scale = params.get(name + SCALE)
    if scale is None or params[name].dtype != torch.int8:
        return None
    return QuantTensor(q=params[name], scale=scale, axis=axis_of(scale))


def quantized_names(params: dict) -> list[str]:
    """The names of the quantized leaves of a weight set."""
    return [n for n, t in params.items() if t.dtype == torch.int8 and n + SCALE in params]


def quantize_tree(params: dict, min_size: int = 1 << 16) -> dict:
    """Quantize every 2-D floating leaf with ``>= min_size`` elements at
    axis 0, the port's one layout (the JAX package's ``axis=-1`` and its
    ``{"embed": 0}`` override are both axis 0 here); smaller leaves (norm
    scales, biases) stay as they are. Returns a new weight set: each
    quantized leaf's int8 codes under its own name and its ``(rows, 1)``
    scales under ``name + "_scale"``. A tree with LoRA adapters is
    refused: fold them in with ``ops.lora.merge_lora`` first (a quantized
    base under an adapter has no consumer)."""
    from tensorflowonspark_tpu_torch.ops.lora import lora_names

    if lora_names(params):
        raise ValueError("quantize_tree of a tree with LoRA adapters: merge_lora it first")
    out = {}
    for name, x in params.items():
        if x.dim() == 2 and x.numel() >= min_size and x.is_floating_point():
            qt = quantize(x, 0)
            out[name] = qt.q
            out[name + SCALE] = qt.scale
        else:
            out[name] = x
    return out


def dequantize_tree(params: dict, dtype=torch.bfloat16) -> dict:
    """Inverse of :func:`quantize_tree`: every quantized leaf back to a
    ``dtype`` tensor under its own name, its scales dropped."""
    out = {}
    for name, x in params.items():
        qt = quant_of(params, name)
        if qt is not None:
            out[name] = dequantize(qt, dtype)
        elif not (name.endswith(SCALE) and quant_of(params, name[: -len(SCALE)]) is not None):
            out[name] = x
    return out


def quantized_dot(x: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """``x @ wᵀ`` for a quantized ``(out, in)`` weight, with the scales on
    the fp32 accumulator, in ``x.dtype``.

    As the JAX package's: ``x`` is rounded to bf16, the int8 codes enter
    the product exactly (as bf16), the product accumulates in fp32 and the
    per-output-channel scales multiply the accumulator. Only axis-0
    (output-channel) scales are supported, which :func:`quantize_tree`
    makes. The plain form materializes a bf16 copy of the weight on every
    call (XLA fuses that convert into the dot), so a decode step reads
    more than the int8 bytes (see the module docstring)."""
    if w.axis != 0:
        raise ValueError("quantized_dot needs output-channel (axis 0) scales")
    x16 = x.to(torch.bfloat16)
    q16 = w.q.to(torch.bfloat16)
    flat = x16.reshape(1, -1, x16.shape[-1])
    if flat.is_cuda:
        acc = torch.bmm(flat, q16.t()[None], out_dtype=torch.float32)
    else:  # the CPU has no bf16 -> fp32 product: widen first (exact)
        acc = torch.bmm(flat.float(), q16.float().t()[None])
    acc = acc.view(*x.shape[:-1], w.q.shape[0])
    return (acc * w.scale.float().reshape(-1)).to(x.dtype)
