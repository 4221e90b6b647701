"""Attention ops (port of :mod:`tensorflowonspark_tpu.ops.attention`).

``dot_product_attention`` routes to an implementation:

- ``impl='xla'`` — plain attention (the name is the JAX package's): GQA by
  repeat, end-aligned causal mask, window, segment mask, fp32 softmax.
- ``impl='flash'`` — :func:`ops.flash_attention.flash_attention`, the CUDA
  kernels on a GPU (their plain versions for CPU tensors).
- ``impl='auto'`` — flash when the tensors are on CUDA and the shape gate
  passes, else xla: the JAX package's single-device resolution.

``ring`` and ``ulysses`` (sequence parallel over a mesh) are not ported yet.
"""

from __future__ import annotations

import torch

from tensorflowonspark_tpu_torch.ops.flash_attention import flash_attention


def _flash_shapes_ok(q, k, segment_ids) -> bool:
    """Shapes the flash kernels accept (same thresholds as the JAX gate)."""
    return (
        q.shape[1] >= 128
        and q.shape[1] % 128 == 0
        and k.shape[1] % 128 == 0
        and q.shape[3] >= 64
        # segment masking needs square attention (one id per position)
        and (segment_ids is None or q.shape[1] == k.shape[1])
    )


def _xla_attention(q, k, v, *, causal=False, scale=None, segment_ids=None, window=None):
    """Reference attention: (B, Sq, H, D) x (B, Sk, Hk, D) -> (B, Sq, H, D).

    As in the JAX package, masked logits get the dtype's lowest value, so
    a row with no live key returns the mean of V.
    """
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    scale = (d**-0.5) if scale is None else scale
    if hq != hk:
        if hq % hk:
            raise ValueError(f"q heads {hq} not divisible by kv heads {hk}")
        k = k.repeat_interleave(hq // hk, dim=2)
        v = v.repeat_interleave(hq // hk, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    lowest = torch.finfo(logits.dtype).min
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        if window is not None:
            q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
            k_pos = torch.arange(sk, device=q.device)[None, :]
            mask = mask & (q_pos - k_pos < window)
        logits = logits.masked_fill(~mask[None, None], lowest)
    if segment_ids is not None:
        seg_mask = segment_ids[:, :, None] == segment_ids[:, None, :]
        logits = logits.masked_fill(~seg_mask[:, None], lowest)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _local_auto_impl(q, k, segment_ids) -> str:
    on_cuda = q.device.type == "cuda"
    return "flash" if on_cuda and _flash_shapes_ok(q, k, segment_ids) else "xla"


def dot_product_attention(
    q, k, v, *, causal=False, scale=None, segment_ids=None, impl="auto", window=None
):
    """Multi-head attention with optional causal masking and GQA.

    Shapes: q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D); returns (B, Sq, Hq, D).
    ``window`` restricts each query to the last ``window`` keys (requires
    ``causal=True``).
    """
    if window is not None and (not causal or window < 1):
        raise ValueError(f"window={window} requires causal=True and window >= 1")
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"impl={impl!r} (sequence-parallel attention over a mesh) is not "
            "ported yet: ROADMAP A10"
        )
    if impl == "auto":
        impl = _local_auto_impl(q, k, segment_ids)
    if impl == "flash":
        return flash_attention(q, k, v, causal, scale, window, segment_ids)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    return _xla_attention(
        q, k, v, causal=causal, scale=scale, segment_ids=segment_ids, window=window
    )
