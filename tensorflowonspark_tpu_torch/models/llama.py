"""Llama-family decoder: training, KV-cache decode and sampling (port of
:mod:`tensorflowonspark_tpu.models.llama`).

Parameters are stored in fp32 and cast to ``cfg.dtype`` where they are
used, as flax does with its default fp32 params; activations run in
``cfg.dtype`` with fp32 RMSNorm, RoPE and softmax. Attention goes through
:func:`ops.attention.dot_product_attention`, whose ``auto`` route takes the
CUDA flash kernels on a GPU.

Parameter names follow the flax tree (``embed``, ``layers.{i}.attn.q_proj``
for ``layer{i}/attn/q_proj`` …); :mod:`models.convert` maps the two.

On a device mesh the params are DTensors placed by the layout table's
'llama' rules (:func:`llama_param_shardings`) and the tokens a DTensor
sharded over ``(data, fsdp)``: each dense layer gathers its weight's
``fsdp`` shards where it uses it, attention runs the flash kernels on each
rank's shard (``ops.attention.mesh_flash_attention``), and DTensor carries
the rest.

``remat_policy='dots'`` recomputes a block in backward but keeps the
outputs of its plain matrix products (``aten.mm``/``aten.addmm``: the
projections), as JAX's ``dots_with_no_batch_dims_saveable`` keeps the dot
products without batch dims; attention's batched products are recomputed,
and with them the flash forward.

Decode (``forward(..., decode=True, cache=...)``) runs against a KV cache
the caller owns: :func:`init_cache` allocates it once, one dict of tensors
per layer named as the flax cache variables (``k``, ``v``, ``k_scale``,
``v_scale``, ``seg``, ``pos``, ``idx``), and each call updates it in place.
Attention against the cache is plain torch products, as the reference's
einsums are: decode reads the weights and the cache once a step. The K/V
planes are laid out ``(B, kv_heads, C, D)`` (flax: ``(B, C, kv_heads,
D)``) so that each head's cache is one contiguous matrix the batched
products read in place; ``models.convert.cache_from_jax`` /
``cache_to_jax`` move between the two. :func:`generate` is the
autoregressive loop over :func:`prefill` and :func:`decode_step`, and
:func:`sample_logits` draws from a ``torch.Generator``.

Int8 and LoRA weights (``ops.quant``, ``ops.lora``) are entries of the
same flat weight set: a quantized leaf ``n`` holds int8 codes with fp32
scales under ``n + "_scale"``; an adapted dense weight keeps its base under
``n`` beside ``n + "_lora_a"``, ``"_lora_b"`` and ``"_lora_scale"`` (a bank
of adapters when the factors are 3-D). Every such entry has a slot in the
module tree, empty (None) until a weight set fills it:
:func:`adopt_params` makes a weight set a model's own parameters (and
checks it, :func:`check_params`). :class:`Dense` then runs the quantized
product, the adapter or the bank (the JAX package's ``QDense``), the
embedding gathers int8 rows and their scales, and the head projects
through ``ops.quant.quantized_dot``. ``forward``, :func:`prefill`,
:func:`decode_step` and :func:`generate` take ``adapter_ids`` (B,), each
row's bank slot; None routes every row to slot 0, the bank's zero adapter.

With ``num_experts > 0`` every block's MLP is a routed expert bank
(:class:`parallel.moe.MoEMLP`); its load-balancing loss comes out of the
forward with ``return_aux=True`` and :func:`llama_loss_fn` adds it.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): decode on a device mesh (A9b) and MoE experts on a mesh (A10).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.ops import lora as _lora
from tensorflowonspark_tpu_torch.ops import quant as _quant
from tensorflowonspark_tpu_torch.ops.attention import dot_product_attention
from tensorflowonspark_tpu_torch.parallel.context import gather_fsdp, is_dtensor, mesh_region
from tensorflowonspark_tpu_torch.parallel.moe import MoEConfig, MoEMLP


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3-style RoPE frequency rescaling (``kind='llama3'``) or
    position interpolation (``kind='linear'``)."""

    kind: str = "llama3"
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_seq_len: int = 8192


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rope_scaling: RopeScaling | None = None
    rms_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "auto"
    remat: bool = True
    # 'full' (or 'none'): recompute the whole block in backward; 'dots':
    # keep the outputs of the plain matrix products, recompute the rest
    remat_policy: str = "full"
    # MoE: when num_experts > 0 every block's MLP is a routed expert bank
    # (parallel/moe.py)
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    # Qwen2-family QKV bias
    attention_bias: bool = False
    # sliding-window attention: each query sees the last `sliding_window` keys
    # (training, prefill and cached decode, where the cache's position plane
    # masks by RoPE-position distance)
    sliding_window: int | None = None
    # Rolling KV cache: cache only this many slots (>= sliding_window + write
    # width - 1) instead of max_seq_len, with slot = position % kv_cache_len.
    # Requires sliding_window (full attention needs every position). None =
    # dense (max_seq_len slots).
    kv_cache_len: int | None = None
    # KV-cache storage: "model" (= dtype, exact) or "int8" (per-token per-head
    # max-abs quantization with fp32 scales: half the cache's device memory).
    # Decode-side only; training has no cache.
    kv_cache_dtype: str = "model"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama_1b(**overrides) -> "LlamaConfig":
        """The single-chip benchmark config (953M params)."""
        base = dict(
            vocab_size=32000, hidden_size=2048, intermediate_size=5632,
            num_layers=16, num_heads=16, num_kv_heads=16, max_seq_len=1024,
            dtype=torch.bfloat16,
        )
        base.update(overrides)
        return LlamaConfig(**base)

    @staticmethod
    def mistral_7b(**overrides) -> "LlamaConfig":
        """Mistral-7B-v0.1: Llama layout + GQA + sliding window 4096."""
        base = dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=32768,
            rope_theta=10000.0, sliding_window=4096,
        )
        base.update(overrides)
        return LlamaConfig(**base)

    @staticmethod
    def llama3_8b(**overrides) -> "LlamaConfig":
        """Llama-3.1-8B: GQA 32/8, 128k vocab, llama3 RoPE scaling."""
        base = dict(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=131072,
            rope_theta=500000.0,
            rope_scaling=RopeScaling(
                kind="llama3", factor=8.0, low_freq_factor=1.0,
                high_freq_factor=4.0, original_max_seq_len=8192,
            ),
        )
        base.update(overrides)
        return LlamaConfig(**base)

    @staticmethod
    def qwen2_7b(**overrides) -> "LlamaConfig":
        """Qwen2-7B: Llama layout + QKV bias + GQA, 1M rope theta."""
        base = dict(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4, max_seq_len=32768,
            rope_theta=1_000_000.0, rms_norm_eps=1e-6, attention_bias=True,
        )
        base.update(overrides)
        return LlamaConfig(**base)

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        """Test-size config."""
        base = dict(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
        )
        base.update(overrides)
        return LlamaConfig(**base)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        norm = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(self.dtype)


def _scaled_rope_freqs(d: int, theta: float, scaling: RopeScaling | None, device=None):
    """Base (or rescaled) inverse frequencies for head dim ``d``, fp32."""
    exponent = -torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    # a Python base: a device tensor made from it would be a copy that
    # waits for the stream, twice a layer
    freqs = torch.pow(float(theta), exponent)
    if scaling is None:
        return freqs
    if scaling.kind == "linear":
        return freqs / scaling.factor
    if scaling.kind != "llama3":
        raise ValueError(f"unknown rope_scaling kind {scaling.kind!r}")
    orig = float(scaling.original_max_seq_len)
    low_wavelen = orig / scaling.low_freq_factor
    high_wavelen = orig / scaling.high_freq_factor
    wavelen = 2.0 * math.pi / freqs
    smooth = (orig / wavelen - scaling.low_freq_factor) / (
        scaling.high_freq_factor - scaling.low_freq_factor
    )
    interp = (1.0 - smooth) * freqs / scaling.factor + smooth * freqs
    out = torch.where(wavelen > low_wavelen, freqs / scaling.factor, freqs)
    mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return torch.where(mid, interp, out)


def rope(x, positions, theta: float, scaling: RopeScaling | None = None):
    """Rotary embedding (half-split convention); x (B, S, H, D), positions (B, S)."""
    d = x.shape[-1]
    freqs = _scaled_rope_freqs(d, theta, scaling, x.device)
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# the optional slots of a weight, filled only by an int8 or adapted weight set
_WEIGHT_SLOTS = (_quant.SCALE, _lora.A, _lora.B, _lora.S)


def _register_slots(mod: nn.Module, weight: str) -> None:
    for sfx in _WEIGHT_SLOTS:
        mod.register_parameter(weight + sfx, None)


class Dense(nn.Module):
    """Bias-free (or, for Qwen2's QKV, biased) projection computed in
    ``dtype``: the JAX package's ``QDense``. The weight is stored ``(out,
    in)`` as ``nn.Linear`` does; int8 codes with ``weight_scale`` run
    :func:`ops.quant.quantized_dot`, ``weight_lora_*`` factors run
    :func:`ops.lora.lora_apply` (2-D) or the bank's
    :func:`ops.lora.multi_lora_apply` (3-D, per-row ``adapter_ids``; None
    routes every row to slot 0). A bias is added after whichever ran."""

    def __init__(self, d_in, d_out, dtype, bias=False, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device)) if bias else None
        _register_slots(self, "weight")

    def forward(self, x, adapter_ids=None):
        x = x.to(self.dtype)
        w = gather_fsdp(self.weight)
        if self.weight_scale is not None:
            y = _quant.quantized_dot(x, _quant.QuantTensor(w, self.weight_scale, axis=0))
        elif self.weight_lora_a is not None:
            a, b = gather_fsdp(self.weight_lora_a), gather_fsdp(self.weight_lora_b)
            scale = self.weight_lora_scale
            if a.dim() == 2:
                y = _lora.lora_apply(x, _lora.LoraTensor(w, a, b, scale))
            elif adapter_ids is None:  # slot 0 for every row
                y = _lora.lora_apply(x, _lora.LoraTensor(w, a[0], b[0], scale))
            else:
                y = _lora.multi_lora_apply(x, _lora.MultiLoraTensor(w, a, b, scale), adapter_ids)
        else:
            y = F.linear(x, w.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd, ab = cfg.head_dim, cfg.attention_bias
        dense = lambda o, b=False: Dense(cfg.hidden_size, o, cfg.dtype, b, device)  # noqa: E731
        self.q_proj = dense(cfg.num_heads * hd, ab)
        self.k_proj = dense(cfg.num_kv_heads * hd, ab)
        self.v_proj = dense(cfg.num_kv_heads * hd, ab)
        self.o_proj = Dense(cfg.num_heads * hd, cfg.hidden_size, cfg.dtype, device=device)

    def forward(self, x, positions, segment_ids=None, cache=None, padded=False, adapter_ids=None):
        """``cache`` (this layer's dict of :func:`init_cache`) runs the
        decode branch: the new K/V are written into it and the queries
        attend the cache."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.q_proj(x, adapter_ids).view(b, s, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x, adapter_ids).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = self.v_proj(x, adapter_ids).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        if cache is not None:
            if segment_ids is not None and padded:
                raise ValueError(
                    "segment_ids with padded=True is unsupported: padded decode writes each "
                    "row's cache at its own positions (mixed-length unpadded prompts), which "
                    "conflicts with packed rows' global slot indexing"
                )
            out = cached_attention(cfg, q, k, v, positions, cache, padded, segment_ids)
        else:
            out = dot_product_attention(
                q, k, v.contiguous(), causal=True, segment_ids=segment_ids,
                impl=cfg.attention_impl, window=cfg.sliding_window,
            )
        return self.o_proj(out.reshape(b, s, cfg.num_heads * cfg.head_dim), adapter_ids)


def _cache_len(cfg: LlamaConfig) -> tuple[int, bool]:
    """(slots, rolling) of a layer's cache."""
    c = cfg.kv_cache_len or cfg.max_seq_len
    return c, c < cfg.max_seq_len


def init_cache(cfg: LlamaConfig, batch: int, device=None) -> list[dict[str, torch.Tensor]]:
    """A fresh decode cache for ``batch`` rows: one dict per layer, each
    tensor batch-first, allocated once and updated in place by every
    decode call.

    ``k``/``v`` ``(B, kv_heads, C, D)`` in ``cfg.dtype`` (int8 with
    ``kv_cache_dtype='int8'``, then also fp32 ``k_scale``/``v_scale``
    ``(B, kv_heads, C)``); ``seg`` ``(B, C)`` int32, each slot's segment id;
    ``pos`` ``(B, C)`` int32, each slot's RoPE position (only with a
    sliding window); ``idx``, the scalar running write index. ``C`` is
    ``kv_cache_len`` or ``max_seq_len``. The one rule of the reference's
    initial values: every leaf is zero except ``pos`` under a rolling
    cache, which is -1 ("never written"), so that a stale slot cannot pass
    for position 0.
    """
    device = resolve_device(device)
    c, rolling = _cache_len(cfg)
    int8_kv = cfg.kv_cache_dtype == "int8"
    kv_shape = (batch, cfg.num_kv_heads, c, cfg.head_dim)
    kv_dtype = torch.int8 if int8_kv else cfg.dtype
    layers = []
    for _ in range(cfg.num_layers):
        layer = {
            "k": torch.zeros(kv_shape, dtype=kv_dtype, device=device),
            "v": torch.zeros(kv_shape, dtype=kv_dtype, device=device),
        }
        if int8_kv:
            layer["k_scale"] = torch.zeros(kv_shape[:3], device=device)
            layer["v_scale"] = torch.zeros(kv_shape[:3], device=device)
        layer["seg"] = torch.zeros(batch, c, dtype=torch.int32, device=device)
        if cfg.sliding_window is not None:
            layer["pos"] = torch.full((batch, c), -1 if rolling else 0, dtype=torch.int32,
                                      device=device)
        layer["idx"] = torch.zeros((), dtype=torch.int32, device=device)
        layers.append(layer)
    return layers


def _kv_store(x, int8_kv: bool, dtype):
    """What lands in the cache for new K/V rows (B, S, kv_heads, D): the
    model-dtype values, or (int8 codes, fp32 scale (B, S, kv_heads)) with
    symmetric per-token per-head max-abs rounding."""
    if not int8_kv:
        return x.to(dtype), None
    xf = x.float()
    scale = xf.abs().amax(-1).clamp_min(1e-8) * (1.0 / 127.0)
    return torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8), scale


def qk_logits(q, k):
    """(N, M, D) x (N, C, D) -> fp32 (N, M, C) products. On CUDA bf16/fp16
    operands accumulate into an fp32 output directly, so neither the logits
    are rounded to bf16 nor is the cache copied to fp32; on the CPU (where
    that form does not exist) the operands are widened first."""
    if q.dtype == torch.float32:
        return torch.bmm(q, k.transpose(1, 2))
    if q.is_cuda:
        return torch.bmm(q, k.transpose(1, 2), out_dtype=torch.float32)
    return torch.bmm(q.float(), k.float().transpose(1, 2))


def cached_attention(cfg: LlamaConfig, q, k, v, positions, cache, padded=False,
                     segment_ids=None):
    """Autoregressive attention against one layer's cache (port of the
    reference's ``_cached_attention``); q (B, S, H, D), k/v (B, S, kv_heads,
    D) after RoPE, ``positions`` (B, S).

    With uniform rows (``padded=False``) the new K/V land at the running
    write index ``idx``; with ``padded=True`` each row writes at its own
    positions (right-padded mixed-length prompts, where row r's next slot
    is its true length). Either way a token's slot is its row index, so the
    slot mask hides both unwritten slots and the padding a padded prefill
    writes past each row's true length, until that row's own decode tokens
    overwrite it. ``segment_ids`` (packed rows) are stored per slot and
    reads are masked by id equality; unpacked callers store zeros. With a
    sliding window the ``pos`` plane masks by RoPE-position distance; a
    rolling cache (``kv_cache_len < max_seq_len``) writes slot ``position
    % C`` and masks by position alone. With ``kv_cache_dtype='int8'`` the K
    scale multiplies the fp32 logits per key slot and the V scale the fp32
    probabilities, so the codes are widened to ``cfg.dtype`` (a copy per
    layer per call in eager torch) but never dequantized by a scale.

    The products are grouped against the un-repeated cache, the logits
    fp32 (:func:`qk_logits`), the probabilities rounded to ``cfg.dtype``
    before the product with V, as the reference computes them.
    """
    b, s = q.shape[:2]
    hk, d = cfg.num_kv_heads, cfg.head_dim
    rep = cfg.num_heads // hk
    c, rolling = _cache_len(cfg)
    if rolling:
        if cfg.sliding_window is None:
            raise ValueError(
                f"kv_cache_len={c} < max_seq_len needs sliding_window "
                "(full attention reads every position)"
            )
        if segment_ids is not None:
            # per-document positions collide under slot = position % C
            raise ValueError(
                "segment_ids (packed rows) are unsupported with a rolling kv_cache_len: "
                "per-document positions collide under slot = position % C"
            )
        if c < cfg.sliding_window + s - 1:
            # a write of s positions may not wrap onto slots that queries of
            # the same call still attend
            raise ValueError(
                f"kv_cache_len={c} must be >= sliding_window ({cfg.sliding_window}) + "
                f"write width ({s}) - 1; prefill in smaller chunks or grow the cache"
            )
    int8_kv = cfg.kv_cache_dtype == "int8"
    positions = positions.long()
    seg = (torch.zeros(b, s, dtype=torch.int32, device=q.device) if segment_ids is None
           else segment_ids.to(torch.int32))
    k_new, ks_new = _kv_store(k, int8_kv, cfg.dtype)
    v_new, vs_new = _kv_store(v, int8_kv, cfg.dtype)
    rows = torch.arange(b, device=q.device)[:, None]
    if rolling or padded:
        # per-row scatter; the K/V planes index as [row, :, slot] -> (B, S, kv_heads, ...)
        slots = positions % c if rolling else positions
        cache["k"][rows, :, slots] = k_new
        cache["v"][rows, :, slots] = v_new
        if int8_kv:
            cache["k_scale"][rows, :, slots] = ks_new
            cache["v_scale"][rows, :, slots] = vs_new
        if rolling:
            cache["seg"][rows, slots] = seg
        if cfg.sliding_window is not None:
            cache["pos"][rows, slots] = positions.to(torch.int32)
        slot_q = positions  # unused when rolling: it masks by position alone
    else:
        cur = cache["idx"]
        # the write clamps into the cache, as lax.dynamic_update_slice does
        slots = cur.clamp(0, c - s) + torch.arange(s, device=q.device)
        cache["k"].index_copy_(2, slots, k_new.transpose(1, 2))
        cache["v"].index_copy_(2, slots, v_new.transpose(1, 2))
        if int8_kv:
            cache["k_scale"].index_copy_(2, slots, ks_new.transpose(1, 2))
            cache["v_scale"].index_copy_(2, slots, vs_new.transpose(1, 2))
        cache["seg"].index_copy_(1, slots, seg)
        if cfg.sliding_window is not None:
            cache["pos"].index_copy_(1, slots, positions.to(torch.int32))
        slot_q = (cur + torch.arange(s, device=q.device)).expand(b, s)
    cache["idx"].add_(s)

    kc, vc = cache["k"], cache["v"]
    if int8_kv:
        kc, vc = kc.to(cfg.dtype), vc.to(cfg.dtype)
    # (B, S, kv_heads, rep, D) -> one (rep*S, D) matrix per (row, kv head)
    qg = q.view(b, s, hk, rep, d).permute(0, 2, 3, 1, 4).reshape(b * hk, rep * s, d)
    logits = qk_logits(qg, kc.view(b * hk, c, d)).view(b, hk, rep, s, c) * d**-0.5
    if int8_kv:
        logits = logits * cache["k_scale"][:, :, None, None, :]
    seg_eq = cache["seg"][:, None, None, None, :] == seg[:, None, None, :, None]
    if rolling:
        # a slot is attended iff its recorded position is real (>= 0), causal
        # and inside the window; stale slots hold positions <= q - C <= q - W
        kplane = cache["pos"][:, None, None, None, :]
        qcol = positions[:, None, None, :, None]
        mask = (kplane >= 0) & (kplane <= qcol) & (kplane > qcol - cfg.sliding_window)
    else:
        key_pos = torch.arange(c, device=q.device)
        mask = key_pos[None, None, None, None, :] <= slot_q[:, None, None, :, None]
        if cfg.sliding_window is not None:
            mask = mask & (cache["pos"][:, None, None, None, :]
                           > positions[:, None, None, :, None] - cfg.sliding_window)
    logits = torch.where(mask & seg_eq, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    if int8_kv:
        probs = probs * cache["v_scale"][:, :, None, None, :]
    probs = probs.to(cfg.dtype)
    out = torch.bmm(probs.view(b * hk, rep * s, c), vc.view(b * hk, c, d))
    return out.view(b, hk, rep, s, d).permute(0, 3, 1, 2, 4).reshape(b, s, cfg.num_heads, d)


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        h, i, dt = cfg.hidden_size, cfg.intermediate_size, cfg.dtype
        self.gate_proj = Dense(h, i, dt, device=device)
        self.up_proj = Dense(h, i, dt, device=device)
        self.down_proj = Dense(i, h, dt, device=device)

    def forward(self, x, adapter_ids=None):
        return self.down_proj(
            F.silu(self.gate_proj(x, adapter_ids)) * self.up_proj(x, adapter_ids), adapter_ids
        )


def moe_config(cfg: LlamaConfig) -> MoEConfig:
    """The :class:`parallel.moe.MoEConfig` of ``cfg``'s expert banks."""
    return MoEConfig(num_experts=cfg.num_experts, top_k=cfg.moe_top_k,
                     capacity_factor=cfg.moe_capacity_factor, hidden_size=cfg.hidden_size,
                     intermediate_size=cfg.intermediate_size, dtype=cfg.dtype)


class Block(nn.Module):
    """One decoder layer: ``(x, aux)``, where ``aux`` is the MoE layer's
    :class:`parallel.moe.MoEAux` (None for a dense MLP). It is an output,
    not a side effect, so a remat recompute in backward adds nothing."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device)
        self.mlp = MoEMLP(moe_config(cfg), device) if cfg.num_experts > 0 else MLP(cfg, device)

    def forward(self, x, positions, segment_ids=None, cache=None, padded=False, adapter_ids=None):
        h = x + self.attn(self.attn_norm(x), positions, segment_ids, cache, padded, adapter_ids)
        if isinstance(self.mlp, MoEMLP):
            y, aux = self.mlp(self.mlp_norm(h))  # MoE routes by token, not adapter
            return h + y, aux
        return h + self.mlp(self.mlp_norm(h), adapter_ids), None


# the plain matrix products, whose outputs remat_policy='dots' keeps
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_saved():
    return create_selective_checkpoint_contexts(_dots_policy)


def llama_param_shardings(params, mesh):
    """Placements of a Llama's params (name -> tensor) from the layout
    table's 'llama' rules: Megatron on ``(fsdp, model)``, norms
    replicated; with ``model=1`` pure FSDP, with ``fsdp=1`` pure TP. Each
    spec is the one JAX gives the param's flax leaf, permuted onto the
    port's ``(out, in)`` weights (``models.convert.jax_leaf``). The table
    leaves divisibility to the caller, as the JAX package's does: a dim
    that does not divide its axes raises here."""
    from tensorflowonspark_tpu_torch.compute import layout
    from tensorflowonspark_tpu_torch.models.convert import jax_leaf

    shs = layout.param_shardings(params, mesh, "llama", view=jax_leaf)
    sizes = layout.axis_sizes(mesh)
    for name, sh in shs.items():
        layout.check_divisible(name, tuple(params[name].shape), sh.spec, sizes)
    return shs


def packed_positions(segment_ids):
    """RoPE positions that restart at each document boundary."""
    idx = torch.arange(segment_ids.shape[1], device=segment_ids.device).expand_as(segment_ids)
    new_doc = torch.cat(
        [
            torch.ones_like(segment_ids[:, :1], dtype=torch.bool),
            segment_ids[:, 1:] != segment_ids[:, :-1],
        ],
        dim=1,
    )
    doc_start = torch.cummax(torch.where(new_doc, idx, 0), dim=1).values
    return idx - doc_start


class Llama(nn.Module):
    """tokens (B, S) -> fp32 logits (B, S, vocab).

    Built on ``device`` (CUDA unless the caller passes another), with
    weights drawn from ``seed``: normal(0.02) for every matrix, ones for
    the norms, zeros for biases, as the flax initializers draw them.
    """

    def __init__(self, cfg: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.remat and cfg.remat_policy not in ("full", "dots", "none"):
            raise ValueError(
                f"unknown remat_policy {cfg.remat_policy!r}; expected 'full', 'dots', or 'none'"
            )
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, device=device))
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device)
        # untied output head, stored (vocab, hidden) like nn.Linear
        self.lm_head = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, device=device))
        # int8 scales of the embedding and the head (per row: axis 0)
        self.register_parameter("embed" + _quant.SCALE, None)
        self.register_parameter("lm_head" + _quant.SCALE, None)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(("weight", ".w_gate", ".w_up", ".w_down")) or name in (
                        "embed", "lm_head"):
                    p.normal_(0.0, 0.02, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, positions=None, segment_ids=None, decode=False, return_hidden=False,
                padded=False, cache=None, adapter_ids=None, return_aux=False):
        """``return_hidden=True`` returns ``(hidden, lm_head)`` — the final
        normed hidden states (B, S, H) and the head weight (vocab, H; a
        ``QuantTensor`` when it is int8) — so a loss can project the
        vocabulary in chunks.

        ``return_aux=True`` returns ``(out, auxes)``: ``out`` as above and
        the list of the MoE layers' :class:`parallel.moe.MoEAux` in layer
        order (empty for a dense model), whose ``loss`` terms
        :func:`llama_loss_fn` adds (the reference's sown ``losses``).

        ``adapter_ids`` (B,) routes each row through its slot of every
        LoRA bank in the weights; None routes every row to slot 0, the
        bank's zero adapter. Ignored when the weights hold no bank.

        ``decode=True`` runs against ``cache`` (:func:`init_cache`), which
        it updates in place; ``positions`` are then the tokens' absolute
        positions. ``padded=True`` (decode only) makes each row write the
        cache at its own positions (right-padded mixed-length prompts).
        Packed ``segment_ids`` work with decode too, except with
        ``padded``."""
        if decode:
            if cache is None:
                raise ValueError("decode=True needs a cache: pass cache=init_cache(cfg, batch)")
            if len(cache) != self.cfg.num_layers:
                raise ValueError(f"a cache of {len(cache)} layers for a model of "
                                 f"{self.cfg.num_layers}")
            if is_dtensor(self.embed):  # the params are placed together
                raise NotImplementedError(
                    "KV-cache decode on a device mesh is not ported yet: ROADMAP A9b"
                )
        with mesh_region(tokens):
            out, auxes = self._forward(tokens, positions, segment_ids, return_hidden,
                                       cache if decode else None, padded, adapter_ids)
        return (out, auxes) if return_aux else out

    def _forward(self, tokens, positions, segment_ids, return_hidden, cache, padded, adapter_ids):
        cfg = self.cfg
        if positions is None:
            if segment_ids is None:
                positions = torch.arange(tokens.shape[1], device=tokens.device).expand_as(tokens)
            else:
                positions = packed_positions(segment_ids)
        embed = gather_fsdp(self.embed)
        if self.embed_scale is not None:
            # int8 rows and their per-row scales: the table stays int8
            x = (F.embedding(tokens, embed).float()
                 * F.embedding(tokens, self.embed_scale)).to(cfg.dtype)
        else:
            x = F.embedding(tokens, embed).to(cfg.dtype)
        context_fn = _dots_saved if cfg.remat_policy == "dots" else None
        auxes = []
        for i, block in enumerate(self.layers):
            if cache is not None:  # decode stays out of remat
                x, aux = block(x, positions, segment_ids, cache[i], padded, adapter_ids)
            elif cfg.remat and torch.is_grad_enabled():
                kw = {} if context_fn is None else {"context_fn": context_fn}
                x, aux = checkpoint(block, x, positions, segment_ids, None, False, adapter_ids,
                                    use_reentrant=False, **kw)
            else:
                x, aux = block(x, positions, segment_ids, adapter_ids=adapter_ids)
            if aux is not None:
                auxes.append(aux)
        x = self.final_norm(x)
        head = gather_fsdp(self.lm_head)
        if self.lm_head_scale is not None:
            head = _quant.QuantTensor(head, self.lm_head_scale, axis=0)
            if return_hidden:
                return (x, head), auxes
            return _quant.quantized_dot(x, head).float(), auxes
        if return_hidden:
            return (x, head), auxes
        return F.linear(x, head.to(cfg.dtype)).float(), auxes


def _slots(model: nn.Module) -> dict:
    """Every parameter slot of ``model``'s tree, filled or not: name ->
    (owning module, attribute)."""
    return {f"{prefix}.{n}" if prefix else n: (mod, n)
            for prefix, mod in model.named_modules() for n in mod._parameters}


def _optional(slots: dict, name: str) -> bool:
    return any(name.endswith(sfx) and name[: -len(sfx)] in slots for sfx in _WEIGHT_SLOTS)


def check_params(model: nn.Module, params: dict) -> None:
    """Raise ``ValueError`` unless ``params`` (name -> tensor) is a weight
    set ``model`` can run: every name one of its slots, every required
    weight present in its shape, an int8 leaf with its ``(rows, 1)``
    scales, an adapter with its two factors and scale in shapes that fit
    its base (2-D: one adapter; 3-D: a bank), and no leaf both int8 and
    adapted."""
    slots = _slots(model)
    unknown = sorted(n for n in params if n not in slots)
    if unknown:
        raise ValueError(f"no parameter slot for {unknown[:5]}")
    own = dict(model.named_parameters())
    for name in slots:
        if _optional(slots, name):
            continue
        t = params.get(name)
        if t is None:
            raise ValueError(f"missing parameter {name}")
        if name in own and tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(
                f"{name}: shape {tuple(t.shape)}, the model's {tuple(own[name].shape)}")
        scale = params.get(name + _quant.SCALE)
        if (t.dtype == torch.int8) != (scale is not None):
            raise ValueError(f"{name}: int8 codes and {name + _quant.SCALE} go together")
        if scale is not None and tuple(scale.shape) != (t.shape[0], 1):
            raise ValueError(f"{name + _quant.SCALE}: shape {tuple(scale.shape)}, the codes "
                             f"need one scale a row {(t.shape[0], 1)} (axis 0)")
        factors = [params.get(name + sfx) for sfx in (_lora.A, _lora.B, _lora.S)]
        if all(f is None for f in factors):
            continue
        if any(f is None for f in factors):
            raise ValueError(f"{name}: an adapter needs its _lora_a, _lora_b and _lora_scale")
        if scale is not None:
            raise ValueError(f"{name}: an adapter over int8 codes (merge_lora, then quantize)")
        a, b, _ = factors
        lead = tuple(a.shape[:-2])
        if (a.dim() not in (2, 3) or tuple(b.shape[:-2]) != lead
                or a.shape[-1] != t.shape[1] or b.shape[-2] != t.shape[0]
                or a.shape[-2] != b.shape[-1]):
            raise ValueError(f"{name}: factors {tuple(a.shape)} and {tuple(b.shape)} do not fit "
                             f"the base {tuple(t.shape)}")


def adopt_params(model: nn.Module, params: dict) -> dict:
    """Make ``params`` (name -> tensor, checked by :func:`check_params`)
    the parameters of ``model``: every slot is filled from ``params`` or
    emptied, so the weight set decides the format (plain, int8, one
    adapter, a bank). Tensors on the model's device are taken as they are
    (no copy), others are moved there. Returns the model's parameters by
    name: the same tensor objects a ``TrainState`` must hold (remat
    recomputes from the module's own)."""
    check_params(model, params)
    device = model.device
    for name, (mod, attr) in _slots(model).items():
        t = params.get(name)
        if t is not None and not isinstance(t, nn.Parameter):
            t = t.to(device)
            # scales (int8, LoRA) are constants: only weights may train
            t = nn.Parameter(t, requires_grad=t.is_floating_point() and not attr.endswith(
                _quant.SCALE))
        elif t is not None and t.device != device:
            raise ValueError(f"{name}: a Parameter on {t.device}, the model is on {device}")
        mod._parameters[attr] = t
    return dict(model.named_parameters())


def prefill(model: Llama, cache, prompt, lengths=None, adapter_ids=None):
    """The prompt (B, S) through ``model`` into a fresh ``cache``: returns
    each row's next-token logits (B, vocab) fp32 and the position of its
    next token (B,). With ``lengths`` (right-padded rows) each row's logits
    come from its true last position and it continues from its length.
    ``adapter_ids`` (B,): each row's LoRA bank slot."""
    b, s = prompt.shape
    positions = torch.arange(s, device=prompt.device).expand(b, s)
    logits = model(prompt, positions=positions, decode=True, padded=lengths is not None,
                   cache=cache, adapter_ids=adapter_ids)
    if lengths is None:
        return logits[:, -1], torch.full((b,), s, dtype=torch.long, device=prompt.device)
    last = logits[torch.arange(b, device=prompt.device), lengths - 1]
    return last, lengths


def decode_step(model: Llama, cache, tok, pos, padded=False, adapter_ids=None):
    """One token per row (B,) at positions ``pos`` (B,) through ``model``
    against ``cache``: the next-token logits (B, vocab) fp32."""
    return model(tok[:, None], positions=pos[:, None], decode=True, padded=padded,
                 cache=cache, adapter_ids=adapter_ids)[:, -1]


def _truncate(logits, top_k=None, top_p=None, min_p=None):
    """Temperature-scaled logits with the tokens ``top_k``/``top_p``/
    ``min_p`` drop set to -inf (top-k first; the three intersect)."""
    vocab = logits.shape[-1]
    k_active = top_k is not None and top_k < vocab
    p_active = top_p is not None and top_p < 1.0
    if k_active:
        sorted_desc = torch.topk(logits, top_k, dim=-1).values
        logits = logits.masked_fill(logits < sorted_desc[..., -1:], -math.inf)
    elif p_active:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    if p_active:
        cum = torch.softmax(sorted_desc, dim=-1).cumsum(-1)
        # the last kept token: everything before cumulative mass reaches
        # top_p, and at least the most likely token (an index past the end
        # keeps all, as the reference's clamping gather does)
        cutoff = (cum < top_p).sum(-1, keepdim=True).clamp(max=sorted_desc.shape[-1] - 1)
        logits = logits.masked_fill(logits < sorted_desc.gather(-1, cutoff), -math.inf)
    if min_p is not None and min_p > 0.0:
        # prob >= min_p * prob_max  <=>  logit >= max + log(min_p)
        log_min_p = torch.log(torch.tensor(min_p, dtype=torch.float32)).item()  # fp32, on the host
        floor = logits.amax(-1, keepdim=True) + log_min_p
        logits = logits.masked_fill(logits < floor, -math.inf)
    return logits


def sample_logits(logits, generator, temperature, top_k=None, top_p=None, min_p=None):
    """Next tokens (B,) from (B, vocab) logits.

    ``temperature == 0`` is greedy argmax (``generator`` unused). Otherwise
    a draw from ``softmax(logits / temperature)`` truncated to the ``top_k``
    most likely tokens and/or the smallest nucleus of mass ``top_p`` (top-k
    first) and/or the tokens of probability at least ``min_p`` times the
    most likely one's, intersected. The draw is Gumbel-max on uniforms from
    ``generator`` (never the global generator), so a seed fixes the tokens.
    """
    if temperature == 0.0:
        return logits.argmax(-1)
    logits = _truncate(logits / temperature, top_k, top_p, min_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return (logits - torch.log(-torch.log(u))).argmax(-1)


@torch.no_grad()
def generate(model: Llama, prompt, max_new_tokens: int, temperature: float = 0.0,
             top_k: int | None = None, top_p: float | None = None,
             min_p: float | None = None, generator: torch.Generator | None = None,
             eos_id: int | None = None, prompt_lengths=None, mesh=None, adapter_ids=None):
    """Autoregressive sampling with a KV cache: (B, S) -> (B, max_new_tokens).

    One prefill over the prompt (:func:`prefill`), then single-token steps
    (:func:`decode_step`) against the cache :func:`init_cache` allocated
    once. ``temperature=0`` is greedy argmax; otherwise tokens are drawn by
    :func:`sample_logits` from ``generator`` (a fresh one seeded 0 on the
    model's device when None).

    Mixed-length prompts: right-pad ``prompt`` and pass ``prompt_lengths``
    (B,); each row samples its first token at its last real position and
    decodes from its own length, overwriting its padding slots as it goes.
    Without ``prompt_lengths`` every row's true length is S.

    ``eos_id``: rows that emit it are finished and keep emitting it; the
    loop ends once every row has finished (one host sync a step for that
    test), and the output stays (B, max_new_tokens). Without ``eos_id`` the
    loop takes max_new_tokens - 1 steps and never waits for the device.

    ``adapter_ids`` (B,): each row's LoRA bank slot (None: slot 0). int8
    and adapted weights decode as the model holds them (:func:`adopt_params`).

    Not ported yet: ``mesh`` (decode on a device mesh, ROADMAP A9b).
    """
    cfg = model.cfg
    device = model.device
    prompt = torch.as_tensor(prompt, device=device)
    b, s = prompt.shape
    if s + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds max_seq_len "
            f"({cfg.max_seq_len}); the KV cache cannot hold it"
        )
    if top_k is not None and top_k < 1:
        raise ValueError("top_k must be >= 1")
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError("top_p must be in (0, 1]")
    if min_p is not None and not (0.0 <= min_p <= 1.0):
        raise ValueError("min_p must be in [0, 1]")
    if temperature == 0.0 and (top_k is not None or top_p is not None or min_p is not None):
        raise ValueError(
            "top_k/top_p/min_p require temperature > 0 (temperature=0 is greedy argmax, "
            "which would silently ignore them)"
        )
    if mesh is not None:
        raise NotImplementedError("generate on a device mesh is not ported yet: ROADMAP A9b")
    lengths = None
    if prompt_lengths is not None:
        # host-side range check: an out-of-range length would index garbage
        host = np.asarray(torch.as_tensor(prompt_lengths).cpu())
        if host.shape != (b,):
            raise ValueError(f"prompt_lengths must have shape ({b},), got {host.shape}")
        if (host < 1).any() or (host > s).any():
            raise ValueError(
                f"prompt_lengths must be in [1, {s}] (the padded prompt width); "
                f"got {host.tolist()}"
            )
        lengths = torch.as_tensor(host, dtype=torch.long, device=device)
    if generator is None and temperature != 0.0:
        generator = torch.Generator(device=device).manual_seed(0)
    if adapter_ids is not None:
        adapter_ids = torch.as_tensor(adapter_ids, dtype=torch.long, device=device)

    def sample(logits):
        return sample_logits(logits, generator, float(temperature), top_k, top_p, min_p)

    padded = lengths is not None
    cache = init_cache(cfg, b, device)
    logits, pos = prefill(model, cache, prompt, lengths, adapter_ids)
    tok = sample(logits)
    if eos_id is None:
        toks = [tok]
        for _ in range(max_new_tokens - 1):
            tok = sample(decode_step(model, cache, tok, pos, padded, adapter_ids))
            pos = pos + 1
            toks.append(tok)
        return torch.stack(toks, dim=1)
    out = torch.full((b, max_new_tokens), eos_id, dtype=torch.long, device=device)
    out[:, 0] = tok
    done = tok == eos_id
    for i in range(1, max_new_tokens):
        if bool(done.all()):
            break
        nxt = sample(decode_step(model, cache, tok, pos, padded, adapter_ids))
        pos = pos + 1
        nxt = torch.where(done, eos_id, nxt)  # eos stays in finished rows
        out[:, i] = nxt
        done = done | (nxt == eos_id)
        tok = nxt
    return out


def packed_loss_mask(segment_ids):
    """Loss mask + canonicalized ids for packed rows (B, S+1): returns
    ``(mask (B, S) fp32, canonical_ids (B, S+1))``. Id 0 is padding; a
    document's last token does not train on the next document's first."""
    not_pad = (segment_ids[:, :-1] != 0).float()
    new_doc = segment_ids[:, 1:] != segment_ids[:, :-1]
    canonical = torch.cat(
        [
            torch.zeros_like(segment_ids[:, :1]),
            torch.cumsum(new_doc.to(segment_ids.dtype), dim=1),
        ],
        dim=1,
    )
    mask = (canonical[:, :-1] == canonical[:, 1:]).float() * not_pad
    return mask, canonical


def packed_valid_count(segment_ids):
    """Scalar count of loss-contributing positions in a packed batch:
    ``build_train_step``'s ``batch_weight_fn`` for packed CE."""
    mask, _ = packed_loss_mask(segment_ids)
    return mask.sum()


def cross_entropy_loss(logits, targets, mask=None):
    """Mean next-token cross entropy; logits (B,S,V), targets (B,S)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1)
    return nll.mean()


def _chunk_nll_sum(hc, head16, tc, mk):
    logits = (hc @ head16.t()).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tc[..., None].long())[..., 0]
    return (nll * mk).sum()


def llama_loss_fn(model: Llama, logit_chunk: int | None = None):
    """Next-token loss ``(params, tokens (B, S+1), segment_ids=None) -> scalar``,
    plus the MoE layers' load-balancing losses (``parallel.moe``; none for a
    dense model): MoE configs must train through this loss, as in the
    reference, whose loss collects the sown ``losses``.

    ``params`` maps the model's parameter names to tensors (a
    ``TrainState.params``); the model runs with them in place of its own
    (``torch.func.functional_call``). Under ``cfg.remat`` the blocks are
    recomputed in backward from the module's own parameters, so there
    ``params`` must hold the model's own tensors.

    ``logit_chunk``: project the vocabulary and take the cross entropy per
    sequence chunk of this length under checkpointing, so the (B, S,
    vocab) fp32 logits never exist at once. Must divide the sequence.

    ``segment_ids`` (B, S+1) marks packed documents (see
    :func:`packed_loss_mask`).
    """

    def loss(params, tokens, segment_ids=None):
        if model.cfg.remat:
            own = dict(model.named_parameters())
            if any(params[n] is not p for n, p in own.items()):
                raise ValueError("with cfg.remat the loss needs the model's own parameters")
        mask = None
        if segment_ids is not None:
            mask, segment_ids = packed_loss_mask(segment_ids)
        seg_in = None if segment_ids is None else segment_ids[:, :-1]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        kw = {"segment_ids": seg_in, "return_aux": True}
        if logit_chunk is None:
            logits, auxes = torch.func.functional_call(model, params, (inputs,), kw)
            return _with_aux(cross_entropy_loss(logits, targets, mask), auxes)
        (hidden, head), auxes = torch.func.functional_call(
            model, params, (inputs,), {**kw, "return_hidden": True}
        )
        b, s, _ = hidden.shape
        if s % logit_chunk:
            raise ValueError(f"logit_chunk {logit_chunk} must divide seq len {s}")
        head16 = head.to(hidden.dtype)
        mc = torch.ones(b, s, device=hidden.device) if mask is None else mask
        total = torch.zeros((), device=hidden.device)
        for c0 in range(0, s, logit_chunk):
            sl = slice(c0, c0 + logit_chunk)
            total = total + checkpoint(
                _chunk_nll_sum, hidden[:, sl], head16, targets[:, sl], mc[:, sl],
                use_reentrant=False,
            )
        return _with_aux(total / mc.sum().clamp_min(1), auxes)

    return loss


def _with_aux(loss, auxes):
    for aux in auxes:
        loss = loss + aux.loss
    return loss
