"""Llama-family decoder, training path (port of
:mod:`tensorflowonspark_tpu.models.llama`).

Parameters are stored in fp32 and cast to ``cfg.dtype`` where they are
used, as flax does with its default fp32 params; activations run in
``cfg.dtype`` with fp32 RMSNorm, RoPE and softmax. Attention goes through
:func:`ops.attention.dot_product_attention`, whose ``auto`` route takes the
CUDA flash kernels on a GPU.

Parameter names follow the flax tree (``embed``, ``layers.{i}.attn.q_proj``
for ``layer{i}/attn/q_proj`` …); :mod:`models.convert` maps the two.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): KV-cache decode, MoE experts, ``remat_policy='dots'``, and int8 or
LoRA kernels (``models.convert.params_from_jax`` rejects them).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.ops.attention import dot_product_attention


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
    # 'full' (or 'none'): recompute the whole block in backward; 'dots'
    # is not ported yet
    remat_policy: str = "full"
    # MoE experts are not ported yet (ROADMAP A10): only 0 is accepted
    num_experts: int = 0
    # Qwen2-family QKV bias
    attention_bias: bool = False
    # sliding-window attention: each query sees the last `sliding_window` keys
    sliding_window: int | None = None

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
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponent)
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


class Dense(nn.Module):
    """Bias-free (or, for Qwen2's QKV, biased) projection computed in
    ``dtype``. The weight is stored ``(out, in)`` as ``nn.Linear`` does."""

    def __init__(self, d_in, d_out, dtype, bias=False, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device)) if bias else None

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
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

    def forward(self, x, positions, segment_ids=None):
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = self.v_proj(x).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        out = dot_product_attention(
            q, k, v.contiguous(), causal=True, segment_ids=segment_ids,
            impl=cfg.attention_impl, window=cfg.sliding_window,
        )
        return self.o_proj(out.reshape(b, s, cfg.num_heads * cfg.head_dim))


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        h, i, dt = cfg.hidden_size, cfg.intermediate_size, cfg.dtype
        self.gate_proj = Dense(h, i, dt, device=device)
        self.up_proj = Dense(h, i, dt, device=device)
        self.down_proj = Dense(i, h, dt, device=device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, positions, segment_ids=None):
        h = x + self.attn(self.attn_norm(x), positions, segment_ids)
        return h + self.mlp(self.mlp_norm(h))


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
        if cfg.num_experts > 0:
            raise NotImplementedError("MoE experts (num_experts > 0) are not ported yet: ROADMAP A10")
        if cfg.remat and cfg.remat_policy == "dots":
            raise NotImplementedError("remat_policy='dots' is not ported yet: ROADMAP A3")
        if cfg.remat and cfg.remat_policy not in ("full", "none"):
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
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("weight") or name in ("embed", "lm_head"):
                    p.normal_(0.0, 0.02, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, positions=None, segment_ids=None, decode=False, return_hidden=False):
        """``return_hidden=True`` returns ``(hidden, lm_head)`` — the final
        normed hidden states (B, S, H) and the head weight (vocab, H) — so
        a loss can project the vocabulary in chunks."""
        if decode:
            raise NotImplementedError("KV-cache decode is not ported yet: ROADMAP A9")
        cfg = self.cfg
        if positions is None:
            if segment_ids is None:
                positions = torch.arange(tokens.shape[1], device=tokens.device).expand_as(tokens)
            else:
                positions = packed_positions(segment_ids)
        x = self.embed[tokens].to(cfg.dtype)
        for block in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, positions, segment_ids, use_reentrant=False)
            else:
                x = block(x, positions, segment_ids)
        x = self.final_norm(x)
        if return_hidden:
            return x, self.lm_head
        return F.linear(x, self.lm_head.to(cfg.dtype)).float()


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
    """Next-token loss ``(params, tokens (B, S+1), segment_ids=None) -> scalar``.

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
        if logit_chunk is None:
            logits = torch.func.functional_call(model, params, (inputs,), {"segment_ids": seg_in})
            return cross_entropy_loss(logits, targets, mask)
        hidden, head = torch.func.functional_call(
            model, params, (inputs,), {"segment_ids": seg_in, "return_hidden": True}
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
        return total / mc.sum().clamp_min(1)

    return loss
