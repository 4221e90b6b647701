"""BERT encoder family (port of :mod:`tensorflowonspark_tpu.models.bert`).

Post-LN encoder blocks (attention → add & LayerNorm → tanh-GELU FFN → add
& LayerNorm), products in ``cfg.dtype``, LayerNorm in fp32 at
``layer_norm_eps`` (1e-12) cast back to ``cfg.dtype``. Attention is
bidirectional, through :func:`ops.attention.dot_product_attention` with
``causal=False``: the 0/1 ``attention_mask`` is passed as ``segment_ids``,
so a real token never attends to a pad and a pad attends to pads (pad rows
are dropped downstream); ``attention_mask=None`` means no mask. On CUDA at
S ∈ {128, 512} the ``auto`` gate takes the flash kernels, so BERT runs the
forward, dQ and dK/dV kernels with segment ids and no causal mask.
``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``).

Parameter names are the flax paths (``bert.tok.embedding``, ``bert.pos``,
``bert.emb_ln.LayerNorm_0.scale``, ``bert.layer_0.query.weight``,
``head.weight``, ``mlm_head.weight`` …), so :mod:`models.convert` maps the
trees leaf by leaf. ``bert_param_shardings`` reads the layout table
``"bert"``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.models.conv import (
    Dense, FlaxNamed, LayerNorm, init_weights, table_shardings,
)
from tensorflowonspark_tpu_torch.ops.attention import dot_product_attention
from tensorflowonspark_tpu_torch.parallel.context import gather_fsdp, mesh_region


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "auto"
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def bert_base(**kw) -> "BertConfig":
        return BertConfig(**kw)

    @staticmethod
    def bert_large(**kw) -> "BertConfig":
        return BertConfig(hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
                          **kw)

    @staticmethod
    def tiny(**overrides) -> "BertConfig":
        base = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                    intermediate_size=128, max_seq_len=64)
        base.update(overrides)
        return BertConfig(**base)


class Embed(nn.Module):
    """flax ``nn.Embed(num, features, dtype)``: an fp32 table, the gathered
    rows in ``dtype``."""

    def __init__(self, num: int, features: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, features, device=device))

    def forward(self, ids):
        return F.embedding(ids, gather_fsdp(self.embedding)).to(self.dtype)


class _LayerNorm(FlaxNamed):
    """The reference's ``_LayerNorm``: flax LayerNorm in fp32 (its params at
    ``<name>/LayerNorm_0``); the caller casts the fp32 result."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.child(LayerNorm(dim, eps, torch.float32, device))

    def forward(self, x):
        return self.LayerNorm_0(x)


class EncoderBlock(FlaxNamed):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, f, dt = cfg.hidden_size, cfg.intermediate_size, cfg.dtype
        for name in ("query", "key", "value"):
            self.child(Dense(h, cfg.num_heads * cfg.head_dim, dt, device), name)
        self.child(Dense(h, h, dt, device), "attn_out")
        self.child(_LayerNorm(h, cfg.layer_norm_eps, device), "attn_ln")
        self.child(Dense(h, f, dt, device), "ffn_in")
        self.child(Dense(f, h, dt, device), "ffn_out")
        self.child(_LayerNorm(h, cfg.layer_norm_eps, device), "ffn_ln")

    def forward(self, x, segment_ids=None):
        cfg = self.cfg
        heads = (*x.shape[:2], cfg.num_heads, cfg.head_dim)
        q, k, v = (proj(x).reshape(heads) for proj in (self.query, self.key, self.value))
        attn = dot_product_attention(q, k, v, causal=False, segment_ids=segment_ids,
                                     impl=cfg.attention_impl)
        attn = self.attn_out(attn.reshape(x.shape))
        x = self.attn_ln(x + attn).to(cfg.dtype)
        ffn = self.ffn_out(F.gelu(self.ffn_in(x), approximate="tanh"))
        return self.ffn_ln(x + ffn).to(cfg.dtype)


class Bert(FlaxNamed):
    """``(tokens, token_types=None, attention_mask=None) -> (sequence
    output (B, S, H), pooled output (B, H))``."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden_size, cfg.dtype
        self.child(Embed(cfg.vocab_size, h, dt, device), "tok")
        self.child(Embed(cfg.type_vocab_size, h, dt, device), "typ")
        self.pos = nn.Parameter(torch.empty(cfg.max_seq_len, h, device=device))
        self.child(_LayerNorm(h, cfg.layer_norm_eps, device), "emb_ln")
        self.blocks = tuple(self.child(EncoderBlock(cfg, device), f"layer_{i}")
                            for i in range(cfg.num_layers))
        self.child(Dense(h, h, dt, device), "pooler")

    def forward(self, tokens, token_types=None, attention_mask=None):
        cfg = self.cfg
        s = tokens.shape[1]
        if token_types is None:
            token_types = torch.zeros_like(tokens)
        # the 0/1 padding mask as segment ids: attention only between equal values
        segment_ids = attention_mask
        emb = self.tok(tokens) + self.typ(token_types)
        emb = emb + self.pos[None, :s].to(cfg.dtype)
        x = self.emb_ln(emb).to(cfg.dtype)
        for blk in self.blocks:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, segment_ids, use_reentrant=False)
            else:
                x = blk(x, segment_ids)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


def _init(model: nn.Module, seed: int, device) -> None:
    """Dense weights at std 1/√fan_in, embedding tables and ``pos`` at
    std 0.02, LayerNorm scales 1 and biases 0, from ``seed``."""
    init_weights(model, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("embedding") or name.endswith("pos"):
                p.normal_(0.0, 0.02, generator=gen)


class BertForClassification(FlaxNamed):
    """fp32 logits ``(B, num_classes)`` from the pooled output."""

    def __init__(self, cfg: BertConfig, num_classes: int = 2, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.num_classes = cfg, num_classes
        self.child(Bert(cfg, device), "bert")
        # head in fp32 for a stable softmax
        self.child(Dense(cfg.hidden_size, num_classes, torch.float32, device), "head")
        _init(self, seed, device)

    def forward(self, tokens, token_types=None, attention_mask=None):
        _, pooled = self.bert(tokens, token_types, attention_mask)
        return self.head(pooled)


class BertForMLM(FlaxNamed):
    """fp32 logits ``(B, S, vocab)``: dense, tanh GELU, LayerNorm, head."""

    def __init__(self, cfg: BertConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        h = cfg.hidden_size
        self.child(Bert(cfg, device), "bert")
        self.child(Dense(h, h, cfg.dtype, device), "mlm_transform")
        self.child(_LayerNorm(h, cfg.layer_norm_eps, device), "mlm_ln")
        self.child(Dense(h, cfg.vocab_size, torch.float32, device), "mlm_head")
        _init(self, seed, device)

    def forward(self, tokens, token_types=None, attention_mask=None):
        seq, _ = self.bert(tokens, token_types, attention_mask)
        x = F.gelu(self.mlm_transform(seq), approximate="tanh")
        return self.mlm_head(self.mlm_ln(x).to(self.cfg.dtype))


# the layout table's 'bert' rules (Megatron: q/k/v and ffn_in column-
# parallel, attn_out and ffn_out row-parallel; a rule whose dims do not
# divide falls through)
bert_param_shardings = table_shardings("bert")


def classification_loss_fn(model: BertForClassification):
    """``loss(params, batch)`` for batches ``{'tokens', 'label', optional
    'mask'}``: mean softmax cross entropy of the fp32 logits."""

    def loss(params, batch):
        with mesh_region(batch["tokens"]):
            logits = torch.func.functional_call(model, params, (batch["tokens"],),
                                                {"attention_mask": batch.get("mask")})
            return F.cross_entropy(logits.float(), batch["label"].long())

    return loss
