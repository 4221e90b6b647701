"""Vision Transformer, the ViT-B/16 family (port of
:mod:`tensorflowonspark_tpu.models.vit`).

``image (B, H, W, 3) -> fp32 logits (B, num_classes)``. The patch
embedding is a strided ``VALID`` convolution (``patch_embed``, NHWC, with a
bias); its grid flattens row-major into tokens, a CLS token (zeros, fp32,
cast to ``cfg.dtype``) goes first and ``pos_embed`` (fp32) is added in
``cfg.dtype``. Each block is pre-LN: LayerNorm (flax's: ε = 1e-6,
statistics in fp32, output in ``cfg.dtype``), q/k/v projections, attention
through :func:`ops.attention.dot_product_attention` with ``causal=False``
and ``impl=cfg.attention_impl``, ``o_proj``, then LayerNorm, ``up``, tanh
GELU (flax's ``nn.gelu`` default) and ``down``, each with its residual. The
head is an fp32 dense layer on the final LayerNorm of the CLS token.

Parameter names are the flax paths (``patch_embed.weight``, ``cls``,
``pos_embed``, ``layer0.q_proj.weight``, ``layer0.LayerNorm_1.scale``,
``Dense_0.weight`` …), so :mod:`models.convert` maps the trees leaf by
leaf. ``vit_param_shardings`` reads the layout table ``"vit"``.

At ViT-B/16's 197 tokens, ``impl="auto"`` takes the plain attention on
CUDA too: the flash gate (``ops/attention.py``) keeps the JAX package's
multiple-of-128 thresholds. ``attention_impl="flash"`` sends it through the
kernels, which take ragged lengths.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.models.conv import (
    Conv, Dense, FlaxNamed, LayerNorm, init_weights, table_shardings,
)
from tensorflowonspark_tpu_torch.ops.attention import dot_product_attention
from tensorflowonspark_tpu_torch.parallel.context import mesh_region


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "auto"

    @staticmethod
    def b16(**overrides) -> "ViTConfig":
        return ViTConfig(**overrides)

    @staticmethod
    def tiny(**overrides) -> "ViTConfig":
        base = dict(image_size=16, patch_size=4, hidden_size=32, num_layers=2, num_heads=4,
                    num_classes=10, dtype=torch.float32)
        base.update(overrides)
        return ViTConfig(**base)


class _Block(FlaxNamed):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden_size, cfg.dtype
        self.child(LayerNorm(h, 1e-6, dt, device))
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            self.child(Dense(h, h, dt, device), name)
        self.child(LayerNorm(h, 1e-6, dt, device))
        self.child(Dense(h, h * cfg.mlp_ratio, dt, device), "up")
        self.child(Dense(h * cfg.mlp_ratio, h, dt, device), "down")

    def forward(self, x):
        cfg = self.cfg
        b, n, h = x.shape
        heads = (b, n, cfg.num_heads, h // cfg.num_heads)
        y = self.LayerNorm_0(x)
        q, k, v = (proj(y).reshape(heads) for proj in (self.q_proj, self.k_proj, self.v_proj))
        a = dot_product_attention(q, k, v, causal=False, impl=cfg.attention_impl)
        x = x + self.o_proj(a.reshape(b, n, h))
        y = self.down(F.gelu(self.up(self.LayerNorm_1(x)), approximate="tanh"))
        return x + y


class ViT(FlaxNamed):
    """``image (B, H, W, 3) -> fp32 logits``, built on ``device`` (CUDA
    unless the caller passes another) with weights drawn from ``seed``."""

    def __init__(self, cfg: ViTConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.image_size % cfg.patch_size:
            raise ValueError(
                f"image_size {cfg.image_size} not divisible by patch_size {cfg.patch_size}")
        device = resolve_device(device)
        self.cfg = cfg
        h, p = cfg.hidden_size, cfg.patch_size
        self.child(Conv(3, h, (p, p), (p, p), cfg.dtype, device, bias=True, padding="VALID"),
                   "patch_embed")
        n = (cfg.image_size // p) ** 2
        self.cls = nn.Parameter(torch.zeros(1, 1, h, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, n + 1, h, device=device))
        self.blocks = tuple(self.child(_Block(cfg, device), f"layer{i}")
                            for i in range(cfg.num_layers))
        self.child(LayerNorm(h, 1e-6, cfg.dtype, device))
        # classifier head in fp32 for a stable softmax
        self.child(Dense(h, cfg.num_classes, torch.float32, device))
        init_weights(self, seed, device)
        with torch.no_grad():
            gen = torch.Generator(device=device).manual_seed(seed + 1)
            self.pos_embed.normal_(0.0, 0.02, generator=gen)

    def forward(self, x, train: bool = False):
        cfg = self.cfg
        x = self.patch_embed(x.to(cfg.dtype))
        b = x.shape[0]
        x = x.reshape(b, -1, cfg.hidden_size)  # the grid, row-major
        cls = self.cls.expand(b, 1, cfg.hidden_size).to(cfg.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        for blk in self.blocks:
            x = blk(x)
        x = self.LayerNorm_0(x)
        return self.Dense_0(x[:, 0])


# the layout table's 'vit' rules: 2-D kernels over ('fsdp', 'model'), the
# patch kernel's output channels over 'model', a dim that does not divide
# its axis replicated, the rest replicated
vit_param_shardings = table_shardings("vit")


def loss_fn(model: ViT):
    """``loss(params, batch) -> scalar`` for batches ``{'image', 'label'}``
    (ViT has no BatchNorm statistics): mean softmax cross entropy."""

    def loss(params, batch):
        with mesh_region(batch["image"]):
            logits = torch.func.functional_call(model, params, (batch["image"],),
                                                {"train": True})
            return F.cross_entropy(logits.float(), batch["label"].long())

    return loss
