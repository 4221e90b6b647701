"""Inception-v3 (port of :mod:`tensorflowonspark_tpu.models.inception`).

The JAX package's variant: SAME padding everywhere (at 299×299 the A/B/C
grids are 38/19/10), BatchNorm epsilon 1e-3, factorized 7×1/1×7 and
3×1/1×3 convs, branch widths scaled by ``width_mult`` through
:meth:`InceptionConfig.w`, an auxiliary head on the B grid in train mode.
NHWC; branches concatenate along the channels (the last dim, so the
result stays contiguous NHWC).

Dropout (``dropout_rate > 0``) draws from an explicit ``torch.Generator``;
its bits cannot match JAX's, so the port is held to the JAX package at
rate 0 only. ``inception_param_shardings`` waits for ROADMAP A8.
"""

from __future__ import annotations

import dataclasses

import torch

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.models.conv import (
    Dense,
    FlaxNamed,
    _ConvBN,
    avg_pool,
    classifier_loss_fn,
    global_avg_pool,
    init_weights,
    max_pool,
)


@dataclasses.dataclass(frozen=True)
class InceptionConfig:
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    # classic v3: 3 A-blocks, 4 B-blocks, 2 C-blocks, separated by the two
    # reduction blocks
    num_a_blocks: int = 3
    num_b_blocks: int = 4
    num_c_blocks: int = 2
    width_mult: float = 1.0  # scales every branch width (tiny/CI configs)
    aux_logits: bool = True  # B-grid auxiliary classifier (train only)
    aux_weight: float = 0.4  # paper's aux-loss discount
    dropout_rate: float = 0.0  # pre-classifier dropout

    @staticmethod
    def v3(**overrides) -> "InceptionConfig":
        return InceptionConfig(**overrides)

    @staticmethod
    def tiny(**overrides) -> "InceptionConfig":
        """One of each block type at 1/8 width: every code path, tiny cost."""
        base = dict(num_classes=10, num_a_blocks=1, num_b_blocks=1, num_c_blocks=1,
                    width_mult=0.125, aux_logits=False)
        base.update(overrides)
        return InceptionConfig(**base)

    def w(self, channels: int) -> int:
        """Scale a classic branch width, keeping multiples of 8."""
        return max(8, int(channels * self.width_mult) // 8 * 8)


class _Block(FlaxNamed):
    def __init__(self, cfg: InceptionConfig, device):
        super().__init__()
        self._cfg, self._device = cfg, device

    def cbn(self, cin, cout, kernel, strides=(1, 1)):
        cfg = self._cfg
        return self.child(_ConvBN(cin, cout, kernel, strides, cfg.dtype, eps=1e-3,
                                  device=self._device))


def _chain(units, x, train):
    for unit in units:
        x = unit(x, train)
    return x


def _avg_pool_same(x):
    return avg_pool(x, 3, 1, "SAME")


class InceptionA(_Block):
    """A-grid block: 1x1 / 5x5 / double-3x3 / pool branches."""

    def __init__(self, cfg, cin, pool_features, device=None):
        super().__init__(cfg, device)
        w = cfg.w
        self.b1 = (self.cbn(cin, w(64), (1, 1)),)
        self.b5 = (self.cbn(cin, w(48), (1, 1)), self.cbn(w(48), w(64), (5, 5)))
        self.b3 = (self.cbn(cin, w(64), (1, 1)), self.cbn(w(64), w(96), (3, 3)),
                   self.cbn(w(96), w(96), (3, 3)))
        self.bp = (self.cbn(cin, pool_features, (1, 1)),)
        self.out = w(64) + w(64) + w(96) + pool_features

    def forward(self, x, train):
        return torch.cat([_chain(self.b1, x, train), _chain(self.b5, x, train),
                          _chain(self.b3, x, train), _chain(self.bp, _avg_pool_same(x), train)],
                         dim=-1)


class ReductionA(_Block):
    """A -> B grid: stride-2 3x3 / stride-2 double-3x3 / maxpool."""

    def __init__(self, cfg, cin, device=None):
        super().__init__(cfg, device)
        w = cfg.w
        self.b3 = (self.cbn(cin, w(384), (3, 3), (2, 2)),)
        self.bd = (self.cbn(cin, w(64), (1, 1)), self.cbn(w(64), w(96), (3, 3)),
                   self.cbn(w(96), w(96), (3, 3), (2, 2)))
        self.out = w(384) + w(96) + cin

    def forward(self, x, train):
        return torch.cat([_chain(self.b3, x, train), _chain(self.bd, x, train),
                          max_pool(x, 3, 2, "SAME")], dim=-1)


class InceptionB(_Block):
    """B-grid block with factorized 7x1/1x7 convs."""

    def __init__(self, cfg, cin, c7, device=None):
        super().__init__(cfg, device)
        c7, out = cfg.w(c7), cfg.w(192)
        self.b1 = (self.cbn(cin, out, (1, 1)),)
        self.b7 = (self.cbn(cin, c7, (1, 1)), self.cbn(c7, c7, (1, 7)), self.cbn(c7, out, (7, 1)))
        self.bd = (self.cbn(cin, c7, (1, 1)), self.cbn(c7, c7, (7, 1)), self.cbn(c7, c7, (1, 7)),
                   self.cbn(c7, c7, (7, 1)), self.cbn(c7, out, (1, 7)))
        self.bp = (self.cbn(cin, out, (1, 1)),)
        self.out = 4 * out

    def forward(self, x, train):
        return torch.cat([_chain(self.b1, x, train), _chain(self.b7, x, train),
                          _chain(self.bd, x, train), _chain(self.bp, _avg_pool_same(x), train)],
                         dim=-1)


class ReductionB(_Block):
    """B -> C grid."""

    def __init__(self, cfg, cin, device=None):
        super().__init__(cfg, device)
        w = cfg.w
        self.b3 = (self.cbn(cin, w(192), (1, 1)), self.cbn(w(192), w(320), (3, 3), (2, 2)))
        self.b7 = (self.cbn(cin, w(192), (1, 1)), self.cbn(w(192), w(192), (1, 7)),
                   self.cbn(w(192), w(192), (7, 1)), self.cbn(w(192), w(192), (3, 3), (2, 2)))
        self.out = w(320) + w(192) + cin

    def forward(self, x, train):
        return torch.cat([_chain(self.b3, x, train), _chain(self.b7, x, train),
                          max_pool(x, 3, 2, "SAME")], dim=-1)


class InceptionC(_Block):
    """C-grid block: the widest one (1x3/3x1 split branches)."""

    def __init__(self, cfg, cin, device=None):
        super().__init__(cfg, device)
        w = cfg.w
        # a tuple, not attributes: each unit is registered once, under its flax name
        self.units = (
            self.cbn(cin, w(320), (1, 1)),  # b1
            self.cbn(cin, w(384), (1, 1)),  # b3, then split 1x3 / 3x1
            self.cbn(w(384), w(384), (1, 3)),
            self.cbn(w(384), w(384), (3, 1)),
            self.cbn(cin, w(448), (1, 1)),  # bd, then split 1x3 / 3x1
            self.cbn(w(448), w(384), (3, 3)),
            self.cbn(w(384), w(384), (1, 3)),
            self.cbn(w(384), w(384), (3, 1)),
            self.cbn(cin, w(192), (1, 1)),  # pool branch
        )
        self.out = w(320) + 4 * w(384) + w(192)

    def forward(self, x, train):
        b1, b3, b3a, b3b, bd0, bd1, bda, bdb, bp = self.units
        y3 = b3(x, train)
        yd = bd1(bd0(x, train), train)
        return torch.cat([
            b1(x, train),
            torch.cat([b3a(y3, train), b3b(y3, train)], dim=-1),
            torch.cat([bda(yd, train), bdb(yd, train)], dim=-1),
            bp(_avg_pool_same(x), train),
        ], dim=-1)


class _AuxHead(_Block):
    """B-grid auxiliary classifier (training regularizer, paper §4)."""

    def __init__(self, cfg, cin, device=None):
        super().__init__(cfg, device)
        self.units = (self.cbn(cin, cfg.w(128), (1, 1)), self.cbn(cfg.w(128), cfg.w(768), (5, 5)))
        self.child(Dense(cfg.w(768), cfg.num_classes, torch.float32, device))

    def forward(self, x, train):
        x = _chain(self.units, avg_pool(x, 5, 3), train)
        return self.Dense_0(global_avg_pool(x))


class InceptionV3(FlaxNamed):
    """``image (B, H, W, 3) -> fp32 logits``; ``(logits, aux_logits)`` when
    the aux head runs (``aux_logits`` configs in train mode)."""

    def __init__(self, cfg: InceptionConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        w, dt = cfg.w, cfg.dtype
        cbn = lambda cin, cout, k, s=(1, 1): self.child(  # noqa: E731
            _ConvBN(cin, cout, k, s, dt, eps=1e-3, device=device))
        # stem: 299 -> /8 grid, 192 channels
        self.stem_a = (cbn(3, w(32), (3, 3), (2, 2)), cbn(w(32), w(32), (3, 3)),
                       cbn(w(32), w(64), (3, 3)))
        self.stem_b = (cbn(w(64), w(80), (1, 1)), cbn(w(80), w(192), (3, 3)))
        cin, tower = w(192), []
        for i in range(cfg.num_a_blocks):
            tower.append(self.child(InceptionA(cfg, cin, w(32 if i == 0 else 64), device)))
            cin = tower[-1].out
        tower.append(self.child(ReductionA(cfg, cin, device)))
        cin = tower[-1].out
        # B tower: factorized-conv width ramps 128 -> 160 -> 192
        for i in range(cfg.num_b_blocks):
            frac = i / max(cfg.num_b_blocks - 1, 1)
            tower.append(self.child(InceptionB(cfg, cin, int(128 + 64 * frac), device)))
            cin = tower[-1].out
        self.tower_ab = tuple(tower)
        if cfg.aux_logits:
            self.child(_AuxHead(cfg, cin, device), "aux")
        tower = [self.child(ReductionB(cfg, cin, device))]
        cin = tower[-1].out
        for _ in range(cfg.num_c_blocks):
            tower.append(self.child(InceptionC(cfg, cin, device)))
            cin = tower[-1].out
        self.tower_c = tuple(tower)
        self.child(Dense(cin, cfg.num_classes, torch.float32, device), "head")
        init_weights(self, seed, device)

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        cfg = self.cfg
        x = x.to(cfg.dtype)
        x = max_pool(_chain(self.stem_a, x, train), 3, 2, "SAME")
        x = max_pool(_chain(self.stem_b, x, train), 3, 2, "SAME")
        x = _chain(self.tower_ab, x, train)
        aux = self.aux(x, train) if cfg.aux_logits and train else None
        x = global_avg_pool(_chain(self.tower_c, x, train))
        if cfg.dropout_rate > 0 and train:
            if generator is None:
                raise ValueError("dropout_rate > 0 needs a torch.Generator in train mode")
            keep = 1.0 - cfg.dropout_rate
            mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
            x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
        logits = self.head(x)
        return (logits, aux) if aux is not None else logits


def loss_fn(model: InceptionV3, generator: torch.Generator | None = None):
    """``loss(params, batch_stats, batch) -> (loss, new_batch_stats)``,
    folding the aux head in at ``cfg.aux_weight`` when it runs; dropout
    draws from ``generator``."""
    kwargs = {"generator": generator} if generator is not None else {}
    return classifier_loss_fn(model, aux_weight=model.cfg.aux_weight, **kwargs)
