"""Model-zoo factory: name -> ready-to-train model bundle (port of
:mod:`tensorflowonspark_tpu.models.zoo`, the ``nets_factory`` surface
through which a driver script picks a model by flag).

Every name resolves to a :class:`ZooEntry` carrying the port's module, an
example input maker, the layout table's placements and a loss builder with
the signature of its family:

- the BatchNorm image classifiers (ResNet, VGG, Inception-v3;
  ``kind='image'``, ``has_batch_stats``): batches ``{'image', 'label'}``,
  loss ``(params, batch_stats, batch) -> (loss, new_batch_stats)``
  (``models.conv.classifier_loss_fn``), trained with
  ``compute.train.build_bn_train_step``;
- ViT-B/16 (``kind='image'``, no statistics): ``(params, batch) -> loss``;
- U-Net (``kind='segmentation'``): batches ``{'image', 'mask'}``,
  ``(params, batch) -> loss``;
- BERT-base (masked LM) and the Llama presets (``kind='tokens'``):
  ``(params, batch) -> loss`` on ``{'tokens', 'targets'}`` and
  ``{'tokens'}``.

The names are the JAX package's 15. Divergences: an entry carries the
family's ``config`` and builds its module on first use of ``model`` (on
``device``, CUDA unless named, with weights from ``seed``), since a port
module holds its weights and a full-size Llama preset is tens of GB; the
JAX package's flax module holds none. ``make_input`` is the JAX package's
numpy draw from ``default_rng(0)``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class ZooEntry:
    name: str
    kind: str  # 'image' | 'tokens' | 'segmentation'
    config: Any  # the family's config dataclass
    build_model: Callable[[], Any]  # () -> the port's module
    make_input: Callable[[int], dict]  # batch_size -> example numpy batch
    param_shardings: Callable  # (params, mesh) -> placements by name
    loss_builder: Callable[[Any], Callable]  # model -> loss fn for the kind
    has_batch_stats: bool = False

    @functools.cached_property
    def model(self):
        """The port's module, built on first use."""
        return self.build_model()

    def make_loss(self) -> Callable:
        return self.loss_builder(self.model)


def _image_input(size, classes):
    def make_input(b):
        rng = np.random.default_rng(0)
        return {
            "image": rng.random((b, size, size, 3)).astype(np.float32),
            "label": rng.integers(0, classes, size=b).astype(np.int32),
        }

    return make_input


def _build_resnet(variant, tiny, num_classes, device, seed):
    from tensorflowonspark_tpu_torch.models import resnet

    cfg = (resnet.ResNetConfig.tiny(num_classes=num_classes) if tiny
           else getattr(resnet.ResNetConfig, variant)(num_classes=num_classes))
    return ZooEntry(variant, "image", cfg, lambda: resnet.ResNet(cfg, device, seed),
                    _image_input(32 if tiny else 224, num_classes),
                    resnet.resnet_param_shardings, resnet.loss_fn, has_batch_stats=True)


def _build_inception(tiny, num_classes, device, seed):
    from tensorflowonspark_tpu_torch.models import inception

    cfg = (inception.InceptionConfig.tiny(num_classes=num_classes) if tiny
           else inception.InceptionConfig.v3(num_classes=num_classes))
    return ZooEntry("inception_v3", "image", cfg,
                    lambda: inception.InceptionV3(cfg, device, seed),
                    _image_input(64 if tiny else 299, num_classes),
                    inception.inception_param_shardings, inception.loss_fn,
                    has_batch_stats=True)


def _build_vgg(variant, tiny, num_classes, device, seed):
    from tensorflowonspark_tpu_torch.models import vgg

    cfg = (vgg.VGGConfig.tiny(num_classes=num_classes) if tiny
           else getattr(vgg.VGGConfig, variant)(num_classes=num_classes))
    return ZooEntry(variant, "image", cfg, lambda: vgg.VGG(cfg, device, seed),
                    _image_input(32 if tiny else 224, num_classes),
                    vgg.vgg_param_shardings, vgg.loss_fn, has_batch_stats=True)


def _build_vit(tiny, num_classes, device, seed):
    from tensorflowonspark_tpu_torch.models import vit

    cfg = (vit.ViTConfig.tiny(num_classes=num_classes) if tiny
           else vit.ViTConfig.b16(num_classes=num_classes))
    # ViT has no BatchNorm: its loss is (params, batch) -> loss
    return ZooEntry("vit_b16", "image", cfg, lambda: vit.ViT(cfg, device, seed),
                    _image_input(cfg.image_size, num_classes), vit.vit_param_shardings,
                    vit.loss_fn)


def _build_unet(tiny, num_classes, device, seed):
    from tensorflowonspark_tpu_torch.models import unet

    cfg = unet.UNetConfig.tiny() if tiny else unet.UNetConfig(num_classes=num_classes)

    def make_input(b):
        rng = np.random.default_rng(0)
        s = 16 if tiny else 128
        return {
            "image": rng.random((b, s, s, 3)).astype(np.float32),
            "mask": rng.integers(0, cfg.num_classes, size=(b, s, s)).astype(np.int32),
        }

    return ZooEntry("unet", "segmentation", cfg, lambda: unet.UNet(cfg, device, seed),
                    make_input, unet.unet_param_shardings, unet.loss_fn)


def _build_bert(tiny, device, seed):
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny() if tiny else bert.BertConfig()

    def make_input(b):
        rng = np.random.default_rng(0)
        s = min(cfg.max_seq_len, 32 if tiny else 128)
        return {
            "tokens": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32),
        }

    def loss_builder(model):
        def loss(params, batch):
            logits = torch.func.functional_call(model, params, (batch["tokens"].long(),))
            return F.cross_entropy(logits.float().flatten(0, 1),
                                   batch["targets"].long().flatten())

        return loss

    return ZooEntry("bert_base", "tokens", cfg, lambda: bert.BertForMLM(cfg, device, seed),
                    make_input, bert.bert_param_shardings, loss_builder)


def _build_llama(variant, tiny, device, seed):
    from tensorflowonspark_tpu_torch.models import llama as L

    if tiny:
        cfg = L.LlamaConfig.tiny(sliding_window=8 if variant == "mistral_7b" else None,
                                 attention_bias=variant == "qwen2_7b")
    elif variant == "llama_1b":  # the single-chip benchmark config
        cfg = L.LlamaConfig.llama_1b()
    else:
        cfg = getattr(L.LlamaConfig, variant)()

    def make_input(b):
        rng = np.random.default_rng(0)
        s = min(cfg.max_seq_len, 32 if tiny else 1024)
        return {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)}

    def loss_builder(model):
        token_loss = L.llama_loss_fn(model)
        return lambda p, batch: token_loss(p, batch["tokens"])

    return ZooEntry(variant, "tokens", cfg, lambda: L.Llama(cfg, device, seed), make_input,
                    L.llama_param_shardings, loss_builder)


_BUILDERS: dict[str, Callable[..., ZooEntry]] = {
    **{v: functools.partial(_build_resnet, v)
       for v in ("resnet18", "resnet34", "resnet50", "resnet101")},
    "inception_v3": _build_inception,
    **{v: functools.partial(_build_vgg, v) for v in ("vgg11", "vgg16")},
    "vit_b16": _build_vit,
    "unet": _build_unet,
    "bert_base": lambda tiny, nc, device, seed: _build_bert(tiny, device, seed),
    **{v: (lambda v: lambda tiny, nc, device, seed: _build_llama(v, tiny, device, seed))(v)
       for v in ("llama_1b", "llama2_7b", "llama3_8b", "mistral_7b", "qwen2_7b")},
}


def names() -> list[str]:
    return sorted(_BUILDERS)


def build(name: str, tiny: bool = False, num_classes: int = 1000, device=None,
          seed: int = 0) -> ZooEntry:
    """Resolve a zoo model by name (the ``nets_factory`` surface).

    ``tiny=True`` swaps in each family's test-size config; ``num_classes``
    applies to the image families. The module is built on first use of
    ``entry.model``, on ``device`` (CUDA unless named)."""
    if name not in _BUILDERS:
        raise KeyError(f"unknown zoo model {name!r}; available: {', '.join(names())}")
    return _BUILDERS[name](tiny, num_classes, device, seed)
