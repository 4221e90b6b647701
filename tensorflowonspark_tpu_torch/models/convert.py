"""Weight bridge between the JAX package's flax trees and the port.

``params_from_jax`` takes a flax ``params`` tree as nested dicts of numpy
arrays and returns the port's parameters by name; ``params_to_jax`` goes
back. Two families:

- Llama (:class:`models.llama.Llama`): ``layer{i}/attn/q_proj/kernel`` ↔
  ``layers.{i}.attn.q_proj.weight`` and so on;
- the BatchNorm conv nets (:mod:`models.resnet`, :mod:`models.vgg`,
  :mod:`models.inception`), whose port modules carry flax's names, so a
  path maps to its dotted join: ``…/Conv_0/kernel`` ↔ ``….Conv_0.weight``,
  ``…/Dense_0/kernel`` (or ``head``) ↔ ``….weight``, ``…/BatchNorm_0/scale``
  and ``bias`` unchanged. ``batch_stats_from_jax``/``batch_stats_to_jax``
  carry the ``batch_stats`` collection (``…/BatchNorm_0/mean`` and ``var``).

Dense kernels are stored ``(in, out)`` in flax and ``(out, in)`` in the
port, so they are transposed, as is Llama's ``(hidden, vocab)`` output
head; conv kernels go HWIO ↔ OIHW. Any leaf that maps to nothing raises;
int8 (``QuantTensor``) and LoRA kernels raise ``NotImplementedError``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LAYER = re.compile(r"layer(\d+)$")
_CONV_KERNEL = re.compile(r"(?:(?:Conv|Dense)_\d+|head)$")
_BATCH_NORM = re.compile(r"BatchNorm_\d+$")
_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")
_DENSE = {
    "attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
    "mlp": ("gate_proj", "up_proj", "down_proj"),
}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict):
            yield from _flatten(val, path)
        else:
            yield path, val


def _biased(owner: str) -> bool:
    return not owner.startswith("Conv")  # the conv nets' convs have no bias


def _conv_port_name(path: tuple[str, ...]) -> tuple[str, bool] | None:
    """(port name, kernel) for a conv-net leaf path, else None."""
    if len(path) < 2 or not all(_NAME.match(p) for p in path):
        return None
    owner, leaf = path[-2], path[-1]
    prefix = ".".join(path[:-1])
    if _CONV_KERNEL.match(owner) and (leaf == "kernel" or (leaf == "bias" and _biased(owner))):
        return f"{prefix}.{'weight' if leaf == 'kernel' else 'bias'}", leaf == "kernel"
    if _BATCH_NORM.match(owner) and leaf in ("scale", "bias"):
        return f"{prefix}.{leaf}", False
    return None


def _port_name(path: tuple[str, ...]) -> tuple[str, bool]:
    """(port name, transposed) for one flax leaf path."""
    conv = _conv_port_name(path)
    if conv is not None:
        return conv
    if path == ("embed",):
        return "embed", False
    if path == ("lm_head",):
        return "lm_head", True
    if path == ("final_norm", "scale"):
        return "final_norm.scale", False
    m = _LAYER.match(path[0])
    if m:
        i, rest = m.group(1), path[1:]
        if len(rest) == 2 and rest[0] in ("attn_norm", "mlp_norm") and rest[1] == "scale":
            return f"layers.{i}.{rest[0]}.scale", False
        if len(rest) == 3 and rest[1] in _DENSE.get(rest[0], ()):
            if rest[2] == "kernel":
                return f"layers.{i}.{rest[0]}.{rest[1]}.weight", True
            if rest[2] == "bias":
                return f"layers.{i}.{rest[0]}.{rest[1]}.bias", False
    raise KeyError(f"no port parameter for flax leaf {'/'.join(path)}")


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """flax Llama ``params`` (nested dicts of arrays) -> port ``state_dict``."""
    out = {}
    for path, leaf in _flatten(tree):
        if not hasattr(leaf, "__array__"):
            # QuantTensor / LoraTensor / MultiLoraTensor kernels
            raise NotImplementedError(
                f"{type(leaf).__name__} at {'/'.join(path)}: int8 and LoRA kernels are "
                "not ported yet: ROADMAP A10"
            )
        name, transpose = _port_name(path)
        arr = np.asarray(leaf, dtype=np.float32)
        out[name] = torch.tensor(_from_flax(arr) if transpose else arr)
    return out


def _from_flax(kernel: np.ndarray) -> np.ndarray:
    """flax kernel -> port weight: (in, out) -> (out, in), HWIO -> OIHW."""
    return kernel.T.copy() if kernel.ndim == 2 else kernel.transpose(3, 2, 0, 1).copy()


def _to_flax(weight: np.ndarray) -> np.ndarray:
    return weight.T.copy() if weight.ndim == 2 else weight.transpose(2, 3, 1, 0).copy()


def batch_stats_from_jax(tree) -> dict[str, torch.Tensor]:
    """flax ``batch_stats`` (``…/BatchNorm_k/{mean,var}``) -> port buffers."""
    out = {}
    for path, leaf in _flatten(tree):
        if not (len(path) >= 2 and _BATCH_NORM.match(path[-2]) and path[-1] in ("mean", "var")
                and all(_NAME.match(p) for p in path)):
            raise KeyError(f"no port buffer for flax batch_stats leaf {'/'.join(path)}")
        out[".".join(path)] = torch.tensor(np.asarray(leaf, dtype=np.float32))
    return out


def _tensors(model, buffers: bool) -> dict:
    if isinstance(model, dict):
        return model
    return dict(model.named_buffers() if buffers else model.named_parameters())


def _nest(tree: dict, parts, arr) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = arr


def batch_stats_to_jax(model) -> dict:
    """Port model's buffers (or a dict of them) -> flax ``batch_stats``."""
    tree: dict = {}
    for name, t in _tensors(model, buffers=True).items():
        parts = name.split(".")
        if len(parts) < 2 or not _BATCH_NORM.match(parts[-2]) or parts[-1] not in ("mean", "var"):
            raise KeyError(f"no flax batch_stats leaf for port buffer {name}")
        _nest(tree, parts, t.detach().float().cpu().numpy())
    return tree


def _conv_leaf(parts: list[str]) -> tuple[str, bool] | None:
    """(flax leaf, kernel) for a conv-net port name, else None."""
    if len(parts) < 2:
        return None
    owner, leaf = parts[-2], parts[-1]
    if _CONV_KERNEL.match(owner) and (leaf == "weight" or (leaf == "bias" and _biased(owner))):
        return ("kernel", True) if leaf == "weight" else ("bias", False)
    if _BATCH_NORM.match(owner) and leaf in ("scale", "bias"):
        return leaf, False
    return None


def params_to_jax(model) -> dict:
    """Port model (or a dict of its parameters) -> flax-shaped nested dict of numpy."""
    tree: dict = {}
    for name, t in _tensors(model, buffers=False).items():
        arr = t.detach().float().cpu().numpy()
        parts = name.split(".")
        conv = _conv_leaf(parts)
        if conv is not None:
            leaf, kernel = conv
            _nest(tree, parts[:-1] + [leaf], _to_flax(arr) if kernel else arr)
            continue
        if name in ("embed", "lm_head"):
            tree[name] = arr.T.copy() if name == "lm_head" else arr
            continue
        if name == "final_norm.scale":
            tree.setdefault("final_norm", {})["scale"] = arr
            continue
        if parts[0] != "layers":
            raise KeyError(f"no flax leaf for port parameter {name}")
        layer = tree.setdefault(f"layer{parts[1]}", {})
        if parts[2] in ("attn_norm", "mlp_norm") and parts[3:] == ["scale"]:
            layer.setdefault(parts[2], {})["scale"] = arr
        elif len(parts) == 5 and parts[3] in _DENSE.get(parts[2], ()):
            leaf = {"weight": "kernel", "bias": "bias"}.get(parts[4])
            if leaf is None:
                raise KeyError(f"no flax leaf for port parameter {name}")
            dense = layer.setdefault(parts[2], {}).setdefault(parts[3], {})
            dense[leaf] = arr.T.copy() if leaf == "kernel" else arr
        else:
            raise KeyError(f"no flax leaf for port parameter {name}")
    return tree
