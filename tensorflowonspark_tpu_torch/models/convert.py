"""Weight bridge between the JAX package's flax Llama tree and the port.

``params_from_jax`` takes the flax ``params`` tree as nested dicts of numpy
arrays and returns a ``state_dict`` for :class:`models.llama.Llama`;
``params_to_jax`` goes back. Dense kernels are stored ``(in, out)`` in
flax and ``(out, in)`` in the port, so they are transposed, as is the
``(hidden, vocab)`` output head. Any leaf that maps to nothing raises;
int8 (``QuantTensor``) and LoRA kernels raise ``NotImplementedError``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LAYER = re.compile(r"layer(\d+)$")
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


def _port_name(path: tuple[str, ...]) -> tuple[str, bool]:
    """(state_dict name, transposed) for one flax leaf path."""
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
        out[name] = torch.tensor(arr.T if transpose else arr)
    return out


def params_to_jax(model) -> dict:
    """Port model (or its ``state_dict``) -> flax-shaped nested dict of numpy."""
    state = model.state_dict() if hasattr(model, "state_dict") else model
    tree: dict = {}
    for name, t in state.items():
        arr = t.detach().float().cpu().numpy()
        parts = name.split(".")
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
