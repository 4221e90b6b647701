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
head; conv kernels go HWIO ↔ OIHW. Any leaf that maps to nothing raises.

Int8 and LoRA leaves (``ops.quant``, ``ops.lora``) move both ways. From
the JAX package: a ``QuantTensor`` (or its checkpoint form ``{"q",
"scale"}``) becomes the port's codes under the leaf's name and scales
under ``name + "_scale"``, transposed with the leaf, so the JAX package's
axis -1 of a kernel (and of the head) is the port's axis 0; a
``LoraTensor`` / ``MultiLoraTensor`` (or ``{"base", "a", "b"}``, whose
scale the checkpoint does not store: 1.0) becomes the base under the
leaf's name and ``_lora_a`` ``(r, in)``, ``_lora_b`` ``(out, r)`` (banks
``(K, r, in)``, ``(K, out, r)``) and a 0-d ``_lora_scale``. Back to the
JAX package the nodes come out in their checkpoint forms, ``{"q",
"scale"}`` and ``{"base", "a", "b"}`` (the scale dropped, as orbax drops
it: the JAX package's ``rewrap_lora`` re-supplies it).

``cache_from_jax``/``cache_to_jax`` carry a Llama decode cache (the flax
``cache`` collection, ``layer{i}/attn/{k,v,k_scale,v_scale,seg,pos,idx}``)
to and from the port's list of per-layer dicts
(:func:`models.llama.init_cache`); the K/V planes go ``(B, C, kv_heads,
D)`` ↔ ``(B, kv_heads, C, D)`` and the int8 scales ``(B, C, kv_heads)`` ↔
``(B, kv_heads, C)``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from tensorflowonspark_tpu_torch.ops import lora as _lora
from tensorflowonspark_tpu_torch.ops import quant as _quant

_LAYER = re.compile(r"layer(\d+)$")
_CONV_KERNEL = re.compile(r"(?:(?:Conv|Dense)_\d+|head)$")
_BATCH_NORM = re.compile(r"BatchNorm_\d+$")
_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")
_DENSE = {
    "attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
    "mlp": ("gate_proj", "up_proj", "down_proj"),
}


_QUANT_KEYS, _LORA_KEYS = {"q", "scale"}, {"base", "a", "b"}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict) and set(val) not in (_QUANT_KEYS, _LORA_KEYS):
            yield from _flatten(val, path)
        else:
            yield path, val


def _field(leaf, name):
    return leaf[name] if isinstance(leaf, dict) else getattr(leaf, name)


def _is_quant(leaf) -> bool:
    return set(leaf) == _QUANT_KEYS if isinstance(leaf, dict) else hasattr(leaf, "q")


def _is_lora(leaf) -> bool:
    return set(leaf) == _LORA_KEYS if isinstance(leaf, dict) else hasattr(leaf, "base")


def _np32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _factors_from_flax(a, b):
    """JAX ``a`` (in, r) / (K, in, r) and ``b`` (r, out) / (K, r, out) ->
    the port's (r, in) / (K, r, in) and (out, r) / (K, out, r)."""
    a, b = _np32(a), _np32(b)
    return np.swapaxes(a, -1, -2).copy(), np.swapaxes(b, -1, -2).copy()


def _node_from_jax(name: str, transpose: bool, leaf) -> dict:
    """The port entries of one int8 or LoRA node of the JAX package."""
    if _is_quant(leaf):
        q = np.asarray(_field(leaf, "q"), dtype=np.int8)
        scale = _np32(_field(leaf, "scale"))
        if transpose:
            q, scale = q.T.copy(), scale.T.copy()
        return {name: torch.tensor(q), name + _quant.SCALE: torch.tensor(scale)}
    if not transpose:
        raise KeyError(f"{name}: a LoRA node on a leaf that is not a dense kernel")
    a, b = _factors_from_flax(_field(leaf, "a"), _field(leaf, "b"))
    scale = 1.0 if isinstance(leaf, dict) else float(leaf.scale)
    return {
        name: torch.tensor(_from_flax(_np32(_field(leaf, "base")))),
        name + _lora.A: torch.tensor(a),
        name + _lora.B: torch.tensor(b),
        name + _lora.S: torch.tensor(scale, dtype=torch.float32),
    }


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


def params_from_jax(tree, mesh=None, table: str | None = None) -> dict[str, torch.Tensor]:
    """flax ``params`` (nested dicts of arrays: a mesh-sharded JAX tree
    comes here through ``jax.device_get``) -> port ``state_dict``. With
    ``mesh`` and a layout ``table`` ('llama', 'resnet') each tensor comes
    back as a DTensor placed by the table's spec for its flax leaf
    (:func:`jax_leaf`); every rank passes the same tree."""
    if mesh is not None:
        from tensorflowonspark_tpu_torch.compute import layout
        from tensorflowonspark_tpu_torch.compute.train import place

        plain = params_from_jax(tree)
        shs = layout.param_shardings(plain, mesh, table, view=jax_leaf)
        return {n: place(t, shs[n]) for n, t in plain.items()}
    out = {}
    for path, leaf in _flatten(tree):
        name, transpose = _port_name(path)
        if isinstance(leaf, dict) or not hasattr(leaf, "__array__"):
            # QuantTensor / LoraTensor / MultiLoraTensor, or a checkpoint's dict of one
            if not (_is_quant(leaf) or _is_lora(leaf)):
                raise KeyError(f"{type(leaf).__name__} at {'/'.join(path)} is no param leaf")
            out.update(_node_from_jax(name, transpose, leaf))
            continue
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


# an int8 or LoRA entry's suffix -> the JAX node's field; the LoRA scale is
# a static field there (the layout tables see it as a replicated scalar)
_NODE_FIELDS = ((_lora.A, "a"), (_lora.B, "b"), (_lora.S, "scale"), (_quant.SCALE, "scale"))


def _node_field(name: str) -> tuple[str, str] | None:
    """(base name, JAX field) for an int8 or LoRA entry's name, else None."""
    for sfx, field in _NODE_FIELDS:
        base = name[: -len(sfx)]
        if name.endswith(sfx) and (base in ("embed", "lm_head") or base.endswith(".weight")):
            return base, field
    return None


def _jax_path(name: str) -> tuple[list[str], bool]:
    """(flax path parts, transposed) for one port parameter name; an int8
    or LoRA entry is the field of its node under the kernel's path."""
    node = _node_field(name)
    if node is not None:
        base, field = node
        parts, transposed = _jax_path(base)
        return parts + [field], transposed and name != base + _lora.S
    parts = name.split(".")
    conv = _conv_leaf(parts)
    if conv is not None:
        leaf, kernel = conv
        return parts[:-1] + [leaf], kernel
    if name in ("embed", "lm_head"):
        return [name], name == "lm_head"
    if name == "final_norm.scale":
        return ["final_norm", "scale"], False
    if parts[0] == "layers" and len(parts) >= 4:
        layer = f"layer{parts[1]}"
        if parts[2] in ("attn_norm", "mlp_norm") and parts[3:] == ["scale"]:
            return [layer, parts[2], "scale"], False
        if len(parts) == 5 and parts[3] in _DENSE.get(parts[2], ()):
            leaf = {"weight": "kernel", "bias": "bias"}.get(parts[4])
            if leaf is not None:
                return [layer, parts[2], parts[3], leaf], leaf == "kernel"
    raise KeyError(f"no flax leaf for port parameter {name}")


def jax_leaf(name: str, shape: tuple) -> tuple[str, tuple, tuple]:
    """``(path, shape, perm)`` of the flax leaf of one port parameter: its
    '/'-joined path, its shape, and ``perm`` with port dim ``i`` = flax dim
    ``perm[i]`` (the transpose :func:`params_from_jax` undoes). The layout
    tables are keyed on these (``compute.layout.param_shardings``)."""
    parts, transposed = _jax_path(name)
    ndim = len(shape)
    if not transposed:
        perm = tuple(range(ndim))
    elif ndim == 2:
        perm = (1, 0)  # (out, in) <- (in, out)
    elif ndim == 3:
        perm = (0, 2, 1)  # a bank's factors: the slot dim leads
    elif ndim == 4:
        perm = (3, 2, 0, 1)  # OIHW <- HWIO
    else:
        raise ValueError(f"{name}: a transposed leaf of rank {ndim}")
    jshape = [0] * ndim
    for i, p in enumerate(perm):
        jshape[p] = shape[i]
    return "/".join(parts), tuple(jshape), perm


def _host(t) -> np.ndarray:
    """A parameter (a tensor, or a DTensor gathered whole) as fp32 numpy."""
    full = getattr(t, "full_tensor", None)
    if full is not None:
        t = full()
    return t.detach().float().cpu().numpy()


def params_to_jax(model) -> dict:
    """Port model (or a dict of its parameters, plain or DTensors) ->
    flax-shaped nested dict of numpy; int8 and LoRA leaves as the JAX
    package's checkpoint forms ``{"q", "scale"}`` and ``{"base", "a",
    "b"}``."""
    tensors = _tensors(model, buffers=False)
    tree: dict = {}
    for name, t in tensors.items():
        if _node_field(name) is not None and _node_field(name)[0] in tensors:
            continue  # carried with its base
        parts, transposed = _jax_path(name)
        qt = _quant.quant_of(tensors, name)
        w = _lora.lora_of(tensors, name) if qt is None else None
        if qt is not None:
            q = qt.q.detach().cpu().numpy()
            scale = _host(qt.scale)
            node = {"q": q.T.copy(), "scale": scale.T.copy()} if transposed else {
                "q": q, "scale": scale}
        elif w is not None:
            node = {"base": _to_flax(_host(w.base)),
                    "a": np.swapaxes(_host(w.a), -1, -2).copy(),
                    "b": np.swapaxes(_host(w.b), -1, -2).copy()}
        else:
            arr = _host(t)
            node = _to_flax(arr) if transposed else arr
        _nest(tree, parts, node)
    return tree


_CACHE_LEAVES = ("k", "v", "k_scale", "v_scale", "seg", "pos", "idx")
_CACHE_HEADS_MOVE = {"k": (0, 2, 1, 3), "v": (0, 2, 1, 3), "k_scale": (0, 2, 1),
                     "v_scale": (0, 2, 1)}


def _cache_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16: through fp32, exactly
        return torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(arr)


def cache_from_jax(tree) -> list[dict[str, torch.Tensor]]:
    """flax ``cache`` collection (nested dicts of arrays) -> the port's
    per-layer cache dicts, on the CPU, in the same dtypes."""
    layers: dict[int, dict] = {}
    for path, leaf in _flatten(tree):
        m = _LAYER.match(path[0])
        if not (m and len(path) == 3 and path[1] == "attn" and path[2] in _CACHE_LEAVES):
            raise KeyError(f"no port cache leaf for flax cache leaf {'/'.join(path)}")
        t = _cache_tensor(leaf)
        perm = _CACHE_HEADS_MOVE.get(path[2])
        layers.setdefault(int(m.group(1)), {})[path[2]] = (
            t if perm is None else t.permute(*perm).contiguous())
    if sorted(layers) != list(range(len(layers))):
        raise KeyError(f"cache layers {sorted(layers)} are not 0..n-1")
    return [layers[i] for i in range(len(layers))]


def cache_to_jax(cache) -> dict:
    """The port's per-layer cache dicts -> the flax ``cache`` collection's
    nested dict of numpy (bf16 leaves as fp32 arrays of the same values,
    as ``params_to_jax`` gives fp32)."""
    tree: dict = {}
    for i, layer in enumerate(cache):
        for name, t in layer.items():
            if name not in _CACHE_LEAVES:
                raise KeyError(f"no flax cache leaf for port cache leaf {name}")
            perm = _CACHE_HEADS_MOVE.get(name)
            t = t.detach().cpu()
            if perm is not None:
                t = t.permute(*perm)
            if t.dtype == torch.bfloat16:
                t = t.float()
            _nest(tree, [f"layer{i}", "attn", name], t.contiguous().numpy())
    return tree
