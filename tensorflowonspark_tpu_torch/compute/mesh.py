"""Device mesh construction and batch placement (port of
:mod:`tensorflowonspark_tpu.compute.mesh`).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the process group, one device each, with the JAX package's six axis
names (:data:`MESH_AXES`): ``data`` (replicated params, sharded batch),
``fsdp`` (sharded params and optimizer state), ``pipe``, ``expert``,
``model`` (tensor parallel) and ``seq``. Axes the caller leaves out get
extent 1, so code can always name all six. The ``pipe``, ``expert`` and
``seq`` axes have no ported consumer yet (ROADMAP A10).

Where the JAX package's mesh spans the devices of one process, the port
runs one process per device: ``make_mesh`` joins the process group that
``torch.distributed`` already has, and starts a group of one (its store in
memory) in a process that has none, so a single-process caller needs no
set-up of its own. The mesh is on CUDA (NCCL) unless the
caller asks for the CPU (gloo); without CUDA and without that request
``make_mesh`` raises.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from tensorflowonspark_tpu_torch.compute import layout as _layout
from tensorflowonspark_tpu_torch.compute.layout import BATCH_AXES, MESH_AXES  # noqa: F401


def _check_axes(shapes: Mapping[str, int]) -> None:
    for ax in shapes:
        if ax not in MESH_AXES:
            raise ValueError(f"unknown mesh axis {ax!r}; expected {MESH_AXES}")


def full_shape(axis_shapes: Mapping[str, int] | None, n: int) -> list[int]:
    """The extents of all six axes for ``n`` devices, as ``make_mesh``
    resolves ``axis_shapes`` (at most one ``-1``, inferred; missing axes
    1; default everything on ``data``)."""
    shapes = dict(axis_shapes or {"data": n})
    _check_axes(shapes)
    infer = [ax for ax, s in shapes.items() if s == -1]
    if len(infer) > 1:
        raise ValueError("at most one axis may be -1")
    known = math.prod(s for s in shapes.values() if s != -1)
    if infer:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        shapes[infer[0]] = n // known
    full = [shapes.get(ax, 1) for ax in MESH_AXES]
    if math.prod(full) != n:
        raise ValueError(
            f"mesh {dict(zip(MESH_AXES, full))} needs {math.prod(full)} devices, have {n}"
        )
    return full


def _join_group(device_type: str) -> None:
    """Start a process group of one when this process has none (its store
    in memory: a group of one needs no address)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), world_size=1, rank=0)


def make_mesh(axis_shapes: Mapping[str, int] | None = None, device_type: str | None = None):
    """A ``DeviceMesh`` over every rank of the process group.

    ``axis_shapes`` maps axis name → extent; at most one axis may be ``-1``
    (inferred). Missing axes get extent 1. Default: everything on
    ``data``. ``device_type``: ``"cuda"`` unless the caller passes
    ``"cpu"``.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if axis_shapes is not None:
        _check_axes(axis_shapes)
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device_type='cpu' for a CPU mesh"
            )
        device_type = "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    _join_group(device_type)
    n = dist.get_world_size()
    full = full_shape(axis_shapes, n)
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device_type, torch.arange(n).reshape(full), mesh_dim_names=MESH_AXES)


def fit_axis_shapes(axis_shapes: Mapping[str, int] | None, n_devices: int,
                    elastic_axis: str = "fsdp") -> dict[str, int]:
    """Re-fit an axis spec to a changed device count, deterministically: a
    spec that already defers an axis (``-1``) keeps it; otherwise
    ``elastic_axis`` absorbs the change. The fixed axes must divide
    ``n_devices``, else this raises."""
    shapes = dict(axis_shapes) if axis_shapes else {elastic_axis: -1}
    if not any(s == -1 for s in shapes.values()):
        if elastic_axis not in MESH_AXES:
            raise ValueError(f"unknown elastic axis {elastic_axis!r}; expected one of {MESH_AXES}")
        shapes[elastic_axis] = -1
    known = math.prod(s for s in shapes.values() if s != -1)
    if known <= 0 or n_devices % known:
        raise ValueError(
            f"axis spec {dict(shapes)} cannot fit {n_devices} devices: "
            f"fixed axes multiply to {known}"
        )
    return shapes


def parse_axis_spec(spec: str) -> dict[str, int]:
    """Parse a CLI mesh spec ``'data=2,model=4'`` into the mapping
    :func:`make_mesh` takes (``-1`` = infer). Axis names are checked by
    ``make_mesh``."""
    out: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad mesh spec segment {part!r}; expected axis=size (e.g. 'data=2,model=4')"
            )
        key, val = part.split("=", 1)
        out[key.strip()] = int(val)
    if not out:
        raise ValueError(f"empty mesh spec {spec!r}")
    return out


def batch_sharding(mesh, ndim: int = 1) -> _layout.Sharding:
    """Batch leaf: leading dim over ``(data, fsdp)``, the rest replicated."""
    return _layout.batch_sharding(mesh, ndim)


def replicated(mesh) -> _layout.Sharding:
    return _layout.replicated(mesh)


def data_parallel_size(mesh) -> int:
    sizes = _layout.axis_sizes(mesh)
    return sizes["data"] * sizes["fsdp"]


def batch_rows(mesh, n: int) -> slice:
    """The rows of an ``n``-row global batch that this rank holds: its
    block of the leading dim, split over ``(data, fsdp)`` with ``data``
    outermost."""
    sizes = _layout.axis_sizes(mesh)
    dp = sizes["data"] * sizes["fsdp"]
    if n % dp:
        raise ValueError(f"batch dim {n} does not divide over (data, fsdp) extent {dp}")
    coord = mesh.get_coordinate()
    names = list(mesh.mesh_dim_names)
    block = coord[names.index("data")] * sizes["fsdp"] + coord[names.index("fsdp")]
    per = n // dp
    return slice(block * per, (block + 1) * per)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, torch.Tensor):
        return x
    raise TypeError(f"a batch leaf must be an array or a tensor, got {type(x).__name__}")


def local_batch(mesh, batch):
    """This rank's rows of a global host batch (a dict of arrays or
    tensors, or one of them), as views where the leaf allows it."""
    if isinstance(batch, dict):
        return {k: local_batch(mesh, v) for k, v in batch.items()}
    x = batch
    return x[batch_rows(mesh, x.shape[0])]


def from_local_batch(mesh, local, n_rows: int | None = None):
    """DTensors sharded on dim 0 over ``(data, fsdp)`` from this rank's
    rows (already on the mesh's device)."""
    from torch.distributed.tensor import DTensor

    if isinstance(local, dict):
        return {k: from_local_batch(mesh, v, n_rows) for k, v in local.items()}
    sh = batch_sharding(mesh, local.dim())
    dp = data_parallel_size(mesh)
    shape = (local.shape[0] * dp if n_rows is None else n_rows, *local.shape[1:])
    return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def shard_batch(mesh, batch):
    """Place a global host batch on the mesh, sharded on its leading dim
    over ``(data, fsdp)``: each rank copies only its own rows to its
    device, and the global array is the DTensor over all of them. Every
    rank passes the same global batch (the JAX package's single-controller
    contract)."""
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")

    def place(x):
        x = _as_tensor(x)
        rows = x[batch_rows(mesh, x.shape[0])]
        return from_local_batch(mesh, rows.to(device, copy=True), x.shape[0])

    if isinstance(batch, dict):
        return {k: place(v) for k, v in batch.items()}
    return place(batch)
