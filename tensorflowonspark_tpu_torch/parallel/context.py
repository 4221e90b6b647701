"""Ambient mesh context (port of
:mod:`tensorflowonspark_tpu.parallel.context`).

``compute.train.build_train_step`` publishes its mesh with
:func:`use_mesh` for the duration of a step, as the JAX package's does
while it traces; :func:`current_mesh` reads it.

:func:`dispatch_mesh` is the gate of the kernels' mesh routes (flash
attention, batch-norm statistics). It diverges from the JAX package's on
purpose: there the route is taken on a multi-device TPU with a published
mesh, and on one device the kernel runs on plain arrays. A ctypes kernel
cannot take a DTensor at all, so here the route is keyed on the inputs
being DTensors, at any world size, a world of one included: plain tensors
go to the kernel, DTensors go through ``local_map`` to the kernel on each
rank's shard. Sequence-parallel placements (a sharded ``seq``, ``pipe`` or
``expert`` axis) wait for ROADMAP A10 and raise.
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()

# calls of each kernel's mesh route (ops.attention.mesh_flash_attention,
# ops.bn_kernels.mesh_pair_stats / mesh_cross_stats)
MESH_ROUTES = {"attention": 0, "bn_pair": 0, "bn_cross": 0}


def reset_mesh_routes() -> None:
    for name in MESH_ROUTES:
        MESH_ROUTES[name] = 0


def current_mesh():
    """The mesh published by the innermost :func:`use_mesh`, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Publish ``mesh`` as the ambient mesh for the code run inside."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def dispatch_mesh(tensors, batch_extent: int, forbidden_axes=()):
    """The mesh of ``tensors`` when they are DTensors, else None (plain
    tensors: the single-device route).

    Raises when only some are DTensors, when they lie on different meshes,
    when an axis of ``forbidden_axes`` is wider than 1 (a sequence-parallel
    placement: ROADMAP A10), or when ``batch_extent`` does not divide over
    the mesh's ``(data, fsdp)`` extent. There is no quiet route back to the
    plain tensors.
    """
    tensors = [t for t in tensors if t is not None]
    flags = [is_dtensor(t) for t in tensors]
    if not any(flags):
        return None
    if not all(flags):
        raise TypeError("a mesh route got DTensors mixed with plain tensors")
    mesh = tensors[0].device_mesh
    if any(t.device_mesh != mesh for t in tensors):
        raise ValueError("a mesh route got DTensors on different meshes")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    wide = [ax for ax in forbidden_axes if sizes.get(ax, 1) != 1]
    if wide:
        raise NotImplementedError(
            f"sharded {wide} axes (sequence, pipeline or expert parallel) are not "
            "ported yet: ROADMAP A10, the next slice (its parallel remainder)"
        )
    dp = sizes.get("data", 1) * sizes.get("fsdp", 1)
    if batch_extent % dp:
        raise ValueError(f"batch {batch_extent} does not divide over (data, fsdp) extent {dp}")
    return mesh


def gather_fsdp(w):
    """``w`` with its ``fsdp`` sharding gathered (its ``model`` sharding
    kept), right where a layer uses it; a plain tensor as it is.

    This makes FSDP explicit. Left to itself, DTensor picks a strategy per
    operator and, on a weight sharded on its contracting dim, may move the
    activations instead of the weight; XLA, which partitions a whole step
    at once, gathers the weight. The gather's backward reduce-scatters the
    weight's gradient back onto the ``fsdp`` shards.
    """
    if not is_dtensor(w):
        return w
    names = w.device_mesh.mesh_dim_names or ()
    if "fsdp" not in names:
        return w
    from torch.distributed.tensor import Replicate

    i = names.index("fsdp")
    if w.placements[i].is_replicate():
        return w
    want = list(w.placements)
    want[i] = Replicate()
    return w.redistribute(w.device_mesh, want)


_replicating = [0]  # depth of nested mesh regions (the flag they set is global)


@contextlib.contextmanager
def _replication():
    from torch.distributed.tensor.experimental import implicit_replication

    if _replicating[0]:  # implicit_replication() is not reentrant: its exit clears the flag
        _replicating[0] += 1
        try:
            yield
        finally:
            _replicating[0] -= 1
        return
    with implicit_replication():
        _replicating[0] = 1
        try:
            yield
        finally:
            _replicating[0] = 0


def mesh_region(*tensors):
    """A context in which the plain tensors that code makes (positions,
    masks, constants) act as replicated over the DTensors' mesh; a no-op
    when none of ``tensors`` is a DTensor. Regions nest."""
    if any(is_dtensor(t) for t in tensors if t is not None):
        return _replication()
    return contextlib.nullcontext()
