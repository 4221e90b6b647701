"""Batch-norm channel statistics: two hand-written CUDA kernels and their
plain versions.

Port of :mod:`tensorflowonspark_tpu.ops.bn_kernels`. Both reduce over all
rows of the ``(rows, C)`` view of a tensor whose last dim is the channels:

- :func:`pair_stats` ``(x) -> (Σx, Σx²)``, the forward statistics (B4);
- :func:`cross_stats` ``(dy, x) -> (Σdy, Σdy·x)``, the backward's (B5).

Both return fp32 ``(C,)`` tensors. The kernels live in ``csrc/bn_stats.cu``
(see the note at the top of that file for the bound and the design); the
plain versions :func:`pair_stats_plain` and :func:`cross_stats_plain` sum
in fp32 with PyTorch. A wrapper takes the plain version for tensors on the
CPU and launches the kernel for tensors on a CUDA device: there is no
fallback from a kernel to its plain version. Either way it takes bf16 or
fp32 only and a contiguous tensor only (a channels-last activation viewed
NHWC), and raises on anything else rather than copying. ``LAUNCHES``
counts the kernel launches.

On a device mesh, :func:`mesh_pair_stats` and :func:`mesh_cross_stats` take
DTensors sharded on the batch over ``(data, fsdp)``: each rank runs the
wrapper (kernel or plain version) on its own rows, and one ``all_reduce``
per batch axis sums the two partial vectors. The sums are exact identities
of that split, so they equal the single-device kernel's up to the order of
the fp32 additions: the kernels are bit-repeatable on one rank, but not
across a change of world size. A batch that does not divide over the ranks
is split as DTensor splits it (the last ranks hold fewer rows); each rank
sums the rows it holds. A DTensor that reaches :func:`pair_stats` or
:func:`cross_stats` raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tensorflowonspark_tpu_torch.parallel.context import MESH_ROUTES, is_dtensor

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = {"pair": 0, "cross": 0}

# launch geometry; the kernel's kThreads and kUnroll are the same numbers
THREADS = 256
UNROLL = 4
MAX_SPLITS = 65535
# blocks to aim for: 8 on each of an H100's 132 SMs
TARGET_BLOCKS = 132 * 8

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_GEOMETRY = [_LL, _I, _I, _I, _I, _I, _LL, _VP]  # rows, C, dtype, vec, tx, splits, rows/split, stream
_ARGTYPES = {
    "tfos_bn_pair_stats": [_VP] * 4 + _GEOMETRY,
    "tfos_bn_cross_stats": [_VP] * 5 + _GEOMETRY,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _kernels() -> dict:
    """The C entry points, with their signatures set, on the first launch."""
    from tensorflowonspark_tpu_torch.ops import _build

    lib = _build.load("bn_stats")
    fns = {}
    for name, argtypes in _ARGTYPES.items():
        f = fns[name] = getattr(lib, name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return fns


def as_2d(x: torch.Tensor) -> torch.Tensor:
    """The ``(rows, C)`` view of ``x`` (channels last), without a copy:
    raises for a DTensor (its route is :func:`mesh_pair_stats` /
    :func:`mesh_cross_stats`), a dtype the kernels do not take or a tensor
    that is not contiguous."""
    if is_dtensor(x):
        raise TypeError(
            "a DTensor reached the batch-norm statistics outside their mesh route "
            "(mesh_pair_stats / mesh_cross_stats)"
        )
    if x.dtype not in DTYPES:
        raise TypeError(f"batch-norm statistics take float32/bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(
            f"batch-norm statistics need a contiguous channels-last tensor, got shape "
            f"{tuple(x.shape)} strides {x.stride()}"
        )
    if x.dim() == 0 or x.numel() == 0:
        raise ValueError(f"batch-norm statistics need rows and channels, got {tuple(x.shape)}")
    return x.view(-1, x.shape[-1])


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"batch-norm statistics need tensors all on cpu or all on cuda, got {devices}")


def vector_width(tensors, c: int) -> int:
    """Channels per load: one 16-byte vector (8 bf16 or 4 fp32) when C is
    a multiple of it and every base pointer is 16-byte aligned, else 1."""
    vec = 16 // tensors[0].element_size()
    if c % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return vec
    return 1


def launch_geometry(rows: int, c: int, vec: int) -> tuple[int, int, int]:
    """``(tx, splits, rows_per_split)``: ``tx`` channel vectors per block
    row (a power of two up to 32), ``THREADS // tx`` rows per block row;
    the rows cut into ``splits`` contiguous runs of whole block tiles, as
    many as make about ``TARGET_BLOCKS`` blocks with every split holding
    rows."""
    nvec = c // vec
    tx = 1
    while tx < nvec and tx < 32:
        tx *= 2
    tile = (THREADS // tx) * UNROLL
    tiles = -(-rows // tile)
    columns = -(-nvec // tx)
    splits = max(1, min(tiles, MAX_SPLITS, TARGET_BLOCKS // columns))
    rows_per_split = -(-tiles // splits) * tile
    return tx, -(-rows // rows_per_split), rows_per_split


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def pair_stats_plain(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x2.float()
    return xf.sum(0), (xf * xf).sum(0)


def cross_stats_plain(dy2: torch.Tensor, x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    dyf = dy2.float()
    return dyf.sum(0), (dyf * x2.float()).sum(0)


# --------------------------------------------------------------------------
# wrappers: plain version on the CPU, kernel on CUDA
# --------------------------------------------------------------------------


def _launch(fn_name, tensors, outs, rows, c):
    vec = vector_width(tensors, c)
    tx, splits, rows_per_split = launch_geometry(rows, c, vec)
    device = tensors[0].device
    ws = torch.empty(splits, 2, c, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _kernels()[fn_name](
        *(t.data_ptr() for t in tensors), ws.data_ptr(), *(o.data_ptr() for o in outs),
        rows, c, DTYPES[tensors[0].dtype], vec, tx, splits, rows_per_split, stream,
    )
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {rc}")


def pair_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel ``(Σx, Σx²)`` in fp32 over the ``(rows, C)`` view of ``x``."""
    x2 = as_2d(x)
    if _on_cpu(x2):
        return pair_stats_plain(x2)
    rows, c = x2.shape
    s = torch.empty(c, dtype=torch.float32, device=x2.device)
    q = torch.empty_like(s)
    _launch("tfos_bn_pair_stats", (x2,), (s, q), rows, c)
    LAUNCHES["pair"] += 1
    return s, q


def cross_stats(dy: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel ``(Σdy, Σdy·x)`` in fp32 over the ``(rows, C)`` views."""
    dy2, x2 = as_2d(dy), as_2d(x)
    if dy2.shape != x2.shape or dy2.dtype != x2.dtype:
        raise ValueError(
            f"dy {tuple(dy2.shape)} {dy2.dtype} does not match x {tuple(x2.shape)} {x2.dtype}"
        )
    if _on_cpu(dy2, x2):
        return cross_stats_plain(dy2, x2)
    rows, c = x2.shape
    s = torch.empty(c, dtype=torch.float32, device=x2.device)
    q = torch.empty_like(s)
    _launch("tfos_bn_cross_stats", (dy2, x2), (s, q), rows, c)
    LAUNCHES["cross"] += 1
    return s, q


# --------------------------------------------------------------------------
# mesh routes: the wrappers on each rank's rows, then an all_reduce
# --------------------------------------------------------------------------


def _mesh_stats(stats_fn, kind, arrays):
    """``stats_fn`` on each rank's rows of DTensors sharded on dim 0 over
    the batch axes (redistributed there if they are not), the two partial
    sums all-reduced over each batch axis of the mesh: replicated fp32
    ``(C,)`` DTensors."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from tensorflowonspark_tpu_torch.compute import layout

    mesh = arrays[0].device_mesh
    want = layout.placements(mesh, layout.batch_spec(arrays[0].ndim))
    local = [(a if tuple(a.placements) == want else a.redistribute(mesh, want)).to_local()
             for a in arrays]
    c = local[0].shape[-1]
    if local[0].numel():
        s, q = stats_fn(*local)
        both = torch.stack([s, q])
    else:  # a rank whose split of an uneven batch is empty
        both = torch.zeros(2, c, dtype=torch.float32, device=local[0].device)
    names = mesh.mesh_dim_names
    for axis in layout.BATCH_AXES:
        if axis in names and mesh.size(names.index(axis)) > 1:
            dist.all_reduce(both, group=mesh.get_group(axis))
    MESH_ROUTES[f"bn_{kind}"] += 1
    rep = [Replicate()] * mesh.ndim
    return tuple(DTensor.from_local(t, mesh, rep, run_check=False) for t in both.unbind(0))


def mesh_pair_stats(x) -> tuple:
    """:func:`pair_stats` of a batch-sharded DTensor, over all its rows."""
    return _mesh_stats(pair_stats, "pair", (x,))


def mesh_cross_stats(dy, x) -> tuple:
    """:func:`cross_stats` of batch-sharded DTensors, over all their rows."""
    return _mesh_stats(cross_stats, "cross", (dy, x))
