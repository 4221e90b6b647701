"""Flash attention: three hand-written CUDA kernels and their plain versions.

Port of :mod:`tensorflowonspark_tpu.ops.flash_attention`. The kernels live
in ``csrc/flash_attention.cu`` (forward, dQ, dK/dV; in bf16 all three run
on wgmma with TMA loads from ``csrc/hopper.cuh``; see the note at the top
of the ``.cu`` for the bounds and the design). Beside each kernel is a plain
PyTorch version of the same function, blockless and in fp32:

- :func:`attention_plain` — masked softmax attention that also returns the
  per-row log-sum-exp;
- :func:`dq_plain` — ``P = exp(scale·QKᵀ − LSE)``, ``dS = P ⊙ (dO·Vᵀ − δ)``,
  ``dQ = scale·dS·K``;
- :func:`dkv_plain` — ``dV = Pᵀ·dO``, ``dK = scale·dSᵀ·Q``, summed over
  each GQA group.

The wrappers :func:`flash_forward`, :func:`flash_dq` and :func:`flash_dkv`
take the plain version for tensors on the CPU and launch the kernel for
tensors on a CUDA device; anything else raises. There is no fallback from
a kernel to its plain version. ``LAUNCHES`` counts the kernel launches.

Layouts: q/dO/O ``(B, Sq, Hq, D)``, k/v ``(B, Sk, Hk, D)``, both contiguous;
LSE and δ are fp32 ``(B·Hq, Sq)``; segment ids ``(B, S)`` (``Sq == Sk``).
Causal masking is end-aligned (query i sees keys ``j <= i + Sk − Sq``);
``window`` keeps the last ``window`` of those keys.

Dead rows — queries with no live key, which occur under causal attention
when ``Sq > Sk`` — get O = 0 and LSE = NEG_INF, zero dQ and no dK/dV
contribution. (The JAX package's own two paths differ there: its XLA path
returns the mean of V, its Pallas path 0 or a tile-local mean.)
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tensorflowonspark_tpu_torch.parallel.context import is_dtensor

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "tfos_flash_fwd": [_VP] * 6 + [_I] * 9 + [ctypes.c_float, _VP],
    "tfos_flash_dq": [_VP] * 8 + [_I] * 9 + [ctypes.c_float, _VP],
    "tfos_flash_dkv": [_VP] * 9 + [_I] * 9 + [ctypes.c_float, _VP],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _kernels() -> dict:
    """The C entry points, with their signatures set, on the first launch."""
    from tensorflowonspark_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    fns = {}
    for name, argtypes in _ARGTYPES.items():
        f = fns[name] = getattr(lib, name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return fns


def _check_args(q, k, v, causal, window, segment_ids):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if hq % hk:
        raise ValueError(f"q heads {hq} not divisible by kv heads {hk}")
    if window is not None and (not causal or window < 1):
        raise ValueError(f"window={window} requires causal=True and window >= 1")
    if segment_ids is not None:
        if sq != sk:
            raise ValueError("segment_ids needs sq == sk (one id array covers both sides)")
        if tuple(segment_ids.shape) != (b, sq):
            raise ValueError(f"segment_ids shape {tuple(segment_ids.shape)} != {(b, sq)}")


def _kernel_tensors(*tensors):
    """Check that CUDA tensors are ones the kernels take; returns the dtype
    code. Raises for anything else (no quiet fallback)."""
    q = tensors[0]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash kernels take float32/bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash kernels take head dim {HEAD_DIMS}, got {q.shape[-1]}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"mixed dtypes {t.dtype} and {q.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash kernels need contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash kernels need 16-byte aligned tensors")
    b, sq, hq, _ = q.shape
    if b * hq > 65535:
        raise ValueError(f"batch*heads {b * hq} exceeds the grid limit 65535")
    return DTYPES[q.dtype]


def _seg_arg(segment_ids, device):
    if segment_ids is None:
        return None, None
    seg = segment_ids.to(device=device, dtype=torch.int32).contiguous()
    return seg, seg.data_ptr()


# the entry points' own return codes; any other is a cudaError_t
_LAUNCH_ERRORS = {-1: "unsupported dtype or head dim", -2: "TMA tensor map could not be encoded"}


def _launch(fn_name, *args):
    stream = torch.cuda.current_stream().cuda_stream
    rc = _kernels()[fn_name](*args, stream)
    if rc != 0:
        why = _LAUNCH_ERRORS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"{fn_name} failed to launch: {why}")


def _geometry(q, k):
    b, sq, hq, d = q.shape
    return b, sq, k.shape[1], hq, k.shape[2], d


def _on_cpu(*tensors) -> bool:
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(
            "a DTensor reached the flash kernels outside their mesh route "
            "(ops.attention.mesh_flash_attention)"
        )
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"flash attention needs tensors all on cpu or all on cuda, got {devices}")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def live_mask(sq, sk, causal, window, segment_ids, device):
    """(B or 1, 1, Sq, Sk) bool: query i attends key j."""
    i = torch.arange(sq, device=device)[:, None] + (sk - sq)
    j = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask = mask & (j <= i)
    if window is not None:
        mask = mask & (i - j < window)
    mask = mask[None, None]
    if segment_ids is not None:
        seg = segment_ids.to(device)
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
    return mask


def _bhsd(x, group=1):
    """(B, S, H, D) -> fp32 (B, H·group, S, D), repeating each head."""
    x = x.float().transpose(1, 2)
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def _probs(q, k, lse, scale, mask):
    """P = exp(scale·QKᵀ − LSE) on live entries of live rows, else 0."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    live = mask & (lse[..., None] > NEG_INF / 2)
    return torch.where(live, torch.exp(s - lse[..., None]), torch.zeros((), device=s.device))


def attention_plain(q, k, v, causal=False, scale=None, window=None, segment_ids=None):
    """Blockless masked softmax attention -> (out (B,Sq,Hq,D), lse (B·Hq,Sq))."""
    b, sq, sk, hq, hk, d = _geometry(q, k)
    scale = d**-0.5 if scale is None else scale
    qf, kf, vf = _bhsd(q), _bhsd(k, hq // hk), _bhsd(v, hq // hk)
    mask = live_mask(sq, sk, causal, window, segment_ids, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=s.device))
    l = p.sum(dim=-1, keepdim=True)
    dead = l <= 0
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf) / torch.where(dead, 1.0, l)
    lse = torch.where(dead, NEG_INF, m + torch.log(torch.where(dead, 1.0, l)))
    out = out.transpose(1, 2).to(q.dtype).contiguous()
    return out, lse[..., 0].reshape(b * hq, sq)


def _row_stats(lse, delta, b, hq, sq):
    return lse.reshape(b, hq, sq).float(), delta.reshape(b, hq, sq).float()


def dq_plain(q, k, v, do, lse, delta, causal=False, scale=None, window=None, segment_ids=None):
    b, sq, sk, hq, hk, d = _geometry(q, k)
    scale = d**-0.5 if scale is None else scale
    group = hq // hk
    qf, kf, vf, dof = _bhsd(q), _bhsd(k, group), _bhsd(v, group), _bhsd(do)
    lse_, delta_ = _row_stats(lse, delta, b, hq, sq)
    mask = live_mask(sq, sk, causal, window, segment_ids, q.device)
    p = _probs(qf, kf, lse_, scale, mask)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta_[..., None])
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    return dq.transpose(1, 2).to(q.dtype).contiguous()


def dkv_plain(q, k, v, do, lse, delta, causal=False, scale=None, window=None, segment_ids=None):
    b, sq, sk, hq, hk, d = _geometry(q, k)
    scale = d**-0.5 if scale is None else scale
    group = hq // hk
    qf, kf, vf, dof = _bhsd(q), _bhsd(k, group), _bhsd(v, group), _bhsd(do)
    lse_, delta_ = _row_stats(lse, delta, b, hq, sq)
    mask = live_mask(sq, sk, causal, window, segment_ids, q.device)
    p = _probs(qf, kf, lse_, scale, mask)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta_[..., None])
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    # fp32 group sum, then one cast (as flash_attention.py:626-632)
    dk = dk.reshape(b, hk, group, sk, d).sum(2).transpose(1, 2)
    dv = dv.reshape(b, hk, group, sk, d).sum(2).transpose(1, 2)
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


# --------------------------------------------------------------------------
# wrappers: plain version on the CPU, kernel on CUDA
# --------------------------------------------------------------------------


def flash_forward(q, k, v, causal=False, scale=None, window=None, segment_ids=None):
    """-> (out (B, Sq, Hq, D), lse fp32 (B·Hq, Sq))."""
    _check_args(q, k, v, causal, window, segment_ids)
    if _on_cpu(q, k, v):
        return attention_plain(q, k, v, causal, scale, window, segment_ids)
    code = _kernel_tensors(q, k, v)
    b, sq, sk, hq, hk, d = _geometry(q, k)
    scale = d**-0.5 if scale is None else scale
    out = torch.empty_like(q)
    lse = torch.empty(b * hq, sq, dtype=torch.float32, device=q.device)
    seg, seg_ptr = _seg_arg(segment_ids, q.device)
    _launch(
        "tfos_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr,
        out.data_ptr(), lse.data_ptr(), b, sq, sk, hq, hk, d, code,
        int(causal), window or 0, float(scale),
    )
    LAUNCHES["fwd"] += 1
    return out, lse


def row_delta(out, do):
    """δ = rowsum(dO ⊙ O) in fp32, laid out (B·Hq, Sq) (flash_attention.py:482)."""
    b, sq, hq, _ = out.shape
    delta = (do.float() * out.float()).sum(-1)  # (B, Sq, Hq)
    return delta.transpose(1, 2).reshape(b * hq, sq).contiguous()


def _check_row_stats(lse, delta, q):
    b, sq, hq, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b * hq, sq) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {(b * hq, sq)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")


def flash_dq(q, k, v, do, lse, delta, causal=False, scale=None, window=None, segment_ids=None):
    _check_args(q, k, v, causal, window, segment_ids)
    if _on_cpu(q, k, v, do):
        return dq_plain(q, k, v, do, lse, delta, causal, scale, window, segment_ids)
    code = _kernel_tensors(q, k, v, do)
    _check_row_stats(lse, delta, q)
    b, sq, sk, hq, hk, d = _geometry(q, k)
    scale = d**-0.5 if scale is None else scale
    dq = torch.empty_like(q)
    seg, seg_ptr = _seg_arg(segment_ids, q.device)
    _launch(
        "tfos_flash_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seg_ptr, dq.data_ptr(),
        b, sq, sk, hq, hk, d, code, int(causal), window or 0, float(scale),
    )
    LAUNCHES["dq"] += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal=False, scale=None, window=None, segment_ids=None):
    _check_args(q, k, v, causal, window, segment_ids)
    if _on_cpu(q, k, v, do):
        return dkv_plain(q, k, v, do, lse, delta, causal, scale, window, segment_ids)
    code = _kernel_tensors(q, k, v, do)
    _check_row_stats(lse, delta, q)
    b, sq, sk, hq, hk, d = _geometry(q, k)
    scale = d**-0.5 if scale is None else scale
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    seg, seg_ptr = _seg_arg(segment_ids, q.device)
    _launch(
        "tfos_flash_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seg_ptr, dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, hq, hk, d, code, int(causal), window or 0, float(scale),
    )
    LAUNCHES["dkv"] += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Custom gradient as in flash_attention.py:685-708: saves
    (q, k, v, out, lse); ``segment_ids`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, segment_ids):
        out, lse = flash_forward(q, k, v, causal, scale, window, segment_ids)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.segment_ids = segment_ids
        ctx.opts = (causal, scale, window)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, window = ctx.opts
        g = g.contiguous()
        delta = row_delta(out, g)
        dq = flash_dq(q, k, v, g, lse, delta, causal, scale, window, ctx.segment_ids)
        dk, dv = flash_dkv(q, k, v, g, lse, delta, causal, scale, window, ctx.segment_ids)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, window=None, segment_ids=None):
    """Flash attention over (B, S, H, D) with GQA, end-aligned causal mask,
    optional sliding ``window`` (needs ``causal``) and ``segment_ids``.
    Plain tensors only: DTensors go through
    ``ops.attention.mesh_flash_attention``."""
    _on_cpu(q, k, v)
    return FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), causal, scale, window, segment_ids
    )
