"""The port's flash attention against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in the Pallas interpreter, as
tests/test_attention.py does. Inputs are numpy arrays from a seed, handed
to both. Tolerances are the JAX tests' own (test_attention.py): 2e-3 for
the forward, 5e-3 for the gradients, in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.ops import flash_attention as jfa
from tensorflowonspark_tpu.ops.attention import _xla_attention as jax_xla_attention
from tensorflowonspark_tpu_torch.ops import flash_attention as tfa
from tensorflowonspark_tpu_torch.ops.attention import (
    _local_auto_impl,
    _xla_attention,
    dot_product_attention,
)

FWD_TOL = 2e-3
GRAD_TOL = 5e-3


def _inputs(b=2, sq=128, sk=128, hq=4, hk=4, d=64, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(b, sq, hq, d), (b, sk, hk, d), (b, sk, hk, d), (b, sq, hq, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]  # q, k, v, dO


def _segments(b, s, seed=0):
    """Three documents per row at seeded boundaries, ids from 1."""
    rng = np.random.default_rng(seed)
    seg = np.ones((b, s), np.int32)
    for r in range(b):
        c1, c2 = sorted(rng.choice(np.arange(8, s - 8), 2, replace=False))
        seg[r, c1:] += 1
        seg[r, c2:] += 1
    return seg


def _jax_flash(q, k, v, g, causal, window, seg):
    qj, kj, vj, gj = map(jnp.asarray, (q, k, v, g))
    sj = None if seg is None else jnp.asarray(seg)
    out, lse = jfa._flash_forward(
        qj, kj, vj, causal, None, return_lse=True, segment_ids=sj, window=window
    )
    _, vjp = jax.vjp(
        lambda a, b_, c: jfa.flash_attention(a, b_, c, causal, None, None, None, window, sj),
        qj, kj, vj,
    )
    grads = vjp(gj)
    return np.asarray(out), np.asarray(lse), [np.asarray(x) for x in grads]


def _port_flash(q, k, v, g, causal, window, seg):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    st = None if seg is None else torch.from_numpy(seg)
    out = tfa.flash_attention(qt, kt, vt, causal, None, window, st)
    out.backward(torch.from_numpy(g))
    _, lse = tfa.flash_forward(qt.detach(), kt.detach(), vt.detach(), causal, None, window, st)
    return out.detach().numpy(), lse.numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


CASES = {
    "noncausal": (dict(), dict(causal=False)),
    "causal": (dict(), dict(causal=True)),
    "gqa_8_2": (dict(hq=8, hk=2), dict(causal=True)),
    "multibatch_b3_6_3": (dict(b=3, hq=6, hk=3), dict(causal=False)),
    "cross_sq128_sk256": (dict(b=1, sq=128, sk=256), dict(causal=True)),
    "window_1": (dict(b=1), dict(causal=True, window=1)),
    "window_100": (dict(b=1, sq=256, sk=256, hq=2, hk=1), dict(causal=True, window=100)),
    "segments": (dict(hk=2), dict(causal=True, segments=True)),
    "window_segments": (dict(hk=2), dict(causal=True, window=40, segments=True)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_flash_matches_jax_pallas(name, monkeypatch):
    monkeypatch.setattr(jfa, "INTERPRET", True)
    shape, opts = CASES[name]
    q, k, v, g = _inputs(**shape, seed=len(name))
    seg = _segments(q.shape[0], q.shape[1]) if opts.get("segments") else None
    causal, window = opts["causal"], opts.get("window")
    out_j, lse_j, grads_j = _jax_flash(q, k, v, g, causal, window, seg)
    out_t, lse_t, grads_t = _port_flash(q, k, v, g, causal, window, seg)
    np.testing.assert_allclose(out_t, out_j, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse_t, lse_j, rtol=FWD_TOL, atol=FWD_TOL)
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt, gj, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_flash_dead_rows(monkeypatch):
    """causal with sq > sk: queries 0..63 see no key. Live rows match the
    JAX kernels; the port's dead rows hold O = 0, LSE = NEG_INF and dQ = 0
    exactly (the JAX Pallas path leaves a tile-local mean in O there)."""
    monkeypatch.setattr(jfa, "INTERPRET", True)
    q, k, v, g = _inputs(sq=128, sk=64, hk=2, seed=3)
    dead = 64
    out_j, lse_j, grads_j = _jax_flash(q, k, v, g, True, None, None)
    out_t, lse_t, grads_t = _port_flash(q, k, v, g, True, None, None)
    np.testing.assert_allclose(out_t[:, dead:], out_j[:, dead:], rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse_t[:, dead:], lse_j[:, dead:], rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_array_equal(out_t[:, :dead], 0.0)
    np.testing.assert_array_equal(lse_t[:, :dead], np.float32(tfa.NEG_INF))
    np.testing.assert_array_equal(grads_t[0][:, :dead], 0.0)
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt, gj, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize(
    "shape,opts",
    [
        (dict(hq=8, hk=2, sq=16, sk=16, d=8), dict(causal=False)),
        (dict(sq=16, sk=32, d=8), dict(causal=True)),
        (dict(sq=32, sk=16, d=8), dict(causal=True)),  # dead rows: mean of V
        (dict(sq=32, sk=32, d=8), dict(causal=True, window=5)),
        (dict(sq=32, sk=32, d=8, hk=2), dict(causal=True, segments=True)),
    ],
)
def test_xla_attention_matches_jax(shape, opts):
    q, k, v, _ = _inputs(**shape, seed=5)
    seg = _segments(q.shape[0], q.shape[1]) if opts.pop("segments", False) else None
    ref = jax_xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=None if seg is None else jnp.asarray(seg), **opts,
    )
    out = dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), impl="xla",
        segment_ids=None if seg is None else torch.from_numpy(seg), **opts,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_auto_on_cpu_resolves_to_xla():
    q, k, v, _ = _inputs(sq=128, sk=128)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    assert _local_auto_impl(qt, kt, None) == "xla"
    out = dot_product_attention(qt, kt, vt, causal=True, impl="auto")
    ref = _xla_attention(qt, kt, vt, causal=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_flash_shape_gate_matches_jax():
    from tensorflowonspark_tpu.ops.attention import _flash_shapes_ok as jax_gate
    from tensorflowonspark_tpu_torch.ops.attention import _flash_shapes_ok as port_gate

    for sq, sk, d, seg in [(128, 128, 64, None), (64, 64, 64, None), (256, 128, 128, 1),
                           (256, 256, 32, None), (192, 192, 128, None)]:
        q, k = np.zeros((1, sq, 1, d)), np.zeros((1, sk, 1, d))
        assert port_gate(q, k, seg) == jax_gate(q, k, seg)


def test_wrappers_reject_bad_arguments():
    q, k, v, _ = map(torch.from_numpy, _inputs(sq=64, sk=32, hq=3, hk=2))
    with pytest.raises(ValueError, match="not divisible"):
        tfa.flash_forward(q, k, v, causal=True)
    q, k, v, _ = map(torch.from_numpy, _inputs(sq=64, sk=32))
    with pytest.raises(ValueError, match="window"):
        tfa.flash_forward(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="sq == sk"):
        tfa.flash_forward(q, k, v, causal=True, segment_ids=torch.ones(2, 64, dtype=torch.int32))
    # neither cpu nor cuda: no path, no quiet fallback
    with pytest.raises(ValueError, match="all on cpu or all on cuda"):
        tfa.flash_forward(q.to("meta"), k.to("meta"), v.to("meta"), causal=True)


def test_kernel_argument_checks():
    """What the CUDA kernels take is checked before any launch."""
    q, k, v, _ = map(torch.from_numpy, _inputs(d=64))
    assert tfa._kernel_tensors(q, k, v) == 0
    assert tfa._kernel_tensors(q.bfloat16(), k.bfloat16(), v.bfloat16()) == 1
    with pytest.raises(TypeError, match="float32/bfloat16"):
        tfa._kernel_tensors(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="mixed"):
        tfa._kernel_tensors(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._kernel_tensors(q, k.transpose(1, 2), v)
    q32, k32, v32, _ = map(torch.from_numpy, _inputs(d=32))
    with pytest.raises(ValueError, match="head dim"):
        tfa._kernel_tensors(q32, k32, v32)
