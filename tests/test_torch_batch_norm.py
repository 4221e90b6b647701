"""The port's batch-norm statistics and BatchNorm layer against the JAX
package's.

The JAX side runs its Pallas kernels in interpret mode (``INTERPRET``
patched, as its own ``pallas_interpret`` fixture does) and is forced onto
them with ``use_pallas`` patched to True; the port's wrappers take their
plain versions on these CPU tensors. Inputs come from numpy with a seed and
keep an offset (normal(0.5, 2)), so the one-pass variance cancels as it
does in use.

Tolerances. A per-channel sum is held to ``|a − b| ≤ 1e-5·Σ|terms| +
1e-5``, Σ|terms| in fp64: fp32 sums of up to 2050 terms in different
orders differ by a few ulps of that scale. The layer's outputs and
gradients in fp32: 1e-5 absolute for y, 2e-4 absolute / 1e-4 relative for
the gradients (the JAX package's own bound between its two routes, which
derive Σdy·x̂ differently); in bf16, one bf16 step (2^-7) relative plus 2e-2
absolute.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.ops import batch_norm as jbn
from tensorflowonspark_tpu.ops import bn_kernels as jbk
from tensorflowonspark_tpu_torch.ops import batch_norm as tbn
from tensorflowonspark_tpu_torch.ops import bn_kernels as tbk

RESNET50_STATS_SHAPES = [  # (rows, C) of ResNet-50's BatchNorm layers at batch 256, 224x224
    (3211264, 64), (802816, 64), (802816, 128), (802816, 256), (200704, 128), (200704, 256),
    (200704, 512), (50176, 256), (50176, 512), (50176, 1024), (12544, 512), (12544, 2048),
]


@pytest.fixture
def pallas(monkeypatch):
    """The JAX package's Pallas statistics kernels, interpreted, on every route."""
    monkeypatch.setattr(jbk, "INTERPRET", True)
    monkeypatch.setattr(jbk, "use_pallas", lambda impl="auto": True)


def _data(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(0.5, 2.0, shape).astype(dtype)


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _assert_sums(got, want, terms):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    limit = 1e-5 * terms + 1e-5
    assert np.all(np.abs(got - want) <= limit), np.max(np.abs(got - want) - limit)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(7, 4), (1030, 65), (2050, 600)])
def test_pair_stats_matches_pallas(pallas, shape, dtype):
    jx = jnp.asarray(_data(shape, 10)).astype(dtype)
    tx = _to_torch(jx, getattr(torch, dtype))
    js, jq = jbk.pair_stats(jx)
    ts, tq = tbk.pair_stats(tx)
    assert ts.dtype == tq.dtype == torch.float32 and ts.shape == (shape[1],)
    x64 = tx.double()
    _assert_sums(ts, js, x64.abs().sum(0).numpy())
    _assert_sums(tq, jq, (x64 * x64).sum(0).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(7, 4), (1030, 65), (2050, 600)])
def test_cross_stats_matches_pallas(pallas, shape, dtype):
    jdy = jnp.asarray(_data(shape, 11) - 0.5).astype(dtype)
    jx = jnp.asarray(_data(shape, 12)).astype(dtype)
    tdy, tx = _to_torch(jdy, getattr(torch, dtype)), _to_torch(jx, getattr(torch, dtype))
    js, jq = jbk.cross_stats(jdy, jx)
    ts, tq = tbk.cross_stats(tdy, tx)
    _assert_sums(ts, js, tdy.double().abs().sum(0).numpy())
    _assert_sums(tq, jq, (tdy.double() * tx.double()).abs().sum(0).numpy())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(4, 6, 6, 8)
    with pytest.raises(ValueError, match="contiguous"):
        tbk.pair_stats(x.permute(0, 3, 1, 2))  # NCHW-contiguous: channels not last in memory
    with pytest.raises(TypeError, match="float32/bfloat16"):
        tbk.pair_stats(x.half())
    with pytest.raises(ValueError, match="does not match"):
        tbk.cross_stats(x, x[:2])
    with pytest.raises(ValueError, match="does not match"):
        tbk.cross_stats(x, x.bfloat16())


GEOMETRY_CASES = [
    (rows, c, vec)
    for rows, c in RESNET50_STATS_SHAPES + [(7, 4), (1030, 65), (2050, 600), (1, 1), (100003, 3)]
    for vec in (8, 4, 1) if c % vec == 0
]


@pytest.mark.parametrize("rows,c,vec", GEOMETRY_CASES)
def test_launch_geometry_covers_every_row_once(rows, c, vec):
    tx, splits, per = tbk.launch_geometry(rows, c, vec)
    assert tx in (1, 2, 4, 8, 16, 32) and tx >= min(c // vec, 32)
    tile = (tbk.THREADS // tx) * tbk.UNROLL
    assert per % tile == 0 and 1 <= splits <= tbk.MAX_SPLITS
    assert (splits - 1) * per < rows <= splits * per  # no split is empty
    columns = -(-(c // vec) // tx)
    assert splits * columns <= max(tbk.TARGET_BLOCKS, columns)


def test_vector_width_needs_alignment_and_width():
    x = torch.zeros(1000, 64, dtype=torch.bfloat16)
    assert tbk.vector_width((x,), 64) == 8
    assert tbk.vector_width((x.float(),), 64) == 4
    assert tbk.vector_width((x,), 65) == 1
    flat = torch.zeros(64 * 100 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(100, 64)  # 2-byte offset: not 16-byte aligned
    assert tbk.vector_width((x, shifted), 64) == 1


def _layer_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.normal(0.5, 2.0, shape).astype(np.float32),
            rng.normal(1.0, 0.3, (c,)).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _jax_layer(x, g, b, t, impl, dtype):
    def loss(x, g, b):
        y = jbn.fused_batch_norm(x.astype(dtype), g, b, 1e-5, impl=impl)
        return jnp.sum(y.astype(jnp.float32) * t)

    y = jbn.fused_batch_norm(jnp.asarray(x).astype(dtype), g, b, 1e-5, impl=impl)
    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    return [np.asarray(a, np.float32) for a in (y, *grads)]


def _port_layer(x, g, b, t, impl, dtype):
    tx = torch.tensor(x, requires_grad=True)
    tg = torch.tensor(g, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    y = tbn.fused_batch_norm(tx.to(dtype), tg, tb, 1e-5, impl=impl)
    (y.float() * torch.from_numpy(t)).sum().backward()
    return [a.detach().float().numpy() for a in (y, tx.grad, tg.grad, tb.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", [("kernel", "pallas"), ("xla", "xla")])
def test_fused_batch_norm_matches_jax(route, dtype, monkeypatch):
    port_impl, jax_impl = route
    monkeypatch.setattr(jbk, "INTERPRET", True)
    x, g, b, t = _layer_inputs((3, 5, 5, 24), 13)
    want = _jax_layer(x, g, b, t, jax_impl, getattr(jnp, dtype))
    got = _port_layer(x, g, b, t, port_impl, getattr(torch, dtype))
    if dtype == "float32":
        np.testing.assert_allclose(got[0], want[0], atol=1e-5)
        for a, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, w, atol=2e-4, rtol=1e-4)
    else:
        for a, w in zip(got, want):
            np.testing.assert_allclose(a, w, atol=2e-2, rtol=2**-7)


def test_kernel_and_xla_routes_agree_in_the_port():
    x, g, b, t = _layer_inputs((4, 6, 6, 16), 14)
    k = _port_layer(x, g, b, t, "kernel", torch.float32)
    p = _port_layer(x, g, b, t, "xla", torch.float32)
    np.testing.assert_allclose(k[0], p[0], atol=1e-5)
    for a, w in zip(k[1:], p[1:]):
        np.testing.assert_allclose(a, w, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_running_stats_and_eval_match_jax(dtype):
    x = jnp.asarray(np.random.default_rng(3).normal(1.0, 2.0, (4, 6, 6, 12))).astype(dtype)
    jm = jbn.FusedBatchNorm(momentum=0.9, epsilon=1e-5, dtype=getattr(jnp, dtype))
    v = jm.init(jax.random.key(0), x, use_running_average=False)
    rng = np.random.default_rng(4)
    params = {"scale": rng.normal(1.0, 0.2, 12).astype(np.float32),
              "bias": rng.normal(0.0, 0.2, 12).astype(np.float32)}
    stats = {"mean": rng.normal(0.0, 0.5, 12).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 12).astype(np.float32)}
    jy, mut = jm.apply({"params": params, "batch_stats": stats}, x,
                       use_running_average=False, mutable=["batch_stats"])
    jeval = jm.apply({"params": params, "batch_stats": mut["batch_stats"]}, x,
                     use_running_average=True)

    tm = tbn.FusedBatchNorm(12, momentum=0.9, epsilon=1e-5, dtype=getattr(torch, dtype))
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in {**params, **stats}.items()})
    tx = _to_torch(x, getattr(torch, dtype))
    ty = tm(tx, use_running_average=False)
    new = tbn.pop_batch_stats(tm)
    assert set(new) == {"mean", "var"} and tm.updated is None
    tol = dict(atol=1e-5) if dtype == "float32" else dict(atol=2e-2, rtol=2**-7)
    np.testing.assert_allclose(ty.float().detach().numpy(), np.asarray(jy, np.float32), **tol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(mut["batch_stats"][k]),
                                   rtol=1e-6, atol=1e-6)
        assert not new[k].requires_grad
        # the buffers themselves are not written: the update is returned
        np.testing.assert_array_equal(getattr(tm, k).numpy(), stats[k])
    tm.load_state_dict({**{k: torch.from_numpy(v) for k, v in params.items()}, **new})
    teval = tm(tx, use_running_average=True)
    np.testing.assert_allclose(teval.float().detach().numpy(), np.asarray(jeval, np.float32), **tol)


def test_running_stats_take_no_gradient():
    """Gradients with the running-stat update active equal those of the
    bare normalize (the JAX package's test_grad_does_not_leak_through_running_stats)."""
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 3, 3, 4)).astype(np.float32))
    m = tbn.FusedBatchNorm(4)
    y = m(x)
    new = tbn.pop_batch_stats(m)
    assert not any(t.requires_grad for t in new.values())
    g_upd = torch.autograd.grad((y * y).sum(), [m.scale, m.bias])
    y2 = tbn.fused_batch_norm(x, m.scale, m.bias, m.epsilon)
    g_pure = torch.autograd.grad((y2 * y2).sum(), [m.scale, m.bias])
    for a, b in zip(g_upd, g_pure):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_auto_resolves_to_kernel_on_cuda_and_xla_on_cpu(monkeypatch):
    cuda_like = types.SimpleNamespace(device=torch.device("cuda"))
    assert tbn.resolve_impl("auto", cuda_like) == "kernel"
    assert tbn.resolve_impl("auto", torch.zeros(1)) == "xla"
    assert tbn.resolve_impl("pallas", torch.zeros(1)) == "kernel"
    assert tbn.resolve_impl("xla", cuda_like) == "xla"
    with pytest.raises(ValueError, match="impl"):
        tbn.resolve_impl("triton", torch.zeros(1))

    calls = []
    monkeypatch.setattr(tbk, "pair_stats", lambda x: (calls.append("pair"), tbk.pair_stats_plain(x.view(-1, x.shape[-1])))[1])
    monkeypatch.setattr(tbk, "cross_stats",
                        lambda dy, x: (calls.append("cross"), tbk.cross_stats_plain(
                            dy.reshape(-1, dy.shape[-1]), x.reshape(-1, x.shape[-1])))[1])
    x = torch.randn(2, 3, 3, 4, requires_grad=True)
    g, b = torch.ones(4, requires_grad=True), torch.zeros(4, requires_grad=True)
    tbn.fused_batch_norm(x, g, b, 1e-5, impl="auto").sum().backward()
    assert calls == []  # CPU: auto is the plain-reduction route, forward and backward
    tbn.fused_batch_norm(x, g, b, 1e-5, impl="kernel").sum().backward()
    assert calls == ["pair", "cross"]  # the route chosen at the forward runs the backward


def test_set_impl_routes_every_layer():
    from tensorflowonspark_tpu_torch.models.resnet import ResNet, ResNetConfig

    model = ResNet(ResNetConfig.tiny(dtype=torch.float32), device="cpu")
    tbn.set_impl(model, "kernel")
    layers = [m for m in model.modules() if isinstance(m, tbn.FusedBatchNorm)]
    assert len(layers) == 9 and all(m.impl == "kernel" for m in layers)
    with pytest.raises(ValueError):
        tbn.set_impl(model, "pallas_tpu")
