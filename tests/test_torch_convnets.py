"""The port's ResNet and VGG against the JAX package's, on the CPU.

Both sides start from one flax weight set, carried into the port by
``models.convert``, and see one numpy batch. The port runs its BatchNorm
statistics on both routes: ``kernel`` (the kernels' plain versions on
these CPU tensors, which also checks that every BatchNorm input reaches
the wrappers contiguous NHWC) and ``xla``.

Tolerances. fp32: the two sides differ only in the order of their sums
(convolutions, statistics, the one-pass variance), so logits and loss are
held to 1e-4 relative, grads to 1e-4 relative plus 1e-5 absolute, running
statistics to 1e-5. bf16: the convs round their outputs to bf16 on both
sides, in different places of their sums, and the gradient of a
BatchNorm's bias or scale is a sum that mostly cancels: against the fp32
result, the JAX package's own bf16 gradients are off by up to 53 % of
their norm on the tiny net. So bf16 is held to the fp32 truth as the JAX
package is: per leaf, ``‖port − fp32‖ ≤ 2.5·‖jax_bf16 − fp32‖ + 1e-2·‖fp32‖``
(the port read at most 1.9× when this was written), and the loss to 3e-2
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tensorflowonspark_tpu.models import resnet as jresnet
from tensorflowonspark_tpu.models import vgg as jvgg
from tensorflowonspark_tpu_torch.compute import TrainState, build_bn_train_step, sgd
from tensorflowonspark_tpu_torch.models import conv as tconv
from tensorflowonspark_tpu_torch.models import resnet as tresnet
from tensorflowonspark_tpu_torch.models import vgg as tvgg
from tensorflowonspark_tpu_torch.ops.batch_norm import set_impl
from tensorflowonspark_tpu_torch.models.convert import (
    batch_stats_from_jax,
    batch_stats_to_jax,
    params_from_jax,
    params_to_jax,
)

FP32_TOL = dict(rtol=1e-4, atol=1e-5)


def _batch(size, seed=0, n=2, classes=10):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, size, size, 3)).astype(np.float32),
            "label": rng.integers(0, classes, size=n).astype(np.int32)}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def jax_side(jmodel, jloss, variables, batch):
    """(logits, loss, new batch_stats, grads) of the JAX model in train mode."""
    out, _ = jmodel.apply(variables, batch["image"], train=True, mutable=["batch_stats"])
    logits = out[0] if isinstance(out, tuple) else out  # (logits, aux_logits) with an aux head
    (loss, new_bs), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"], variables["batch_stats"], batch)
    return np.asarray(logits), float(loss), _np(new_bs), _np(grads)


def port_side(tmodel, tloss, variables, batch):
    tmodel.load_state_dict({**params_from_jax(_np(variables["params"])),
                            **batch_stats_from_jax(_np(variables["batch_stats"]))})
    params = dict(tmodel.named_parameters())
    stats = dict(tmodel.named_buffers())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = tmodel(tb["image"], train=True)
    logits = logits[0] if isinstance(logits, tuple) else logits
    loss, new_bs = tloss(params, stats, tb)
    grads = torch.autograd.grad(loss, list(params.values()))
    return (logits.float().numpy(), loss.item(), batch_stats_to_jax(new_bs),
            params_to_jax(dict(zip(params, grads))))


def assert_trees_close(tree, ref, **tol):
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat) == len(flat_ref) and flat_ref
    for path, want in flat_ref:
        np.testing.assert_allclose(flat[path], want, err_msg=jax.tree_util.keystr(path), **tol)


def assert_leaves_within(tree, ref, rel):
    """Each leaf within ``rel`` of its own largest value: max|a − b| ≤
    rel·max|b|, the scale for sums that may cancel to small elements."""
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    for path, want in jax.tree_util.tree_flatten_with_path(ref)[0]:
        err = np.abs(flat[path] - want).max()
        assert err <= rel * np.abs(want).max(), (jax.tree_util.keystr(path), err)


def assert_sides_close(got, want, grad_leaf_rel=None):
    """fp32: the port against the JAX package, leaf by leaf (the grads
    element by element, or each within ``grad_leaf_rel`` of its scale)."""
    logits, loss, stats, grads = got
    rlogits, rloss, rstats, rgrads = want
    np.testing.assert_allclose(logits, rlogits, rtol=1e-4, atol=1e-5)
    assert loss == pytest.approx(rloss, rel=1e-4)
    assert_trees_close(stats, rstats, rtol=1e-5, atol=1e-5)
    if grad_leaf_rel is None:
        assert_trees_close(grads, rgrads, **FP32_TOL)
    else:
        assert len(jax.tree.leaves(grads)) == len(jax.tree.leaves(rgrads))
        assert_leaves_within(grads, rgrads, grad_leaf_rel)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def assert_bf16_as_close_as_jax(port, jax_bf16, fp32):
    """Each leaf of the port's bf16 result is at most 2.5× as far from the
    fp32 result as the JAX package's bf16 result is, plus 1 %."""
    assert port[1] == pytest.approx(fp32[1], rel=3e-2)
    np.testing.assert_allclose(port[0], fp32[0], rtol=3e-2, atol=3e-2)
    for i in (2, 3):  # running statistics, grads
        ref = dict(jax.tree_util.tree_flatten_with_path(fp32[i])[0])
        theirs = dict(jax.tree_util.tree_flatten_with_path(jax_bf16[i])[0])
        ours = dict(jax.tree_util.tree_flatten_with_path(port[i])[0])
        assert set(ours) == set(ref)
        for path, want in ref.items():
            limit = 2.5 * _rel(theirs[path], want) + 1e-2
            assert _rel(ours[path], want) <= limit, (jax.tree_util.keystr(path), limit)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_resnet_tiny_bf16_as_close_to_fp32_as_jax(impl):
    batch = _batch(32)
    jfp32 = jresnet.ResNet(jresnet.ResNetConfig.tiny(dtype=jnp.float32))
    variables = jfp32.init(jax.random.PRNGKey(0), batch["image"], train=False)
    fp32 = jax_side(jfp32, jresnet.loss_fn(jfp32), variables, batch)
    jbf16 = jresnet.ResNet(jresnet.ResNetConfig.tiny(dtype=jnp.bfloat16))
    jax_bf16 = jax_side(jbf16, jresnet.loss_fn(jbf16), variables, batch)
    tmodel = tresnet.ResNet(tresnet.ResNetConfig.tiny(), device="cpu")
    set_impl(tmodel, impl)
    port = port_side(tmodel, tresnet.loss_fn(tmodel), variables, batch)
    assert_bf16_as_close_as_jax(port, jax_bf16, fp32)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_resnet_tiny_matches_jax(impl):
    batch = _batch(32)
    jmodel = jresnet.ResNet(jresnet.ResNetConfig.tiny(dtype=jnp.float32))
    variables = jmodel.init(jax.random.PRNGKey(0), batch["image"], train=False)
    want = jax_side(jmodel, jresnet.loss_fn(jmodel), variables, batch)
    tmodel = tresnet.ResNet(tresnet.ResNetConfig.tiny(dtype=torch.float32), device="cpu")
    set_impl(tmodel, impl)
    got = port_side(tmodel, tresnet.loss_fn(tmodel), variables, batch)
    assert_sides_close(got, want)


def test_resnet_basic_blocks_match_jax():
    """The ResNet-18/34 block (two 3x3 convs), at tiny width."""
    batch = _batch(32, seed=1)
    overrides = dict(stage_sizes=(1, 1), bottleneck=False, width=8, num_classes=10)
    jmodel = jresnet.ResNet(jresnet.ResNetConfig(**overrides, dtype=jnp.float32))
    variables = jmodel.init(jax.random.PRNGKey(1), batch["image"], train=False)
    want = jax_side(jmodel, jresnet.loss_fn(jmodel), variables, batch)
    tmodel = tresnet.ResNet(
        tresnet.ResNetConfig(**overrides, dtype=torch.float32), device="cpu")
    assert_sides_close(port_side(tmodel, tresnet.loss_fn(tmodel), variables, batch), want)


def test_resnet_sgd_trajectory_matches_jax():
    """Three steps of the JAX ResNet example's step (optax.sgd(0.1,
    momentum=0.9), ``examples/resnet/resnet_imagenet.py:120-133``) against
    ``build_bn_train_step`` with the port's ``sgd``, fp32."""
    batch = _batch(32, seed=2, n=4)
    jmodel = jresnet.ResNet(jresnet.ResNetConfig.tiny(dtype=jnp.float32))
    variables = jmodel.init(jax.random.PRNGKey(2), batch["image"], train=False)
    tx = optax.sgd(0.1, momentum=0.9)
    jloss = jresnet.loss_fn(jmodel)

    @jax.jit
    def jstep(params, opt_state, batch_stats, batch):
        (l, new_bs), grads = jax.value_and_grad(jloss, has_aux=True)(params, batch_stats, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, new_bs, l

    params, opt_state, jbs = variables["params"], tx.init(variables["params"]), variables["batch_stats"]
    jlosses = []
    for _ in range(3):
        params, opt_state, jbs, l = jstep(params, opt_state, jbs, batch)
        jlosses.append(float(l))

    tmodel = tresnet.ResNet(tresnet.ResNetConfig.tiny(dtype=torch.float32), device="cpu")
    tmodel.load_state_dict({**params_from_jax(_np(variables["params"])),
                            **batch_stats_from_jax(_np(variables["batch_stats"]))})
    ttx = sgd(0.1, momentum=0.9)
    step = build_bn_train_step(tresnet.loss_fn(tmodel), ttx, device="cpu")
    state = TrainState.create(tmodel.named_parameters(), ttx)
    tbs, losses = dict(tmodel.named_buffers()), []
    for _ in range(3):
        state, tbs, l = step(state, tbs, batch)
        losses.append(l.item())
    assert state.step == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    assert_trees_close(params_to_jax(state.params), _np(params), rtol=1e-4, atol=1e-4)
    assert_trees_close(batch_stats_to_jax(tbs), _np(jbs), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_vgg_tiny_matches_jax(impl):
    """Also pins the H, W, C flatten before fc6: its weights come straight
    from the flax tree."""
    batch = _batch(32, seed=3)
    jmodel = jvgg.VGG(jvgg.VGGConfig.tiny(dtype=jnp.float32))
    variables = jmodel.init(jax.random.PRNGKey(3), batch["image"], train=False)
    want = jax_side(jmodel, jvgg.loss_fn(jmodel), variables, batch)
    tmodel = tvgg.VGG(tvgg.VGGConfig.tiny(dtype=torch.float32), device="cpu")
    set_impl(tmodel, impl)
    assert_sides_close(port_side(tmodel, tvgg.loss_fn(tmodel), variables, batch), want)


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)), (56, 1, 2, (0, 0)),
    (150, 3, 2, (0, 1)), (299, 3, 2, (1, 1)), (35, 3, 1, (1, 1)), (17, 7, 1, (3, 3)),
])
def test_same_pads_follow_lax(size, kernel, stride, pads):
    from jax import lax

    assert tconv.same_pads(size, kernel, stride) == pads
    assert lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME") == [pads]


def test_stride2_same_conv_is_asymmetric():
    """A 3x3 stride-2 SAME conv on an even grid pads (0, 1), not (1, 1):
    the port matches flax, and a symmetric ``padding=1`` would not."""
    import flax.linen as nn

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    jconv = nn.Conv(6, (3, 3), (2, 2), padding="SAME", use_bias=False, dtype=jnp.float32)
    v = jconv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(jconv.apply(v, x))
    conv = tconv.Conv(4, 6, (3, 3), (2, 2), torch.float32, device="cpu")
    conv.load_state_dict({"weight": params_from_jax({"Conv_0": _np(v["params"])})["Conv_0.weight"]})
    got = conv(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 4, 4, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    symmetric = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), conv.weight, stride=2,
                         padding=1).permute(0, 2, 3, 1).detach().numpy()
    assert symmetric.shape == want.shape
    assert np.abs(symmetric - want).max() > 0.1


def test_max_pool_same_pads_with_minus_inf():
    import flax.linen as nn

    x = -np.abs(np.random.default_rng(6).normal(size=(1, 6, 6, 3))).astype(np.float32) - 1.0
    want = np.asarray(nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME"))
    got = tconv.max_pool(torch.from_numpy(x), 3, 2, "SAME").numpy()
    np.testing.assert_array_equal(got, want)  # a zero pad would show through: all x < 0


def test_convert_round_trips_and_refuses_unknown_leaves():
    jmodel = jresnet.ResNet(jresnet.ResNetConfig.tiny(dtype=jnp.float32))
    variables = _np(jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32)))
    params = params_from_jax(variables["params"])
    tmodel = tresnet.ResNet(tresnet.ResNetConfig.tiny(dtype=torch.float32), device="cpu")
    assert set(params) == set(dict(tmodel.named_parameters()))
    assert set(batch_stats_from_jax(variables["batch_stats"])) == set(dict(tmodel.named_buffers()))
    assert params["_ConvBN_0.Conv_0.weight"].shape == (8, 3, 7, 7)  # HWIO -> OIHW
    assert params["Dense_0.weight"].shape == (10, 64)  # (in, out) -> (out, in)
    assert_trees_close(params_to_jax(params), variables["params"], rtol=0, atol=0)
    assert_trees_close(batch_stats_to_jax(batch_stats_from_jax(variables["batch_stats"])),
                       variables["batch_stats"], rtol=0, atol=0)
    with pytest.raises(KeyError):
        params_from_jax({"_ConvBN_0": {"Conv_0": {"bias": np.zeros(3)}}})
    with pytest.raises(KeyError):
        params_from_jax({"_ConvBN_0": {"Norm_0": {"scale": np.zeros(3)}}})
    with pytest.raises(KeyError):
        batch_stats_from_jax({"_ConvBN_0": {"BatchNorm_0": {"count": np.zeros(3)}}})
    with pytest.raises(KeyError):
        params_to_jax({"_ConvBN_0.Conv_0.bias": torch.zeros(3)})
