"""The port's Inception-v3 against the JAX package's, on the CPU, fp32.

``InceptionConfig.tiny`` (one block of each type at 1/8 width) from one
flax weight set, on one numpy batch; tolerances as in
test_torch_convnets.py, except the gradients: each leaf within 1e-3 of its
own largest element. The tiny Inception stacks some 40 BatchNorm layers,
each dividing by a std taken over a few hundred rows, and the differences
in summation order grow through them: the worst element read 2e-4
absolute on a leaf whose largest element is 1.4, while a BatchNorm bias
gradient, a sum that cancels, can be 30 times smaller than its leaf's
largest element. The port's BatchNorm statistics take the
``kernel`` route (the kernels' plain versions on CPU tensors), which also
checks that every BatchNorm input, the branches of a concatenation
included, reaches the wrappers contiguous NHWC in both directions. The aux
head runs at 80×80, where its 5×5/3 pool still has a window; the flax
model creates it only when initialized in train mode.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from tests.test_torch_convnets import _batch, assert_sides_close, jax_side, port_side

from tensorflowonspark_tpu.models import inception as jinception
from tensorflowonspark_tpu_torch.models import inception as tinception
from tensorflowonspark_tpu_torch.ops.batch_norm import set_impl


@pytest.mark.parametrize("size,aux", [(64, False), (80, True)])
def test_inception_tiny_matches_jax(size, aux):
    batch = _batch(size, seed=4)
    jmodel = jinception.InceptionV3(
        jinception.InceptionConfig.tiny(dtype=jnp.float32, aux_logits=aux))
    variables = jmodel.init(jax.random.PRNGKey(4), batch["image"], train=aux)
    want = jax_side(jmodel, jinception.loss_fn(jmodel), variables, batch)
    tmodel = tinception.InceptionV3(
        tinception.InceptionConfig.tiny(dtype=torch.float32, aux_logits=aux), device="cpu")
    set_impl(tmodel, "kernel")
    assert_sides_close(port_side(tmodel, tinception.loss_fn(tmodel), variables, batch), want,
                       grad_leaf_rel=1e-3)


def test_inception_widths_follow_the_config():
    cfg = tinception.InceptionConfig.v3()
    assert [cfg.w(c) for c in (32, 48, 80, 96, 192, 2048)] == [32, 48, 80, 96, 192, 2048]
    tiny = tinception.InceptionConfig.tiny()
    assert [tiny.w(c) for c in (32, 64, 384, 448)] == [8, 8, 48, 56]


def test_inception_dropout_needs_a_generator():
    cfg = tinception.InceptionConfig.tiny(dtype=torch.float32, dropout_rate=0.5)
    model = tinception.InceptionV3(cfg, device="cpu")
    x = torch.from_numpy(_batch(32)["image"])
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True)
    with torch.no_grad():
        a = model(x, train=True, generator=torch.Generator().manual_seed(0))
        b = model(x, train=True, generator=torch.Generator().manual_seed(0))
        c = model(x, train=False)
    torch.testing.assert_close(a, b)  # the same generator state gives the same mask
    assert torch.isfinite(c).all() and not torch.equal(a, c)
