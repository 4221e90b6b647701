"""The port's int8 weight-only quantization against the JAX package's.

``quantize`` of the port's ``(out, in)`` weight at axis 0 against the JAX
package's of the ``(in, out)`` kernel at axis -1: codes and scales equal
(both round half to even, ``torch.round`` and ``jnp.round``, after the
same fp32 division). ``quantized_dot`` in fp32: both sides round ``x`` to
bf16 and accumulate exact products in fp32 in other orders, 1e-5 of the
output's scale. ``quantize_tree`` picks the same leaves with the same axes
(compared after ``params_from_jax``). A tiny Llama (2 layers, fp32) on the
same quantized tree: logits within 2e-3 absolute / 1e-2 relative (each
``quantized_dot`` rounds its input to bf16 on both sides; an fp32
difference at a rounding boundary moves that input by one bf16 step, which
reads up to 1.1e-3 in the logits of rms ~0.2) and greedy tokens equal to
the JAX ``generate``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu.ops import quant as jquant
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models.convert import params_from_jax, params_to_jax
from tensorflowonspark_tpu_torch.ops import quant as tquant

INT8_LOGIT_TOL = dict(rtol=1e-2, atol=2e-3)
B, S, NEW = 3, 8, 10


def _kernel(shape, seed):
    return np.random.default_rng(seed).normal(0.0, 0.02, size=shape).astype(np.float32)


def test_quantize_codes_and_scales_equal_jax():
    kernel = _kernel((96, 160), 0)  # (in, out)
    kernel[:, 7] = 0.0  # an all-zero channel: scale 1, codes 0
    ref = jquant.quantize(jnp.asarray(kernel), axis=-1)
    got = tquant.quantize(torch.from_numpy(kernel.T.copy()), axis=0)
    assert got.q.dtype == torch.int8 and got.axis == 0 and tuple(got.scale.shape) == (160, 1)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q).T)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale).T)
    # the embedding's per-row scales are axis 0 on both sides
    table = _kernel((64, 32), 1)
    ref = jquant.quantize(jnp.asarray(table), axis=0)
    got = tquant.quantize(torch.from_numpy(table), axis=0)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    back = tquant.dequantize(got, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jquant.dequantize(ref, jnp.float32)))


def test_quantized_dot_matches_jax_fp32():
    kernel = _kernel((96, 160), 2)
    x = np.random.default_rng(3).normal(size=(2, 5, 96)).astype(np.float32)
    ref = np.asarray(jquant.quantized_dot(jnp.asarray(x), jquant.quantize(jnp.asarray(kernel))))
    qt = tquant.quantize(torch.from_numpy(kernel.T.copy()))
    got = tquant.quantized_dot(torch.from_numpy(x), qt)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 160)
    scale = np.sqrt(np.mean(ref**2))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * scale)
    with pytest.raises(ValueError, match="axis 0"):
        tquant.quantized_dot(torch.from_numpy(x), tquant.quantize(torch.from_numpy(kernel), 1))


def _configs(vocab=1024):
    base = dict(hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=2,
                num_layers=2, max_seq_len=64, remat=False, vocab_size=vocab)
    jcfg = jllama.LlamaConfig.tiny(**base, dtype=jnp.float32, attention_impl="xla")
    tcfg = tllama.LlamaConfig.tiny(**base, dtype=torch.float32, attention_impl="xla")
    return jcfg, tcfg


def _jax_params(jcfg, tcfg, seed=0):
    """The JAX model and weights for it: a port model's seeded initial
    weights through ``params_to_jax`` (the same distributions as flax's
    initializers, without its op-by-op ``init``)."""
    params = params_to_jax(tllama.Llama(tcfg, device="cpu", seed=seed))
    return jllama.Llama(jcfg), jax.tree.map(jnp.asarray, params)


@pytest.mark.parametrize("min_size", [1 << 16, 1 << 14])
def test_quantize_tree_picks_the_same_leaves_and_axes(min_size):
    jcfg, tcfg = _configs()
    _, params = _jax_params(jcfg, tcfg)
    jq = jquant.quantize_tree(params, min_size=min_size)
    host = jax.tree.map(np.asarray, params)
    got = tquant.quantize_tree(params_from_jax(host), min_size=min_size)
    want = params_from_jax(jq)
    assert set(got) == set(want)
    names = tquant.quantized_names(got)
    # default: the (1024, 128) embedding and head; at 1 << 14 also every
    # kernel but k_proj and v_proj (128 x 64)
    assert len(names) == (2 if min_size == 1 << 16 else 2 + 5 * jcfg.num_layers)
    assert sorted(names) == sorted(tquant.quantized_names(want))
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(), err_msg=name)
    for name in names:
        assert tquant.quant_of(got, name).axis == 0
    # and back: the JAX package's checkpoint form of each QuantTensor
    tree = params_to_jax(got)
    assert set(tree["embed"]) == {"q", "scale"}
    np.testing.assert_array_equal(tree["lm_head"]["q"], np.asarray(jq["lm_head"].q))
    np.testing.assert_array_equal(tree["lm_head"]["scale"], np.asarray(jq["lm_head"].scale))
    deq = tquant.dequantize_tree(got, torch.float32)
    assert set(deq) == set(params_from_jax(host))


def test_int8_llama_logits_and_greedy_tokens_match_jax():
    jcfg, tcfg = _configs()
    jmodel, params = _jax_params(jcfg, tcfg)
    jq = jquant.quantize_tree(params, min_size=1 << 14)
    tmodel = tllama.Llama(tcfg, device="cpu")
    own = tllama.adopt_params(tmodel, params_from_jax(jq))
    assert own["embed"].dtype == torch.int8 and "lm_head_scale" in own
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    ref = np.asarray(jax.jit(jmodel.apply)({"params": jq}, jnp.asarray(prompt)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(prompt)).numpy()
    np.testing.assert_allclose(got, ref, **INT8_LOGIT_TOL)
    ref_toks = np.asarray(jllama.generate(jmodel, jq, jnp.asarray(prompt), NEW))
    got_toks = tllama.generate(tmodel, torch.from_numpy(prompt), NEW)
    np.testing.assert_array_equal(got_toks.numpy(), ref_toks)
    # the int8 model decodes close to the fp32 one it came from
    plain = tllama.Llama(tcfg, device="cpu")
    tllama.adopt_params(plain, params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        err = (plain(torch.from_numpy(prompt)).numpy() - got)
    assert np.sqrt(np.mean(err**2)) < 0.05 * np.sqrt(np.mean(ref**2))


def test_check_params_refuses_half_a_quantized_leaf():
    _, tcfg = _configs()
    model = tllama.Llama(tcfg, device="cpu")
    q = tquant.quantize_tree(dict(model.named_parameters()), min_size=1 << 14)
    broken = dict(q)
    del broken["embed_scale"]
    with pytest.raises(ValueError, match="go together"):
        tllama.check_params(model, broken)
    with pytest.raises(ValueError, match="no parameter slot"):
        tllama.check_params(model, {**q, "layers.0.attn_norm.scale_scale": q["embed_scale"]})


def test_quantize_tree_has_the_one_axis_layout():
    """axis 0 is the port's only layout: ``quantize_tree`` takes no axis knob,
    and every scale it makes is ``(rows, 1)``."""
    import inspect

    assert list(inspect.signature(tquant.quantize_tree).parameters) == ["params", "min_size"]
    _, tcfg = _configs()
    q = tquant.quantize_tree(dict(tllama.Llama(tcfg, device="cpu").named_parameters()),
                             min_size=1 << 14)
    for name in tquant.quantized_names(q):
        assert tuple(q[name + tquant.SCALE].shape) == (q[name].shape[0], 1), name


@pytest.mark.parametrize("where", ["check_params", "engine", "swap"])
def test_int8_scales_on_the_input_axis_are_refused(where):
    """Scales on the input axis of a square weight (q_proj, where the shapes
    alone would broadcast) are refused before anything runs them."""
    from tensorflowonspark_tpu_torch.serving import ContinuousBatcher, WeightsIncompatible

    _, tcfg = _configs()
    model = tllama.Llama(tcfg, device="cpu")
    q = tquant.quantize_tree(dict(model.named_parameters()), min_size=1 << 14)
    name = "layers.0.attn.q_proj.weight"
    assert q[name].shape[0] == q[name].shape[1]
    wrong = tquant.quantize(model.get_parameter(name), axis=1)
    bad = {**q, name: wrong.q, name + tquant.SCALE: wrong.scale}
    if where == "check_params":
        with pytest.raises(ValueError, match="one scale a row"):
            tllama.check_params(model, bad)
        return
    if where == "engine":
        with pytest.raises(WeightsIncompatible, match="one scale a row"):
            ContinuousBatcher(model, params=bad, slots=1, prompt_widths=(8,))
        return
    eng = ContinuousBatcher(model, params=q, slots=1, prompt_widths=(8,))
    try:
        with pytest.raises(WeightsIncompatible):
            eng.swap_weights(bad, version="x")
        assert eng.weights_version == "v0"
    finally:
        eng.close()
