"""The port's Llama training path against the JAX package's.

A tiny fp32 config (hidden 256, 4 heads of 64, 2 kv heads, 2 layers,
seq 128). The JAX model's initial weights go through ``params_from_jax``
into the port, and both sides see the same numpy tokens. The port routes
attention through its flash wrapper (the plain versions on the CPU); the
JAX side runs ``attention_impl='xla'``, and in one case its Pallas flash
kernels in interpret mode.

Tolerances (fp32): logits 1e-4 absolute / 1e-3 relative (two attention
algorithms and two matmul libraries sum in other orders); loss 1e-5
relative; gradients 2e-5 absolute / 2e-3 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu.ops import flash_attention as jfa
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models.convert import params_from_jax, params_to_jax

SEQ = 128
LOGIT_TOL = dict(rtol=1e-3, atol=1e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


def _configs(**overrides):
    """(JAX config, port config) of one tiny fp32 model."""
    base = dict(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
                num_layers=2, max_seq_len=SEQ, remat=False)
    jax_over = dict(overrides)
    port_over = dict(overrides)
    if "rope_scaling" in overrides:
        rs = overrides["rope_scaling"]
        jax_over["rope_scaling"] = jllama.RopeScaling(**dataclasses.asdict(rs))
    jcfg = jllama.LlamaConfig.tiny(**base, dtype=jnp.float32, attention_impl="xla", **jax_over)
    tcfg = tllama.LlamaConfig.tiny(**base, dtype=torch.float32, attention_impl="flash",
                                   **port_over)
    return jcfg, tcfg


def _tokens(b=2, s=SEQ + 1, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def _packed_segments(b=2, s=SEQ + 1, seed=1):
    """Packed rows: documents of seeded lengths, then padding (id 0)."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for r in range(b):
        pos, doc = 0, 1
        while pos < s - 20:
            n = int(rng.integers(10, 50))
            seg[r, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    return seg


def _models(jcfg, tcfg, seed=0):
    jmodel = jllama.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, SEQ), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    tmodel = tllama.Llama(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(params))
    return jmodel, params, tmodel


VARIANTS = {
    "base": dict(),
    "llama3_rope": dict(rope_scaling=tllama.RopeScaling(
        kind="llama3", factor=8.0, original_max_seq_len=64)),
    "linear_rope": dict(rope_scaling=tllama.RopeScaling(kind="linear", factor=4.0)),
    "attention_bias": dict(attention_bias=True),
    "sliding_window": dict(sliding_window=32),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_logits_match_jax(name):
    jcfg, tcfg = _configs(**VARIANTS[name])
    jmodel, params, tmodel = _models(jcfg, tcfg)
    if jcfg.attention_bias:
        # flax zero-inits biases; give them values so the test sees them
        rng = np.random.default_rng(2)
        for i in range(jcfg.num_layers):
            for p in ("q_proj", "k_proj", "v_proj"):
                leaf = params[f"layer{i}"]["attn"][p]
                leaf["bias"] = rng.normal(0, 0.1, leaf["bias"].shape).astype(np.float32)
        tmodel.load_state_dict(params_from_jax(params))
    toks = _tokens()[:, :-1]
    ref = jmodel.apply({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(toks))
    assert out.dtype == torch.float32 and out.shape == (2, SEQ, jcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOGIT_TOL)


def test_logits_match_jax_pallas_flash(monkeypatch):
    monkeypatch.setattr(jfa, "INTERPRET", True)
    jcfg, tcfg = _configs()
    jcfg = dataclasses.replace(jcfg, attention_impl="flash")
    jmodel, params, tmodel = _models(jcfg, tcfg, seed=3)
    toks = _tokens(seed=3)[:, :-1]
    ref = jmodel.apply({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(toks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOGIT_TOL)


def _port_params(tmodel):
    return dict(tmodel.named_parameters())


@pytest.mark.parametrize(
    "logit_chunk,packed", [(None, False), (32, False), (None, True), (64, True)]
)
def test_loss_and_grads_match_jax(logit_chunk, packed):
    jcfg, tcfg = _configs()
    jmodel, params, tmodel = _models(jcfg, tcfg, seed=1)
    toks = _tokens(seed=4)
    seg = _packed_segments() if packed else None
    jloss = jllama.llama_loss_fn(jmodel, logit_chunk=logit_chunk)
    ref_loss, ref_grads = jax.value_and_grad(jloss)(
        params, jnp.asarray(toks), None if seg is None else jnp.asarray(seg)
    )
    tloss = tllama.llama_loss_fn(tmodel, logit_chunk=logit_chunk)
    loss = tloss(_port_params(tmodel), torch.from_numpy(toks),
                 None if seg is None else torch.from_numpy(seg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    grads = params_to_jax({n: p.grad for n, p in tmodel.named_parameters()})
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref_grads)[0])
    flat = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    assert flat.keys() == flat_ref.keys()
    for path, g in flat.items():
        np.testing.assert_allclose(g, np.asarray(flat_ref[path]), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_matches_no_remat():
    """Block checkpointing recomputes in backward; loss and grads stay."""
    _, tcfg = _configs()
    outs = []
    for remat in (False, True):
        model = tllama.Llama(dataclasses.replace(tcfg, remat=remat), device="cpu", seed=5)
        loss = tllama.llama_loss_fn(model)(_port_params(model), torch.from_numpy(_tokens()))
        loss.backward()
        outs.append((loss.item(), [p.grad.clone() for p in model.parameters()]))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-6)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_remat_dots_matches_no_remat_and_recomputes_attention(monkeypatch):
    """``remat_policy='dots'`` keeps the projections' outputs and recomputes
    the rest of each block, the flash forward among it: the loss and grads
    are those of ``remat=False`` (1e-6 / 1e-5 relative, fp32), and the flash
    Function's forward runs twice a layer (the forward, then the recompute)
    where ``remat=False`` runs it once."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as tfa

    calls = {"n": 0}
    real = tfa.flash_forward

    def counted(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(tfa, "flash_forward", counted)
    _, tcfg = _configs()  # the port's attention runs through the flash wrapper
    outs = []
    for remat in (False, True):
        calls["n"] = 0
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy="dots")
        model = tllama.Llama(cfg, device="cpu", seed=5)
        loss = tllama.llama_loss_fn(model)(_port_params(model), torch.from_numpy(_tokens()))
        loss.backward()
        outs.append((loss.item(), [p.grad.clone() for p in model.parameters()], calls["n"]))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-6)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert (outs[0][2], outs[1][2]) == (tcfg.num_layers, 2 * tcfg.num_layers)


def test_remat_dots_saves_only_plain_matmul_outputs():
    """The 'dots' policy keeps aten.mm/addmm outputs (JAX's
    dots_with_no_batch_dims_saveable) and recomputes everything else,
    batched products included."""
    from torch.utils.checkpoint import CheckpointPolicy

    policy = tllama._dots_policy
    assert policy(None, torch.ops.aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert policy(None, torch.ops.aten.addmm.default) == CheckpointPolicy.MUST_SAVE
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.mul.Tensor, torch.ops.aten.exp.default):
        assert policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


def test_packed_positions_and_mask_match_jax():
    seg = _packed_segments(seed=7)
    jmask, jcanon = jllama.packed_loss_mask(jnp.asarray(seg))
    tmask, tcanon = tllama.packed_loss_mask(torch.from_numpy(seg))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tcanon.numpy(), np.asarray(jcanon))
    assert tllama.packed_valid_count(torch.from_numpy(seg)).item() == float(
        jllama.packed_valid_count(jnp.asarray(seg))
    )
    # positions restart at each document (the JAX cummax construction)
    pos = tllama.packed_positions(torch.from_numpy(seg[:, :-1]))
    for r in range(seg.shape[0]):
        row = seg[r, :-1]
        starts = np.r_[0, np.nonzero(row[1:] != row[:-1])[0] + 1]
        expect = np.arange(len(row)) - starts[np.searchsorted(starts, np.arange(len(row)),
                                                              side="right") - 1]
        np.testing.assert_array_equal(pos[r].numpy(), expect)


def test_rope_freqs_match_jax():
    for scaling in (None, tllama.RopeScaling(), tllama.RopeScaling(kind="linear", factor=2.0)):
        jscaling = None if scaling is None else jllama.RopeScaling(**dataclasses.asdict(scaling))
        ref = jllama._scaled_rope_freqs(128, 500000.0, jscaling)
        out = tllama._scaled_rope_freqs(128, 500000.0, scaling)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_weight_bridge_round_trip():
    jcfg, _ = _configs(attention_bias=True)
    params = jllama.Llama(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree.map(np.asarray, params["params"])
    back = params_to_jax(params_from_jax(tree))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)
    tree["layer0"]["attn"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="layer0/attn/extra/kernel"):
        params_from_jax(tree)


def test_quantized_kernels_not_ported():
    """Quantized kernels do reach the port: each ``QuantTensor`` becomes
    int8 codes under the weight's name and fp32 scales beside it
    (``tests/test_torch_quant.py`` holds them to the JAX package)."""
    from tensorflowonspark_tpu.ops.quant import quantize_tree

    jcfg, _ = _configs()
    params = jllama.Llama(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    got = params_from_jax(quantize_tree(params["params"], min_size=1 << 14))
    assert got["layers.0.mlp.up_proj.weight"].dtype == torch.int8
    assert tuple(got["layers.0.mlp.up_proj.weight_scale"].shape) == (jcfg.intermediate_size, 1)


def test_unported_features_raise():
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tllama.Llama(dataclasses.replace(tcfg, num_experts=4), device="cpu")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tllama.Llama(dataclasses.replace(tcfg, remat=True, remat_policy="offload"), device="cpu")
    model = tllama.Llama(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A9b"):
        tllama.generate(model, torch.zeros(1, 4, dtype=torch.long), 2, mesh=object())
    from tensorflowonspark_tpu_torch.ops.attention import dot_product_attention

    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dot_product_attention(x, x, x, impl="ring")
