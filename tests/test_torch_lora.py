"""The port's LoRA adapters and banks against the JAX package's.

The factors are drawn once on the JAX side (``add_lora`` with a JAX key,
``b`` then set to seeded normals so that both factors train) and carried
into the port through ``models.convert``; the generators are not compared.
A tiny Llama (2 layers, fp32, attention ``xla``).

Tolerances. ``lora_apply`` / ``multi_lora_apply``: 1e-5 of the output's
rms (the same fp32 products summed in other orders). Logits: 1e-4
absolute / 1e-3 relative (as ``test_torch_llama.py``). ``merge_lora`` and
``select_adapter``: merged weights to 1e-6 absolute (one fp32 product
summed over the rank), slices exact. The train step (as
``test_torch_train.py``): adamw at lr 1e-3 with eps 1e-6 and fp32 moments,
3 steps; losses to 1e-5 relative, adapters to 1e-5 absolute / 1e-4
relative, every frozen leaf bit-unchanged.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.compute import TrainState as JTrainState
from tensorflowonspark_tpu.compute import build_train_step as jbuild_train_step
from tensorflowonspark_tpu.compute import optim as joptim
from tensorflowonspark_tpu.compute.mesh import make_mesh
from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu.ops import lora as jlora
from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step, optim
from tensorflowonspark_tpu_torch.compute.checkpoint import restore_checkpoint, save_checkpoint
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models.convert import params_from_jax, params_to_jax
from tensorflowonspark_tpu_torch.ops import lora as tlora

LOGIT_TOL = dict(rtol=1e-3, atol=1e-4)
RANK, SEQ, B = 4, 16, 3
LR, EPS, STEPS = 1e-3, 1e-6, 3


def _configs(**overrides):
    base = dict(hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=2,
                num_layers=2, max_seq_len=64, remat=False)
    base.update(overrides)
    jcfg = jllama.LlamaConfig.tiny(**base, dtype=jnp.float32, attention_impl="xla")
    tcfg = tllama.LlamaConfig.tiny(**base, dtype=torch.float32, attention_impl="xla")
    return jcfg, tcfg


def _is_node(x):
    return isinstance(x, (jlora.LoraTensor, jlora.MultiLoraTensor))


def _trained_b(tree, seed):
    """``b`` of every adapter set to seeded normals (a trained adapter)."""
    rng = np.random.default_rng(seed)

    def rule(x):
        if isinstance(x, jlora.LoraTensor):
            return x.replace(b=jnp.asarray(rng.normal(0, 0.05, x.b.shape), jnp.float32))
        return x

    return jax.tree.map(rule, tree, is_leaf=_is_node)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The JAX tiny Llama and weights for it, on the host (read-only): a
    port model's seeded initial weights through ``params_to_jax`` (flax's
    initializers draw from the same distributions; its ``init`` costs
    seconds op by op)."""
    jcfg, tcfg = _configs()
    return jllama.Llama(jcfg), params_to_jax(tllama.Llama(tcfg, device="cpu", seed=0))


@functools.lru_cache(maxsize=None)
def _apply_fn():
    jmodel, _ = _jax_params()
    return jax.jit(jmodel.apply)


def _jax_logits(tree, toks, ids=None):
    kw = {} if ids is None else {"adapter_ids": jnp.asarray(ids)}
    return np.asarray(_apply_fn()({"params": tree}, jnp.asarray(toks), **kw))


def _jax_lora(seed=0, alpha=None):
    _, tcfg = _configs()
    jmodel, params = _jax_params()
    lora = jlora.add_lora(params, RANK, jax.random.PRNGKey(1), alpha=alpha)
    return jmodel, params, jax.tree.map(np.asarray, _trained_b(lora, seed)), tcfg


def _port(tcfg, tree):
    model = tllama.Llama(tcfg, device="cpu")
    return model, tllama.adopt_params(model, params_from_jax(tree))


def _tokens(shape, seed=3):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.int32)


def test_lora_apply_and_multi_lora_apply_match_jax():
    rng = np.random.default_rng(0)
    base = rng.normal(0, 0.02, (48, 40)).astype(np.float32)  # (in, out)
    a = rng.normal(0, 0.1, (3, 48, RANK)).astype(np.float32)  # (K, in, r)
    b = rng.normal(0, 0.1, (3, RANK, 40)).astype(np.float32)
    x = rng.normal(size=(4, 5, 48)).astype(np.float32)
    ids = np.array([2, 0, 1, 2], np.int32)
    ref = np.asarray(jlora.multi_lora_apply(
        jnp.asarray(x), jlora.MultiLoraTensor(base=base, a=a, b=b, scale=0.5), jnp.asarray(ids)))
    bank = tlora.MultiLoraTensor(torch.tensor(base.T), torch.tensor(a.transpose(0, 2, 1)),
                                 torch.tensor(b.transpose(0, 2, 1)), 0.5)
    got = tlora.multi_lora_apply(torch.tensor(x), bank, torch.tensor(ids, dtype=torch.long))
    rms = np.sqrt(np.mean(ref**2))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * rms)
    for row, k in enumerate(ids):  # each row against its adapter alone, both packages
        one = tlora.LoraTensor(bank.base, bank.a[k], bank.b[k], 0.5)
        alone = tlora.lora_apply(torch.tensor(x[row:row + 1]), one)
        jone = jlora.lora_apply(jnp.asarray(x[row:row + 1]),
                                jlora.LoraTensor(base=base, a=a[k], b=b[k], scale=0.5))
        np.testing.assert_allclose(alone.numpy(), np.asarray(jone), rtol=0, atol=1e-5 * rms)
        np.testing.assert_allclose(got[row:row + 1].numpy(), alone.numpy(), rtol=0,
                                   atol=1e-5 * rms)


def test_adapted_llama_logits_match_jax():
    jmodel, _, lora, tcfg = _jax_lora(alpha=2.0 * RANK)
    model, own = _port(tcfg, lora)
    assert float(own["layers.0.attn.q_proj.weight_lora_scale"]) == 2.0
    assert tuple(own["layers.0.mlp.down_proj.weight_lora_a"].shape) == (RANK, 256)
    toks = _tokens((B, SEQ))
    ref = _jax_logits(lora, toks)
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


def test_merge_lora_and_select_adapter_match_jax():
    _, _, lora, tcfg = _jax_lora()
    want = params_from_jax(jlora.merge_lora(lora))
    got = tlora.merge_lora(params_from_jax(lora))
    assert set(got) == set(want) and not tlora.lora_names(got)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    other = _trained_b(lora, 1)
    jbank = jlora.multi_lora_bank([lora, other])
    bank = tlora.multi_lora_bank([params_from_jax(lora), params_from_jax(other)])
    assert tlora.bank_size(bank) == jlora.bank_size(jbank) == 3
    for k in range(3):
        want = params_from_jax(jlora.select_adapter(jbank, k))
        got = tlora.select_adapter(bank, k)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(), err_msg=name)
    assert not tlora.select_adapter(bank, 0)["layers.1.attn.v_proj.weight_lora_b"].any()


def test_bank_rows_route_to_their_adapter():
    jmodel, _, lora, tcfg = _jax_lora()
    other = _trained_b(lora, 1)
    jbank = jlora.multi_lora_bank([lora, other])
    model, _ = _port(tcfg, jbank)
    toks = _tokens((3, SEQ))
    ids = np.array([1, 2, 0], np.int32)
    ref = _jax_logits(jbank, toks, ids)
    with torch.no_grad():
        got = model(torch.from_numpy(toks), adapter_ids=torch.tensor(ids, dtype=torch.long))
        default = model(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), ref, **LOGIT_TOL)
    base_model, _ = _port(tcfg, jax.tree.map(lambda x: x, jlora.merge_lora(
        jlora.select_adapter(jbank, 0))))
    for row, k in enumerate(ids):  # a row routed to k equals adapter k alone
        alone, _ = _port(tcfg, jlora.select_adapter(jbank, int(k)))
        with torch.no_grad():
            want = alone(torch.from_numpy(toks[row:row + 1]))
        np.testing.assert_allclose(got[row:row + 1].numpy(), want.numpy(), **LOGIT_TOL)
    with torch.no_grad():  # None routes every row to slot 0: the base model
        np.testing.assert_allclose(default.numpy(), base_model(torch.from_numpy(toks)).numpy(),
                                   **LOGIT_TOL)


def _refusals():
    _, params, lora, _ = _jax_lora()
    other_rank = jlora.add_lora(params, RANK * 2, jax.random.PRNGKey(2))
    other_scale = jlora.add_lora(params, RANK, jax.random.PRNGKey(2), alpha=1.0)
    fewer = {k: v for k, v in lora.items() if k != "layer1"}
    shifted = jax.tree.map(lambda x: x + 1.0, params)
    other_base = jlora.add_lora(shifted, RANK, jax.random.PRNGKey(2))
    return {
        "empty": ([], "at least one adapter"),
        "structure": ([lora, fewer], "different tree structure"),
        "rank": ([lora, other_rank], "rank/scale mismatch"),
        "scale": ([lora, other_scale], "rank/scale mismatch"),
        "base": ([lora, other_base], "different base weight"),
    }


@pytest.mark.parametrize("case", ["empty", "structure", "rank", "scale", "base"])
def test_bank_builder_refuses_as_jax_does(case):
    trees, match = _refusals()[case]
    with pytest.raises(ValueError, match=match):
        jlora.multi_lora_bank(trees)
    with pytest.raises(ValueError, match=match):
        tlora.multi_lora_bank([params_from_jax(t) for t in trees])


def test_bank_builder_refuses_other_targets():
    """Adapters on other leaves: the JAX package's tree-structure check
    lets them through (a LoraTensor and a plain kernel are both leaves of
    its flattening) and fails later on a missing field; the port refuses
    them by name."""
    _, params, lora, _ = _jax_lora()
    fewer = jlora.add_lora(params, RANK, jax.random.PRNGKey(2), targets=("q_proj",))
    with pytest.raises(AttributeError):
        jlora.multi_lora_bank([lora, fewer])
    with pytest.raises(ValueError, match="different tree structure"):
        tlora.multi_lora_bank([params_from_jax(lora), params_from_jax(fewer)])


class _Recorder:
    """Wraps a transformation and records the names each update receives."""

    def __init__(self, tx):
        self.seen = []
        self.tx = optim.GradientTransformation(tx.init, self._update, tx.frozen)
        self._inner = tx

    def _update(self, updates, state, params=None):
        self.seen.append(sorted(updates))
        return self._inner.update(updates, state, params)


@functools.lru_cache(maxsize=None)
def _jax_lora_steps():
    """The JAX package's LoRA fine-tune: its step with its lora_optimizer,
    STEPS steps from ``_jax_lora()``'s factors (losses, final params)."""
    jmodel, _, lora, _ = _jax_lora()
    tokens = _tokens((4, SEQ + 1))
    jtx = jlora.lora_optimizer(joptim.adamw(LR, eps=EPS), lora)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jloss = jllama.llama_loss_fn(jmodel)
    jstep = jbuild_train_step(lambda p, bt: jloss(p, bt["tokens"]), jtx, mesh)
    # a device copy of its own: the step donates its state
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, lora), jtx)
    losses = []
    for _ in range(STEPS):
        jstate, val = jstep(jstate, {"tokens": tokens})
        losses.append(float(val))
    return losses, jax.tree.map(np.asarray, jstate.params)


@pytest.mark.parametrize("remat", [False, True])
def test_lora_train_step_matches_jax_and_freezes_the_base(remat):
    """The port with and without remat (which recomputes each block from
    the module's own parameters in backward) against the JAX step."""
    ref_losses, ref = _jax_lora_steps()
    _, _, lora, _ = _jax_lora()
    jcfg, tcfg = _configs(remat=remat)
    tokens = _tokens((4, SEQ + 1))
    model, own = _port(tcfg, lora)
    before = {n: t.detach().clone() for n, t in own.items()}
    rec = _Recorder(tlora.lora_optimizer(adamw(LR, eps=EPS), own))
    loss = tllama.llama_loss_fn(model)
    step = build_train_step(lambda p, bt: loss(p, bt["tokens"]), rec.tx, device="cpu")
    state = TrainState.create(own, rec.tx)
    losses = []
    for _ in range(STEPS):
        state, val = step(state, {"tokens": tokens})
        losses.append(val.item())
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    trained = [n for n, lab in tlora.lora_labels(own).items() if lab == "train"]
    assert len(trained) == 2 * 7 * jcfg.num_layers
    # gradients: one tensor a trained leaf, none for a frozen one
    assert rec.seen == [sorted(trained)] * STEPS
    frozen = [n for n in own if n not in trained]
    assert all(own[n].grad is None and not own[n].requires_grad for n in frozen)
    # moments: the adapters' alone
    adam = state.opt_state.inner_states["train"][0]
    assert sorted(adam.mu) == sorted(adam.nu) == sorted(trained)
    assert state.opt_state.inner_states["freeze"] == optim.EmptyState()
    for n in frozen:
        assert torch.equal(own[n], before[n]), n
    got = params_to_jax(own)
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref, is_leaf=_is_node)[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        node = got
        for k in keys:
            node = node[k]
        if isinstance(leaf, jlora.LoraTensor):
            for field in ("a", "b"):
                np.testing.assert_allclose(node[field], np.asarray(getattr(leaf, field)),
                                           rtol=1e-4, atol=1e-5, err_msg=f"{keys}/{field}")
            np.testing.assert_array_equal(node["base"], np.asarray(leaf.base))
        else:
            np.testing.assert_array_equal(node, np.asarray(leaf))


@pytest.mark.parametrize("bank", [False, True])
def test_rewrap_lora_after_a_checkpoint_round_trip(tmp_path, bank):
    jmodel, _, lora, tcfg = _jax_lora()
    tree = jlora.multi_lora_bank([lora, _trained_b(lora, 1)]) if bank else lora
    params = params_from_jax(tree)
    path = save_checkpoint(os.path.join(tmp_path, "ckpt"), {"params": params})
    restored = restore_checkpoint(path)["params"]
    assert set(restored) == set(params)
    got = tlora.rewrap_lora(restored, 0.5)
    assert all(float(got[n + tlora.S]) == 0.5 for n in tlora.lora_names(got))
    # the JAX side: its checkpoint form, rewrapped at the same scale
    ref_tree = jlora.rewrap_lora(params_to_jax(params), 0.5)
    kind = jlora.MultiLoraTensor if bank else jlora.LoraTensor
    assert isinstance(ref_tree["layer0"]["attn"]["q_proj"]["kernel"], kind)
    model = tllama.Llama(tcfg, device="cpu")
    tllama.adopt_params(model, got)
    toks = _tokens((2, SEQ))
    ids = np.array([1, 2], np.int32) if bank else None
    ref = _jax_logits(ref_tree, toks, ids)
    with torch.no_grad():
        out = model(torch.from_numpy(toks),
                    adapter_ids=None if ids is None else torch.tensor(ids, dtype=torch.long))
    np.testing.assert_allclose(out.numpy(), ref, **LOGIT_TOL)
    # a scale of 0 turns the adapters off: the base model
    off = tlora.rewrap_lora(restored, 0.0)
    model_off = tllama.Llama(tcfg, device="cpu")
    tllama.adopt_params(model_off, off)
    plain = tllama.Llama(tcfg, device="cpu")
    tllama.adopt_params(plain, {n: t for n, t in params.items()
                                if not any(n.endswith(s) for s in (tlora.A, tlora.B, tlora.S))})
    with torch.no_grad():
        np.testing.assert_allclose(model_off(torch.from_numpy(toks)).numpy(),
                                   plain(torch.from_numpy(toks)).numpy(), **LOGIT_TOL)


def test_add_lora_draws_from_the_generator_and_starts_as_a_no_op():
    _, tcfg = _configs()
    model = tllama.Llama(tcfg, device="cpu", seed=4)
    own = dict(model.named_parameters())
    a1 = tlora.add_lora(own, RANK, torch.Generator().manual_seed(5))
    a2 = tlora.add_lora(own, RANK, torch.Generator().manual_seed(5))
    names = tlora.lora_names(a1)
    assert len(names) == 7 * tcfg.num_layers and all(a1[n] is own[n] for n in names)
    assert all(torch.equal(a1[n + tlora.A], a2[n + tlora.A]) for n in names)
    assert not any(a1[n + tlora.B].any() for n in names)
    toks = torch.from_numpy(_tokens((2, SEQ)))
    with torch.no_grad():
        want = model(toks)
        tllama.adopt_params(model, a1)
        np.testing.assert_array_equal(model(toks).numpy(), want.numpy())
    with pytest.raises(ValueError, match="exceeds min dim"):
        tlora.add_lora(own, 100, torch.Generator())
    with pytest.raises(ValueError, match="nothing to adapt"):
        tlora.add_lora(own, RANK, torch.Generator(), targets=("nope",))
    with pytest.raises(ValueError, match="merge_lora it first"):
        from tensorflowonspark_tpu_torch.ops.quant import quantize_tree

        quantize_tree(a1)


def test_dataclass_views_keep_the_shapes():
    w = tlora.MultiLoraTensor(torch.zeros(6, 4), torch.zeros(3, 2, 4), torch.zeros(3, 6, 2))
    assert w.n_adapters == 3 and tuple(w.shape) == (6, 4) and w.dtype == torch.float32
    assert dataclasses.replace(w, scale=2.0).scale == 2.0
