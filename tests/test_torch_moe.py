"""The port's mixture-of-experts (``parallel/moe.py`` and the MoE Llama)
against the JAX package's.

Weights are drawn once on the JAX side and carried into the port through
``models.convert``; inputs come from numpy seeds. Widths are kept with
``d != f`` so that a bank carried across on a wrong axis cannot pass.

Tolerances. Routing (dispatch, combine, aux) in fp32: dispatch exact,
combine and aux to 1e-6 absolute (the same softmax, summed in another
order). ``MoEMLP`` output and parameter gradients in fp32: 1e-5 absolute /
1e-4 relative, as ``tests/test_parallel.py::TestMoE`` holds the JAX module
to its dense reference. Logits: 1e-4 absolute / 1e-3 relative (as
``test_torch_llama.py``); losses 1e-5 relative. The train step (as
``test_torch_lora.py``): adamw at lr 1e-3, eps 1e-6, 3 steps; losses to
1e-5 relative, params to 1e-5 absolute / 1e-4 relative. Decode: tokens
equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.compute import TrainState as JTrainState
from tensorflowonspark_tpu.compute import build_train_step as jbuild_train_step
from tensorflowonspark_tpu.compute import layout as jlayout
from tensorflowonspark_tpu.compute import optim as joptim
from tensorflowonspark_tpu.compute.mesh import make_mesh
from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu.parallel import moe as jmoe
from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step, optim
from tensorflowonspark_tpu_torch.compute import layout as tlayout
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models.convert import jax_leaf, params_from_jax, params_to_jax
from tensorflowonspark_tpu_torch.parallel import moe as tmoe
from tensorflowonspark_tpu_torch.serving import ContinuousBatcher

LOGIT_TOL = dict(rtol=1e-3, atol=1e-4)
MLP_TOL = dict(rtol=1e-4, atol=1e-5)
E, K, D, F_, SEQ = 4, 2, 64, 96, 16
LR, EPS, STEPS = 1e-3, 1e-6, 3


def _configs(**overrides):
    base = dict(hidden_size=D, intermediate_size=F_, num_heads=4, num_kv_heads=2,
                num_layers=1, max_seq_len=64, remat=False, num_experts=E, moe_top_k=K)
    base.update(overrides)
    jcfg = jllama.LlamaConfig.tiny(**base, dtype=jnp.float32, attention_impl="xla")
    tcfg = tllama.LlamaConfig.tiny(**base, dtype=torch.float32, attention_impl="xla")
    return jcfg, tcfg


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_llama(**overrides):
    jcfg, _ = _configs(**overrides)
    model = jllama.Llama(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _port(tcfg, jparams):
    model = tllama.Llama(tcfg, device="cpu")
    own = tllama.adopt_params(model, params_from_jax(jparams))
    return model, own


def _mlp_cfgs(cap):
    j = jmoe.MoEConfig(num_experts=E, top_k=K, capacity_factor=cap, hidden_size=D,
                       intermediate_size=F_, dtype=jnp.float32)
    t = tmoe.MoEConfig(num_experts=E, top_k=K, capacity_factor=cap, hidden_size=D,
                       intermediate_size=F_, dtype=torch.float32)
    return j, t


# router logits (T=6, E=4): "tie" has equal top probabilities in rows 0, 2
# and 5 (lax.top_k takes the lower index first)
_TIE = np.array([[1.0, 1.0, 0.0, -1.0], [0.5, 2.0, 2.0, 0.1], [3.0, 0.0, 3.0, 3.0],
                 [0.0, 0.0, 0.0, 0.0], [-1.0, 2.0, -1.0, 2.0], [0.2, 0.2, 0.2, 0.9]],
                np.float32)


@pytest.mark.parametrize("case", ["no_drops", "drops", "tie"])
def test_top_k_routing_matches_jax(case):
    """Dispatch and combine element for element, and the aux loss: with
    room for every assignment, with capacity 0.5 (drops, where the
    token-major priority decides which), and with tied probabilities."""
    cap = {"no_drops": 64.0, "drops": 0.5, "tie": 64.0}[case]
    jcfg, tcfg = _mlp_cfgs(cap)
    logits = _TIE if case == "tie" else np.random.default_rng(3).normal(
        size=(24, E)).astype(np.float32)
    t = logits.shape[0]
    jd, jc, ja = jax.jit(jmoe.top_k_routing, static_argnums=(1, 2))(jnp.asarray(logits), jcfg, t)
    td, tc, ta = tmoe.top_k_routing(torch.tensor(logits), tcfg, t)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)
    kept = int(np.asarray(jd).sum())
    assert (kept < t * K) == (case == "drops")


def test_routing_priority_is_token_major():
    """Two tokens that both pick experts 0 and 1 at capacity 2 (top_k 2):
    token 0's two choices take slot 0 of each, token 1's slot 1; a third
    token is dropped from both, whatever its rank order."""
    _, tcfg = _mlp_cfgs(0.75)  # C = max(ceil(3*2*0.75/4), 2) = 2
    logits = torch.tensor([[3.0, 2.0, 0.0, 0.0], [2.0, 3.0, 0.0, 0.0], [3.0, 2.5, 0.0, 0.0]])
    r = tmoe.route(logits, tcfg, 3)
    assert r.capacity == 2
    assert r.expert.tolist() == [[0, 1], [1, 0], [0, 1]]
    assert r.slot.tolist() == [[0, 0], [1, 1], [2, 2]]
    assert r.kept.tolist() == [[True, True], [True, True], [False, False]]


def _mlp_pair(cap):
    jcfg, tcfg = _mlp_cfgs(cap)
    x = np.random.default_rng(1).normal(size=(2, 8, D)).astype(np.float32)
    jmod = jmoe.MoEMLP(jcfg)
    jparams = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tmod = tmoe.MoEMLP(tcfg, device="cpu")
    with torch.no_grad():
        tmod.router.weight.copy_(torch.tensor(np.asarray(jparams["router"]["kernel"]).T))
        for n in ("w_gate", "w_up", "w_down"):
            getattr(tmod, n).copy_(torch.tensor(np.asarray(jparams[n])))
    return jmod, jparams, tmod, x


@pytest.mark.parametrize("cap", [64.0, 0.5], ids=["no_drops", "drops"])
def test_moe_mlp_output_and_gradients_match_jax(cap):
    jmod, jparams, tmod, x = _mlp_pair(cap)
    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jobj(p):
        out, state = jmod.apply({"params": p}, jnp.asarray(x), mutable=["losses"])
        aux = jax.tree.leaves(state["losses"])[0]
        return jnp.sum(out * w) + jnp.sum(aux), (out, aux)

    (_, (jout, jaux)), jgrad = jax.jit(jax.value_and_grad(jobj, has_aux=True))(jparams)
    tout, aux = tmod(torch.tensor(x))
    ((tout * torch.tensor(w)).sum() + aux.loss).backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **MLP_TOL)
    np.testing.assert_allclose(float(aux.loss.detach()), float(jaux), rtol=1e-6)
    assert int(aux.assigned) == x.shape[0] * x.shape[1] * K
    assert tuple(aux.dropped.shape) == x.shape[:2]
    assert (int(aux.dropped.sum()) > 0) == (cap < 1)
    np.testing.assert_allclose(tmod.router.weight.grad.numpy().T,
                               np.asarray(jgrad["router"]["kernel"]), **MLP_TOL)
    for n in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(getattr(tmod, n).grad.numpy(), np.asarray(jgrad[n]),
                                   **MLP_TOL, err_msg=n)


def test_moe_mlp_in_bf16_rounds_as_jax_does():
    """bf16 expert products with bf16-rounded gates: the output within two
    bf16 steps of the output's largest magnitude (products summed in other
    orders), dropped tokens' zeros exact in both."""
    jmod, jparams, tmod, x = _mlp_pair(0.5)
    jcfg, tcfg = _mlp_cfgs(0.5)
    jmod = jmoe.MoEMLP(dataclasses.replace(jcfg, dtype=jnp.bfloat16))
    tmod.cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jout = np.asarray(jax.jit(lambda p, v: jmod.apply({"params": p}, v, mutable=["losses"]))(
        jparams, jnp.asarray(x))[0], np.float32)
    with torch.no_grad():
        tout = tmod(torch.tensor(x))[0].float().numpy()
    assert np.abs(tout - jout).max() <= 2 * 2**-8 * np.abs(jout).max()
    np.testing.assert_array_equal(tout == 0, jout == 0)


def test_moe_llama_logits_and_loss_match_jax():
    jmodel, jparams = _jax_llama()
    _, tcfg = _configs()
    model, own = _port(tcfg, jparams)
    toks = _tokens((2, SEQ + 1))
    jlogits = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(jparams,
                                                                   jnp.asarray(toks[:, :-1]))
    with torch.no_grad():
        tlogits, auxes = model(torch.tensor(toks[:, :-1], dtype=torch.long), return_aux=True)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **LOGIT_TOL)
    assert len(auxes) == tcfg.num_layers
    jloss = float(jax.jit(jllama.llama_loss_fn(jmodel))(jparams, jnp.asarray(toks)))
    jce = float(jllama.cross_entropy_loss(jlogits, jnp.asarray(toks[:, 1:])))
    with torch.no_grad():
        tloss = float(tllama.llama_loss_fn(model)(own, torch.tensor(toks, dtype=torch.long)))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert jloss - jce > 1e-3  # the aux loss is in it


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_loss_under_remat_counts_the_aux_loss_once(policy):
    """Under remat the blocks are recomputed in backward; the loss (chunked
    vocabulary too) and its gradients equal the JAX package's."""
    jmodel, jparams = _jax_llama()
    _, tcfg = _configs(remat=True, remat_policy=policy)
    model, own = _port(tcfg, jparams)
    toks = _tokens((2, SEQ + 1), seed=4)
    jval, jgrad = jax.jit(jax.value_and_grad(jllama.llama_loss_fn(jmodel)))(jparams,
                                                                            jnp.asarray(toks))
    for chunk in (None, 8):
        for p in own.values():
            p.grad = None
        loss = tllama.llama_loss_fn(model, logit_chunk=chunk)(own, torch.tensor(
            toks, dtype=torch.long))
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
        got = params_to_jax({n: p.grad for n, p in own.items()})
        for n in ("router", "w_gate", "w_down"):
            ref = jgrad["layer0"]["mlp"][n]
            ref = ref["kernel"] if n == "router" else ref
            got_n = got["layer0"]["mlp"][n]
            got_n = got_n["kernel"] if n == "router" else got_n
            np.testing.assert_allclose(got_n, np.asarray(ref), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{chunk}/{n}")


def test_convert_round_trips_moe_leaves():
    """``d != f``: the router is transposed like a Dense kernel, the banks
    keep their axes both ways."""
    _, jparams = _jax_llama()
    port = params_from_jax(jparams)
    assert tuple(port["layers.0.mlp.router.weight"].shape) == (E, D)
    assert tuple(port["layers.0.mlp.w_gate"].shape) == (E, D, F_)
    assert tuple(port["layers.0.mlp.w_down"].shape) == (E, F_, D)
    np.testing.assert_array_equal(port["layers.0.mlp.w_up"].numpy(),
                                  jparams["layer0"]["mlp"]["w_up"])
    back = params_to_jax(port)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == len(port)
    for path, leaf in flat_j:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
    assert jax_leaf("layers.0.mlp.w_down", (E, F_, D)) == ("layer0/mlp/w_down", (E, F_, D),
                                                          (0, 1, 2))


def test_layout_tables_take_the_expert_banks():
    """``expert_bank_spec``, the 'moe' table and the 'llama' table's 3-D
    rules as the JAX package's, and the ZeRO state spec of a bank."""
    for name in ("layer0/mlp/w_gate", "layer0/mlp/w_up", "layer0/mlp/w_down"):
        assert tlayout.expert_bank_spec(name) == tuple(jlayout.expert_bank_spec(name))
        assert tmoe.moe_expert_bank_spec(name) == tuple(jmoe.moe_expert_bank_spec(name))
        assert tlayout.get_layout("llama").spec(name, (E, D, F_)) == tuple(
            jlayout.get_layout("llama").spec(name, (E, D, F_)))
    jmod, jparams, tmod, _ = _mlp_pair(64.0)
    jmesh = make_mesh({"data": 2, "expert": 4}, devices=jax.devices()[:8])
    want = jmoe.moe_param_shardings(jparams, jmesh)
    sizes = dict(jmesh.shape)
    got = tlayout.param_specs(dict(tmod.named_parameters()), sizes, "moe", tmoe._leaf)

    def placed(spec):  # the axes that shard a dim on this mesh, trailing Nones dropped
        axes = [ax if ax is not None and sizes.get(ax, 1) > 1 else None for ax in spec]
        while axes and axes[-1] is None:
            axes.pop()
        return tuple(axes)

    assert placed(got["w_gate"]) == placed(want["w_gate"].spec) == ("expert",)
    assert placed(got["w_down"]) == placed(want["w_down"].spec)
    assert placed(got["router.weight"]) == placed(want["router"]["kernel"].spec) == ()
    sizes = {"data": 2, "fsdp": 2, "pipe": 1, "expert": 1, "model": 1, "seq": 1}
    base = tlayout.get_layout("llama").spec("layer0/mlp/w_gate", (E, D, F_), sizes)
    got = tlayout.optimizer_state_spec("0/mu/layer0/mlp/w_gate", (E, D, F_), base, sizes)
    want = jlayout.optimizer_state_spec("0/mu/layer0/mlp/w_gate", (E, D, F_),
                                        jlayout.P(*base), sizes)
    assert got == tuple(want)


@functools.lru_cache(maxsize=None)
def _jax_steps():
    jmodel, jparams = _jax_llama()
    tokens = _tokens((4, SEQ + 1), seed=5)
    jtx = joptim.adamw(LR, eps=EPS)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jloss = jllama.llama_loss_fn(jmodel)
    jstep = jbuild_train_step(lambda p, bt: jloss(p, bt["tokens"]), jtx, mesh)
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, jparams), jtx)
    losses = []
    for _ in range(STEPS):
        jstate, val = jstep(jstate, {"tokens": tokens})
        losses.append(float(val))
    return losses, jax.tree.map(np.asarray, jstate.params)


def test_train_step_matches_jax():
    ref_losses, ref = _jax_steps()
    _, jparams = _jax_llama()
    _, tcfg = _configs()
    model, own = _port(tcfg, jparams)
    loss = tllama.llama_loss_fn(model)
    tx = adamw(LR, eps=EPS)
    step = build_train_step(lambda p, bt: loss(p, bt["tokens"]), tx, device="cpu")
    state = TrainState.create(own, tx)
    tokens = torch.tensor(_tokens((4, SEQ + 1), seed=5), dtype=torch.long)
    losses = []
    for _ in range(STEPS):
        state, val = step(state, {"tokens": tokens})
        losses.append(val.item())
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    got = params_to_jax(state.params)
    for n in ("router", "w_gate", "w_up", "w_down"):
        g, r = got["layer0"]["mlp"][n], ref["layer0"]["mlp"][n]
        if n == "router":
            g, r = g["kernel"], r["kernel"]
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5, err_msg=n)


def test_frozen_router_takes_no_gradient():
    """A router frozen by ``multi_transform``/``set_to_zero``: no gradient,
    bit-unchanged; the 3-D banks train and get their moments."""
    _, jparams = _jax_llama()
    _, tcfg = _configs()
    model, own = _port(tcfg, jparams)
    labels = {n: "freeze" if ".router." in n else "train" for n in own}
    tx = optim.multi_transform({"train": adamw(LR, eps=EPS), "freeze": optim.set_to_zero()},
                               labels)
    loss = tllama.llama_loss_fn(model)
    step = build_train_step(lambda p, bt: loss(p, bt["tokens"]), tx, device="cpu")
    state = TrainState.create(own, tx)
    before = {n: t.detach().clone() for n, t in own.items()}
    state, _ = step(state, {"tokens": torch.tensor(_tokens((2, SEQ + 1)), dtype=torch.long)})
    for n, t in own.items():
        if ".router." in n:
            assert t.grad is None and torch.equal(t, before[n]), n
        elif n.endswith(".w_gate"):
            assert not torch.equal(t, before[n]), n
    adam = state.opt_state.inner_states["train"][0]
    assert tuple(adam.mu["layers.0.mlp.w_down"].shape) == (E, F_, D)


def test_generate_matches_jax():
    """Greedy decode of the MoE Llama, batch 3 with mixed lengths: prefill
    routes the padded batch, each step the batch's tokens."""
    jmodel, jparams = _jax_llama()
    _, tcfg = _configs()
    model, _ = _port(tcfg, jparams)
    prompt = _tokens((3, 8), seed=6)
    lengths = np.array([8, 5, 3], np.int32)
    want = jllama.generate(jmodel, jparams, jnp.asarray(prompt), 6, prompt_lengths=lengths)
    got = tllama.generate(model, torch.tensor(prompt, dtype=torch.long), 6,
                          prompt_lengths=lengths)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_composes_with_moe():
    """The JAX package's ``test_engine_composes_with_moe``: a routed-expert
    Llama decodes through the continuous engine and matches ``generate``
    on the same weights (and the JAX package's ``generate``)."""
    jmodel, jparams = _jax_llama()
    _, tcfg = _configs()
    model, _ = _port(tcfg, jparams)
    eng = ContinuousBatcher(model, slots=2, prompt_widths=(8,))
    try:
        got = eng.submit([1, 2, 3], 5)
    finally:
        eng.close()
    want = tllama.generate(model, torch.tensor([[1, 2, 3]]), 5)[0].tolist()
    assert got == want
    assert want == np.asarray(jllama.generate(jmodel, jparams, jnp.asarray([[1, 2, 3]]), 5))[
        0].tolist()
