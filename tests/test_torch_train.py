"""The port's optimizer and train step against the JAX package's.

The tiny fp32 Llama of test_torch_llama.py, its JAX initial weights loaded
into the port, trains 5 steps on both sides from one numpy batch: JAX
``build_train_step`` on a one-device mesh, the port's on the CPU.

Adam's normalized step turns a rounding difference δg of a gradient near
0 into an update difference up to lr·|δg|/(|g| + eps): with the default
eps of 1e-8 one element in 1e5 moved by 8e-5 here. The trajectories
therefore run with eps = 1e-6 (the default is held to JAX exactly in
test_optimizer_updates_match_jax). Tolerances: the loss trajectory to 1e-5
relative; final params to 1e-5 absolute / 1e-4 relative with fp32
moments; with bf16 moments 2e-4 absolute, since a moment whose fp32
values differ in the last bits may round to neighbouring bf16 values
(2^-8 relative) on the two sides.
"""

import dataclasses

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
from tensorflowonspark_tpu_torch.compute import (
    TrainState,
    adamw,
    build_bn_train_step,
    build_eval_step,
    build_train_step,
    mixed_precision_adamw,
    sgd,
)
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models.convert import params_from_jax, params_to_jax

SEQ = 64
STEPS = 5
LR = 1e-3
EPS = 1e-6


def _setup(seed=0):
    common = dict(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
                  num_layers=2, max_seq_len=SEQ, remat=False)
    jcfg = jllama.LlamaConfig.tiny(**common, dtype=jnp.float32, attention_impl="xla")
    tcfg = tllama.LlamaConfig.tiny(**common, dtype=torch.float32, attention_impl="flash")
    jmodel = jllama.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, SEQ), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    tmodel = tllama.Llama(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(params))
    tokens = np.random.default_rng(seed).integers(0, 256, size=(4, SEQ + 1)).astype(np.int32)
    return jmodel, params, tmodel, tokens


def _run_jax(jmodel, params, tokens, tx):
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    loss = jllama.llama_loss_fn(jmodel)
    step = jbuild_train_step(lambda p, bt: loss(p, bt["tokens"]), tx, mesh)
    state = JTrainState.create(jax.tree.map(jnp.asarray, params), tx)
    losses = []
    for _ in range(STEPS):
        state, val = step(state, {"tokens": tokens})
        losses.append(float(val))
    return losses, jax.tree.map(np.asarray, state.params)


def _run_port(tmodel, tokens, tx):
    loss = tllama.llama_loss_fn(tmodel)
    step = build_train_step(lambda p, bt: loss(p, bt["tokens"]), tx, device="cpu")
    state = TrainState.create(tmodel.named_parameters(), tx)
    losses = []
    for _ in range(STEPS):
        state, val = step(state, {"tokens": tokens})
        losses.append(val.item())
    assert state.step == STEPS
    return losses, params_to_jax(tmodel)


def _assert_trees_close(tree, ref, **tol):
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_allclose(flat[path], leaf, err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize(
    "moments,tol",
    [("fp32", dict(rtol=1e-4, atol=1e-5)), ("bf16", dict(rtol=1e-4, atol=2e-4))],
)
def test_train_trajectory_matches_jax(moments, tol):
    jmodel, params, tmodel, tokens = _setup()
    jdt, tdt = (None, None) if moments == "fp32" else (jnp.bfloat16, torch.bfloat16)
    ref_losses, ref_params = _run_jax(
        jmodel, params, tokens, joptim.adamw(LR, eps=EPS, moment_dtype=jdt)
    )
    losses, out_params = _run_port(tmodel, tokens, adamw(LR, eps=EPS, moment_dtype=tdt))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    _assert_trees_close(out_params, ref_params, **tol)


def _toy(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(6, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(4)]
    return params, grads


@pytest.mark.parametrize("kind", ["adamw", "adamw_bf16", "adamw_schedule", "mixed_bf16"])
def test_optimizer_updates_match_jax(kind):
    """Four updates of each transformation from the same gradients."""
    import optax

    params, grads = _toy()
    sched_j = lambda c: 1e-2 / (1.0 + c)  # noqa: E731
    sched_t = lambda c: 1e-2 / (1.0 + c.float())  # noqa: E731
    jtx, ttx = {
        "adamw": (joptim.adamw(1e-2), adamw(1e-2)),
        "adamw_bf16": (joptim.adamw(1e-2, moment_dtype=jnp.bfloat16),
                       adamw(1e-2, moment_dtype=torch.bfloat16)),
        "adamw_schedule": (joptim.adamw(sched_j), adamw(sched_t)),
        "mixed_bf16": (joptim.mixed_precision_adamw(1e-2), mixed_precision_adamw(1e-2)),
    }[kind]
    narrow = kind == "mixed_bf16"
    jp = {k: jnp.asarray(v, jnp.bfloat16 if narrow else jnp.float32) for k, v in params.items()}
    tp = {k: torch.tensor(v, dtype=torch.bfloat16 if narrow else torch.float32)
          for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    from tensorflowonspark_tpu_torch.compute.optim import apply_updates

    for g in grads:
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        apply_updates(tp, tu)
    for k in params:
        np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                                   rtol=1e-5, atol=1e-6)
    state = ts if narrow else ts[0]  # adamw chains: adam state first
    assert int(state.count) == len(grads)


@pytest.mark.parametrize("momentum,nesterov", [(None, False), (0.9, False), (0.9, True)])
def test_sgd_matches_optax(momentum, nesterov):
    """Four updates of ``sgd`` and ``optax.sgd`` from the same gradients,
    a constant and a scheduled learning rate; the trace is optax's state."""
    import optax

    params, grads = _toy(1)
    for jlr, tlr in ((0.1, 0.1), (lambda c: 0.1 / (1.0 + c), lambda c: 0.1 / (1.0 + c.float()))):
        jtx = optax.sgd(jlr, momentum=momentum, nesterov=nesterov)
        ttx = sgd(tlr, momentum=momentum, nesterov=nesterov)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        tp = {k: torch.tensor(v) for k, v in params.items()}
        js, ts = jtx.init(jp), ttx.init(tp)
        from tensorflowonspark_tpu_torch.compute.optim import apply_updates

        for g in grads:
            ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
            jp = optax.apply_updates(jp, ju)
            tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
            apply_updates(tp, tu)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
        if momentum is not None:
            for k in params:
                np.testing.assert_allclose(ts[0].trace[k].numpy(), np.asarray(js[0].trace[k]),
                                           rtol=1e-6, atol=1e-6)


def test_bn_train_step_threads_batch_stats():
    """``build_bn_train_step`` hands the loss the batch_stats it is given,
    returns the loss's new ones, and updates the params in place once."""
    params = {"w": torch.ones(3)}
    seen = []

    def loss_fn(p, stats, batch):
        seen.append(stats["m"].clone())
        return (p["w"] * batch).sum(), {"m": stats["m"] + 1}

    tx = sgd(0.5)
    step = build_bn_train_step(loss_fn, tx, device="cpu")
    state = TrainState.create(params, tx)
    stats = {"m": torch.zeros(2)}
    for _ in range(2):
        state, stats, loss = step(state, stats, torch.tensor([1.0, 2.0, 3.0]))
    assert state.step == 2 and not loss.requires_grad
    assert [s.tolist() for s in seen] == [[0.0, 0.0], [1.0, 1.0]]
    torch.testing.assert_close(stats["m"], torch.full((2,), 2.0))
    torch.testing.assert_close(state.params["w"], torch.tensor([0.0, -1.0, -2.0]))


def test_weighted_accumulation_matches_full_batch():
    """accum_steps=2 with the packed valid count as weight reproduces one
    full-batch step of the packed, masked loss, though the microbatches
    hold very different numbers of valid tokens."""
    _, params, _, tokens = _setup(seed=2)
    seg = np.zeros(tokens.shape, np.int32)
    seg[0, :] = 1
    seg[1, :60] = 1
    seg[2, :8] = 1
    seg[3, :20] = 2
    batch = {"tokens": tokens, "segment_ids": seg}
    results = []
    for accum in (1, 2):
        tcfg = tllama.LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_heads=4,
                                       num_kv_heads=2, max_seq_len=SEQ, remat=False,
                                       dtype=torch.float32, attention_impl="flash")
        model = tllama.Llama(tcfg, device="cpu")
        model.load_state_dict(params_from_jax(params))
        loss = tllama.llama_loss_fn(model)
        tx = adamw(LR, eps=EPS)
        step = build_train_step(
            lambda p, bt: loss(p, bt["tokens"], bt["segment_ids"]), tx, device="cpu",
            accum_steps=accum,
            batch_weight_fn=lambda bt: tllama.packed_valid_count(bt["segment_ids"]),
        )
        state, val = step(TrainState.create(model.named_parameters(), tx), batch)
        results.append((val.item(), {n: p.detach().clone() for n, p in state.params.items()}))
    assert results[1][0] == pytest.approx(results[0][0], rel=1e-5)
    for n, p in results[0][1].items():
        torch.testing.assert_close(results[1][1][n], p, rtol=1e-5, atol=1e-5)


def test_eval_step_and_accum_errors():
    _, _, tmodel, tokens = _setup()
    loss = tllama.llama_loss_fn(tmodel)
    evaluate = build_eval_step(lambda p, bt: loss(p, bt["tokens"]), device="cpu")
    val = evaluate(dict(tmodel.named_parameters()), {"tokens": tokens})
    assert not val.requires_grad and torch.isfinite(val)
    with pytest.raises(ValueError, match="accum_steps"):
        build_train_step(lambda p, bt: loss(p, bt), adamw(), device="cpu", accum_steps=0)
    bad = build_train_step(lambda p, bt: loss(p, bt), adamw(), device="cpu", accum_steps=3)
    with pytest.raises(ValueError, match="not divisible"):
        bad(TrainState.create(tmodel.named_parameters(), adamw()), torch.from_numpy(tokens))


def test_remat_requires_own_params():
    _, _, tmodel, tokens = _setup()
    model = tllama.Llama(dataclasses.replace(tmodel.cfg, remat=True), device="cpu")
    foreign = {n: p.detach().clone() for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="own parameters"):
        tllama.llama_loss_fn(model)(foreign, torch.from_numpy(tokens))
