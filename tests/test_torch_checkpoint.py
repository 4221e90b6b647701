"""The port's checkpoints, and a tiny Llama trained through its cluster.

- ``compute/checkpoint.py``: a save → restore round trip is bit for bit
  (tolerance 0) for params, bf16 moments and the step; the three cases of
  ``checkpoint_complete``; an async save followed by an in-place step
  restores the values from before the step (tolerance 0); the manager's
  save interval and ``max_to_keep``; a restore into a target of another
  structure names the first difference.
- A tiny fp32 Llama trained 3 steps in a SPARK-mode node fed through
  ``DataFeed`` → ``DevicePrefetcher`` (CPU) gives the losses of the
  in-process ``build_train_step`` on the same batches (atol 1e-6), and its
  checkpoint, carried through ``models/convert.py:params_to_jax`` into the
  JAX package's ``Llama``, gives the port's logits (atol 1e-5, fp32).
- The port's ``examples/llama_fsdp.py`` ``main_fun`` runs two legs with
  ``--model-dir`` through ``tfcluster.run`` (two gloo nodes, CPU); the
  second resumes from the first's last step.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu_torch.cluster import tfcluster
from tensorflowonspark_tpu_torch.cluster.tfcluster import InputMode
from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step
from tensorflowonspark_tpu_torch.compute import checkpoint as ckpt_mod
from tensorflowonspark_tpu_torch.compute.checkpoint import (
    CheckpointManager,
    checkpoint_complete,
    chief_final_save,
    hydration_restore,
    restore_checkpoint,
    restore_latest,
    save_checkpoint,
)
from tensorflowonspark_tpu_torch.examples import llama_fsdp
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models.convert import params_to_jax
from tensorflowonspark_tpu_torch.utils.util import cpu_only_env

from tests import torch_cluster_fns

# CPU nodes share the host: one intra-op thread each (see test_torch_cluster.py)
NODE_ENV = {**cpu_only_env(), "OMP_NUM_THREADS": "1"}
LOSS_ATOL = 1e-6
LOGIT_ATOL = 1e-5


def _tiny_state(seed=0, moment_dtype=torch.bfloat16):
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, remat=False, num_layers=1)
    model = tllama.Llama(cfg, device="cpu", seed=seed)
    tx = adamw(1e-2, moment_dtype=moment_dtype)
    return model, tx, TrainState.create(model.named_parameters(), tx)


def _step_fn(model, tx):
    loss_fn = tllama.llama_loss_fn(model)
    return build_train_step(lambda p, b: loss_fn(p, b["tokens"]), tx, device="cpu")


def _batch(seed, b=2, s=17, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, size=(b, s)).astype(np.int32)}


def _flat(state):
    flat = {}
    ckpt_mod._flatten(state, "", flat)
    return flat


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
    assert a.step == b.step


def test_save_restore_round_trip_is_bit_exact(tmp_path):
    model, tx, state = _tiny_state()
    step = _step_fn(model, tx)
    for i in range(2):
        state, _ = step(state, _batch(i))
    assert state.opt_state[0].mu["embed"].dtype == torch.bfloat16
    path = save_checkpoint(str(tmp_path / "ck"), state)
    assert checkpoint_complete(path)
    _, _, fresh = _tiny_state(seed=1)
    restored = restore_checkpoint(path, target=fresh)
    _assert_same(restored, state)
    assert restored.step == 2 and restored.params["embed"] is fresh.params["embed"]
    untargeted = restore_checkpoint(path)
    assert type(untargeted).__name__ == "TrainState"
    assert type(untargeted.opt_state[0]).__name__ == "ScaleByAdamState"
    _assert_same(untargeted, state)


def test_checkpoint_complete_cases(tmp_path):
    path = save_checkpoint(str(tmp_path / "5"), {"w": torch.ones(3)})
    assert checkpoint_complete(path)
    tmp_named = tmp_path / "5.orbax-checkpoint-tmp-123"
    tmp_named.mkdir()
    (tmp_named / "_CHECKPOINT_METADATA").write_text("{}")
    assert not checkpoint_complete(str(tmp_named))  # a tmp name is rejected
    no_marker = tmp_path / "6"
    no_marker.mkdir()
    assert not checkpoint_complete(str(no_marker))  # no marker: not committed
    assert not checkpoint_complete(str(tmp_path / "missing"))
    assert checkpoint_complete("gs://bucket/run/7")  # a remote URI is trusted
    assert not checkpoint_complete("gs://bucket/run/7.orbax-checkpoint-tmp-9")


def test_async_save_then_in_place_step_restores_the_saved_values(tmp_path):
    model, tx, state = _tiny_state()
    step = _step_fn(model, tx)
    state, _ = step(state, _batch(0))
    before = {k: v.clone() for k, v in _flat(state).items()}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    assert mgr.save(state.step, state)
    state, _ = step(state, _batch(1))  # updates params and moments in place
    assert not torch.equal(state.params["embed"], before["params/embed"])
    mgr.wait()
    assert set(mgr.last_save) == {"snapshot_s", "write_s"}
    _, _, fresh = _tiny_state(seed=1)
    got, restored = restore_latest(mgr, fresh)
    assert got == 1 and restored.step == 1
    for k, v in _flat(restored).items():
        assert torch.equal(v, before[k]), k


def test_manager_interval_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3, async_save=True, save_interval_steps=2)
    saved = [mgr.save(s, {"w": torch.full((2,), float(s))}) for s in range(1, 11)]
    mgr.wait()
    assert saved == [s % 2 == 0 for s in range(1, 11)]
    assert mgr.all_steps() == [6, 8, 10] and mgr.latest_step() == 10
    assert not mgr.save(9, {"w": torch.zeros(2)})  # behind the latest
    assert mgr.save(11, {"w": torch.full((2,), 11.0)}, force=True)
    mgr.wait()
    assert mgr.all_steps() == [8, 10, 11]
    assert mgr.step_path(11) == str(tmp_path / "11")
    assert torch.equal(mgr.restore(target={"w": torch.zeros(2)})["w"], torch.full((2,), 11.0))
    mgr.close()


def test_keep_best_metric(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, async_save=False,
                            keep_best_metric="loss")
    for s, loss in [(1, 3.0), (2, 1.0), (3, 2.0), (4, 5.0)]:
        mgr.save(s, {"w": torch.ones(1)}, metrics={"loss": loss})
    assert mgr.all_steps() == [2, 3]


def test_restore_into_another_structure_names_the_difference(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"params": {"w": torch.ones(2, 3)}, "step": 1})
    with pytest.raises(ValueError, match="written by a different trainer"):
        restore_latest(mgr, {"weights": {"w": torch.ones(2, 3)}, "step": 0})
    with pytest.raises(ValueError, match="'params/w' is torch.float32 \\(2, 3\\)"):
        restore_latest(mgr, {"params": {"w": torch.ones(3, 2)}, "step": 0})
    with pytest.raises(ValueError, match="first difference"):
        restore_latest(mgr, {"params": {"v": torch.ones(2, 3)}, "step": 0})
    assert hydration_restore(str(tmp_path / "none"), {"w": torch.ones(1)}) == (None, None)


def test_chief_final_save_skips_a_landed_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=5)
    mgr.save(5, {"w": torch.ones(1)})
    chief_final_save(mgr, {"w": torch.zeros(1)}, 5, is_chief=True)
    assert torch.equal(restore_checkpoint(mgr.step_path(5))["w"], torch.ones(1))
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=5)
    chief_final_save(mgr, {"w": torch.zeros(1)}, 7, is_chief=False)
    assert mgr.all_steps() == [5]
    chief_final_save(mgr, {"w": torch.zeros(1)}, 7, is_chief=True)
    assert mgr.all_steps() == [5, 7]


# -- a tiny Llama through the port's cluster -------------------------------------

BATCH, SEQ, STEPS = 2, 32, 3


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("tiny_llama")
    rng = np.random.default_rng(0)
    rows = [(rng.integers(0, 256, SEQ + 1).astype(np.int32),) for _ in range(BATCH * STEPS)]
    cluster = tfcluster.run(torch_cluster_fns.tiny_llama_fn,
                            {"out_dir": str(out), "batch": BATCH, "device": "cpu"},
                            num_executors=1, input_mode=InputMode.SPARK,
                            reservation_timeout=120, env=NODE_ENV)
    cluster.train([rows[:3], rows[3:]])
    cluster.shutdown(timeout=300)
    result = json.loads((out / "node0.json").read_text())
    batches = [np.stack([r[0] for r in rows[i * BATCH:(i + 1) * BATCH]]) for i in range(STEPS)]
    return out, result, batches


def test_cluster_losses_match_in_process_steps(trained):
    out, result, batches = trained
    assert result["sums"] == [int(b.astype(np.int64).sum()) for b in batches]
    assert result["stats"]["delivered"] == STEPS and result["step"] == STEPS
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, remat=False)
    model = tllama.Llama(cfg, device="cpu", seed=0)
    tx = adamw(1e-3)
    state = TrainState.create(model.named_parameters(), tx)
    step = _step_fn(model, tx)
    losses = []
    for b in batches:
        state, loss = step(state, {"tokens": b})
        losses.append(float(loss))
    np.testing.assert_allclose(result["losses"], losses, rtol=0, atol=LOSS_ATOL)
    assert losses[-1] < losses[0]


def test_cluster_checkpoint_gives_the_jax_models_logits(trained):
    out, _, batches = trained
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, remat=False)
    model = tllama.Llama(cfg, device="cpu", seed=1)
    tx = adamw(1e-3)
    mgr = CheckpointManager(str(out / "ckpt"))
    step, state = restore_latest(mgr, TrainState.create(model.named_parameters(), tx))
    assert step == STEPS and state.step == STEPS
    tokens = batches[0][:, :-1]
    with torch.no_grad():
        port_logits = model(torch.from_numpy(tokens)).numpy()
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, remat=False, attention_impl="xla")
    jax_logits = np.asarray(jllama.Llama(jcfg).apply({"params": params_to_jax(model)},
                                                      jnp.asarray(tokens)))
    np.testing.assert_allclose(port_logits, jax_logits, rtol=0, atol=LOGIT_ATOL)


def test_llama_example_resumes_across_legs(tmp_path, capfd):
    model_dir = tmp_path / "model"

    def leg():
        args = llama_fsdp.parse_args(["--cpu", "--steps", "2", "--seq", "16", "--batch-size",
                                      "2", "--save-every", "1", "--model-dir", str(model_dir)])
        cluster = tfcluster.run(llama_fsdp.main_fun, args, num_executors=2,
                                input_mode=InputMode.TENSORFLOW, distributed=True,
                                reservation_timeout=120, env=NODE_ENV)
        cluster.shutdown(timeout=300)
        return capfd.readouterr().out

    first = leg()
    assert "resuming" not in first and "MFU" in first
    # warm-up + 2 steps; the last two are saved, max_to_keep 3 keeps all
    assert CheckpointManager(str(model_dir)).all_steps() == [2, 3]
    second = leg()
    assert "resuming from step 3" in second
    # restored step 3, warm-up to 4, saves 5 and 6; max_to_keep 3
    assert CheckpointManager(str(model_dir)).all_steps() == [3, 5, 6]


def test_llama_example_trains_on_the_mesh_axes(capfd):
    """The example's mesh flags on four CPU nodes: data parallel (ZeRO over
    'data') times tensor parallel, with the 'dots' remat (the default
    --fsdp -1 is the resume test's above)."""
    flags = ["--dp", "2", "--tp", "2", "--fsdp", "1", "--remat", "dots"]
    args = llama_fsdp.parse_args(["--cpu", "--steps", "2", "--seq", "16", "--batch-size", "2",
                                  *flags])
    cluster = tfcluster.run(llama_fsdp.main_fun, args, num_executors=4,
                            input_mode=InputMode.TENSORFLOW, distributed=True,
                            reservation_timeout=120, env=NODE_ENV)
    cluster.shutdown(timeout=300)
    out = capfd.readouterr().out
    assert "'data': 2, 'fsdp': 1" in out and "'model': 2" in out
    assert out.count("MFU") == 4


def test_llama_example_still_refuses_sequence_parallel():
    args = llama_fsdp.parse_args(["--cpu", "--sp", "2"])
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        llama_fsdp._refuse_unported(args)
