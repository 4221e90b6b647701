"""The port's mesh train step, ZeRO, the weight update alone and sharded
checkpoints, against the JAX package's, on the CPU.

A tiny fp32 Llama (2 layers, 4 query heads over 2 KV heads), its JAX
weights initialized and placed on a 4-device JAX mesh, then fetched with
``jax.device_get`` and carried into the port, trains 3 steps of AdamW on
one numpy batch on both sides:

- JAX: ``build_train_step(..., zero_sharding=False)`` on 4 of the 8 CPU
  devices of ``tests/conftest.py``, meshes ``(data, fsdp, model)`` =
  (1,2,2) and (2,2,1); its ZeRO path is not the reference, since the JAX
  package's own test of it against the replicated optimizer fails;
- the port: 4 gloo ranks, the same mesh shapes, the 'llama' table's
  placements, ZeRO on and off, attention through the mesh flash route
  (the kernels' plain versions here), ``remat_policy='dots'``.

Tolerances (as ``test_torch_train.py``'s, eps 1e-6 for the same reason):
losses to 1e-5 relative, params to 1e-4 relative plus 1e-5 absolute. The
port's ZeRO on and off are held bit-equal: on the same gradients the
update is elementwise. The weight update alone (``build_update_step``, two
fixed gradient sets, ZeRO on over ``data=2``) is held to the JAX
package's to 1e-6 relative. A checkpoint saved sharded on ``fsdp=2,
model=2`` restores bit for bit onto ``fsdp=4`` (4 ranks) and into plain
tensors in this one process. One spawned group of 4 ranks does the port's
side of every test in this file.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.compute import TrainState as JTrainState
from tensorflowonspark_tpu.compute import build_train_step as jbuild_train_step
from tensorflowonspark_tpu.compute import optim as joptim
from tensorflowonspark_tpu.compute.mesh import make_mesh as jmake_mesh
from tensorflowonspark_tpu.compute.train import build_update_step as jbuild_update_step
from tensorflowonspark_tpu.compute.train import shard_state as jshard_state
from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu_torch.compute import TrainState, adamw
from tensorflowonspark_tpu_torch.compute.checkpoint import CheckpointManager, restore_checkpoint
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models.convert import jax_leaf, params_from_jax, params_to_jax
from tests import torch_mesh_fns

CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=2,
           num_layers=2)
SEQ, STEPS, LR, EPS = 64, 3, 1e-3, 1e-6
MESHES = {"1x2x2": {"data": 1, "fsdp": 2, "model": 2}, "2x2x1": {"data": 2, "fsdp": 2, "model": 1}}


def _jax_model():
    cfg = jllama.LlamaConfig.tiny(**CFG, max_seq_len=SEQ, remat=False, dtype=jnp.float32,
                                  attention_impl="xla")
    return jllama.Llama(cfg)


def _jax_mesh(shape):
    return jmake_mesh(shape, devices=jax.devices()[:4])


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32)
            for n, p in params.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jmodel = _jax_model()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    # the JAX weights as a mesh-sharded tree, fetched whole
    jm = _jax_mesh(MESHES["1x2x2"])
    placed = jax.tree.map(jax.device_put, params, jllama.llama_param_shardings(params, jm))
    host = jax.device_get(placed)
    tokens = np.random.default_rng(1).integers(0, 256, size=(4, SEQ + 1)).astype(np.int32)
    port_names = params_from_jax(host)
    grads = [_grads(port_names, s) for s in (5, 6)]
    ckpt = str(tmp_path_factory.mktemp("sharded_ckpt"))
    args = {"cfg": dict(CFG, max_seq_len=SEQ), "params": host, "tokens": tokens, "lr": LR,
            "eps": EPS, "steps": STEPS, "meshes": MESHES, "ckpt_mesh": "1x2x2",
            "ckpt_dir": ckpt, "update_mesh": "2x2x1", "grads": grads}
    port = {}
    worker = threading.Thread(target=lambda: port.update(
        out=torch_mesh_fns.run_group(torch_mesh_fns.llama_zero_fn, 4, args, timeout=300)))
    worker.start()  # the JAX side runs meanwhile
    jax_runs = {}
    loss = jllama.llama_loss_fn(jmodel)
    for key, shape in MESHES.items():
        mesh = _jax_mesh(shape)
        psh = jllama.llama_param_shardings(params, mesh)
        tx = joptim.adamw(LR, eps=EPS)
        state = jshard_state(JTrainState.create(jax.tree.map(jnp.asarray, host), tx), mesh, psh,
                             zero_sharding=False)
        step = jbuild_train_step(lambda p, b: loss(p, b["tokens"]), tx, mesh,
                                 param_shardings=psh, zero_sharding=False)
        losses = []
        for _ in range(STEPS):
            state, val = step(state, {"tokens": tokens})
            losses.append(float(val))
        jax_runs[key] = (losses, jax.device_get(state.params))
    mesh = _jax_mesh(MESHES["2x2x1"])
    psh = jllama.llama_param_shardings(params, mesh)
    tx = joptim.adamw(LR, eps=EPS)
    state = jshard_state(JTrainState.create(jax.tree.map(jnp.asarray, host), tx), mesh, psh)
    update = jbuild_update_step(tx, mesh, param_shardings=psh, zero_sharding=True)
    for g in grads:
        state = update(state, params_to_jax({n: torch.from_numpy(v) for n, v in g.items()}))
    jax_update = jax.device_get(state.params)
    worker.join()
    return {"port": port["out"], "jax": jax_runs, "jax_update": jax_update, "host": host,
            "ckpt": ckpt, "port_shapes": {n: tuple(t.shape) for n, t in port_names.items()}}


def _port_params(arrays):
    return params_to_jax({k[len("params/"):]: torch.from_numpy(v)
                          for k, v in arrays.items() if k.startswith("params/")})


def _assert_trees_close(tree, ref, **tol):
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_allclose(flat[path], leaf, err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_train_step_matches_jax(runs, mesh):
    losses, arrays = runs["port"]["train"][(mesh, False)]
    ref_losses, ref_params = runs["jax"][mesh]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    _assert_trees_close(_port_params(arrays), ref_params, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero_on_and_off_are_bit_equal(runs, mesh):
    on_losses, on = runs["port"]["train"][(mesh, True)]
    off_losses, off = runs["port"]["train"][(mesh, False)]
    assert on_losses == off_losses
    assert sorted(on) == sorted(off)
    for k in on:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)


def test_zero_places_the_moments_over_data(runs):
    placements = runs["port"]["placements"]
    # (2,2,1): the moments split dim 0 over data (outermost) as well as fsdp
    assert placements[("2x2x1", True)]["mu/embed"] == "(Shard(dim=0), Shard(dim=0))"
    assert placements[("2x2x1", False)]["mu/embed"] == placements[("2x2x1", False)]["params/embed"]
    # data=1: nothing to add, ZeRO leaves the moments mirroring the params
    assert placements[("1x2x2", True)]["mu/embed"] == placements[("1x2x2", True)]["params/embed"]


# One step's collectives by op, per mesh (CommDebugMode, torch 2.13 on
# the CPU): the port's counterpart of tools/shardcheck.py's census, pinned
# so that a placement or dispatch change that adds collectives shows. FSDP
# gathers each weight where it is used, in the forward and again in the
# 'dots' recompute, and the gather's backward reduce-scatters the gradient;
# DTensor's own strategies add the rest (activations split on 'model',
# ZeRO's reduce-scatter over 'data' and the updates' all-gather).
CENSUS = {
    "1x2x2": {"c10d_functional.all_gather_into_tensor": 91,
              "c10d_functional.all_reduce": 6,
              "c10d_functional.reduce_scatter_tensor": 60},
    "2x2x1": {"c10d_functional.all_gather_into_tensor": 66,
              "c10d_functional.all_reduce": 23,
              "c10d_functional.reduce_scatter_tensor": 21},
}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_collective_census_of_one_step(runs, mesh):
    assert runs["port"]["census"][mesh] == CENSUS[mesh]


def test_update_step_matches_jax(runs):
    _assert_trees_close(_port_params(runs["port"]["update"]), runs["jax_update"],
                        rtol=1e-6, atol=1e-9)


def test_sharded_checkpoint_restores_onto_another_mesh(runs):
    r = runs["port"]["restored_fsdp4"]
    assert r["unequal"] == []
    assert r["step"] == (STEPS, STEPS, STEPS)
    assert r["placements"] == "(Shard(dim=0),)"  # embed's fsdp rows over the 4 ranks


def test_sharded_checkpoint_restores_into_one_process(runs):
    model = tllama.Llama(tllama.LlamaConfig.tiny(**CFG, max_seq_len=SEQ, remat=False,
                                                 dtype=torch.float32), device="cpu")
    target = TrainState.create(model.named_parameters(), adamw(LR, eps=EPS))
    step = CheckpointManager(runs["ckpt"]).latest_step()
    restored = restore_checkpoint(CheckpointManager(runs["ckpt"]).step_path(step), target)
    saved = runs["port"]["train"][("1x2x2", True)][1]
    got = torch_mesh_fns._state_arrays(restored)
    assert restored.step == STEPS and sorted(got) == sorted(saved)
    for k in saved:
        np.testing.assert_array_equal(got[k], saved[k], err_msg=k)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_params_from_jax_places_the_tree(runs, mesh):
    """With a mesh the bridge places each weight as the table says."""
    assert runs["port"]["bridge"][mesh] == []


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fsdp_shardings_match_jax(runs, mesh):
    from tensorflowonspark_tpu.compute.train import fsdp_shardings as jfsdp_shardings

    jsh = jfsdp_shardings(runs["host"], _jax_mesh(MESHES[mesh]))
    flat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda s: tuple(s.spec), jsh, is_leaf=lambda x: hasattr(x, "spec")),
        is_leaf=lambda x: isinstance(x, tuple))[0])
    got = runs["port"]["fsdp"][mesh]
    for name, spec in got.items():
        jspec = [v for k, v in flat.items()
                 if "/".join(str(getattr(p, "key", p)) for p in k) == jax_leaf(
                     name, runs["port_shapes"][name])[0]]
        # the generic rule reads shapes, which the bridge transposes
        assert len(jspec) == 1
        assert sorted(a for a in spec if a) == sorted(a for a in jspec[0] if a), name


def test_params_from_a_sharded_jax_tree(runs):
    """The port's weights from the JAX tree that lived on a JAX mesh equal
    the tree's own leaves, moved by the bridge."""
    port = params_from_jax(runs["host"])
    back = params_to_jax(port)
    _assert_trees_close(back, runs["host"], rtol=0, atol=0)
