"""The kernels' mesh routes and the mesh prefetcher against the JAX
package's, on the CPU, in two spawned gloo groups.

- ``mesh_flash_attention`` on 4 ranks (``fsdp=2, model=2``), causal, 4
  query heads over 2 KV heads: forward and grads against the JAX
  package's ``mesh_flash_attention`` on 4 CPU devices (Pallas in interpret
  mode), to the JAX attention tests' own tolerances (2e-3 forward, 5e-3
  grads, fp32). The route refuses a sharded ``seq`` axis (ROADMAP A10), and
  a DTensor handed straight to a kernel wrapper raises.
- The prefetcher with ``mesh=``: each rank's DTensor shard holds exactly
  its rows of the host batch, and the host and device checksums agree.
- ``mesh_pair_stats``/``mesh_cross_stats`` on 2 ranks (``data=2``) against
  the JAX package's (``impl='pallas'``, interpreted) to ``1e-5·Σ|terms| +
  1e-5``, as ``test_torch_batch_norm.py``; an uneven split (3 rows over 2
  ranks) against the single-device sums; and with the ``all_reduce``
  dropped, a fault that only shows across ranks, the check refuses it.
- A tiny ResNet through the mesh BN step on ``data=2`` against the port's
  single-device step: losses, running statistics and params to 1e-5
  relative (fp32 sums in another order).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensorflowonspark_tpu.compute.mesh import make_mesh as jmake_mesh
from tensorflowonspark_tpu.ops import attention as jattention
from tensorflowonspark_tpu.ops import bn_kernels as jbk
from tensorflowonspark_tpu.ops import flash_attention as jfa
from tests import torch_mesh_fns

FWD_TOL, GRAD_TOL = 2e-3, 5e-3


def _qkvo(seed=0, b=4, s=128, hq=4, hk=2, d=64):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, hq, d), (b, s, hk, d), (b, s, hk, d), (b, s, hq, d)]
    return [rng.standard_normal(x).astype(np.float32) for x in shapes]


def _batches():
    rng = np.random.default_rng(3)
    return [{"tokens": rng.integers(0, 1000, (8, 5)).astype(np.int32),
             "weight": rng.standard_normal(8).astype(np.float32)} for _ in range(3)]


def _bn_data(rows, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 2.0, (rows, 3, 3, 8)).astype(np.float32)
    return x, rng.standard_normal(x.shape).astype(np.float32)


def _in_thread(fn, *args, **kw):
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kw)
        except BaseException as e:  # re-raised in the test thread
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()
    return t, box


def _joined(t, box):
    t.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.fixture(scope="module")
def ops():
    """The 4-rank group (attention, prefetcher) and the JAX side meanwhile."""
    qkvo = _qkvo()
    t, box = _in_thread(torch_mesh_fns.run_group, torch_mesh_fns.mesh_ops_fn, 4,
                        {"qkvo": qkvo, "batches": _batches()}, timeout=240)
    mesh = jmake_mesh({"fsdp": 2, "model": 2}, devices=jax.devices()[:4])
    q, k, v, do = map(jnp.asarray, qkvo)
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    try:
        out, vjp = jax.vjp(lambda a, b_, c: jattention.mesh_flash_attention(
            a, b_, c, mesh, causal=True), q, k, v)
        grads = vjp(do)
    finally:
        jfa.INTERPRET = old
    return _joined(t, box), np.asarray(out), [np.asarray(g) for g in grads]


def test_mesh_flash_attention_matches_jax(ops):
    port, want_out, want_grads = ops
    att = port["attention"]
    np.testing.assert_allclose(att["out"], want_out, atol=FWD_TOL, rtol=FWD_TOL)
    for got, want in zip(att["grads"], want_grads):
        np.testing.assert_allclose(got, want, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_tp_only_matches_jax(ops):
    from jax.sharding import NamedSharding, PartitionSpec

    from tensorflowonspark_tpu.compute import layout as jlayout

    mesh = jmake_mesh({"fsdp": 2, "model": 2}, devices=jax.devices()[:4])
    want = jlayout.tp_only(mesh, NamedSharding(mesh, PartitionSpec(("data", "fsdp"), "model")))
    assert tuple(ops[0]["tp_only"]) == tuple(want.spec)


def test_mesh_flash_attention_runs_on_local_shards(ops):
    att = ops[0]["attention"]
    assert att["routes"] == 1
    assert att["local_heads"] == 2  # 4 heads over model=2
    assert att["out_placements"] == "(Shard(dim=0), Shard(dim=2))"  # batch on fsdp, heads on model


@pytest.mark.parametrize("name, match", [
    ("flash_forward", "outside their mesh route"), ("flash_attention", "outside their mesh route"),
    ("pair_stats", "outside their mesh route"), ("seq", "ROADMAP A10"),
])
def test_mesh_routes_refuse(ops, name, match):
    assert match in ops[0]["refused"][name]


def test_prefetcher_places_each_ranks_rows(ops):
    pf = ops[0]["prefetch"]
    batches = _batches()
    assert len(pf["seen"]) == len(batches)
    assert pf["host_sums"] == [int(b["tokens"].sum(dtype=np.int64)) for b in batches]
    for seen, host in zip(pf["seen"], pf["host_sums"]):
        assert seen["local_ok"] and seen["full_ok"] and seen["device_sum"] == host
        assert seen["local_rows"] == 2  # 8 rows over data=2 x fsdp=2
        assert seen["placements"] == "(Shard(dim=0), Shard(dim=0))"
    assert ops[0]["prefetch_plain"] == [True] * len(batches)


@pytest.fixture(scope="module")
def bn():
    x, dy = _bn_data(4, 0)
    xu, dyu = _bn_data(3, 1)
    rng = np.random.default_rng(2)
    images = {"image": rng.standard_normal((4, 16, 16, 3)).astype(np.float32),
              "label": rng.integers(0, 10, 4)}
    t, box = _in_thread(torch_mesh_fns.run_group, torch_mesh_fns.bn_mesh_fn, 2,
                        {"x": x, "dy": dy, "x_uneven": xu, "dy_uneven": dyu, "images": images},
                        timeout=240)
    mesh = jmake_mesh({"data": 2}, devices=jax.devices()[:2])
    old = jbk.INTERPRET
    jbk.INTERPRET = True
    try:
        want = {"pair": [np.asarray(a) for a in jbk.mesh_pair_stats(jnp.asarray(x), mesh)],
                "cross": [np.asarray(a) for a in jbk.mesh_cross_stats(
                    jnp.asarray(dy), jnp.asarray(x), mesh)]}
    finally:
        jbk.INTERPRET = old
    return _joined(t, box), want, (x, dy), (xu, dyu)


def _sums_close(got, x, dy, kind, want=None):
    """Per channel, |got - want| <= 1e-5·Σ|terms| + 1e-5 (want: fp64 sums)."""
    x64, dy64 = x.astype(np.float64).reshape(-1, 8), dy.astype(np.float64).reshape(-1, 8)
    if kind == "pair":
        terms = [np.abs(x64).sum(0), (x64 * x64).sum(0)]
        exact = [x64.sum(0), (x64 * x64).sum(0)]
    else:
        terms = [np.abs(dy64).sum(0), np.abs(dy64 * x64).sum(0)]
        exact = [dy64.sum(0), (dy64 * x64).sum(0)]
    want = exact if want is None else want
    return all(np.all(np.abs(np.asarray(g, np.float64) - w) <= 1e-5 * t + 1e-5)
               for g, w, t in zip(got, want, terms))


@pytest.mark.parametrize("kind", ["pair", "cross"])
def test_mesh_stats_match_jax(bn, kind):
    port, want, (x, dy), _ = bn
    assert port["even"]["local_rows"] == 2
    assert _sums_close(port["even"][kind], x, dy, kind, [np.asarray(w, np.float64)
                                                         for w in want[kind]])
    assert _sums_close(port["even"][kind], x, dy, kind)


@pytest.mark.parametrize("kind", ["pair", "cross"])
def test_mesh_stats_uneven_split(bn, kind):
    port, _, _, (xu, dyu) = bn
    assert port["uneven"]["local_rows"] == 2  # rank 0 of 3 rows over 2 ranks
    assert _sums_close(port["uneven"][kind], xu, dyu, kind)


@pytest.mark.parametrize("kind", ["pair", "cross"])
def test_dropped_all_reduce_is_refused(bn, kind):
    port, _, (x, dy), _ = bn
    assert not _sums_close(port["no_all_reduce"][kind], x, dy, kind)


def test_resnet_mesh_step_matches_single_device(bn):
    runs = bn[0]["resnet"]
    one, mesh = runs["None"], runs["{'data': 2}"]
    np.testing.assert_allclose(mesh["losses"], one["losses"], rtol=1e-5)
    assert mesh["routes"]["bn_pair"] == mesh["routes"]["bn_cross"] == 2 * 9  # 9 BatchNorms, 2 steps
    assert one["routes"]["bn_pair"] == 0
    for k in one["stats"]:
        np.testing.assert_allclose(mesh["stats"][k], one["stats"][k], rtol=1e-5, atol=1e-6)
    for k in one["params"]:
        np.testing.assert_allclose(mesh["params"][k], one["params"][k], rtol=1e-5, atol=1e-6)
