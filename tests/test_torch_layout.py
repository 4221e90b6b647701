"""The port's layout tables, placements and mesh shapes against the JAX
package's.

- The tables are copies: each literal equals the JAX package's.
- Every leaf of a tiny Llama and a tiny ResNet gets, in the port, the spec
  that the JAX package's ``param_shardings`` gives its flax leaf, mapped
  through the weight bridge's transpose: a dense kernel's ``(in, out)`` spec
  reversed onto the port's ``(out, in)`` weight, a conv kernel's HWIO spec
  reordered to OIHW, everything else as it is. Four meshes of 8 devices:
  ``(data, fsdp, model)`` = (2,2,2), (1,4,2), (8,1,1), (1,2,4). The port
  needs only the axis extents for this, no process group.
- ``fit_axis_shapes``, ``parse_axis_spec`` and the shape checks of
  ``make_mesh`` give the JAX package's shapes and refuse what it refuses.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from tensorflowonspark_tpu.compute import layout as jlayout
from tensorflowonspark_tpu.compute import mesh as jmesh
from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu.models import resnet as jresnet
from tensorflowonspark_tpu_torch.compute import layout, mesh
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models import resnet as tresnet
from tensorflowonspark_tpu_torch.models.convert import jax_leaf

MESHES = [(2, 2, 2), (1, 4, 2), (8, 1, 1), (1, 2, 4)]


@pytest.mark.parametrize("name", ["LAYOUT_TABLES", "ACTIVATION_SPECS", "MESH_AXES",
                                  "BATCH_AXES", "OPTIMIZER_PARAM_STATE_PATTERN"])
def test_tables_are_the_jax_packages(name):
    assert getattr(layout, name) == getattr(jlayout, name)


def test_optimizer_pattern_is_the_tables_rule():
    rules = [r["pattern"] for r in layout.LAYOUT_TABLES["optimizer"]]
    assert layout.OPTIMIZER_PARAM_STATE_PATTERN in rules


def _jax_mesh(shape):
    d, f, m = shape
    return jmesh.make_mesh({"data": d, "fsdp": f, "model": m}, devices=jax.devices()[:8])


def _spec_tuple(pspec, ndim):
    spec = tuple(pspec) + (None,) * (ndim - len(tuple(pspec)))
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def _expected(port_name, port_shape, jax_spec):
    """The JAX leaf's spec moved onto the port's dims, as the weight bridge
    moves the leaf itself (models/convert.py)."""
    if len(port_shape) == 4:  # HWIO -> OIHW
        return (jax_spec[3], jax_spec[2], jax_spec[0], jax_spec[1])
    if len(port_shape) == 2 and port_name != "embed":  # (in, out) -> (out, in)
        return (jax_spec[1], jax_spec[0])
    return jax_spec


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _compare(port_params, jax_params, jax_shardings, table, shape):
    d, f, m = shape
    sizes = {"data": d, "fsdp": f, "pipe": 1, "expert": 1, "model": m, "seq": 1}
    got = layout.param_specs(port_params, sizes, table, view=jax_leaf)
    jax_specs = dict(_flat(jax.tree.map(lambda s: s.spec, jax_shardings,
                                        is_leaf=lambda x: hasattr(x, "spec"))))
    jax_shapes = {k: v.shape for k, v in _flat(jax_params)}
    assert len(got) == len(jax_specs)
    for name, p in port_params.items():
        path, _, _ = jax_leaf(name, tuple(p.shape))
        want = _expected(name, tuple(p.shape), _spec_tuple(jax_specs[path], len(jax_shapes[path])))
        assert _spec_tuple(got[name], p.dim()) == want, (name, shape)


@pytest.fixture(scope="module")
def llama_tree():
    cfg = jllama.LlamaConfig.tiny(hidden_size=128, intermediate_size=256, num_heads=4,
                                  num_kv_heads=2, num_layers=2, remat=False, dtype=jnp.float32)
    return jax.eval_shape(lambda: jllama.Llama(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]


@pytest.fixture(scope="module")
def resnet_tree():
    jmodel = jresnet.ResNet(jresnet.ResNetConfig.tiny(dtype=jnp.float32))
    return jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))["params"]


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_llama_placements_are_the_jax_tables(llama_tree, shape):
    jparams = llama_tree
    jsh = jllama.llama_param_shardings(jparams, _jax_mesh(shape))
    tmodel = tllama.Llama(tllama.LlamaConfig.tiny(hidden_size=128, intermediate_size=256,
                                                  num_heads=4, num_kv_heads=2, num_layers=2,
                                                  remat=False), device="cpu")
    _compare(dict(tmodel.named_parameters()), jparams, jsh, "llama", shape)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_resnet_placements_are_the_jax_tables(resnet_tree, shape):
    jparams = resnet_tree
    jsh = jresnet.resnet_param_shardings(jparams, _jax_mesh(shape))
    tmodel = tresnet.ResNet(tresnet.ResNetConfig.tiny(), device="cpu")
    _compare(dict(tmodel.named_parameters()), jparams, jsh, "resnet", shape)


@pytest.mark.parametrize("name, shape, base", [
    ("0/mu/layers.0.attn.q_proj.weight", (8, 4), ("model", "fsdp")),
    ("0/nu/embed", (6, 4), ("fsdp", "model")),
    ("update/final_norm.scale", (8,), ()),
    ("0/count", (), ()),
    ("master/x", (3, 4), (None, "fsdp")),
])
@pytest.mark.parametrize("data", [1, 2, 4])
def test_optimizer_state_spec_matches_jax(name, shape, base, data):
    sizes = {"data": data, "fsdp": 2, "model": 2}
    want = jlayout.optimizer_state_spec(name, shape, jax.sharding.PartitionSpec(*base), sizes)
    got = layout.optimizer_state_spec(name, shape, base, sizes)
    assert _spec_tuple(got, len(shape)) == _spec_tuple(want, len(shape))


@pytest.mark.parametrize("shape, n, min_el", [((64, 32), 4, 1024), ((8,), 2, 1), ((30, 7), 4, 1),
                                              ((16, 16), 1, 1), ((4, 4), 2, 1024)])
def test_fsdp_leaf_spec_matches_jax(shape, n, min_el):
    want = jlayout.fsdp_leaf_spec(shape, n, min_shard_elements=min_el)
    assert _spec_tuple(layout.fsdp_leaf_spec(shape, n, min_shard_elements=min_el),
                       len(shape)) == _spec_tuple(want, len(shape))


def test_activation_and_batch_specs():
    assert layout.batch_spec(3) == (("data", "fsdp"), None, None)
    assert layout.activation_spec("attn_bshd") == (("data", "fsdp"), None, "model", None)
    with pytest.raises(KeyError, match="unknown activation role"):
        layout.activation_spec("nope")
    with pytest.raises(KeyError, match="unknown layout table"):
        layout.get_layout("nope")


@pytest.mark.parametrize("spec, n", [({"fsdp": -1}, 8), ({"data": 2, "model": -1}, 8),
                                     (None, 4), ({"data": 2, "fsdp": 2, "model": 2}, 8)])
def test_mesh_shapes_match_jax(spec, n):
    want = jmesh.make_mesh(spec, devices=jax.devices()[:n])
    assert mesh.full_shape(spec, n) == [want.shape[a] for a in jlayout.MESH_AXES]


@pytest.mark.parametrize("spec, n, match", [
    ({"bogus": 2}, 8, "unknown mesh axis"),
    ({"data": -1, "fsdp": -1}, 8, "at most one axis"),
    ({"data": 3, "fsdp": -1}, 8, "not divisible"),
    ({"data": 2, "fsdp": 2}, 8, "needs 4 devices"),
])
def test_mesh_shape_errors_match_jax(spec, n, match):
    with pytest.raises(ValueError, match=match):
        jmesh.make_mesh(spec, devices=jax.devices()[:n])
    with pytest.raises(ValueError, match=match):
        mesh.full_shape(spec, n)


def test_make_mesh_wants_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        mesh.make_mesh({"data": 1})
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.make_mesh({"bogus": 1}, device_type="cpu")


@pytest.mark.parametrize("spec, n", [(None, 8), ({"data": 2}, 8), ({"data": 2, "model": -1}, 8),
                                     ({"model": 4}, 8), ({"data": 3}, 8), ({"model": 2}, 6)])
def test_fit_axis_shapes_matches_jax(spec, n):
    try:
        want = jmesh.fit_axis_shapes(spec, n)
    except ValueError as e:
        with pytest.raises(ValueError, match="cannot fit"):
            mesh.fit_axis_shapes(spec, n)
        assert "cannot fit" in str(e)
        return
    assert mesh.fit_axis_shapes(spec, n) == want


@pytest.mark.parametrize("text", ["data=2,model=4", " fsdp = -1 ", "data=2,,model=2", "x", ""])
def test_parse_axis_spec_matches_jax(text):
    try:
        want = jmesh.parse_axis_spec(text)
    except ValueError:
        with pytest.raises(ValueError):
            mesh.parse_axis_spec(text)
        return
    assert mesh.parse_axis_spec(text) == want


def test_llama_strict_divisibility_raises():
    model = tllama.Llama(tllama.LlamaConfig.tiny(num_layers=1, remat=False), device="cpu")
    sizes = {"data": 1, "fsdp": 3, "model": 1}
    specs = layout.param_specs(dict(model.named_parameters()), sizes, "llama", view=jax_leaf)
    with pytest.raises(ValueError, match="does not divide"):
        layout.check_divisible("embed", tuple(model.embed.shape), specs["embed"], sizes)


def test_use_mesh_publishes_and_restores():
    from tensorflowonspark_tpu.parallel import context as jcontext
    from tensorflowonspark_tpu_torch.parallel import context

    outer, inner = object(), object()
    for ctx in (jcontext, context):
        assert ctx.current_mesh() is None
        with ctx.use_mesh(outer):
            with ctx.use_mesh(inner):
                assert ctx.current_mesh() is inner
            assert ctx.current_mesh() is outer
        assert ctx.current_mesh() is None
    # plain tensors take no mesh route
    assert context.dispatch_mesh((torch.zeros(2), None), 2) is None
