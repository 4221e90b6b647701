"""The port's encoder and small-image families (``models/{mnist,vit,bert,
unet,zoo}.py``) against the JAX package's, on the CPU.

Weights are drawn on the JAX side and carried into the port through
``models.convert.params_from_jax``; inputs come from numpy seeds. The JAX
side runs as its own tests run it on the CPU (``attention_impl="xla"``);
the port runs ``impl="flash"`` (on CPU tensors the flash kernels' plain
versions) and ``impl="xla"``. Everything is fp32.

Tolerances: outputs and losses ``rtol=1e-4, atol=1e-5`` (measured gaps
up to ~5e-6 on outputs of magnitude ~4: summation order only); gradients
``rtol=1e-3`` with ``atol`` 1e-5 of the largest gradient of the model (a
sum over the batch and, for BERT and ViT, through the attention backward;
an exactly-zero gradient, as the key projection's bias has, comes out as
rounding noise).
The converter's round trip is exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tensorflowonspark_tpu.models import bert as jbert
from tensorflowonspark_tpu.models import mnist as jmnist
from tensorflowonspark_tpu.models import unet as junet
from tensorflowonspark_tpu.models import vit as jvit
from tensorflowonspark_tpu.models import zoo as jzoo
from tensorflowonspark_tpu_torch.models import bert as tbert
from tensorflowonspark_tpu_torch.models import mnist as tmnist
from tensorflowonspark_tpu_torch.models import unet as tunet
from tensorflowonspark_tpu_torch.models import vit as tvit
from tensorflowonspark_tpu_torch.models import zoo as tzoo
from tensorflowonspark_tpu_torch.models.convert import jax_leaf, params_from_jax, params_to_jax

OUT = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-3
GRAD_ATOL_SCALE = 1e-5

_RNG = np.random.default_rng(0)
IMG16 = _RNG.random((2, 16, 16, 3)).astype(np.float32)
IMG18 = _RNG.random((2, 18, 18, 3)).astype(np.float32)  # odd skip sizes: 18 -> 9 -> 5
MASK18 = _RNG.integers(0, 3, (2, 18, 18)).astype(np.int32)
DIGITS = _RNG.random((3, 28, 28, 1)).astype(np.float32)
TOKENS = _RNG.integers(0, 128, (3, 24)).astype(np.int32)
PAD = np.ones((3, 24), np.int32)
PAD[1, 15:] = 0
PAD[2, 7:] = 0
BATCHES = {
    "vit": {"image": IMG16, "label": np.array([3, 7], np.int32)},
    "bert_cls": {"tokens": TOKENS, "label": np.array([0, 1, 1], np.int32), "mask": PAD},
    "unet": {"image": IMG18, "mask": MASK18},
    "digits": {"image": DIGITS, "label": np.array([1, 4, 9], np.int32)},
}


def _jcfg_bert():
    return jbert.BertConfig.tiny(dtype=jnp.float32, attention_impl="xla")


def _tcfg_bert(impl):
    return tbert.BertConfig.tiny(dtype=torch.float32, attention_impl=impl)


# family -> (JAX module, example args for init, port builder taking an impl)
FAMILIES = {
    "vit": (lambda: jvit.ViT(jvit.ViTConfig.tiny(attention_impl="xla")), (IMG16,),
            lambda impl: tvit.ViT(tvit.ViTConfig.tiny(attention_impl=impl), device="cpu")),
    "bert_cls": (lambda: jbert.BertForClassification(_jcfg_bert()), (TOKENS,),
                 lambda impl: tbert.BertForClassification(_tcfg_bert(impl), device="cpu")),
    "bert_mlm": (lambda: jbert.BertForMLM(_jcfg_bert()), (TOKENS,),
                 lambda impl: tbert.BertForMLM(_tcfg_bert(impl), device="cpu")),
    "unet": (lambda: junet.UNet(junet.UNetConfig.tiny(dtype=jnp.float32)), (IMG18,),
             lambda impl: tunet.UNet(tunet.UNetConfig.tiny(dtype=torch.float32), device="cpu")),
    "mlp": (lambda: jmnist.MLP(), (DIGITS,), lambda impl: tmnist.MLP(device="cpu")),
    "cnn": (lambda: jmnist.CNN(), (DIGITS,), lambda impl: tmnist.CNN(device="cpu")),
}


@functools.lru_cache(maxsize=None)
def _jax(family):
    """(JAX module, its params as numpy) from PRNGKey(0)."""
    make, args, _ = FAMILIES[family]
    model = make()
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *args)["params"]
    return model, jax.tree.map(np.asarray, params)


def _port(family, impl="flash"):
    """The port's module with the JAX weights, and its params by name."""
    model = FAMILIES[family][2](impl)
    _, params = _jax(family)
    own = dict(model.named_parameters())
    with torch.no_grad():
        for name, t in params_from_jax(params).items():
            own[name].copy_(t)
    return model, own


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(family, loss_builder, batch_key):
    """The JAX package's loss and gradients of ``family`` on the batch
    ``BATCHES[batch_key]``, computed once for both of the port's routes."""
    jm, jp = _jax(family)
    batch = {k: jnp.asarray(v) for k, v in BATCHES[batch_key].items()}
    loss, grads = jax.jit(jax.value_and_grad(loss_builder(jm)))(jp, batch)
    return float(loss), jax.tree.map(np.asarray, grads)


def _t(x, long=False):
    t = torch.from_numpy(np.asarray(x))
    return t.long() if long else t


def _assert_grads(port_grads: dict, jax_grads):
    want = jax.tree.map(np.asarray, jax_grads)
    got = params_to_jax(port_grads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    # the scale is the whole gradient's: a leaf whose exact gradient is 0
    # (the key bias: softmax ignores a shift of a query's logits) is noise
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(want))

    def close(a, b):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL_SCALE * scale)

    jax.tree.map(close, got, want)


def _port_loss_and_grads(loss_fn, params, batch):
    loss = loss_fn(params, batch)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    return float(loss.detach()), dict(zip(names, grads))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_converter_round_trip(family):
    """``params_to_jax(params_from_jax(tree)) == tree`` exactly; the port
    module's names are the converted set, and each name's ``jax_leaf`` is
    the flax leaf's path and shape (what the layout tables read)."""
    _, params = _jax(family)
    port = params_from_jax(params)
    back = params_to_jax(port)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), back, params)
    model = FAMILIES[family][2]("xla")
    assert set(port) == set(dict(model.named_parameters()))
    flat = {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    for name, t in port.items():
        path, shape, _ = jax_leaf(name, tuple(t.shape))
        assert flat[path].shape == shape, name


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_vit_matches_jax(impl):
    """Logits, loss and every gradient of the tiny ViT (16x16, 4x4
    patches: 17 tokens, non-causal)."""
    jm, jp = _jax("vit")
    model, params = _port("vit", impl)
    want = np.asarray(jm.apply({"params": jp}, IMG16))
    with torch.no_grad():
        got = model(_t(IMG16)).numpy()
    np.testing.assert_allclose(got, want, **OUT)
    jloss, jgrads = _jax_value_and_grad("vit", jvit.loss_fn, "vit")
    loss, grads = _port_loss_and_grads(tvit.loss_fn(model), params,
                                       {k: _t(v) for k, v in BATCHES["vit"].items()})
    np.testing.assert_allclose(loss, float(jloss), **OUT)
    _assert_grads(grads, jgrads)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_bert_classifier_matches_jax_with_ragged_padding(impl):
    """The classifier with a ragged 0/1 mask (rows of 24, 15 and 7 real
    tokens) as segment ids: logits, loss and every gradient."""
    jm, jp = _jax("bert_cls")
    model, params = _port("bert_cls", impl)
    want = np.asarray(jm.apply({"params": jp}, TOKENS, attention_mask=PAD))
    with torch.no_grad():
        got = model(_t(TOKENS, long=True), attention_mask=_t(PAD)).numpy()
    np.testing.assert_allclose(got, want, **OUT)
    jloss, jgrads = _jax_value_and_grad("bert_cls", jbert.classification_loss_fn, "bert_cls")
    loss, grads = _port_loss_and_grads(tbert.classification_loss_fn(model), params,
                                       {k: _t(v) for k, v in BATCHES["bert_cls"].items()})
    np.testing.assert_allclose(loss, float(jloss), **OUT)
    _assert_grads(grads, jgrads)


def test_bert_sequence_output_matches_on_real_tokens():
    """The encoder's sequence output under the ragged mask, compared on the
    rows' real tokens (pads attend only pads and are dropped downstream);
    and the remat config, which recomputes each block in the backward,
    gives the same loss and gradients."""
    jm, jp = _jax("bert_cls")
    cfg = _jcfg_bert()
    seq, _ = jbert.Bert(cfg).apply({"params": jp["bert"]}, TOKENS, attention_mask=PAD)
    model, params = _port("bert_cls", "flash")
    with torch.no_grad():
        got, _ = model.bert(_t(TOKENS, long=True), attention_mask=_t(PAD))
    real = PAD.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(seq)[real], **OUT)
    remat = tbert.BertForClassification(dataclasses.replace(_tcfg_bert("flash"), remat=True),
                                        device="cpu")
    remat.load_state_dict(model.state_dict())
    batch = {"tokens": _t(TOKENS, long=True), "label": _t(np.array([0, 1, 1])), "mask": _t(PAD)}
    a = _port_loss_and_grads(tbert.classification_loss_fn(model), params, batch)
    b = _port_loss_and_grads(tbert.classification_loss_fn(remat),
                             dict(remat.named_parameters()), batch)
    assert a[0] == pytest.approx(b[0], rel=1e-6)
    for n, g in a[1].items():
        torch.testing.assert_close(b[1][n], g, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_bert_mlm_matches_jax(impl):
    """The masked-LM head's logits without a mask, and the zoo's MLM loss
    (``zoo.build("bert_base", tiny=True)``'s loss on the same weights)."""
    jm, jp = _jax("bert_mlm")
    model, params = _port("bert_mlm", impl)
    want = np.asarray(jm.apply({"params": jp}, TOKENS))
    with torch.no_grad():
        got = model(_t(TOKENS, long=True)).numpy()
    np.testing.assert_allclose(got, want, **OUT)
    targets = np.roll(TOKENS, 1, axis=1)
    jloss = optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(want), targets).mean()
    entry = tzoo.build("bert_base", tiny=True, device="cpu")
    loss = entry.loss_builder(model)(params, {"tokens": _t(TOKENS), "targets": _t(targets)})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **OUT)


def test_unet_matches_jax_at_an_odd_size():
    """18x18 inputs: the strided SAME convs give skips of 18 and 9 and a
    5x5 bottleneck, so every upsampling resizes to an odd size, where
    torch's "nearest" parts from jax.image.resize's half-pixel centres and
    "nearest-exact" does not. Logits, loss, every gradient, and the mIoU."""
    x = torch.arange(25.0).reshape(1, 1, 5, 5)
    assert not torch.equal(F.interpolate(x, size=(9, 9), mode="nearest"),
                           F.interpolate(x, size=(9, 9), mode="nearest-exact"))
    np.testing.assert_array_equal(
        F.interpolate(x, size=(9, 9), mode="nearest-exact")[0, 0].numpy(),
        np.asarray(jax.image.resize(jnp.asarray(x[0, 0].numpy()), (9, 9), "nearest")))
    jm, jp = _jax("unet")
    model, params = _port("unet")
    want = np.asarray(jm.apply({"params": jp}, IMG18))
    with torch.no_grad():
        got = model(_t(IMG18)).numpy()
    assert got.shape == (2, 18, 18, 3)
    np.testing.assert_allclose(got, want, **OUT)
    batch = {"image": jnp.asarray(IMG18), "mask": jnp.asarray(MASK18)}
    jloss, jgrads = _jax_value_and_grad("unet", junet.loss_fn, "unet")
    tbatch = {"image": _t(IMG18), "mask": _t(MASK18)}
    loss, grads = _port_loss_and_grads(tunet.loss_fn(model), params, tbatch)
    np.testing.assert_allclose(loss, float(jloss), **OUT)
    _assert_grads(grads, jgrads)
    jiou = float(junet.iou(jm, jp, batch, 3))
    assert float(tunet.iou(model, params, tbatch, 3)) == pytest.approx(jiou, abs=1e-6)


@pytest.mark.parametrize("family", ["mlp", "cnn"])
def test_mnist_matches_jax(family):
    """Logits, loss, gradients and accuracy of the MNIST nets (the CNN
    flattens its NHWC map in (h, w, c) order, as the JAX package's does)."""
    jm, jp = _jax(family)
    model, params = _port(family)
    want = np.asarray(jm.apply({"params": jp}, DIGITS))
    with torch.no_grad():
        got = model(_t(DIGITS)).numpy()
    np.testing.assert_allclose(got, want, **OUT)
    jloss, jgrads = _jax_value_and_grad(family, lambda m: jmnist.loss_fn(m.apply), "digits")
    batch = {k: jnp.asarray(v) for k, v in BATCHES["digits"].items()}
    tbatch = {k: _t(v) for k, v in BATCHES["digits"].items()}
    loss, grads = _port_loss_and_grads(tmnist.loss_fn(model), params, tbatch)
    np.testing.assert_allclose(loss, float(jloss), **OUT)
    _assert_grads(grads, jgrads)
    assert float(tmnist.accuracy(model, params, tbatch)) == pytest.approx(
        float(jmnist.accuracy(jm.apply, jp, batch)))


def test_mnist_synthetic_batch_is_seeded():
    a, b = tmnist.synthetic_batch(3, 8, device="cpu"), tmnist.synthetic_batch(3, 8, device="cpu")
    assert torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"])
    assert a["image"].shape == (8, 28, 28, 1) and 0 <= float(a["image"].min())
    assert float(a["image"].max()) < 1 and set(a["label"].tolist()) <= set(range(10))


def test_zoo_names_equal_the_reference():
    assert tzoo.names() == jzoo.names()
    with pytest.raises(KeyError, match="unknown zoo model"):
        tzoo.build("resnet999")


def _fields(cfg) -> dict:
    """A config's fields, dtypes by name (jnp and torch spell them alike),
    nested dataclasses (Llama's RoPE scaling) as dicts."""
    def value(name):
        v = getattr(cfg, name)
        if "dtype" in name:
            return str(v).replace("torch.", "").split(".")[-1].strip("'>")
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v

    return {f.name: value(f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", jzoo.names())
def test_zoo_entry_trains_one_step(name):
    """Each entry: the full-size config field by field against the JAX
    package's (no module built), its kind and statistics flag; then the
    tiny entry's example batch takes one port training step on the CPU."""
    from tensorflowonspark_tpu_torch.compute import TrainState, build_bn_train_step
    from tensorflowonspark_tpu_torch.compute import build_train_step, sgd

    want = jzoo.build(name)
    full = tzoo.build(name)
    assert (full.kind, full.has_batch_stats) == (want.kind, want.has_batch_stats)
    jcfg = getattr(want.model, "config", None) or getattr(want.model, "cfg", None)
    ours, theirs = _fields(full.config), _fields(jcfg)
    assert {k: ours[k] for k in theirs if k in ours} == {k: theirs[k] for k in theirs
                                                         if k in ours}
    entry = tzoo.build(name, tiny=True, num_classes=10, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in entry.make_input(2).items()}
    assert {k: v.shape for k, v in batch.items()} == {
        k: v.shape for k, v in jzoo.build(name, tiny=True, num_classes=10).make_input(2).items()}
    tx = sgd(0.01)
    state = TrainState.create(entry.model.named_parameters(), tx)
    if entry.has_batch_stats:
        step = build_bn_train_step(entry.make_loss(), tx, device="cpu")
        state, _, loss = step(state, dict(entry.model.named_buffers()), batch)
    else:
        state, loss = build_train_step(entry.make_loss(), tx, device="cpu")(state, batch)
    assert np.isfinite(float(loss)) and state.step == 1


def test_family_modules_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builders = [lambda d: tvit.ViT(tvit.ViTConfig.tiny(), device=d),
                lambda d: tbert.BertForMLM(tbert.BertConfig.tiny(), device=d),
                lambda d: tunet.UNet(tunet.UNetConfig.tiny(), device=d),
                lambda d: tmnist.CNN(device=d), lambda d: tmnist.MLP(device=d),
                lambda d: tzoo.build("vit_b16", tiny=True, device=d).model]
    for build in builders:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(None)
        assert next(build("cpu").parameters()).device == torch.device("cpu")


def _jax_mesh(shape):
    from tensorflowonspark_tpu.compute import mesh as jmesh

    d, f, m = shape
    return jmesh.make_mesh({"data": d, "fsdp": f, "model": m}, devices=jax.devices()[:8])


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 4)], ids=str)
@pytest.mark.parametrize("family,table", [("vit", "vit"), ("bert_cls", "bert"),
                                          ("unet", "unet")])
def test_family_placements_are_the_jax_tables(family, table, shape):
    """Each port parameter's spec from the layout table (what
    ``*_param_shardings`` places) is the spec the JAX package's
    ``*_param_shardings`` gives its flax leaf, moved onto the port's dims
    as ``jax_leaf``'s permutation moves the leaf."""
    from tensorflowonspark_tpu_torch.compute import layout

    _, jp = _jax(family)
    jfn = {"vit": jvit.vit_param_shardings, "bert": jbert.bert_param_shardings,
           "unet": junet.unet_param_shardings}[table]
    jsh = jfn(jp, _jax_mesh(shape))
    flat = {"/".join(str(k.key) for k in path): s.spec
            for path, s in jax.tree_util.tree_leaves_with_path(
                jsh, is_leaf=lambda x: hasattr(x, "spec"))}
    port = params_from_jax(jp)
    d, f, m = shape
    sizes = {"data": d, "fsdp": f, "pipe": 1, "expert": 1, "model": m, "seq": 1}
    got = layout.param_specs(port, sizes, table, view=jax_leaf)
    assert set(got) == set(port)
    for name, t in port.items():
        path, jshape, perm = jax_leaf(name, tuple(t.shape))
        spec = tuple(flat[path]) + (None,) * (len(jshape) - len(tuple(flat[path])))
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        want = tuple(spec[p] for p in perm)
        have = tuple(got[name]) + (None,) * (t.dim() - len(tuple(got[name])))
        assert tuple(tuple(e) if isinstance(e, list) else e for e in have) == want, name
