"""The port's KV-cache decode against the JAX package's.

A tiny config (hidden 128, 4 heads of 32, 2 kv heads, 2 layers, max_seq_len
64). The JAX model's initial weights go through ``params_from_jax`` into the
port; both sides prefill the same numpy prompt and then take the same
single-token steps (teacher-forced tokens from a seed), each side against
its own cache. After the prefill and after every step the logits and every
cache leaf are compared, the port's cache moved into the flax layout by
``cache_to_jax``.

Tolerances. fp32: logits 1e-4 absolute / 1e-3 relative (as
``test_torch_llama.py``), K/V and int8 scales 1e-5 absolute / 1e-4 relative
(one projection and RoPE, summed in other orders); ``seg``/``pos``/``idx``
exact; int8 codes within one step (a value at a rounding boundary may round
either way). bf16: logits 1e-2 absolute / 1e-2 relative and K/V one bf16
step (2^-7 relative, 1e-2 absolute): both sides round the same products to
bf16 at the same points, in other summation orders (the largest logit
error reads 4.6e-3). At the attention alone, bf16 inputs with logits of
rms ~9: one bf16 step of the output (2^-7 relative, 1e-3 absolute); the
two sides agree exactly on the CPU, and logits rounded to bf16 before the
softmax read 0.047 off.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models.convert import cache_from_jax, cache_to_jax, params_from_jax

MAX_SEQ = 64
B, S = 3, 8
LOGIT_TOL = dict(rtol=1e-3, atol=1e-4)
KV_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_LOGIT_TOL = dict(rtol=1e-2, atol=1e-2)
BF16_KV_TOL = dict(rtol=2**-7, atol=1e-2)
EXACT_LEAVES = ("seg", "pos", "idx")


def _configs(dtype="float32", **overrides):
    base = dict(hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=2,
                num_layers=2, max_seq_len=MAX_SEQ, remat=False, **overrides)
    jcfg = jllama.LlamaConfig.tiny(**base, dtype=getattr(jnp, dtype), attention_impl="xla")
    tcfg = tllama.LlamaConfig.tiny(**base, dtype=getattr(torch, dtype), attention_impl="xla")
    return jcfg, tcfg


def _models(jcfg, tcfg, seed=0):
    jmodel = jllama.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    tmodel = tllama.Llama(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(params))
    tmodel.to(tcfg.dtype)  # both sides decode in the compute dtype
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jcfg.dtype), params)
    return jmodel, jparams, tmodel


def _tokens(shape, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


class Pair:
    """The two models and their caches, stepped together."""

    def __init__(self, jcfg, tcfg, seed=0):
        self.jmodel, self.jparams, self.tmodel = _models(jcfg, tcfg, seed)
        self.tcfg = tcfg
        self.jcache = None
        self.tcache = tllama.init_cache(tcfg, B, "cpu")

    def step(self, tokens, positions=None, padded=False, segment_ids=None):
        jvars = {"params": self.jparams}
        if self.jcache is not None:
            jvars["cache"] = self.jcache
        kw = {} if positions is None else {"positions": jnp.asarray(positions)}
        if segment_ids is not None:
            kw["segment_ids"] = jnp.asarray(segment_ids)
        jlogits, upd = self.jmodel.apply(jvars, jnp.asarray(tokens), decode=True,
                                         padded=padded, mutable=["cache"], **kw)
        self.jcache = upd["cache"]
        tkw = {k: torch.tensor(np.asarray(v)) for k, v in kw.items()}
        with torch.no_grad():
            tlogits = self.tmodel(torch.from_numpy(tokens), decode=True, padded=padded,
                                  cache=self.tcache, **tkw)
        return np.asarray(jlogits, np.float32), tlogits.float().numpy()

    def compare_cache(self, kv_tol):
        ref = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                                              else x), self.jcache))[0]
        got = dict(jax.tree_util.tree_flatten_with_path(cache_to_jax(self.tcache))[0])
        assert sorted(map(jax.tree_util.keystr, got)) == sorted(
            jax.tree_util.keystr(p) for p, _ in ref)
        for path, want in ref:
            name = jax.tree_util.keystr(path)
            have = got[path]
            assert have.shape == want.shape, name
            if name.endswith(tuple(f"'{n}']" for n in EXACT_LEAVES)):
                np.testing.assert_array_equal(have, want, err_msg=name)
            elif want.dtype == np.int8:
                assert have.dtype == np.int8, name
                assert np.abs(have.astype(np.int32) - want.astype(np.int32)).max() <= 1, name
            else:
                np.testing.assert_allclose(have, want, **kv_tol, err_msg=name)


def _packed_segments():
    """Rows of documents (ids restart per row), no padding."""
    return np.array([[1, 1, 1, 2, 2, 2, 2, 2], [1, 1, 1, 1, 1, 1, 1, 1],
                     [1, 2, 3, 3, 3, 4, 4, 4]], np.int32)


# name -> (config overrides, padded, packed)
VARIANTS = {
    "dense": (dict(), False, False),
    "padded": (dict(), True, False),
    "segments": (dict(), False, True),
    "window": (dict(sliding_window=5), False, False),
    "window_padded": (dict(sliding_window=5), True, False),
    "window_segments": (dict(sliding_window=5), False, True),
    "rolling": (dict(sliding_window=5, kv_cache_len=16), False, False),
    "rolling_padded": (dict(sliding_window=5, kv_cache_len=16), True, False),
    "int8": (dict(kv_cache_dtype="int8"), False, False),
    "int8_padded": (dict(kv_cache_dtype="int8"), True, False),
    "int8_rolling_padded": (dict(kv_cache_dtype="int8", sliding_window=5, kv_cache_len=16),
                            True, False),
}
LENGTHS = np.array([8, 1, 5], np.int32)  # rows of very different true lengths
STEPS = 12  # the rolling cache of 16 slots wraps at position 16


def _run(pair, padded, packed, logit_tol, kv_tol, steps=STEPS):
    prompt = _tokens((B, S), seed=1)
    seg = _packed_segments() if packed else None
    positions = None
    jl, tl = pair.step(prompt, padded=padded, segment_ids=seg)
    np.testing.assert_allclose(tl, jl, **logit_tol)
    pair.compare_cache(kv_tol)
    if packed:  # continue each row's last document
        pos = np.asarray(tllama.packed_positions(torch.from_numpy(seg)))[:, -1] + 1
        seg_step = seg[:, -1:]
    else:
        pos = LENGTHS.copy() if padded else np.full(B, S, np.int32)
        seg_step = None
    toks = _tokens((steps, B), seed=2)
    first_k = None
    for t in range(steps):
        positions = pos[:, None].astype(np.int32)
        jl, tl = pair.step(toks[t][:, None], positions, padded, seg_step)
        np.testing.assert_allclose(tl, jl, **logit_tol, err_msg=f"step {t}")
        pair.compare_cache(kv_tol)
        if t == 0:
            first_k = pair.tcache[0]["k"].clone()
        pos = pos + 1
    return first_k


@pytest.mark.parametrize("name", list(VARIANTS))
def test_decode_matches_jax(name):
    """Logits after the prefill and after each of 12 steps, and every cache
    leaf, in each variant of the reference's cached attention."""
    overrides, padded, packed = VARIANTS[name]
    pair = Pair(*_configs(**overrides))
    _run(pair, padded, packed, LOGIT_TOL, KV_TOL)


def test_decode_matches_jax_bf16():
    """bf16 on both sides: the port's logits stay fp32 against the bf16 cache
    (the reference's preferred_element_type=float32), GQA, padded rows."""
    pair = Pair(*_configs("bfloat16"))
    _run(pair, True, False, BF16_LOGIT_TOL, BF16_KV_TOL, steps=4)


class _CachedAttention(jllama.Attention):
    """The reference's cached attention alone, on given q/k/v."""

    @nn.compact
    def __call__(self, q, k, v, positions):
        return self._cached_attention(q, k, v, positions)


def test_cached_attention_keeps_fp32_logits_bf16():
    """bf16 q/k/v with large logits (rms ~9) through the cached attention of
    both sides: the port's QK^T logits are fp32 like the reference's
    (preferred_element_type=float32), so the outputs agree to one bf16
    step; bf16-rounded logits would be ~6 steps off."""
    jcfg, tcfg = _configs("bfloat16")
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, 16, 4, 32)).astype(np.float32) * 3
    k = rng.standard_normal((B, 16, 2, 32)).astype(np.float32) * 3
    v = rng.standard_normal((B, 16, 2, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (B, 16))
    ref, _ = _CachedAttention(jcfg).apply(
        {}, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(pos),
        mutable=["cache"])
    ref = np.asarray(ref.astype(jnp.float32))
    cache = tllama.init_cache(tcfg, B, "cpu")[0]
    out = tllama.cached_attention(tcfg, *(torch.tensor(x).bfloat16() for x in (q, k, v)),
                                  torch.tensor(pos), cache)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2**-7, atol=1e-3)


def test_padding_is_overwritten_by_the_first_decoded_token():
    """A padded prefill writes junk K past each short row's true length;
    the row's first decode step writes its own token's K over it (and the
    cache equals the JAX package's after the step, as the variant test
    checks)."""
    pair = Pair(*_configs())
    prompt = _tokens((B, S), seed=1)
    pair.step(prompt, padded=True)
    junk = pair.tcache[0]["k"].clone()
    for r in (1, 2):  # rows shorter than the width
        assert junk[r, :, LENGTHS[r]].abs().max() > 0
    tok = _tokens((B, 1), seed=3)
    pair.step(tok, LENGTHS[:, None], padded=True)
    after = pair.tcache[0]["k"]
    for r in (1, 2):
        assert not torch.equal(after[r, :, LENGTHS[r]], junk[r, :, LENGTHS[r]])
        # every other slot of the row is untouched
        other = [i for i in range(MAX_SEQ) if i != LENGTHS[r]]
        assert torch.equal(after[r, :, other], junk[r, :, other])
    pair.compare_cache(KV_TOL)


@pytest.mark.parametrize("overrides", [dict(), dict(sliding_window=5),
                                       dict(sliding_window=5, kv_cache_len=16),
                                       dict(kv_cache_dtype="int8", sliding_window=5,
                                            kv_cache_len=16)],
                         ids=["dense", "window", "rolling", "int8_rolling"])
def test_init_cache_matches_the_flax_variables(overrides):
    """init_cache gives the flax cache's leaves, shapes (batch first, heads
    moved before the slots) and dtypes, every value zero except ``pos``
    under a rolling cache (-1, as the reference's ``init_cache`` sets it)."""
    jcfg, tcfg = _configs(**overrides)
    shapes = jax.eval_shape(
        lambda: jllama.Llama(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((B, 4), jnp.int32),
                                        decode=True))["cache"]
    ref = jllama.init_cache(shapes)
    cache = tllama.init_cache(tcfg, B, "cpu")
    flat_ref = {jax.tree_util.keystr(p): x
                for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat = {jax.tree_util.keystr(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(cache_to_jax(cache))[0]}
    assert flat.keys() == flat_ref.keys()
    rolling = "kv_cache_len" in overrides
    for name, want in flat_ref.items():
        have = flat[name]
        assert have.shape == want.shape, name
        if want.dtype == jnp.bfloat16:
            assert have.dtype == np.float32
        else:
            assert have.dtype == want.dtype, name
        if name.endswith("['pos']") and not rolling:
            # a dense window's position plane starts at 0, as the flax
            # variable does (the reference's init_cache writes -1; no read
            # of an unwritten dense slot passes the slot mask either way)
            assert (have == 0).all()
        else:
            np.testing.assert_array_equal(have, np.asarray(want), err_msg=name)
    for layer in cache:
        for name, t in layer.items():
            assert name == "idx" or t.shape[0] == B, name


def test_cache_bridge_round_trips():
    """cache_from_jax(JAX cache) -> cache_to_jax gives the JAX cache back,
    int8 codes and scales included, and the port decodes on from it."""
    jcfg, tcfg = _configs(kv_cache_dtype="int8", sliding_window=5)
    pair = Pair(jcfg, tcfg)
    pair.step(_tokens((B, S), seed=1))
    port = cache_from_jax(jax.tree.map(np.asarray, pair.jcache))
    assert port[0]["k"].dtype == torch.int8 and port[0]["k"].shape == (B, 2, MAX_SEQ, 32)
    back = cache_to_jax(port)
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, want in jax.tree_util.tree_flatten_with_path(pair.jcache)[0]:
        np.testing.assert_array_equal(flat[path], np.asarray(want))
    pair.tcache = port
    tok = _tokens((B, 1), seed=4)
    jl, tl = pair.step(tok, np.full((B, 1), S, np.int32))
    np.testing.assert_allclose(tl, jl, **LOGIT_TOL)
    with pytest.raises(KeyError, match="layer0/attn/extra"):
        cache_from_jax({"layer0": {"attn": {"extra": np.zeros(2)}}})


def _decode(tcfg, tokens, **kw):
    model = tllama.Llama(tcfg, device="cpu")
    cache = tllama.init_cache(tcfg, tokens.shape[0], "cpu")
    with torch.no_grad():
        return model(torch.from_numpy(tokens), decode=True, cache=cache, **kw)


@pytest.mark.parametrize("case", ["segments_padded", "rolling_no_window", "rolling_segments",
                                  "rolling_too_short", "no_cache", "cache_depth"])
def test_decode_errors(case):
    """Every error the reference's cached attention raises, and the port's
    own: decode without a cache, or with one of another depth."""
    toks = _tokens((B, S), seed=5)
    seg = np.ones((B, S), np.int32)
    if case == "segments_padded":
        _, tcfg = _configs()
        with pytest.raises(ValueError, match="segment_ids with padded=True"):
            _decode(tcfg, toks, padded=True, segment_ids=torch.from_numpy(seg))
    elif case == "rolling_no_window":
        _, tcfg = _configs(kv_cache_len=16)
        with pytest.raises(ValueError, match="needs sliding_window"):
            _decode(tcfg, toks)
    elif case == "rolling_segments":
        _, tcfg = _configs(sliding_window=5, kv_cache_len=16)
        with pytest.raises(ValueError, match="packed rows"):
            _decode(tcfg, toks, segment_ids=torch.from_numpy(seg))
    elif case == "rolling_too_short":
        _, tcfg = _configs(sliding_window=12, kv_cache_len=16)
        with pytest.raises(ValueError, match="must be >= sliding_window"):
            _decode(tcfg, toks)
    elif case == "no_cache":
        _, tcfg = _configs()
        with pytest.raises(ValueError, match="needs a cache"):
            tllama.Llama(tcfg, device="cpu")(torch.from_numpy(toks), decode=True)
    else:
        _, tcfg = _configs()
        cache = tllama.init_cache(dataclasses.replace(tcfg, num_layers=1), B, "cpu")
        with pytest.raises(ValueError, match="a cache of 1 layers"):
            tllama.Llama(tcfg, device="cpu")(torch.from_numpy(toks), decode=True, cache=cache)
