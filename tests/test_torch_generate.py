"""The port's ``generate`` and ``sample_logits`` against the JAX package's.

The tiny fp32 config of ``test_torch_decode.py`` (max_seq_len 64) with
``params_from_jax`` weights. Greedy tokens must be identical to JAX's for
uniform and right-padded mixed-length prompts, with ``eos_id``, a sliding
window, a rolling cache and an int8 cache: the logits agree to 1e-4 (see
``test_torch_decode.py``) and greedy output is the argmax.

Sampling cannot be compared draw for draw (JAX's PRNG bits are not
reproduced), so it is held three ways: the set of tokens ``top_k``/
``top_p``/``min_p`` keep equals JAX's on the same logits (the JAX side read
at its ``jax.random.categorical`` call); one ``torch.Generator`` seed gives
the same tokens twice; and 40,000 temperature-only draws from one row of
logits land on each token with the frequency of softmax(logits/T) within
0.012 (more than 4 standard deviations of a frequency, sqrt(p(1-p)/n) <=
0.0025).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models.convert import params_from_jax

B, S, NEW = 3, 8, 12
LENGTHS = np.array([8, 2, 5], np.int32)


def _pair(**overrides):
    base = dict(hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=2,
                num_layers=2, max_seq_len=64, remat=False, **overrides)
    jcfg = jllama.LlamaConfig.tiny(**base, dtype=jnp.float32, attention_impl="xla")
    tcfg = tllama.LlamaConfig.tiny(**base, dtype=torch.float32, attention_impl="xla")
    jmodel = jllama.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = tllama.Llama(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _prompt(seed=1):
    return np.random.default_rng(seed).integers(0, 256, size=(B, S)).astype(np.int32)


def _both(overrides, **kw):
    jmodel, params, tmodel = _pair(**overrides)
    jkw = dict(kw)
    if "prompt_lengths" in kw:
        jkw["prompt_lengths"] = jnp.asarray(kw["prompt_lengths"])
    ref = np.asarray(jllama.generate(jmodel, params, jnp.asarray(_prompt()), NEW, **jkw))
    got = tllama.generate(tmodel, torch.from_numpy(_prompt()), NEW, **kw)
    return ref, got, tmodel


# name -> (config overrides, generate kwargs)
CASES = {
    "uniform": (dict(), dict()),
    "padded": (dict(), dict(prompt_lengths=LENGTHS)),
    "window": (dict(sliding_window=5), dict(prompt_lengths=LENGTHS)),
    "rolling": (dict(sliding_window=5, kv_cache_len=16), dict()),
    "rolling_padded": (dict(sliding_window=5, kv_cache_len=16), dict(prompt_lengths=LENGTHS)),
    "int8": (dict(kv_cache_dtype="int8"), dict(prompt_lengths=LENGTHS)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_match_jax(name):
    overrides, kw = CASES[name]
    ref, got, _ = _both(overrides, **kw)
    assert got.shape == (B, NEW) and got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


def test_eos_exits_early_and_stays_in_finished_rows():
    """With ``eos_id`` the tokens equal JAX's: each row is its no-eos
    decode up to its first eos, then eos; the loop stops once every row
    has finished, after fewer steps than max_new_tokens - 1. The eos token
    and the rows are picked from a plain decode: a token two rows share,
    in a batch of those rows (the first repeated)."""
    jmodel, params, tmodel = _pair()
    first = np.asarray(jllama.generate(jmodel, params, jnp.asarray(_prompt()), NEW,
                                       prompt_lengths=jnp.asarray(LENGTHS)))
    shared = {t: [r for r in range(B) if t in first[r]] for t in set(first.ravel().tolist())}
    eos, rows = min(((t, r) for t, r in shared.items() if len(r) >= 2),
                    key=lambda c: (-len(c[1]), c[0]))
    sel = (rows * B)[:B]
    prompt, lengths = _prompt()[sel], LENGTHS[sel]
    plain = np.asarray(jllama.generate(jmodel, params, jnp.asarray(prompt), NEW,
                                       prompt_lengths=jnp.asarray(lengths)))
    assert all(eos in row for row in plain)
    last = max(int(np.argmax(row == eos)) for row in plain)
    assert last < NEW - 1
    # some row emits another token after its first eos in the plain decode
    assert any((row[int(np.argmax(row == eos)):] != eos).any() for row in plain)
    ref = np.asarray(jllama.generate(jmodel, params, jnp.asarray(prompt), NEW, eos_id=eos,
                                     prompt_lengths=jnp.asarray(lengths)))
    calls = []
    handle = tmodel.register_forward_pre_hook(lambda *a: calls.append(1))
    got = tllama.generate(tmodel, torch.from_numpy(prompt), NEW, eos_id=eos,
                          prompt_lengths=lengths)
    handle.remove()
    np.testing.assert_array_equal(got.numpy(), ref)
    for row, p in zip(got.numpy(), plain):
        at = int(np.argmax(row == eos))
        np.testing.assert_array_equal(row[:at + 1], p[:at + 1])
        assert (row[at:] == eos).all()
    assert len(calls) == 1 + last  # the prefill, then a step per token until all finished


class _Captured(Exception):
    pass


def _jax_kept(monkeypatch, logits, temperature, top_k, top_p, min_p):
    """The tokens JAX's sample_logits may draw: the finite entries of the
    logits it hands to jax.random.categorical."""
    seen = {}

    def capture(key, lg):
        seen["logits"] = np.asarray(lg)
        raise _Captured

    monkeypatch.setattr(jax.random, "categorical", capture)
    with pytest.raises(_Captured):
        jllama.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0), temperature, top_k,
                             top_p, min_p)
    monkeypatch.undo()
    return np.isfinite(seen["logits"])


TRUNCATIONS = [
    dict(top_k=5), dict(top_p=0.6), dict(min_p=0.2), dict(top_k=8, top_p=0.5),
    dict(top_k=6, min_p=0.3), dict(top_p=0.7, min_p=0.1), dict(top_k=10, top_p=0.8, min_p=0.05),
    dict(top_k=64), dict(top_p=1.0), dict(top_p=0.01), dict(min_p=1.0),
]


@pytest.mark.parametrize("trunc", TRUNCATIONS, ids=lambda t: ",".join(f"{k}={v}" for k, v in
                                                                       t.items()))
def test_kept_set_matches_jax(monkeypatch, trunc):
    logits = np.random.default_rng(7).normal(0, 2, size=(4, 64)).astype(np.float32)
    kw = {**dict(top_k=None, top_p=None, min_p=None), **trunc}
    want = _jax_kept(monkeypatch, logits, 0.7, **kw)
    got = torch.isfinite(tllama._truncate(torch.from_numpy(logits) / 0.7, **kw)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any(axis=-1).all()
    # what sample_logits draws always lies in the kept set
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tllama.sample_logits(torch.from_numpy(logits), gen, 0.7, **kw)
        assert got[np.arange(4), tok.numpy()].all()


def test_sampling_is_deterministic_for_a_generator_seed():
    _, _, tmodel = _pair()
    prompt = torch.from_numpy(_prompt())

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return tllama.generate(tmodel, prompt, NEW, temperature=0.9, top_k=40, top_p=0.95,
                               generator=gen, prompt_lengths=LENGTHS)

    a, b, c = draw(3), draw(3), draw(4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.equal(tllama.generate(tmodel, prompt, NEW, temperature=0.9),
                       tllama.generate(tmodel, prompt, NEW, temperature=0.9))


def test_temperature_sample_frequencies_follow_softmax():
    logits = torch.from_numpy(np.random.default_rng(8).normal(0, 1.5, size=16).astype(np.float32))
    temperature, n = 0.8, 40_000
    gen = torch.Generator().manual_seed(1)
    toks = tllama.sample_logits(logits.expand(n, 16), gen, temperature)
    freq = torch.bincount(toks, minlength=16).double() / n
    want = torch.softmax(logits.double() / temperature, -1)
    assert (freq - want).abs().max().item() <= 0.012


def test_greedy_is_argmax():
    logits = torch.randn(5, 32, generator=torch.Generator().manual_seed(2))
    assert torch.equal(tllama.sample_logits(logits, None, 0.0), logits.argmax(-1))


VALIDATIONS = [
    (dict(max_new_tokens=60), ValueError, "exceeds max_seq_len"),
    (dict(temperature=1.0, top_k=0), ValueError, "top_k must be >= 1"),
    (dict(temperature=1.0, top_p=0.0), ValueError, r"top_p must be in \(0, 1\]"),
    (dict(temperature=1.0, top_p=1.5), ValueError, r"top_p must be in \(0, 1\]"),
    (dict(temperature=1.0, min_p=-0.1), ValueError, r"min_p must be in \[0, 1\]"),
    (dict(top_k=5), ValueError, "require temperature > 0"),
    (dict(min_p=0.1), ValueError, "require temperature > 0"),
    (dict(prompt_lengths=np.array([8, 8])), ValueError, "prompt_lengths must have shape"),
    (dict(prompt_lengths=np.array([8, 0, 3])), ValueError, r"prompt_lengths must be in \[1, 8\]"),
    (dict(prompt_lengths=np.array([9, 1, 3])), ValueError, r"prompt_lengths must be in \[1, 8\]"),
    (dict(mesh=object()), NotImplementedError, "ROADMAP A9b"),
]


@pytest.mark.parametrize("kw,exc,match", VALIDATIONS, ids=[m for _, _, m in VALIDATIONS])
def test_generate_validations(kw, exc, match):
    """Every check of the reference's generate, and the refusal of a mesh."""
    _, _, tmodel = _pair()
    kw = dict(kw)
    new = kw.pop("max_new_tokens", NEW)
    with pytest.raises(exc, match=match):
        tllama.generate(tmodel, torch.from_numpy(_prompt()), new, **kw)
