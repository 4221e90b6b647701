"""The port's speculative decoding (``models/speculative.py``) against the
JAX package's and against the port's own ``generate``.

Target and draft weights are drawn on the JAX side and carried into the
port through ``models.convert``; prompts come from numpy seeds. The
target is the tiny Llama in fp32, the draft a smaller one with random
weights of its own (it disagrees with the target often, so the rejection
path runs).

Tolerances. Greedy: tokens equal, to the JAX package's
``speculative_generate`` and to the port's ``generate``. The rejection
rule: over 20,000 draws at V=6, k=2, the total-variation distance of the
emitted first token from the target's ``p`` at most 0.02 (the sampling
error of 20,000 draws is ~0.006). Sampled decoding agrees with the JAX
package's in distribution only (the generators differ), so it is held to
seeding and shapes.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu.models import speculative as jspec
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models import speculative as tspec
from tensorflowonspark_tpu_torch.models.convert import params_from_jax

DRAFT = dict(hidden_size=64, intermediate_size=128, num_layers=1, num_heads=2, num_kv_heads=1)
NEW = 10


def _cfgs(**overrides):
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, remat=False, attention_impl="xla",
                                   **overrides)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, remat=False, attention_impl="xla",
                                   **overrides)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _pair(seed, **overrides):
    """(JAX model, its params as numpy, the port's model on those weights)."""
    jcfg, tcfg = _cfgs(**overrides)
    jm = jllama.Llama(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    tm = tllama.Llama(tcfg, device="cpu")
    tllama.adopt_params(tm, params_from_jax(params))
    return jm, params, tm


def _target():
    return _pair(0)


def _draft():
    return _pair(1, **DRAFT)


def _prompt(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


@pytest.mark.parametrize("k,case,jax_too", [(1, "mixed", True), (4, "eos", True),
                                            (4, "mixed", False), (1, "eos", False)])
def test_greedy_equals_jax_and_generate(k, case, jax_too):
    """Right-padded rows of lengths 12, 7, 3 (and an eos taken from the
    plain decode of row 1, so that rows end at different steps): the
    port's tokens equal the port's plain ``generate`` and (two of the four
    cases, each a compile of its own there) the JAX package's
    ``speculative_generate``."""
    jt, tp, tt = _target()
    jd, dp, td = _draft()
    prompt = _prompt((3, 12), seed=10 + k)
    lengths = np.array([12, 7, 3], np.int32)
    plain = tllama.generate(tt, torch.tensor(prompt, dtype=torch.long), NEW,
                            prompt_lengths=lengths).numpy()
    eos = int(plain[1, 3]) if case == "eos" else None
    if eos is not None:
        plain = tllama.generate(tt, torch.tensor(prompt, dtype=torch.long), NEW,
                                prompt_lengths=lengths, eos_id=eos).numpy()
    stats = {}
    got = tspec.speculative_generate(tt, td, prompt, NEW, k=k, eos_id=eos,
                                     prompt_lengths=lengths, stats=stats).numpy()
    np.testing.assert_array_equal(got, plain)
    if jax_too:
        want = jspec.speculative_generate(jt, tp, jd, dp, jnp.asarray(prompt), NEW, k=k,
                                          eos_id=eos, prompt_lengths=lengths)
        np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["host_reads"] == stats["iterations"] + 1
    assert 0 <= stats["accepted"] <= k * stats["row_verifies"]


def test_self_draft_accepts_every_proposal():
    """The target as its own draft: every verify accepts all k drafts, so
    a row emits k + 1 tokens a verify and the loop takes ceil((N-1) /
    (k+1)) verifies."""
    _, _, tt = _target()
    prompt = _prompt((2, 8), seed=3)
    k = 3
    stats = {}
    got = tspec.speculative_generate(tt, tt, prompt, NEW, k=k, stats=stats)
    plain = tllama.generate(tt, torch.tensor(prompt, dtype=torch.long), NEW)
    assert torch.equal(got, plain)
    assert stats["accepted"] == k * stats["row_verifies"]
    assert stats["iterations"] == -(-(NEW - 1) // (k + 1))


def test_validations_match_the_reference():
    _, _, tt = _target()
    _, _, td = _draft()
    prompt = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match="k must be"):
        tspec.speculative_generate(tt, td, prompt, 4, k=0)
    with pytest.raises(ValueError, match="max_seq_len"):
        tspec.speculative_generate(tt, td, prompt, tt.cfg.max_seq_len, k=4)
    with pytest.raises(ValueError, match="temperature"):
        tspec.speculative_generate(tt, td, prompt, 4, temperature=-1.0)
    with pytest.raises(ValueError, match="prompt_lengths"):
        tspec.speculative_generate(tt, td, prompt, 4, prompt_lengths=[9])
    with pytest.raises(NotImplementedError, match="ROADMAP A9b"):
        tspec.speculative_generate(tt, td, prompt, 4, mesh=object())


def _accept_case():
    v, k = 6, 2
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(v), size=k + 1).astype(np.float32)
    q = rng.dirichlet(np.ones(v), size=k).astype(np.float32)
    return v, k, p, q


def test_accept_rule_keeps_the_target_distribution():
    """Monte Carlo: drafts sampled from q, the first emitted token is
    distributed as p_0 (total variation <= 0.02 over 20,000 draws); the
    same rule in the JAX package gives the same acceptance rate within
    the sampling error."""
    v, k, p, q = _accept_case()
    n = 20000
    g = torch.Generator().manual_seed(0)
    qt = torch.tensor(q)
    drafts = torch.stack([torch.multinomial(qt[j], n, replacement=True, generator=g)
                          for j in range(k)], dim=1)
    t_probs = torch.tensor(p)[None].expand(n, k + 1, v)
    d_probs = qt[None].expand(n, k, v)
    emit, accepted = tspec.speculative_accept(g, t_probs, d_probs, drafts)
    freq = torch.bincount(emit[:, 0], minlength=v).double() / n
    tv = 0.5 * (freq - torch.tensor(p[0]).double()).abs().sum()
    assert tv <= 0.02, float(tv)
    jemit, jacc = jax.jit(jspec.speculative_accept)(
        jax.random.PRNGKey(0), jnp.broadcast_to(jnp.asarray(p), (n, k + 1, v)),
        jnp.broadcast_to(jnp.asarray(q), (n, k, v)), jnp.asarray(drafts.numpy()))
    assert abs(float(accepted.float().mean()) - float(np.asarray(jacc).mean())) < 0.05
    assert emit.shape == (n, k + 1) and int(accepted.max()) <= k


def test_accept_rule_with_the_target_as_draft_accepts_all():
    v, k, p, _ = _accept_case()
    g = torch.Generator().manual_seed(1)
    pt = torch.tensor(p)
    drafts = torch.stack([torch.multinomial(pt[j], 64, replacement=True, generator=g)
                          for j in range(k)], dim=1)
    emit, accepted = tspec.speculative_accept(g, pt[None].expand(64, k + 1, v),
                                              pt[:k][None].expand(64, k, v), drafts)
    assert bool((accepted == k).all())
    assert torch.equal(emit[:, :k], drafts)


def test_sampled_decode_is_seeded():
    """Sampled speculative decoding: the generator fixes the tokens; another
    seed gives others; every token is in the vocabulary."""
    _, _, tt = _target()
    _, _, td = _draft()
    prompt = _prompt((2, 8), seed=4)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tspec.speculative_generate(tt, td, prompt, NEW, k=3, temperature=0.8,
                                          generator=g)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, NEW) and int(a.min()) >= 0 and int(a.max()) < tt.cfg.vocab_size


def test_int8_target_composes_with_a_draft():
    """An int8 weight set (``ops.quant.quantize_tree``) as the target:
    speculative greedy equals that target's plain greedy."""
    from tensorflowonspark_tpu_torch.ops.quant import quantize_tree

    _, _, tt = _target()
    _, _, td = _draft()
    q = tllama.Llama(tt.cfg, device="cpu")
    tllama.adopt_params(q, quantize_tree({n: t.detach() for n, t in tt.named_parameters()},
                                         min_size=1024))
    prompt = _prompt((2, 8), seed=23)
    plain = tllama.generate(q, torch.tensor(prompt, dtype=torch.long), 8)
    spec = tspec.speculative_generate(q, td, prompt, 8, k=3)
    assert torch.equal(plain, spec)


def test_composes_with_window_and_int8_kv_cache():
    """A sliding-window target with an int8 KV cache (the reference's
    ``test_speculative_composes_with_window_and_int8_kv``): equal to that
    target's plain greedy decode."""
    _, _, tt = _target()
    cfg = dataclasses.replace(tt.cfg, sliding_window=5, kv_cache_dtype="int8")
    windowed = tllama.Llama(cfg, device="cpu")
    tllama.adopt_params(windowed, dict(tt.named_parameters()))
    _, _, td = _draft()
    prompt = _prompt((2, 16), seed=7)
    plain = tllama.generate(windowed, torch.tensor(prompt, dtype=torch.long), 12)
    got = tspec.speculative_generate(windowed, td, prompt, 12, k=3)
    assert torch.equal(got, plain)


def test_early_exit_draft_shares_the_target_tensors():
    """A LayerSkip-style draft (the target's embedding, first block, final
    norm and head, the same tensors): greedy equals the target's, and it
    accepts some drafts but not all."""
    _, _, tt = _target()
    dcfg = dataclasses.replace(tt.cfg, num_layers=1)
    early = tllama.Llama(dcfg, device="cpu")
    own = dict(tt.named_parameters())
    tllama.adopt_params(early, {n: own[n] for n, _ in early.named_parameters()})
    assert early.embed is tt.embed and early.layers[0].attn.q_proj.weight is \
        tt.layers[0].attn.q_proj.weight
    prompt = _prompt((2, 8), seed=5)
    stats = {}
    got = tspec.speculative_generate(tt, early, prompt, NEW, k=2, stats=stats)
    assert torch.equal(got, tllama.generate(tt, torch.tensor(prompt, dtype=torch.long), NEW))
    assert 0 <= stats["accepted"] < 2 * stats["row_verifies"]


@pytest.mark.parametrize("draft_vocab", [64, 4096])
def test_draft_of_another_vocabulary(draft_vocab):
    """A 1-layer draft whose vocabulary differs from the target's (256):
    greedy tokens equal the JAX package's ``speculative_generate`` and
    ``generate`` and the port's ``generate``. A prompt id past a small
    draft's vocabulary and a proposal past the target's are clamped, as the
    JAX package's gather clamps them; such a proposal is rejected."""
    jt, tp, tt = _target()
    jd, dp, td = _pair(2, vocab_size=draft_vocab, **DRAFT)
    prompt = _prompt((3, 12), seed=31)
    lengths = np.array([12, 9, 4], np.int32)
    stats = {}
    got = tspec.speculative_generate(tt, td, prompt, NEW, k=3, prompt_lengths=lengths,
                                     stats=stats).numpy()
    plain = tllama.generate(tt, torch.tensor(prompt, dtype=torch.long), NEW,
                            prompt_lengths=lengths).numpy()
    np.testing.assert_array_equal(got, plain)
    want = jspec.speculative_generate(jt, tp, jd, dp, jnp.asarray(prompt), NEW, k=3,
                                      prompt_lengths=lengths)
    np.testing.assert_array_equal(got, np.asarray(want))
    want_plain = jllama.generate(jt, tp, jnp.asarray(prompt), NEW, prompt_lengths=lengths)
    np.testing.assert_array_equal(got, np.asarray(want_plain))
    assert 0 <= stats["accepted"] <= 3 * stats["row_verifies"]


def test_sampling_refuses_two_vocabularies():
    _, _, tt = _target()
    _, _, td = _pair(2, vocab_size=64, **DRAFT)
    with pytest.raises(ValueError, match="one vocabulary"):
        tspec.speculative_generate(tt, td, _prompt((1, 8), seed=1), 4, temperature=0.5)
