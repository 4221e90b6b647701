"""The port's ``ContinuousBatcher`` against the JAX package's.

The tiny fp32 config (max_seq_len 64) with weights drawn by JAX and moved
over by ``params_from_jax``; the JAX engine runs on the CPU. Greedy tokens
must be identical and logprobs within 1e-4 of the JAX engine's on the same
requests: staggered admission from threads, more requests than slots,
per-request and engine-wide eos, per-request budgets, stop sequences with
the longest match, multi-width buckets, chunked prefill, the prefix cache
with LRU eviction, and the int8 and rolling KV caches. A greedy
completion does not depend on how its row was scheduled, so each JAX
engine's outputs are the reference for every port engine of that model.

The sampler's masks (``_row_truncate``, min_p, the penalties and
logit_bias) must equal JAX's exactly on the same logits: both sides' draw
is replaced by "the least likely token still kept", which names each
row's threshold. Sampled draws themselves differ by design (the port's
noise is a counter-based hash, not JAX's PRNG), so sampling is held to
reproducibility and, by a chi-square test, to the truncated softmax.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu.serving import engine as jengine
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models.convert import params_from_jax
from tensorflowonspark_tpu_torch.serving import (
    ContinuousBatcher,
    DeadlineExceeded,
    EngineOverloaded,
    EngineWedged,
    WeightsIncompatible,
)
from tensorflowonspark_tpu_torch.serving import engine as tengine
from tensorflowonspark_tpu_torch.utils import failpoints as fp

LP_TOL = 1e-4
JOIN_S = 120
BASE = dict(remat=False, max_seq_len=64)
# model config overrides of each KV-cache kind
KINDS = {"dense": {}, "int8": dict(kv_cache_dtype="int8"),
         "rolling": dict(sliding_window=8, kv_cache_len=24)}
_rng = np.random.default_rng(0)
PROMPTS = [_rng.integers(1, 256, n).tolist() for n in (3, 7, 12, 5, 16, 2, 9)]
BUDGETS = [12, 5, 9, 12, 3, 12, 7]


@pytest.fixture(scope="module")
def jparams():
    jm = jllama.Llama(jllama.LlamaConfig.tiny(**BASE, dtype=jnp.float32))
    return jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def _jmodel(kind):
    return jllama.Llama(jllama.LlamaConfig.tiny(**BASE, **KINDS[kind], dtype=jnp.float32,
                                                attention_impl="xla"))


def _tmodel(kind, jparams):
    cfg = tllama.LlamaConfig.tiny(**BASE, **KINDS[kind], dtype=torch.float32,
                                  attention_impl="xla")
    m = tllama.Llama(cfg, device="cpu")
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return m


def _requests(full):
    """The request set, from the JAX engine's eos-free completions
    ``full`` of PROMPTS: a per-request eos taken from row 0's own
    completion, stop sequences whose longest match is two tokens (row 3)
    and a mid-completion pair (row 5), and the per-request budgets."""
    reqs = []
    for i, (p, c) in enumerate(zip(PROMPTS, full)):
        kw = dict(max_new_tokens=BUDGETS[i])
        if i == 0:
            kw["eos_id"] = c[4]
        if i == 3:
            kw["stop"] = [[c[6]], [c[5], c[6]]]
        if i == 5:
            kw["stop"] = [c[2:4]]
        reqs.append((p, kw))
    return reqs


def _run(eng, reqs, stagger=0.0, threads=True):
    """Every request through ``eng`` (from one thread each, at staggered
    times, or in order): {i: (tokens, logprobs)}."""
    out = {}

    def fire(i):
        time.sleep(stagger * i)
        p, kw = reqs[i]
        out[i] = eng.submit(p, return_logprobs=True, **kw)

    if not threads:
        for i in range(len(reqs)):
            fire(i)
        return out
    ts = [threading.Thread(target=fire, args=(i,)) for i in range(len(reqs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    return out


def _same(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        assert got[i][0] == want[i][0], (i, got[i][0], want[i][0])
        np.testing.assert_allclose(got[i][1], want[i][1], atol=LP_TOL, rtol=0)


@pytest.fixture(scope="module")
def reference(jparams):
    """The JAX engines' outputs: {kind or setting: (requests, results)}."""
    refs = {}
    eng = jengine.ContinuousBatcher(_jmodel("dense"), jparams, slots=3, prompt_widths=(8, 16))
    try:
        full = eng.submit_many(PROMPTS, 12, eos_id=-1)
        reqs = _requests(full)
        refs["dense"] = (reqs, _run(eng, reqs, threads=False))
        # the engine-wide eos: rows without their own eos stop at E
        eos = full[2][2]
        eos_reqs = [(p, {"eos_id": eos, **kw}) for p, kw in reqs]
        refs["engine_eos"] = (eos, _run(eng, eos_reqs, threads=False))
    finally:
        eng.close()
    eng = jengine.ContinuousBatcher(_jmodel("dense"), jparams, slots=2, prompt_widths=(16,),
                                    prefill_chunk=4, prefix_cache=2)
    try:
        refs["prefix"] = _prefix_run(eng)  # first: its stats count from a fresh engine
        refs["chunked"] = (reqs, _run(eng, reqs, threads=False))
    finally:
        eng.close()
    for kind in ("int8", "rolling"):
        eng = jengine.ContinuousBatcher(_jmodel(kind), jparams, slots=3, prompt_widths=(16,))
        try:
            refs[kind] = (reqs, _run(eng, reqs, threads=False))
        finally:
            eng.close()
    return refs


SYSTEM = [11, 12, 13, 14, 15, 16, 17, 18, 19]


def _prefix_run(eng):
    """Prompts sharing a system prefix, in order, through a 2-entry
    prefix cache: hits, misses and LRU evictions, then the stats."""
    prompts = [SYSTEM + [1, 2], SYSTEM + [3], SYSTEM + [1, 2, 4], [5, 6, 7, 8, 9],
               [40, 41, 42, 43, 44, 45], [50, 51, 52, 53, 54, 55], SYSTEM + [7]]
    out = [eng.submit(p, 6, return_logprobs=True) for p in prompts]
    st = eng.stats()
    return out, {k: st[k] for k in ("prefix_cache_entries", "prefix_hits", "prefix_misses",
                                    "prefix_tokens_saved")}


# name -> (model kind, port engine kwargs, reference, stagger s)
CASES = {
    "staggered": ("dense", dict(slots=3, prompt_widths=(8, 16), decode_block=4), "dense", 0.01),
    "one_slot": ("dense", dict(slots=1, prompt_widths=(8, 16)), "dense", 0.0),
    "serial_k1_depth1": ("dense", dict(slots=3, prompt_widths=(8, 16), decode_block=1,
                                       pipeline_depth=1), "dense", 0.005),
    "multi_width": ("dense", dict(slots=2, prompt_widths=(4, 8, 16), decode_block=2), "dense",
                    0.0),
    "engine_eos": ("dense", dict(slots=3, prompt_widths=(8, 16)), "engine_eos", 0.0),
    "chunked": ("dense", dict(slots=2, prompt_widths=(16,), prefill_chunk=4), "chunked", 0.005),
    "int8": ("int8", dict(slots=3, prompt_widths=(16,), decode_block=4), "int8", 0.005),
    "rolling": ("rolling", dict(slots=3, prompt_widths=(16,), decode_block=4), "rolling", 0.005),
}


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_jax_engine(name, jparams, reference):
    kind, kw, ref, stagger = CASES[name]
    if ref == "engine_eos":
        eos, want = reference[ref]
        reqs = reference["dense"][0]
        kw = dict(kw, eos_id=eos)
    else:
        reqs, want = reference[ref]
    eng = ContinuousBatcher(_tmodel(kind, jparams), **kw)
    try:
        got = _run(eng, reqs, stagger=stagger)
        assert eng.admitted == len(reqs)
    finally:
        eng.close()
    _same(got, want)
    assert any(len(want[i][0]) < BUDGETS[i] for i in want)  # eos or a stop ended some rows


def test_prefix_cache_hits_and_lru_match_jax(jparams, reference):
    want, want_stats = reference["prefix"]
    eng = ContinuousBatcher(_tmodel("dense", jparams), slots=2, prompt_widths=(16,),
                            prefill_chunk=4, prefix_cache=2)
    try:
        got, stats = _prefix_run(eng)
    finally:
        eng.close()
    # hits on a boundary entry and a whole prompt; the last SYSTEM prompt
    # misses, its entries evicted by the three unrelated ones
    assert stats == want_stats and stats["prefix_hits"] >= 2 and stats["prefix_misses"] >= 5
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(gl, wl, atol=LP_TOL, rtol=0)
    # a hit resumes from a stored cache: the same prompt again equals a miss
    solo = ContinuousBatcher(_tmodel("dense", jparams), slots=1, prompt_widths=(16,))
    try:
        assert solo.submit(SYSTEM + [1, 2, 4], 6) == got[2][0]
    finally:
        solo.close()


def test_block_and_depth_give_identical_tokens(jparams):
    """decode_block 1/4 and pipeline_depth 1/2, with staggered and seeded
    sampled traffic mixed in: every completion identical."""
    model = _tmodel("dense", jparams)
    reqs = [(p, dict(max_new_tokens=b)) for p, b in zip(PROMPTS, BUDGETS)]
    reqs += [(p, dict(max_new_tokens=8, temperature=0.8, top_p=0.9, seed=i,
                      min_p=0.05 if i % 2 else None)) for i, p in enumerate(PROMPTS[:4])]
    outs = []
    for k, depth in ((1, 1), (4, 1), (1, 2), (4, 2)):
        eng = ContinuousBatcher(model, slots=3, prompt_widths=(16,), decode_block=k,
                                pipeline_depth=depth)
        try:
            outs.append(_run(eng, reqs, stagger=0.003))
        finally:
            eng.close()
    for o in outs[1:]:
        assert {i: v[0] for i, v in o.items()} == {i: v[0] for i, v in outs[0].items()}


# -- the sampler's masks against JAX's ------------------------------------


def _kept_min_port(trunc, seeds, counters):
    return torch.where(torch.isfinite(trunc), trunc, torch.inf).argmin(-1)


def _kept_min_jax(key, logits, *a, **k):
    return jnp.argmin(jnp.where(jnp.isfinite(logits), logits, jnp.inf))


def _both_sample(monkeypatch, logits, temps, kps, pens=None, counts=None, bias=None):
    """(tokens, logprobs) of both samplers with the draw replaced by the
    least likely kept token; gates as the scheduler would set them."""
    monkeypatch.setattr(tengine, "_draw", _kept_min_port)
    monkeypatch.setattr(jax.random, "categorical", _kept_min_jax)
    b, vocab = logits.shape
    seeds, counters = np.arange(b), np.full(b, 3)
    jkw, tkw = {}, {}
    if pens is not None:
        jkw.update(pens=jnp.asarray(pens), counts=jnp.asarray(counts))
        tkw.update(pens=torch.from_numpy(pens), counts=torch.from_numpy(counts))
    if bias is not None:
        jkw.update(bias_ids=jnp.asarray(bias[0], jnp.int32), bias_vals=jnp.asarray(bias[1]))
        tkw.update(bias_ids=torch.from_numpy(bias[0]).long(), bias_vals=torch.from_numpy(bias[1]))
    jt, jl = jengine._sample_rows(jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(kps),
                                  jnp.asarray(seeds, jnp.uint32),
                                  jnp.asarray(counters, jnp.int32), **jkw)
    gates = (bool(((kps[:, 0] < vocab) | (kps[:, 1] < 1.0)).any()), bool((kps[:, 2] > 0).any()),
             pens is not None and bool((pens != 0).any()),
             bias is not None and bool((bias[0] >= 0).any()), bool((temps > 0).any()))
    tt, tl = tengine._sample_rows(torch.from_numpy(logits), torch.from_numpy(temps),
                                  torch.from_numpy(kps), torch.from_numpy(seeds),
                                  torch.from_numpy(counters), gates=gates, **tkw)
    return (np.asarray(jt), np.asarray(jl)), (tt.numpy(), tl.numpy())


def _assert_same(pair):
    (jt, jl), (tt, tl) = pair
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k,p", [(5, None), (None, 0.7), (8, 0.9), (1, None), (None, 1e-6)])
def test_row_truncate_equals_jax(k, p):
    rng = np.random.default_rng(0)
    vocab, b = 50, 4
    scaled = rng.normal(0, 3, (b, vocab)).astype(np.float32)
    ks = np.full(b, float(k or vocab), np.float32)
    ps = np.full(b, p or 1.0, np.float32)
    want = np.asarray(jengine._row_truncate(jnp.asarray(scaled), jnp.asarray(ks), jnp.asarray(ps)))
    got = tengine._row_truncate(torch.from_numpy(scaled), torch.from_numpy(ks),
                                torch.from_numpy(ps)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])


def test_row_truncate_disabled_row_keeps_its_tail_beside_a_truncating_row():
    """The reference's saturation case: a disabled row (k=vocab, p=1)
    routed through the sort because its batchmate truncates, with a
    peaked distribution whose fp32 cumsum reaches exactly 1.0 before its
    least likely token: the inclusive compare (cum < p) would drop that
    tail, the exclusive prefix keeps every token, as JAX's does."""
    vocab = 1024
    scaled = np.zeros((2, vocab), np.float32)
    scaled[:, 0] = 10.0
    scaled[:, 1:] = np.linspace(0.0, -2.0, vocab - 1)
    ks = np.array([vocab, vocab], np.float32)
    ps = np.array([0.5, 1.0], np.float32)
    want = np.asarray(jengine._row_truncate(jnp.asarray(scaled), jnp.asarray(ks), jnp.asarray(ps)))
    got = tengine._row_truncate(torch.from_numpy(scaled), torch.from_numpy(ks),
                                torch.from_numpy(ps)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got[1]).all() and np.isfinite(got[0]).sum() == 1
    probs = torch.softmax(torch.sort(torch.from_numpy(scaled[1]), descending=True).values, -1)
    assert int((torch.cumsum(probs, -1) >= 1.0).sum()) >= 1  # the cumsum saturates


def test_min_p_penalties_and_bias_masks_equal_jax(monkeypatch):
    """Rows mixing greedy, top-k/top-p, min_p, frequency/presence
    penalties and logit_bias in one batch: the kept set of every sampled
    row, every greedy token and every logprob equal JAX's."""
    rng = np.random.default_rng(3)
    b, vocab = 6, 40
    logits = rng.normal(0, 2, (b, vocab)).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.3, 0.9, 0.0, 1.0], np.float32)
    kps = np.array([[vocab, 1.0, 0.0], [8, 1.0, 0.1], [vocab, 0.8, 0.0], [vocab, 1.0, 0.2],
                    [vocab, 1.0, 0.0], [12, 0.9, 0.05]], np.float32)
    counts = rng.integers(0, 3, (b, vocab)).astype(np.float32)
    pens = np.array([[0.5, 1.0], [0.0, 0.0], [1.5, -0.5], [0.3, 0.3], [2.0, 0.0], [0.0, 1.0]],
                    np.float32)
    ids = np.full((b, 16), -1, np.int64)
    vals = np.zeros((b, 16), np.float32)
    ids[0, :2], vals[0, :2] = [int(np.argmax(logits[0])), 3], [-100.0, 7.5]
    ids[2, :3], vals[2, :3] = [5, 5, 9], [2.0, 1.5, -4.0]  # duplicates accumulate
    ids[4, 0], vals[4, 0] = 17, 100.0
    pair = _both_sample(monkeypatch, logits, temps, kps, pens, counts, (ids, vals))
    _assert_same(pair)
    assert pair[1][0][4] == 17  # the forced token
    # penalties and bias alone, with min_p off: the greedy path
    _assert_same(_both_sample(monkeypatch, logits, np.zeros(b, np.float32),
                              np.tile([[vocab, 1.0, 0.0]], (b, 1)).astype(np.float32), pens,
                              counts, (ids, vals)))


def test_seeded_draws_are_per_row_and_device_independent():
    """The Gumbel noise is a pure function of (seed, counter, token id):
    a row's draw does not depend on its batchmates or its batch index."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(np.tile(rng.normal(0, 1, (1, 64)), (3, 1)).astype(np.float32))
    temps = torch.full((3,), 5.0)
    kps = torch.tensor([[64.0, 1.0, 0.0]]).repeat(3, 1)
    gates = (False, False, False, False, True)
    tok, _ = tengine._sample_rows(logits, temps, kps, torch.tensor([9, 9, 10]),
                                  torch.tensor([3, 3, 3]), gates=gates)
    assert tok[0] == tok[1]
    tok2, _ = tengine._sample_rows(logits[:2], temps[:2], kps[:2], torch.tensor([10, 9]),
                                   torch.tensor([3, 3]), gates=gates)
    assert tok2[1] == tok[0] and tok2[0] == tok[2]
    g = tengine._gumbel(torch.tensor([0, 7, 2**32 - 1]), torch.tensor([0, 1, 63]), 16)
    assert g.shape == (3, 16) and torch.isfinite(g).all()
    # the hash of known inputs (a change in it changes every seeded completion)
    h = tengine._fmix32(torch.tensor([0, 1, 0xDEADBEEF]))
    assert h.tolist() == [0, 0x514E28B7, 0x0DE5C6A9]


def test_sampled_frequencies_match_the_truncated_softmax():
    """40,000 draws (one row of logits, counters 0..39999, temperature
    0.8, top_p 0.9) land on each kept token with the frequency of the
    renormalized truncated softmax: Pearson's chi-square over the kept
    tokens stays under 24.3, the 0.999 quantile of chi-square at 7
    degrees of freedom (8 tokens kept here), and no dropped token is
    ever drawn."""
    n, vocab = 40_000, 24
    logits = torch.from_numpy(np.random.default_rng(5).normal(0, 1.5, vocab).astype(np.float32))
    scaled = logits / 0.8
    kept = torch.isfinite(tengine._row_truncate(scaled[None], torch.tensor([float(vocab)]),
                                                torch.tensor([0.9])))[0]
    assert int(kept.sum()) == 8
    p = torch.softmax(torch.where(kept, scaled, -torch.inf), -1).double()
    tok, _ = tengine._sample_rows(
        logits.expand(n, vocab), torch.full((n,), 0.8), torch.tensor([[vocab, 0.9, 0.0]]).expand(n, 3),
        torch.full((n,), 11), torch.arange(n), gates=(True, False, False, False, True))
    counts = torch.bincount(tok, minlength=vocab).double()
    assert counts[~kept].sum() == 0
    expect = n * p[kept]
    chi2 = float(((counts[kept] - expect) ** 2 / expect).sum())
    assert chi2 < 24.3, chi2


def test_seeded_requests_reproducible_under_concurrency_and_submit_many(jparams):
    model = _tmodel("dense", jparams)
    kw = dict(temperature=0.9, top_k=40, seed=1234)
    eng = ContinuousBatcher(model, slots=3, prompt_widths=(16,), decode_block=4)
    try:
        alone = eng.submit(PROMPTS[1], 10, **kw)
        busy = {}

        def noise(i):
            busy[i] = eng.submit(PROMPTS[i], 12, temperature=1.0)

        ts = [threading.Thread(target=noise, args=(i,)) for i in (2, 3, 4)]
        for t in ts:
            t.start()
        again = eng.submit(PROMPTS[1], 10, **kw)
        for t in ts:
            t.join(timeout=JOIN_S)
        many = eng.submit_many([PROMPTS[1]] * 3, 10, temperature=0.9, top_k=40, seed=1234)
        many2 = eng.submit_many([PROMPTS[1]] * 3, 10, temperature=0.9, top_k=40, seed=1234)
    finally:
        eng.close()
    assert alone == again == many[0]  # seed + 0
    assert many == many2 and len({tuple(m) for m in many}) == 3
    other = ContinuousBatcher(model, slots=1, prompt_widths=(16,), decode_block=1,
                              pipeline_depth=1)
    try:
        assert other.submit(PROMPTS[1], 10, **kw) == alone
    finally:
        other.close()


# -- validation -----------------------------------------------------------

CTOR_ERRORS = {
    "slots_0": dict(slots=0), "no_widths": dict(prompt_widths=()),
    "width_past_max_seq": dict(prompt_widths=(65,)), "width_0": dict(prompt_widths=(0,)),
    "top_k_0": dict(top_k=0), "top_p_0": dict(top_p=0.0), "min_p_2": dict(min_p=2.0),
    "max_queue_0": dict(max_queue=0), "prefill_chunk_0": dict(prefill_chunk=0),
    "prefix_without_chunk": dict(prefix_cache=2), "prefix_0": dict(prefill_chunk=4, prefix_cache=0),
    "depth_0": dict(pipeline_depth=0), "watchdog_0": dict(watchdog_s=0.0),
}


@pytest.mark.parametrize("name", list(CTOR_ERRORS))
def test_constructor_validation_raises_the_reference_types(name, jparams):
    kw = CTOR_ERRORS[name]
    with pytest.raises(ValueError) as jerr:
        jengine.ContinuousBatcher(_jmodel("dense"), jparams, **kw)
    with pytest.raises(type(jerr.value)):
        ContinuousBatcher(_tmodel("dense", jparams), **kw)


REQUEST_ERRORS = {
    "empty": ([], 4, {}), "budget_0": ([1], 0, {}), "too_wide": ([1] * 17, 4, {}),
    "past_max_seq": ([1], 64, {}), "temperature_nan": ([1], 4, dict(temperature=float("nan"))),
    "top_k_0": ([1], 4, dict(top_k=0)), "top_p_big": ([1], 4, dict(top_p=1.5)),
    "min_p_neg": ([1], 4, dict(min_p=-0.1)), "seed_str": ([1], 4, dict(seed="7")),
    "stop_17": ([1], 4, dict(stop=[[1]] * 17)), "stop_empty": ([1], 4, dict(stop=[[]])),
    "penalty_3": ([1], 4, dict(frequency_penalty=3.0)),
    "bias_id": ([1], 4, dict(logit_bias={999: 1.0})), "bias_val": ([1], 4, dict(logit_bias={1: 200.0})),
    "deadline_0": ([1], 4, dict(deadline_s=0.0)), "adapter_1": ([1], 4, dict(adapter=1)),
}


def test_request_validation_raises_the_reference_types(jparams):
    jeng = jengine.ContinuousBatcher(_jmodel("dense"), jparams, slots=1, prompt_widths=(16,))
    teng = ContinuousBatcher(_tmodel("dense", jparams), slots=1, prompt_widths=(16,))
    try:
        for name, (tokens, budget, kw) in REQUEST_ERRORS.items():
            with pytest.raises(ValueError) as jerr:
                jeng.submit(tokens, budget, **kw)
            with pytest.raises(type(jerr.value)):
                teng.submit(tokens, budget, **kw)
        with pytest.raises(ValueError, match="vocabulary"):
            teng.submit([1, 256], 4)  # the port refuses ids past the embedding table
    finally:
        jeng.close()
        teng.close()


def test_unported_options_raise_naming_their_roadmap_item(jparams):
    model = _tmodel("dense", jparams)
    with pytest.raises(NotImplementedError, match="A9b"):
        ContinuousBatcher(model, mesh=object())
    # the prefix L2 is ported: it needs the L1 it feeds and is fed by
    with pytest.raises(ValueError, match="prefix_l2 requires prefix_cache"):
        ContinuousBatcher(model, prompt_widths=(8,), prefix_l2=object())
    eng = ContinuousBatcher(model, slots=1, prompt_widths=(8,), prefill_chunk=4, prefix_cache=1)
    try:
        eng.attach_prefix_l2(None)
        # LoRA and int8 weights are ported (tests/test_torch_lora_serving.py):
        # an engine without adapters takes no factors, a plain one no int8 set,
        # and a leaf that is not a tensor is refused before anything installs
        from tensorflowonspark_tpu_torch.ops.quant import quantize_tree

        name = "layers.0.attn.q_proj.weight_lora_a"
        with pytest.raises(WeightsIncompatible, match="_lora_a"):
            eng.swap_weights({name: torch.zeros(2, 128)}, version="x", kind="lora")
        own = dict(model.named_parameters())
        with pytest.raises(WeightsIncompatible, match="names differ"):
            eng.swap_weights(quantize_tree(own, min_size=1), version="x")
        dicts = {n: {"q": t, "scale": t} for n, t in own.items()}
        with pytest.raises(WeightsIncompatible, match="not a tensor"):
            eng.swap_weights(dicts, version="x")
        assert eng.weights_version == "v0"
    finally:
        eng.close()


# -- lifecycle --------------------------------------------------------------


def _wait(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


@pytest.fixture
def small(jparams):
    return _tmodel("dense", jparams)


@pytest.fixture
def slow():
    """Every decode dispatch of the port's engines waits 20 ms, so that a
    60-token request is still decoding while a test acts on it."""
    fp.arm("engine.dispatch", "delay", delay_s=0.02)
    yield
    fp.disarm_all()


def test_shutdown_and_graceful_drain(small, slow):
    solo = ContinuousBatcher(small, slots=1, prompt_widths=(8,), decode_block=4)
    try:
        want = {"a": solo.submit([1, 2], 30), "b": solo.submit([5], 25)}
    finally:
        solo.close()
    eng = ContinuousBatcher(small, slots=3, prompt_widths=(8,), decode_block=1)
    streams = {"a": eng.stream([1, 2], 30), "b": eng.stream([5], 25)}
    firsts = {n: next(s) for n, s in streams.items()}  # both admitted and decoding
    eng.close(drain=True)  # returns once both have finished in full
    results = {n: [firsts[n]] + list(s) for n, s in streams.items()}
    assert results == want
    assert eng.stats()["stopped_cleanly"] is True and not eng.health()["ready"]
    with pytest.raises(RuntimeError, match="shutting down"):
        eng.submit([3], 2)


def test_abrupt_close_fails_queued_and_live_requests(small, slow):
    eng = ContinuousBatcher(small, slots=1, prompt_widths=(8,), decode_block=1)
    live = eng.stream([1], 60)
    next(live)
    errs = []

    def req(p):
        try:
            eng.submit(p, 60)
        except RuntimeError as e:
            errs.append(str(e))

    ts = [threading.Thread(target=req, args=([i + 2],)) for i in range(2)]
    for t in ts:
        t.start()
    _wait(lambda: eng.stats()["queue_depth"] == 2, "both queued behind the live row")
    eng.close()
    for t in ts:
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    with pytest.raises(RuntimeError, match="shutting down"):
        list(live)
    assert errs == ["engine shutting down"] * 2


def test_cancel_a_queued_and_a_decoding_stream(small, slow):
    eng = ContinuousBatcher(small, slots=1, prompt_widths=(8,), decode_block=1)
    try:
        live = eng.stream([1, 2, 3], 60)
        first = next(live)
        queued = eng.stream([4, 5], 10)
        queued.close()  # cancelled before it ever takes the slot
        live.close()  # the decoding row frees its slot at the next step
        assert list(queued) == [] and queued.result == []
        _wait(lambda: eng.stats()["slots_busy"] == 0, "the slot freed")
        assert eng.cancelled == 2 and isinstance(first, int)
        assert len(live.result) < 60
        assert len(eng.submit([6], 3)) == 3
    finally:
        eng.close()


def test_loop_death_fails_waiters_not_hangs(small):
    eng = ContinuousBatcher(small, slots=1, prompt_widths=(8,))

    def boom(*a, **k):
        raise RuntimeError("synthetic prefill failure")

    eng._prefill_fn = boom  # dies after the queue pop, before parking
    with pytest.raises(RuntimeError, match="synthetic prefill failure"):
        eng.submit([1, 2], 3)
    with pytest.raises(RuntimeError, match="shutting down"):
        eng.submit([3], 2)
    eng.close()


def test_bounded_queue_sheds_load(small, slow):
    eng = ContinuousBatcher(small, slots=1, prompt_widths=(8,), max_queue=2, decode_block=1)
    try:
        holder = eng.stream([1, 2], 60)
        next(holder)
        waiters = [eng.stream([3], 2) for _ in range(2)]
        with pytest.raises(EngineOverloaded, match="queue full"):
            eng.submit([4], 2)
        with pytest.raises(ValueError, match="split the request"):
            eng.submit_many([[1]] * 3, 2)
        holder.close()
        assert all(len(list(w)) == 2 for w in waiters)
    finally:
        eng.close()


def test_watchdog_fires_on_a_fetch_stall_then_recovers(small):
    eng = ContinuousBatcher(small, slots=2, prompt_widths=(8,), decode_block=2, watchdog_s=0.4)
    try:
        eng.warmup()
        baseline = eng.submit([1, 2, 3], 5)
        fp.arm("engine.fetch", "delay", delay_s=1.0, count=1)
        with pytest.raises(EngineWedged, match="no progress"):
            eng.submit([1, 2, 3], 6)
        assert eng.watchdog_fires == 1
        assert eng.submit([1, 2, 3], 5) == baseline
    finally:
        fp.disarm_all()
        eng.close()
    assert eng.stats()["stopped_cleanly"] is True


def test_deadline_expires_terminally(small):
    eng = ContinuousBatcher(small, slots=2, prompt_widths=(8,), decode_block=1)
    try:
        fp.arm("engine.dispatch", "delay", delay_s=0.05, count=20)
        with pytest.raises(DeadlineExceeded):
            eng.submit([1, 2], 60, deadline_s=0.3)
        assert eng.deadline_expired == 1
    finally:
        fp.disarm_all()
        eng.close()


def test_warmup_health_and_metrics(small):
    eng = ContinuousBatcher(small, slots=2, prompt_widths=(4, 8), prefill_chunk=None)
    try:
        assert eng.health()["ready"] and not eng.health()["warming"]
        eng.warmup()
        st = eng.stats()
        assert st["admitted"] == 3 and st["completed"] == 3 and st["steps"] > 0
        text = eng.metrics.render()
        for name in ("engine_inflight_depth", "engine_drain_stalls_total",
                     "engine_decode_steps_total", "engine_ttft_seconds"):
            assert name in text
    finally:
        eng.close()


def test_swap_weights_and_set_knobs_mid_traffic(jparams, small, slow):
    """A whole dense weight set in the layout of models.convert swaps in
    between blocks: later requests match an engine built on the new
    weights; a mismatched set is refused and the engine keeps serving.
    set_knobs changes decode_block and pipeline_depth under traffic with
    identical tokens."""
    new = {n: (p.detach() * 0.5).clone() for n, p in small.named_parameters()}
    ref_model = _tmodel("dense", jparams)
    ref_model.load_state_dict(new)
    ref = ContinuousBatcher(ref_model, slots=1, prompt_widths=(8,))
    try:
        want_new = ref.submit([1, 2, 3], 8)
    finally:
        ref.close()
    eng = ContinuousBatcher(small, slots=2, prompt_widths=(8,))
    try:
        want_old = eng.submit([1, 2, 3], 8)
        stream = eng.stream([4, 5], 50)  # still decoding at the swap
        next(stream)
        assert eng.set_knobs(decode_block=1, pipeline_depth=1) == {"decode_block": 1,
                                                                  "pipeline_depth": 1}
        assert eng.submit([1, 2, 3], 8) == want_old
        bad = dict(new, embed=new["embed"][:, :-1])
        with pytest.raises(WeightsIncompatible):
            eng.swap_weights(bad, version="bad")
        assert eng.swap_weights(new, version="v1") == "v1"
        list(stream)
        assert stream.weights_version == "v1"
        assert eng.submit([1, 2, 3], 8) == want_new and want_new != want_old
        assert eng.stats()["weights_swaps"] == 1 and eng.current_weights()[0] == "v1"
    finally:
        eng.close()
    # the module's own weights are untouched
    assert torch.equal(small.embed, ref_model.embed * 2)
