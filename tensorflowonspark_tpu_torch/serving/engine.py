"""Continuous batching: slot-based admission into a persistent decode loop
(port of :mod:`tensorflowonspark_tpu.serving.engine`).

The engine keeps a B-slot KV cache resident and decodes one token for all
slots per step; a new request is prefilled into any free slot *between
steps*, and a finished row frees its slot immediately. Decode reads every
weight once a step whatever the number of live rows, so utilization comes
from keeping the slots busy, which is what per-step admission does.

The device programs are plain torch functions, run on the scheduler's
thread under ``torch.inference_mode()``:

- **block** (:meth:`ContinuousBatcher._block_fn`): ``k`` decode steps of
  (B, 1) tokens through the model with ``decode=True, padded=True`` — each
  row writes K/V at its own position (the per-row scatter of
  ``models.llama.cached_attention``), so rows at different depths coexist
  in one batch. Per-request sampling knobs ride the step as per-row
  tensors. The ``k`` steps are issued back to back with no host sync; the
  block's tokens and fp32 logprobs come back as one ``(2, k, slots)``
  int32 tensor, copied to a pinned host buffer behind a CUDA event.
- **prefill** (:meth:`ContinuousBatcher._prefill_fn`, one per prompt-width
  bucket): a (1, W) padded prefill builds a fresh single-row cache and
  samples the row's first token from its true last position. In chunked
  mode the bucket prefills are replaced by one (1, C) **chunk** program
  plus a **sample** program, reused for every prompt length.
- **admit** (:meth:`ContinuousBatcher._admit_fn`): copies the single-row
  cache and the request's sampling state into slot ``r`` of the engine's
  tensors.

The reference gates its sampling branches (``lax.cond``) on device
values; here each gate is a Python branch on the scheduler's host-side
bookkeeping (:meth:`ContinuousBatcher._step_gates`), never a device
``any()``, which would make the host wait for the device every step.

**Overlapped pipeline** (``pipeline_depth``, default 2): the scheduler
keeps up to that many k-step blocks in flight. Block N+1 is issued from
the device-resident state before block N is fetched and swept, so the
host sweep (emit, stop-match, retire, stream hand-off) overlaps device
work. The window drains (fetch and sweep every in-flight block, oldest
first) only when host state must change under it: an admission or a
chunked prefill's final-chunk admit. Rows that finish mid-window decode at
most ``decode_block × pipeline_depth`` surplus tokens, which are thrown
away on the host, never emitted. ``pipeline_depth=1`` is the strictly
serial dispatch→fetch→sweep loop. Stream deliveries run on a dedicated
emitter thread.

Sampling is reproducible per request: each row's draw is Gumbel-max with
noise from a 32-bit integer hash of (seed, position, token id) computed
in tensor ops (:func:`_gumbel`), so a seeded completion is a pure function
of (weights, prompt, seed) whatever the slot, the batchmates,
``decode_block`` or ``pipeline_depth``. The bits differ from the
reference's ``jax.random`` keys; the distribution is the same.

**Fleet-global prefix L2** (``prefix_l2=`` or :meth:`ContinuousBatcher.
attach_prefix_l2`, a ``cachetier.PrefixL2``): an L1 miss probes the L2
before prefilling; a hit is uploaded into a single-row cache, inserted
into L1, and the prefill resumes at ``min(depth, len - 1)``. Every L1
insert (boundary and whole-prompt) is offered to the L2; the offer
records an event on the scheduler's stream and a filler thread copies the
entry after it, so the scheduler never waits for the host copy. The L2
key carries the weights version.

**LoRA banks and int8 weights.** A weight set with ``ops.lora`` bank
entries (3-D factors, ``multi_lora_bank``) serves one adapter per request:
``adapter`` picks the row's slot (0 = the base model), which rides the
prefill and every decode step as a per-row id, and the prefix caches key
on it. ``swap_weights(kind='lora')`` installs new factors over the
resident bases (by reference: nothing else moves). An int8 weight set
(``ops.quant.quantize_tree``) serves as given, at construction and at
swaps.

Not ported yet, raising ``NotImplementedError`` naming its ROADMAP item:
``mesh=`` (TP decode on 'model', A9b). MoE weights (A10) cannot reach a
port model. The int8 and rolling KV caches are ported.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import logging
import math
import queue
import threading
import time
import types

import numpy as np
import torch

from tensorflowonspark_tpu_torch.obs import registry as obs_registry
from tensorflowonspark_tpu_torch.obs import reqtrace
from tensorflowonspark_tpu_torch.obs import spans as obs_spans
from tensorflowonspark_tpu_torch.utils.failpoints import failpoint

logger = logging.getLogger(__name__)

# Per-request logit_bias entries are capped so the (B, K) bias tensors keep
# one shape; 16 matches the typical ban/force use cases.
_BIAS_SLOTS = 16
_M32 = 0xFFFFFFFF


class EngineOverloaded(RuntimeError):
    """Raised by submit()/stream() when the bounded request queue is
    full — callers should shed load (HTTP 503), not block."""


class DeadlineExceeded(TimeoutError):
    """Terminal per-request error: the request's ``deadline_s`` budget
    expired before it finished decoding. The scheduler retires the row
    at the next block boundary, and the caller should map this to a
    timeout status (HTTP 504), not retry blindly."""


class EngineWedged(RuntimeError):
    """Terminal per-request error from the scheduler watchdog: the
    dispatch/fetch loop made no observable progress for the configured
    window while work was in flight. In-flight requests are aborted with
    this error so their callers unblock; the scheduler itself recovers and
    keeps serving — see ``ContinuousBatcher(watchdog_s=...)``."""


class WeightsIncompatible(ValueError):
    """``swap_weights`` payload does not fit the running engine: parameter
    names, or a tensor's shape or dtype, differ from the weights currently
    serving. The swap is rejected before anything is installed — the
    engine keeps serving its current version."""


def _row_truncate(scaled, ks, ps):
    """Per-row top-k/top-p mask over (B, vocab) temperature-scaled
    logits: top-k first, then top-p renormalized over the k survivors.
    ``ks``/``ps`` (B,) are per-row tensors; disabled rows pass ``k =
    vocab`` / ``p = 1.0``."""
    vocab = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    rank = torch.arange(vocab, dtype=torch.float32, device=scaled.device)[None, :]
    kept = torch.where(rank < ks[:, None], sorted_desc, -math.inf)
    probs = torch.softmax(kept, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Last kept rank, via the EXCLUSIVE prefix (cum - probs): rank i
    # survives iff the mass strictly before it is < p. The inclusive
    # compare (cum < p) would let fp32 cumsum error bite disabled rows
    # (k=vocab, p=1.0) routed through the sort because a co-batched row
    # truncates: the cumsum can saturate at exactly 1.0 several ranks
    # early, masking tail tokens and making a seeded plain-temperature
    # row's distribution depend on its batchmates. Clamps: >= 0 (the most
    # likely token survives even when it alone exceeds p) and < k (a p of
    # ~1.0 must not walk into the -inf tail and keep more than k tokens).
    cutoff_index = (cum - probs < ps[:, None]).sum(-1, keepdim=True) - 1
    cutoff_index = torch.minimum(cutoff_index.clamp_min(0), (ks[:, None] - 1).long())
    cutoff = torch.gather(kept, -1, cutoff_index)
    return torch.where(scaled < cutoff, -math.inf, scaled)


def _mul32(x, c: int):
    """The low 32 bits of ``x * c`` for int64 ``x`` in [0, 2**32): the
    product is formed in two 16-bit halves so that no int64 product
    overflows (torch's integers are signed)."""
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (hi + (x & 0xFFFF) * c) & _M32


def _fmix32(h):
    """murmur3's 32-bit finalizer on int64 tensors holding 32-bit values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _gumbel(seeds, counters, vocab: int):
    """(B, vocab) fp32 Gumbel noise, a pure function of each row's (seed,
    counter) and the token id: a counter-based draw, identical on the CPU
    and on CUDA (integer hashing; the uniforms carry 24 bits, exact in
    fp32), so a row's sample never depends on its batchmates."""
    key = _fmix32(_fmix32(seeds.long() & _M32) ^ _mul32(counters.long() & _M32, 0x9E3779B9))
    ids = torch.arange(vocab, dtype=torch.long, device=seeds.device)
    h = _fmix32(key[:, None] ^ _mul32(ids, 0x27D4EB2F)[None, :])
    u = ((h >> 8).float() + 0.5) * 2.0**-24
    return -torch.log(-torch.log(u))


def _draw(trunc, seeds, counters):
    """Gumbel-max: one categorical draw per row of the masked logits."""
    return (trunc + _gumbel(seeds, counters, trunc.shape[-1])).argmax(-1)


def _sample_rows(logits, temps, kps, seeds, counters, pens=None, counts=None, bias_ids=None,
                 bias_vals=None, *, gates):
    """Per-row sampling over (B, vocab) fp32 logits.

    Every sampling input is a per-row tensor: ``temps`` (B,) temperature
    (0 = greedy), ``kps`` (B, 3) resolved [top_k, top_p, min_p] (see
    :func:`_row_truncate`; min_p keeps tokens whose probability is at
    least min_p times the most likely token's — an elementwise log-space
    compare, no sort), ``seeds`` (B,) and ``counters`` (B,): each row's
    draw is keyed on (seed, counter) with the counter = the sampled
    token's sequence position (:func:`_gumbel`).

    ``pens`` (B, 2) [frequency_penalty, presence_penalty] with ``counts``
    (B, vocab) per-row generated-token counts applies the OpenAI-convention
    repetition penalties BEFORE temperature scaling (and before the greedy
    argmax — penalties shape greedy rows too): ``logit - freq*count -
    pres*(count > 0)``. ``bias_ids``/``bias_vals`` (B, K), id -1 =
    inactive, add per-request logit_bias to the logits.

    ``gates`` (5 host bools [sort, min_p, penalties, bias, sample]) say
    which branches this batch runs; the scheduler derives them from its
    live rows and the single-row prefill callers from the request's host
    values, so no branch waits on the device. ``sample`` False (every row
    greedy) skips the noise.

    Returns ``(tokens (B,) int64, logprobs (B,) fp32)`` — the logprob of
    each chosen token under the RAW (unscaled, unpenalized) model
    distribution, the convention of the /score surface.
    """
    sort, minp, pen, bias, sample = gates
    raw = logits
    if bias_ids is not None and bias:
        vals = torch.where(bias_ids >= 0, bias_vals, 0.0)
        add = torch.zeros_like(logits, dtype=torch.float32).scatter_add_(
            1, bias_ids.clamp_min(0), vals)
        logits = (logits.float() + add).to(logits.dtype)
    if pens is not None and pen:
        logits = logits - pens[:, :1] * counts - pens[:, 1:] * (counts > 0)
    greedy = logits.argmax(-1)
    if not sample:
        tok = greedy
    else:
        scaled = logits / temps.clamp_min(1e-6)[:, None]
        ks, ps, ms = kps[:, 0], kps[:, 1], kps[:, 2]
        trunc = _row_truncate(scaled, ks, ps) if sort else scaled
        if minp:
            # keep where prob >= min_p * prob_max, i.e. (in log space)
            # scaled >= row_max + log(min_p); on the UNtruncated scaled
            # logits, so min_p composes with k/p by mask intersection
            floor = scaled.amax(-1, keepdim=True) + torch.log(ms.clamp_min(1e-38))[:, None]
            trunc = torch.where(scaled < floor, -math.inf, trunc)
        tok = torch.where(temps > 0, _draw(trunc, seeds, counters), greedy)
    logp = torch.log_softmax(raw.float(), dim=-1)
    lp = torch.gather(logp, -1, tok[:, None])[:, 0]
    return tok, lp


@dataclasses.dataclass
class _Pending:
    tokens: list[int]
    max_new_tokens: int
    event: threading.Event
    temperature: float | None = None  # None = the engine-wide default
    top_k: int | None = None  # None = the engine-wide default
    top_p: float | None = None  # None = the engine-wide default
    min_p: float | None = None  # None = the engine-wide default
    frequency_penalty: float | None = None  # None/0 = disabled
    presence_penalty: float | None = None  # None/0 = disabled
    # {token_id: bias}; at most _BIAS_SLOTS entries, biases clamp the
    # OpenAI [-100, 100] convention
    logit_bias: "dict[int, float] | None" = None
    # None = engine-drawn (independent, nondeterministic across
    # submissions); set = reproducible completion for this request
    seed: int | None = None
    eos_id: int | None = None  # None = the engine-wide default
    adapter: int = 0  # LoRA bank slot (0 = base model)
    # multi-token stop sequences (host-side tail match; the matched
    # suffix is trimmed from the RESULT — streams necessarily saw its
    # tokens already, since the match completes only on the last one)
    stop: tuple = ()
    # set by the consumer side (stream close); the scheduler treats it
    # as finished at the next step/admission — a plain bool is enough
    # (single writer, benign race: at worst one extra token decodes)
    cancelled: bool = False
    # While this request is LIVE, the scheduler caps its decode-block
    # size at this value (warmup rides it to run the k=1 block without
    # mutating the shared engine knob under live traffic).
    decode_block_pin: int | None = None
    # wall-clock budget from enqueue; None = unbounded. Expiry is a
    # TERMINAL DeadlineExceeded, checked at queue pop and every
    # scheduler iteration (see _expire_deadlines).
    deadline_s: float | None = None
    submitted_at: float = 0.0  # time.monotonic() at enqueue
    first_token_at: float | None = None  # set when token 0 emits
    # the engine weights version this request RESOLVED under, stamped on
    # the scheduler thread at retirement — the same thread that applies
    # weight swaps, so the stamp is coherent by construction
    weights_version: str | None = None
    # resolve-once latch (guarded by the engine's _resolve_lock): a
    # request resolves as EXACTLY one of completed/failed even when the
    # watchdog thread races the scheduler
    resolved: bool = False
    result: list[int] | None = None
    logprobs: list[float] | None = None  # filled at retirement
    error: BaseException | None = None
    # streaming: every emitted token is ALSO pushed here as it decodes,
    # then True (done) or the error object as the terminal item, through
    # the engine's _EmitWorker thread
    sink: "queue.Queue | None" = None
    # request tracing (obs.reqtrace): the trace id this request rides, or
    # None; `trace_mark` is the scheduler's per-request segment cursor
    trace: str | None = None
    trace_mark: float | None = None


class _Stream:
    """Iterator over a streaming request's tokens; ``close()`` (or GC)
    before exhaustion CANCELS the request — the scheduler frees its
    slot at the next step instead of running out the budget."""

    def __init__(self, p: "_Pending", yield_logprobs: bool):
        self._p = p
        self._yield_logprobs = yield_logprobs
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        item = self._p.sink.get()
        if item is True:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        token, lp = item
        return (token, lp) if self._yield_logprobs else token

    @property
    def result(self):
        """The request's FINAL (stop-trimmed) completion, available once
        the stream is exhausted."""
        return self._p.result

    @property
    def logprobs(self):
        return self._p.logprobs

    @property
    def weights_version(self):
        """The weights version this request resolved under (set with
        ``result``, i.e. once the stream is exhausted)."""
        return self._p.weights_version

    def close(self) -> None:
        if not self._done:
            self._p.cancelled = True

    __del__ = close


class _EmitWorker:
    """Dedicated delivery thread for stream sinks: the scheduler hands
    every sink item here instead of pushing it inline, so consumer
    hand-off never sits on the decode critical path. One FIFO queue keeps
    per-request item order; ``stop()`` delivers everything enqueued
    before it, then the thread exits."""

    _STOP = object()

    def __init__(self) -> None:
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._run, daemon=True, name="engine-emitter")
        self._thread.start()

    def deliver(self, sink: "queue.Queue", item) -> None:
        self._q.put((sink, item))

    def stop(self, timeout: float = 30.0) -> bool:
        """Flush + stop; False when the thread outlived the join."""
        self._q.put(self._STOP)
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is self._STOP:
                return
            sink, payload = item
            try:
                sink.put(payload)
            except Exception:  # noqa: BLE001 - one bad sink must not
                # take down delivery for every other stream
                logger.exception("stream sink delivery failed")


@dataclasses.dataclass
class _PrefillJob:
    """A chunked prefill in flight: one slot reserved, the single-row
    cache accumulating chunk by chunk between decode steps."""

    p: _Pending
    row: int
    cache_1: object
    next_pos: int  # next chunk's start offset into the prompt
    length: int
    vals: dict  # the request's uploaded per-row sampling tensors
    gates: tuple  # its host-side sampling gates
    # next prompt depth at which to store a chunk-boundary prefix entry
    # (doubles after each insert — see _advance_job)
    next_insert_depth: int = 0
    boundary_inserts: int = 0  # made so far, capped per request


@dataclasses.dataclass
class _SwapRequest:
    """A validated, device-placed weight set waiting for the scheduler to
    install it between decode blocks (see ``swap_weights``): the params
    and a module tree bound to them. Installation is a pointer flip."""

    placed: object
    runner: object
    version: str
    event: threading.Event
    error: BaseException | None = None  # set if the swap was aborted


@dataclasses.dataclass
class _KnobRequest:
    """A validated scheduler-knob change (``decode_block`` /
    ``pipeline_depth``) waiting for the scheduler to install between
    decode blocks (see ``set_knobs``)."""

    decode_block: int | None
    pipeline_depth: int | None
    event: threading.Event
    error: BaseException | None = None  # set if the change was aborted


class _DeviceState:
    """The engine's per-slot device tensors (scheduler thread only):
    the KV cache and each row's next token, its position and its
    resolved sampling knobs."""

    __slots__ = ("cache", "tok", "pos", "temps", "kps", "seeds", "pens", "counts", "bids",
                 "bvals", "ads")


class _PrefixStore:
    """LRU of prompt→single-row-KV-cache entries for prefix reuse.

    A request whose prompt extends a stored prompt resumes prefill from
    the stored cache instead of position 0. The stored caches are never
    written: an entry taken mid-prefill is a copy, and a lookup hands out
    a copy, since the port's decode updates a cache in place.

    Cost model: each entry holds ONE full-length single-row KV cache
    (layers × 2 × max_seq_len × kv_heads × head_dim in the cache dtype),
    so ``capacity`` is a device-memory budget, not just an entry count.
    Accessed only from the scheduler loop thread — no locking.
    """

    def __init__(self, capacity: int):
        from collections import OrderedDict

        self.capacity = capacity
        self._d: "OrderedDict[tuple, object]" = OrderedDict()
        # adapter -> {key_length -> set of stored key tuples}: lookup
        # hashes the PROMPT's prefix at each stored length (longest
        # first, early exit) instead of comparing every stored key
        self._by_adapter: "dict[int, dict[int, set]]" = {}
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0

    def lookup(self, tokens: list[int], adapter: int = 0):
        """Longest stored prefix of ``tokens`` under the same adapter →
        (cache, resume_pos), or (None, 0). Stored key lengths are probed
        longest-first (two distinct same-length keys cannot both prefix
        one prompt, so the first hit IS the longest match). resume_pos is
        capped at len(tokens)-1 so the chunk path always re-processes at
        least the last prompt token — its logits are where the first
        completion token samples from."""
        n = len(tokens)
        best_key = None
        best_len = 0
        by_len = self._by_adapter.get(adapter)
        if by_len:
            for lk in sorted(by_len, reverse=True):
                if lk > n:
                    continue
                cand = tuple(tokens[:lk])
                if cand in by_len[lk]:
                    best_key, best_len = (adapter, cand), lk
                    break
        resume = min(best_len, n - 1)
        if best_key is None or resume < 1:
            self.misses += 1
            return None, 0
        self._d.move_to_end(best_key)
        self.hits += 1
        self.tokens_saved += resume
        return self._d[best_key], resume

    def insert(self, tokens: list[int], cache_1, adapter: int = 0) -> None:
        key = tuple(tokens)
        k = (adapter, key)
        if k not in self._d:
            self._by_adapter.setdefault(adapter, {}).setdefault(len(key), set()).add(key)
        self._d[k] = cache_1
        self._d.move_to_end(k)
        while len(self._d) > self.capacity:
            (ad, old), _ = self._d.popitem(last=False)
            self._unindex(ad, old)

    def _unindex(self, adapter: int, key: tuple) -> None:
        by_len = self._by_adapter[adapter]
        bucket = by_len[len(key)]
        bucket.discard(key)
        if not bucket:
            del by_len[len(key)]
            if not by_len:
                del self._by_adapter[adapter]

    def clear(self) -> None:
        self._d.clear()
        self._by_adapter.clear()

    def __len__(self) -> int:
        return len(self._d)


def _clone_cache(cache):
    return [{n: t.clone() for n, t in layer.items()} for layer in cache]


def _cache_leaves(cache) -> list:
    """A cache's tensors in one fixed order (layer, then name): the
    flat form the prefix L2 stores."""
    return [layer[name] for layer in cache for name in sorted(layer)]


def _bound_module(model, params: dict):
    """A copy of ``model``'s module tree, sharing every attribute but its
    parameters, which are ``params`` (name -> tensor): the module a
    swapped-in weight set runs through. Every parameter slot is filled
    from ``params`` or left empty, so the set decides the format (plain,
    int8, a LoRA bank; ``models.llama.check_params`` checks it). No tensor
    is copied, and ``model`` itself is left as it is (other threads may be
    running it)."""
    from tensorflowonspark_tpu_torch.models.llama import check_params

    try:
        check_params(model, params)
    except ValueError as e:
        raise WeightsIncompatible(str(e)) from e

    def clone(mod, prefix):
        c = copy.copy(mod)
        c._parameters = {n: params.get(prefix + n) for n in mod._parameters}
        c._modules = {n: clone(m, prefix + n + ".") for n, m in mod._modules.items()}
        return c

    return clone(model, "")


class ContinuousBatcher:
    """Persistent B-slot decode engine over one port ``Llama``.

    ``model`` carries its weights; ``params=None`` serves the module's
    own, a dict in the layout of ``models.convert`` (name -> tensor)
    serves those instead. The engine runs on the model's device (CUDA
    unless the model was built elsewhere).

    ``submit(tokens, max_new_tokens)`` blocks the calling thread until
    that request's completion is ready (server handler threads call it
    concurrently). Greedy by default. ``temperature``, ``top_k``,
    ``top_p`` and ``min_p`` are PER-REQUEST (the constructor values are
    just the defaults): they ride the step as per-row tensors.

    ``prompt_widths``: prompts are right-padded to the smallest listed
    width (one prefill program each). A prompt longer than the largest
    width is rejected, as is prompt+budget beyond the model's
    ``max_seq_len``.

    ``decode_block``: steady-state decode issues this many steps per host
    iteration (one fetch per block), dropping to single steps only while a
    queued request could be admitted into a free slot (or a chunked
    prefill is in flight). Rows finishing mid-block retire at their finish
    point; surplus block tokens are discarded, never emitted.

    ``pipeline_depth``: how many decode blocks the scheduler keeps in
    flight at once. Output tokens and logprobs are identical at every
    depth and every ``decode_block``; only latency bounds change.
    """

    _STOP = object()
    # queue sentinel that only WAKES an idle scheduler (so a pending
    # weight swap is noticed without a request arriving)
    _WAKE = object()

    def __init__(
        self,
        model,
        params=None,
        *,
        slots: int = 8,
        prompt_widths: tuple[int, ...] = (128,),
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        min_p: float | None = None,
        eos_id: int | None = None,
        seed: int = 0,
        mesh=None,
        max_queue: int | None = None,
        prefill_chunk: int | None = None,
        prefix_cache: int | None = None,
        prefix_l2=None,
        decode_block: int = 8,
        pipeline_depth: int = 2,
        watchdog_s: float | None = None,
        weights_version: str = "v0",
    ):
        cfg = model.cfg
        if mesh is not None:
            raise NotImplementedError(
                "the continuous engine on a device mesh (TP decode on 'model') is not "
                "ported yet: ROADMAP A9b"
            )
        self._model = model
        self._device = model.device
        self._cuda = self._device.type == "cuda"
        self._params = dict(model.named_parameters())
        # the module the scheduler runs: the model itself while it serves
        # its own weights, else a tree bound to the given ones (whose
        # format, plain, int8 or a LoRA bank, may differ from the model's)
        self._runner = model
        if params is not None:
            self._params = self._place_initial(params)
            self._runner = _bound_module(model, self._params)
        from tensorflowonspark_tpu_torch.ops.lora import bank_size

        # LoRA banks in the weights enable per-request adapter routing;
        # 0 slots means "no bank" (adapter must be 0/None)
        self._n_adapters = bank_size(self._params)
        self._slots = int(slots)
        if self._slots < 1:
            # slots=0 would construct fine, then the scheduler thread
            # busy-spins and every submit() waits forever on a free slot.
            raise ValueError(f"slots must be >= 1, got {slots}")
        self._widths = tuple(sorted(int(w) for w in prompt_widths))
        if not self._widths or self._widths[-1] > cfg.max_seq_len:
            raise ValueError(
                f"prompt_widths {prompt_widths} must be non-empty and "
                f"<= max_seq_len ({cfg.max_seq_len})"
            )
        if self._widths[0] < 1:
            raise ValueError(f"prompt_widths must all be >= 1, got {prompt_widths}")
        self._temperature = float(temperature)
        self._top_k = None if top_k is None else int(top_k)
        self._top_p = None if top_p is None else float(top_p)
        self._min_p = None if min_p is None else float(min_p)
        # The engine-wide defaults feed _effective_knobs exactly like
        # request values do, so they get the same validity check.
        if self._top_k is not None and self._top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if self._top_p is not None and not (math.isfinite(self._top_p) and 0 < self._top_p <= 1):
            raise ValueError(f"top_p must be finite and in (0, 1], got {top_p}")
        if self._min_p is not None and not (
            math.isfinite(self._min_p) and 0 <= self._min_p <= 1
        ):
            raise ValueError(f"min_p must be finite and in [0, 1], got {min_p}")
        self._eos_id = None if eos_id is None else int(eos_id)
        # Per-request sampling seeds: explicit request seeds pass
        # through; unseeded requests draw one here at admission — making
        # each independent, and the whole engine reproducible given its
        # constructor seed and request order.
        self._seed_rng = np.random.Generator(np.random.PCG64(int(seed) % 2**64))

        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._max_queue = max_queue
        if prefill_chunk is not None and not (1 <= prefill_chunk <= cfg.max_seq_len):
            # The upper bound keeps _advance_job's window shift
            # (start_w = min(start, max_seq_len - chunk)) non-negative.
            raise ValueError(
                f"prefill_chunk must be in [1, max_seq_len={cfg.max_seq_len}], "
                f"got {prefill_chunk}"
            )
        self._prefill_chunk = prefill_chunk
        if prefix_cache is not None:
            if prefix_cache < 1:
                raise ValueError(f"prefix_cache must be >= 1 entries, got {prefix_cache}")
            if prefill_chunk is None:
                # Prefix reuse resumes prefill mid-prompt, which is what
                # the chunk path does; the width-bucket prefill always
                # starts from position 0.
                raise ValueError(
                    "prefix_cache requires prefill_chunk (prefix reuse "
                    "resumes prefill through the chunked path)"
                )
            self._prefix_store = _PrefixStore(prefix_cache)
        else:
            self._prefix_store = None
        if prefix_l2 is not None and self._prefix_store is None:
            # The L2 feeds and is fed through the L1 insert/lookup
            # sites; without an L1 neither exists.
            raise ValueError("prefix_l2 requires prefix_cache")
        # Fleet-global prefix L2 (cachetier.PrefixL2 or None). Rebound
        # atomically by attach_prefix_l2; the scheduler thread reads it
        # racily — a one-iteration-stale None/instance is benign (one
        # extra miss or one extra offer to a live client).
        self._prefix_l2 = prefix_l2
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False  # guarded-by: self._submit_lock
        # Hot weight swap: the label of the weights currently serving
        # (written ONLY on the scheduler thread, read racily by stats/
        # health) and the validated/placed update waiting for install.
        self._weights_version = str(weights_version)
        self._weights_swaps = 0  # applied swaps (scheduler-thread-owned)
        self._pending_swap: _SwapRequest | None = None  # guarded-by: self._submit_lock
        # Live scheduler-knob change, applied between decode blocks
        # exactly like a pending weight swap.
        self._pending_knobs: _KnobRequest | None = None  # guarded-by: self._submit_lock
        # True only while warmup() runs its throwaway requests: a warming
        # engine is ALIVE but not READY.
        self._warming = False
        self._stop_now = threading.Event()
        self._submit_lock = threading.Lock()
        self._prefill_cache: dict = {}
        self._decode_block = max(1, int(decode_block))
        self._block_cache: dict = {}
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        # Overlapped pipeline: up to pipeline_depth dispatched-but-not-
        # fetched decode blocks. Each window entry is (k, fetch) — the
        # block length and its pending host copy (see _start_fetch).
        # Scheduler-thread-only, like _live.
        self._pipeline_depth = int(pipeline_depth)
        self._window: "collections.deque[tuple[int, object]]" = collections.deque()
        # Admissions whose first token is still on its way to the host:
        # (row, fetch). Resolved before any sweep can touch the row (see
        # _resolve_first_tokens).
        self._pending_first: list[tuple[int, object]] = []
        self._drain_stalls = 0  # forced drains of a non-empty window
        self._overlap_hidden_s = 0.0  # host sweep time hidden by flight
        # The host-side sampling gates, rebuilt only when the live set
        # changes (admit/retire), not per step.
        self._gates = None
        # The request popped from the queue but not yet parked in a slot
        # — must be failed explicitly if the loop dies mid-admission.
        self._inflight: _Pending | None = None
        # Chunked-prefill job in flight (loop thread only); its request
        # is in neither _live nor the queue, so shutdown/death paths
        # must fail it explicitly.
        self._job: _PrefillJob | None = None

        # Device-resident engine state (built lazily by the scheduler
        # thread on the first request, so constructing an engine is cheap).
        self._state: _DeviceState | None = None
        # Host-side per-slot bookkeeping: None = free, else
        # (_Pending, output tokens, output logprobs).
        self._live: list[tuple[_Pending, list[int], list[float]] | None] = [None] * self._slots
        self.steps = 0  # observability: engine decode steps taken
        self.admitted = 0
        self.completed = 0
        # Accepted-but-not-yet-resolved accounting for the drain
        # quiescence check: _accepted_total bumps under the submit lock
        # at enqueue, and every request resolves as exactly one of
        # completed or _failed_total.
        self._accepted_total = 0  # guarded-by: self._submit_lock
        self._failed_total = 0
        self.tokens_emitted = 0
        self.cancelled = 0  # consumer-abandoned requests (stream close)
        # Degradation surface: deadline expiries and watchdog fires are
        # failures (every one resolves its request via _fail_one).
        self.deadline_expired = 0  # scheduler-thread-owned, like steps
        self.watchdog_fires = 0  # watchdog-thread-owned
        # None until close() runs, then whether the scheduler (and the
        # emitter) actually wound down inside the join timeout.
        self._stopped_cleanly: bool | None = None
        # _fail_one may run on the watchdog thread concurrently with the
        # scheduler's retire path; this lock backs the resolve-once latch
        # on _Pending and the _failed_total count.
        self._resolve_lock = threading.Lock()
        # Watchdog plumbing: the scheduler stamps _progress_ts at every
        # observable step; _current_phase names where it currently is.
        self._progress_ts = time.monotonic()
        self._current_phase: str | None = None
        self._watchdog_abort = threading.Event()
        self._watchdog_suspended = False  # warmup runs under it
        if watchdog_s is not None and watchdog_s <= 0:
            raise ValueError(f"watchdog_s must be > 0, got {watchdog_s}")
        self._watchdog_s = watchdog_s
        self._ttft_sum = 0.0  # seconds, summed over completed requests
        self._duration_sum = 0.0
        # Latency denominators track only requests that actually ran.
        self._latency_n = 0

        # Observability (obs/): a per-engine span tracer and metrics
        # registry, rendered at the server's /stats and /metrics.
        self._tracer = obs_spans.SpanTracer(capacity=4096)
        self.metrics = obs_registry.Registry()
        self._m_accepted = self.metrics.counter(
            "engine_requests_total", "requests accepted into the queue"
        )
        self._m_completed = self.metrics.counter(
            "engine_requests_completed_total", "requests resolved"
        )
        self._m_failed = self.metrics.counter("engine_requests_failed_total", "requests failed")
        self._m_tokens = self.metrics.counter(
            "engine_tokens_emitted_total", "completion tokens decoded"
        )
        self._m_steps = self.metrics.counter(
            "engine_decode_steps_total", "device decode steps taken"
        )
        self._m_phase = self.metrics.histogram(
            "engine_request_phase_seconds",
            "scheduler phase latency (queue/prefill per request; "
            "dispatch/fetch/sweep per k-step decode block shared by "
            "all live slots)",
        )
        self._m_ttft = self.metrics.histogram("engine_ttft_seconds", "time to first token")
        self._m_drains = self.metrics.counter(
            "engine_drain_stalls_total",
            "forced drains of a non-empty in-flight block window "
            "(admission or prefill-admit state changes)",
        )
        self._m_deadline = self.metrics.counter(
            "engine_deadline_expired_total",
            "requests retired with a terminal DeadlineExceeded",
        )
        self._m_watchdog = self.metrics.counter(
            "engine_watchdog_fires_total",
            "scheduler watchdog fires (no loop progress with work in "
            "flight; in-flight requests aborted)",
        )
        self._m_overlap = self.metrics.histogram(
            "engine_overlap_hidden_seconds",
            "host sweep time that ran while >=1 decode block was "
            "still in flight (hidden behind device compute)",
        )
        g_busy = self.metrics.gauge("engine_slots_busy", "KV-cache slots currently occupied")
        g_depth = self.metrics.gauge("engine_queue_depth", "requests waiting for a slot")
        g_slots = self.metrics.gauge("engine_slots", "configured KV-cache slots")
        g_inflight = self.metrics.gauge(
            "engine_inflight_depth", "decode blocks dispatched but not yet fetched"
        )

        def _collect(busy=g_busy, depth=g_depth, slots=g_slots, inflight=g_inflight):
            # render-time refresh: these values' truth lives in the
            # scheduler's bookkeeping, not in a mutation stream
            busy.set(sum(e is not None for e in self._live) + (self._job is not None))
            depth.set(self._queue.qsize())
            slots.set(self._slots)
            inflight.set(len(self._window))

        self.metrics.add_collector(_collect)

        self._emitter = _EmitWorker()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="continuous-batcher")
        self._thread.start()
        if self._watchdog_s is not None:
            threading.Thread(target=self._watchdog_loop, daemon=True, name="engine-watchdog").start()

    # -- public API ----------------------------------------------------

    def _validate(
        self,
        tokens: list[int],
        max_new_tokens: int,
        temperature: float | None,
        adapter: int | None = None,
        stop: "list[list[int]] | None" = None,
        top_k: int | None = None,
        top_p: float | None = None,
        seed: int | None = None,
        min_p: float | None = None,
        frequency_penalty: float | None = None,
        presence_penalty: float | None = None,
        logit_bias: "dict[int, float] | None" = None,
        deadline_s: float | None = None,
    ) -> None:
        if deadline_s is not None and not (
            isinstance(deadline_s, (int, float)) and math.isfinite(deadline_s) and deadline_s > 0
        ):
            raise ValueError(f"deadline_s must be finite and > 0, got {deadline_s!r}")
        vocab = self._model.cfg.vocab_size
        if logit_bias is not None:
            if not isinstance(logit_bias, dict) or len(logit_bias) > _BIAS_SLOTS:
                raise ValueError(
                    f"logit_bias must be a dict of at most {_BIAS_SLOTS} "
                    f"token->bias entries, got {logit_bias!r}"
                )
            for t, v in logit_bias.items():
                if not (isinstance(t, int) and 0 <= t < vocab):
                    raise ValueError(f"logit_bias token id {t!r} outside [0, {vocab})")
                if not (isinstance(v, (int, float)) and math.isfinite(v) and -100.0 <= v <= 100.0):
                    raise ValueError(
                        f"logit_bias value for {t} must be finite and in [-100, 100], got {v!r}"
                    )
        if seed is not None and not isinstance(seed, int):
            raise ValueError(f"seed must be an int, got {seed!r}")
        for nm, v in (("frequency_penalty", frequency_penalty),
                      ("presence_penalty", presence_penalty)):
            # OpenAI's documented range; NaN fails the bounds check
            if v is not None and not (
                isinstance(v, (int, float)) and math.isfinite(v) and -2.0 <= v <= 2.0
            ):
                raise ValueError(f"{nm} must be finite and in [-2, 2], got {v!r}")
        if min_p is not None and not (
            isinstance(min_p, (int, float)) and math.isfinite(min_p) and 0 <= min_p <= 1
        ):
            raise ValueError(f"min_p must be finite and in [0, 1], got {min_p!r}")
        if top_k is not None and (not isinstance(top_k, int) or top_k < 1):
            raise ValueError(f"top_k must be an int >= 1, got {top_k!r}")
        if top_p is not None and not (
            isinstance(top_p, (int, float)) and math.isfinite(top_p) and 0 < top_p <= 1
        ):
            raise ValueError(f"top_p must be finite and in (0, 1], got {top_p!r}")
        if stop:
            if len(stop) > 16:
                # the tail match runs per decoded token inside the SHARED
                # scheduler loop
                raise ValueError(f"at most 16 stop sequences, got {len(stop)}")
            for seq in stop:
                if not seq or not all(isinstance(t, int) and 0 <= t for t in seq):
                    raise ValueError(
                        "stop sequences must be non-empty lists of "
                        f"non-negative token ids, got {seq!r}"
                    )
                if len(seq) > 64:
                    raise ValueError(f"stop sequences are capped at 64 tokens, got {len(seq)}")
        cfg = self._model.cfg
        if not tokens:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if temperature is not None and not (math.isfinite(temperature) and temperature >= 0):
            raise ValueError(f"temperature must be finite and >= 0, got {temperature}")
        if adapter is not None and adapter != 0:
            if self._n_adapters == 0:
                raise ValueError(
                    "this engine's params hold no MultiLoraTensor bank; "
                    "only adapter 0/None (base model) is valid"
                )
            if not (isinstance(adapter, int) and 0 <= adapter < self._n_adapters):
                # an out-of-range gather would read another tenant's
                # adapter (or fault on the device), not raise here
                raise ValueError(f"adapter {adapter} out of range [0, {self._n_adapters})")
        if self._prefill_chunk is None and len(tokens) > self._widths[-1]:
            # chunked prefill never touches the width buckets — its only
            # cap is the KV capacity checked below
            raise ValueError(
                f"prompt length {len(tokens)} exceeds the largest prompt width {self._widths[-1]}"
            )
        if len(tokens) + max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"prompt ({len(tokens)}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_seq_len ({cfg.max_seq_len})"
            )
        bad = [t for t in tokens if not 0 <= t < vocab]
        if bad:
            # an out-of-range id would index past the embedding table
            raise ValueError(f"token ids {bad[:5]} outside the vocabulary [0, {vocab})")

    def _enqueue_all(
        self,
        requests: list[tuple[list[int], "queue.Queue | None"]],
        max_new_tokens: int,
        temperature: float | None = None,
        eos_id: int | None = None,
        adapter: int | None = None,
        stop: "list[list[int]] | None" = None,
        top_k: int | None = None,
        top_p: float | None = None,
        seed: "int | list[int] | None" = None,
        min_p: float | None = None,
        frequency_penalty: float | None = None,
        presence_penalty: float | None = None,
        logit_bias: "dict[int, float] | None" = None,
        decode_block_pin: int | None = None,
        deadline_s: float | None = None,
        trace: str | None = None,
    ) -> list[_Pending]:
        """Validate then enqueue a group ATOMICALLY: either every row is
        accepted or none is.

        ``seed``: None = each row draws an engine seed (independent);
        an int seeds row i as ``seed + i``; a list gives each row its
        exact seed."""
        failpoint("engine.submit")
        if isinstance(seed, list):
            if len(seed) != len(requests):
                raise ValueError(f"seed list has {len(seed)} entries for {len(requests)} rows")
            row_seeds = seed
        elif seed is None:
            row_seeds = [None] * len(requests)
        elif not isinstance(seed, int):
            raise ValueError(f"seed must be an int, got {seed!r}")
        else:
            row_seeds = [seed + i for i in range(len(requests))]
        for (tokens, _), rs in zip(requests, row_seeds):
            self._validate(
                tokens, max_new_tokens, temperature, adapter, stop, top_k, top_p, rs, min_p,
                frequency_penalty, presence_penalty, logit_bias, deadline_s,
            )
        ps = [
            _Pending(
                list(tokens),
                int(max_new_tokens),
                threading.Event(),
                temperature=temperature,
                top_k=top_k,
                top_p=top_p,
                min_p=min_p,
                frequency_penalty=frequency_penalty,
                presence_penalty=presence_penalty,
                logit_bias=dict(logit_bias) if logit_bias else None,
                seed=rs,
                eos_id=eos_id,
                adapter=int(adapter or 0),
                stop=tuple(tuple(q) for q in (stop or ())),
                decode_block_pin=decode_block_pin,
                deadline_s=None if deadline_s is None else float(deadline_s),
                submitted_at=time.monotonic(),
                sink=sink,
                trace=trace,
            )
            for (tokens, sink), rs in zip(requests, row_seeds)
        ]
        if self._max_queue is not None and len(ps) > self._max_queue:
            # Permanently unsatisfiable, not transient overload.
            raise ValueError(
                f"request has {len(ps)} rows but the queue bound is "
                f"{self._max_queue}; split the request"
            )
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("engine shutting down")
            if self._max_queue is not None and self._queue.qsize() + len(ps) > self._max_queue:
                raise EngineOverloaded(f"request queue full ({self._max_queue} waiting)")
            self._accepted_total += len(ps)
            self._m_accepted.inc(len(ps))
            for p in ps:
                self._queue.put(p)
        return ps

    def _enqueue(
        self,
        tokens: list[int],
        max_new_tokens: int,
        sink=None,
        temperature: float | None = None,
        eos_id: int | None = None,
        adapter: int | None = None,
        stop: "list[list[int]] | None" = None,
        top_k: int | None = None,
        top_p: float | None = None,
        seed: int | None = None,
        min_p: float | None = None,
        frequency_penalty: float | None = None,
        presence_penalty: float | None = None,
        logit_bias: "dict[int, float] | None" = None,
        decode_block_pin: int | None = None,
        deadline_s: float | None = None,
        trace: str | None = None,
    ) -> _Pending:
        return self._enqueue_all(
            [(tokens, sink)], max_new_tokens, temperature, eos_id, adapter, stop, top_k, top_p,
            seed, min_p, frequency_penalty, presence_penalty, logit_bias, decode_block_pin,
            deadline_s, trace=trace,
        )[0]

    def submit(
        self,
        tokens: list[int],
        max_new_tokens: int,
        temperature: float | None = None,
        eos_id: int | None = None,
        return_logprobs: bool = False,
        adapter: int | None = None,
        stop: "list[list[int]] | None" = None,
        top_k: int | None = None,
        top_p: float | None = None,
        seed: int | None = None,
        min_p: float | None = None,
        frequency_penalty: float | None = None,
        presence_penalty: float | None = None,
        logit_bias: "dict[int, float] | None" = None,
        deadline_s: float | None = None,
        trace: str | None = None,
    ) -> "list[int] | tuple[list[int], list[float]]":
        """Blocking decode. ``temperature``, ``top_k``, ``top_p`` and
        ``eos_id`` override the engine-wide defaults FOR THIS REQUEST
        (temperature 0 = greedy; a NEGATIVE eos disables EOS stopping for
        this request). ``return_logprobs``: also return each emitted
        token's logprob under the raw model distribution (the /score
        convention). ``deadline_s``: wall-clock budget from submission;
        on expiry the request fails with a terminal
        :class:`DeadlineExceeded`."""
        p = self._enqueue(
            tokens, max_new_tokens, temperature=temperature, eos_id=eos_id, adapter=adapter,
            stop=stop, top_k=top_k, top_p=top_p, seed=seed, min_p=min_p,
            frequency_penalty=frequency_penalty, presence_penalty=presence_penalty,
            logit_bias=logit_bias, deadline_s=deadline_s, trace=trace,
        )
        p.event.wait()
        if p.error is not None:
            raise p.error
        if return_logprobs:
            return p.result, p.logprobs
        return p.result

    def submit_many(
        self,
        prompts: list[list[int]],
        max_new_tokens: int,
        temperature: float | None = None,
        eos_id: int | None = None,
        return_logprobs: bool = False,
        adapter: int | None = None,
        stop: "list[list[int]] | None" = None,
        top_k: int | None = None,
        top_p: float | None = None,
        seed: "int | list[int] | None" = None,
        min_p: float | None = None,
        frequency_penalty: float | None = None,
        presence_penalty: float | None = None,
        logit_bias: "dict[int, float] | None" = None,
        deadline_s: float | None = None,
        return_versions: bool = False,
        trace: str | None = None,
    ) -> "list[list[int]] | tuple[list[list[int]], list[list[float]]]":
        """Blocking decode of several prompts admitted ATOMICALLY (all
        rows accepted or an EngineOverloaded/ValueError before any row
        enters the queue) — the multi-row /generate path.
        ``return_versions``: also return each row's ``weights_version``
        stamp (the trailing element of the return tuple)."""
        ps = self._enqueue_all(
            [(p, None) for p in prompts], max_new_tokens, temperature, eos_id, adapter, stop,
            top_k, top_p, seed, min_p, frequency_penalty, presence_penalty, logit_bias, None,
            deadline_s, trace=trace,
        )
        for p in ps:
            p.event.wait()
        for p in ps:
            if p.error is not None:
                raise p.error
        out: tuple = ([p.result for p in ps],)
        if return_logprobs:
            out += ([p.logprobs for p in ps],)
        if return_versions:
            out += ([p.weights_version for p in ps],)
        return out if len(out) > 1 else out[0]

    def stream(
        self,
        tokens: list[int],
        max_new_tokens: int,
        temperature: float | None = None,
        eos_id: int | None = None,
        yield_logprobs: bool = False,
        adapter: int | None = None,
        stop: "list[list[int]] | None" = None,
        top_k: int | None = None,
        top_p: float | None = None,
        seed: int | None = None,
        min_p: float | None = None,
        frequency_penalty: float | None = None,
        presence_penalty: float | None = None,
        logit_bias: "dict[int, float] | None" = None,
        deadline_s: float | None = None,
        trace: str | None = None,
    ):
        """Yield completion tokens AS THEY DECODE instead of blocking for
        the full result. Validation and enqueue happen EAGERLY, at the
        call. The iterator raises if the request fails mid-decode;
        closing it early (or dropping it) CANCELS the request.
        ``yield_logprobs``: yield ``(token, logprob)`` pairs."""
        p = self._enqueue(
            tokens, max_new_tokens, sink=queue.Queue(), temperature=temperature, eos_id=eos_id,
            adapter=adapter, stop=stop, top_k=top_k, top_p=top_p, seed=seed, min_p=min_p,
            frequency_penalty=frequency_penalty, presence_penalty=presence_penalty,
            logit_bias=logit_bias, deadline_s=deadline_s, trace=trace,
        )
        # An explicit iterator, NOT a generator: close() on a never-started
        # generator skips its finally block entirely.
        return _Stream(p, yield_logprobs)

    def warmup(self) -> None:
        """Run one thrown-away request through every program a request
        could hit (the decode block, the admit copy, each prompt-width
        prefill or the chunk/sample pair, and the k=1 block), so that the
        first real request pays neither the first launches of the kernels
        nor the allocation of the slot cache. Call after construction,
        before serving traffic (``--gen-warmup``). ``health()`` reports
        the engine as warming, not ready, meanwhile."""
        # Watchdog suspended for the duration: first-call stalls are
        # indistinguishable from the wedges it hunts.
        self._watchdog_suspended = True
        self._warming = True
        try:
            self._warmup_requests()
        finally:
            self._warming = False
            self._watchdog_suspended = False

    def _warmup_requests(self) -> None:
        max_seq = self._model.cfg.max_seq_len
        if self._prefill_chunk is not None:
            # chunk + sample1 + admit + step on a multi-chunk prompt, so
            # the window-shift math runs
            n = max(1, min(self._prefill_chunk + 1, max_seq - 2))
            self.submit([0] * n, 2, eos_id=-1)
        else:
            step_warmed = False
            prev = 0
            for w in self._widths:
                # the longest VALID prompt that still maps to this bucket
                n = min(w, max_seq - 1)
                if n <= prev:
                    continue  # no valid request can reach this bucket
                if not step_warmed and n + 2 <= max_seq:
                    self.submit([0] * n, 2, eos_id=-1)
                    step_warmed = True
                else:
                    self.submit([0] * n, 1)
                prev = w
            if not step_warmed:
                self.submit([0], 2, eos_id=-1)
        if self._decode_block > 1:
            # The k=1 block still runs whenever an admission or chunk job
            # is pending; pin the block to 1 THROUGH a warmup request so
            # it runs without mutating the shared self._decode_block.
            p = self._enqueue([0], 2, eos_id=-1, decode_block_pin=1)
            p.event.wait()
            if p.error is not None:
                raise p.error
        if self._prefix_store is not None:
            # drop the throwaway prompts' entries — each pins a full
            # single-row KV cache until evicted. Safe here: submit()
            # returned, so the scheduler is blocked on the queue.
            self._prefix_store.clear()

    # -- hot weight swap -----------------------------------------------

    @property
    def weights_version(self) -> str:
        """Label of the weights currently serving."""
        return self._weights_version

    def current_weights(self) -> "tuple[str, dict]":
        """``(version, params)`` of the weights currently serving (a
        reference to the tensors, not a copy; a swap installs new tensors
        and never writes these)."""
        return self._weights_version, self._params

    def serving_module(self):
        """The module the scheduler runs now: the model itself while the
        engine serves the model's own weights, else the model's tree bound
        to the swapped-in set. Read between installs, it is one version's
        whole module (``tools.serve_model``'s ``/score`` runs it)."""
        return self._runner

    def swap_weights(self, new_params, *, version: str, kind: str = "full",
                     timeout: float = 120.0) -> str:
        """Replace the serving weights WITHOUT restarting the engine.

        ``new_params`` is a whole dense weight set in the layout of
        ``models.convert`` (name -> tensor or array). It is validated
        against the running weights on the CALLER thread (names, per-leaf
        shape and dtype — any mismatch is a synchronous
        :class:`WeightsIncompatible` and the engine keeps serving its
        current version) and copied to the engine's device there. The
        scheduler then installs it between decode blocks — a pointer
        flip. The prefix cache is cleared at install. Requests decoding
        ACROSS the install finish under the new weights and are stamped
        with the new version.

        ``kind='lora'``: ``new_params`` holds only adapter factors, the
        ``_lora_a`` / ``_lora_b`` entries of adapted leaves (both of each;
        ``serving.rollout.lora_state`` extracts them). Those are copied in
        and every other tensor, the bases included, is the running one by
        reference: the adapter-only swap moves the factors alone."""
        if kind not in ("full", "lora"):
            raise ValueError(f"kind must be 'full' or 'lora', got {kind!r}")
        version = str(version)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("engine shutting down")
            if self._pending_swap is not None:
                raise RuntimeError("a weight swap is already pending")
        placed = self._place_update(new_params, kind)
        req = _SwapRequest(placed=placed, runner=_bound_module(self._model, placed),
                           version=version, event=threading.Event())
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("engine shutting down")
            if self._pending_swap is not None:
                raise RuntimeError("a weight swap is already pending")
            self._pending_swap = req
        self._queue.put(self._WAKE)  # an idle scheduler must notice
        if not req.event.wait(timeout):
            with self._submit_lock:
                if self._pending_swap is req:
                    self._pending_swap = None
                    raise TimeoutError(
                        f"weight swap to {version!r} not applied within {timeout}s "
                        "(scheduler busy or wedged)"
                    )
            # the scheduler claimed it just as we timed out: the install
            # is in flight — wait it out briefly
            req.event.wait(10.0)
        if not req.event.is_set():
            raise TimeoutError(f"weight swap to {version!r} not applied within {timeout}s")
        if req.error is not None:
            raise req.error
        return version

    def _place_initial(self, params) -> dict:
        """The construction-time weight set, in any format the model has
        slots for (the constructor's ``_bound_module`` checks its names and
        shapes), placed by :meth:`_place_update` against the model's dtype."""
        return self._place_update(params, "initial")

    def _place_update(self, new_params, kind: str) -> dict:
        """Validate + device-place a weight set (caller thread). Raises
        :class:`WeightsIncompatible` on any name/shape/dtype mismatch BEFORE
        anything is installed. ``kind`` names the target: ``'full'`` the
        running set's names, shapes and dtypes; ``'lora'`` its adapter
        factors (:meth:`_graft_lora`); ``'initial'`` the set's own names
        and shapes, each floating leaf in the model's ``cfg.dtype`` (a
        scale, int8 or LoRA, also in fp32) and every other leaf int8."""
        if not isinstance(new_params, dict):
            raise WeightsIncompatible(
                f"a weight set is a dict of name -> tensor, got {type(new_params).__name__}"
            )
        if kind == "lora":
            return self._graft_lora(new_params)
        if kind == "initial":
            old = {n: self._initial_target(n, t) for n, t in new_params.items()}
        else:
            old = self._params
        if set(new_params) != set(old):
            missing, extra = sorted(set(old) - set(new_params)), sorted(set(new_params) - set(old))
            raise WeightsIncompatible(
                f"weight names differ from the running weights (missing {missing[:5]}, "
                f"unknown {extra[:5]})"
            )
        placed = {name: self._place_leaf(old[name], new_params[name], name) for name in old}
        if self._cuda:
            torch.cuda.synchronize(self._device)
        return placed

    def _initial_target(self, name: str, t):
        """The shape, dtype and device a construction-time leaf must have."""
        if not isinstance(t, (torch.Tensor, np.ndarray)):
            raise WeightsIncompatible(f"leaf {name}: {type(t).__name__} is not a tensor")
        t = torch.as_tensor(t)
        if not t.is_floating_point():
            dtype = torch.int8
        elif name.endswith("_scale") and t.dtype == torch.float32:
            dtype = torch.float32
        else:
            dtype = self._model.cfg.dtype
        return types.SimpleNamespace(shape=t.shape, dtype=dtype, device=self._device)

    def _graft_lora(self, upd: dict) -> dict:
        """Adapter-only update: the running weight set with exactly the
        named ``_lora_a`` / ``_lora_b`` factors replaced (copies on the
        device), every other tensor the running one by reference."""
        from tensorflowonspark_tpu_torch.ops.lora import A, B

        old = self._params
        bases = set()
        for name in upd:
            if not (name.endswith(A) or name.endswith(B)) or name not in old:
                raise WeightsIncompatible(
                    f"{name}: an adapter update names only the running weights' _lora_a / "
                    "_lora_b factors"
                )
            bases.add(name[: -len(A)])
        for base in sorted(bases):
            if base + A not in upd or base + B not in upd:
                raise WeightsIncompatible(f"{base}: adapter update must carry both {A} and {B}")
        placed = dict(old)
        for name, t in upd.items():
            placed[name] = self._place_leaf(old[name], t, name)
        if self._cuda:
            torch.cuda.synchronize(self._device)
        return placed

    @staticmethod
    def _place_leaf(old, new, where: str):
        if new is old:
            return old  # re-install of a retained set: nothing to move
        if not isinstance(new, (torch.Tensor, np.ndarray)):
            raise WeightsIncompatible(f"leaf {where}: {type(new).__name__} is not a tensor")
        new = torch.as_tensor(new)
        if tuple(new.shape) != tuple(old.shape) or new.dtype != old.dtype:
            raise WeightsIncompatible(
                f"leaf {where}: update has shape {tuple(new.shape)} dtype {new.dtype}, "
                f"running weights have {tuple(old.shape)} {old.dtype}"
            )
        return new.detach().to(old.device, copy=True)

    def _apply_pending_swap(self) -> None:
        """Scheduler thread: install a prepared swap between decode
        blocks. In-flight blocks were issued against the old weights —
        sweep them out, then flip."""
        with self._submit_lock:
            req, self._pending_swap = self._pending_swap, None
        if req is None:
            return
        self._drain_window("swap")
        self._params = req.placed
        self._runner = req.runner
        self._weights_version = req.version
        self._weights_swaps += 1
        reqtrace.mark("engine.weights_swap", version=req.version)
        if self._prefix_store is not None:
            # stored prefixes' K/V was computed under the OLD weights
            self._prefix_store.clear()
        req.event.set()
        logger.info("engine weights swapped to %r (swap #%d)", req.version, self._weights_swaps)

    def _abort_pending_swap(self, err: BaseException) -> None:
        """Fail a waiting swap when the scheduler exits before applying
        it (shutdown or loop death) — its caller must not hang."""
        with self._submit_lock:
            req, self._pending_swap = self._pending_swap, None
        if req is not None:
            req.error = RuntimeError(f"weight swap aborted: {err}")
            req.event.set()

    # -- live scheduler knobs ------------------------------------------

    def set_knobs(self, *, decode_block: int | None = None, pipeline_depth: int | None = None,
                  timeout: float = 30.0) -> dict:
        """Change ``decode_block`` and/or ``pipeline_depth`` on a RUNNING
        engine. Both knobs are owned by the scheduler thread, so the
        change is staged here and installed between decode blocks after
        the in-flight window drains, exactly like :meth:`swap_weights`.
        Returns the knob values in effect after the install."""
        if decode_block is None and pipeline_depth is None:
            return {"decode_block": self._decode_block, "pipeline_depth": self._pipeline_depth}
        if decode_block is not None and int(decode_block) < 1:
            raise ValueError(f"decode_block must be >= 1, got {decode_block}")
        if pipeline_depth is not None and int(pipeline_depth) < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        req = _KnobRequest(
            decode_block=None if decode_block is None else int(decode_block),
            pipeline_depth=None if pipeline_depth is None else int(pipeline_depth),
            event=threading.Event(),
        )
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("engine shutting down")
            if self._pending_knobs is not None:
                raise RuntimeError("a knob change is already pending")
            self._pending_knobs = req
        self._queue.put(self._WAKE)  # an idle scheduler must notice
        if not req.event.wait(timeout):
            with self._submit_lock:
                if self._pending_knobs is req:
                    self._pending_knobs = None
                    raise TimeoutError(
                        f"knob change not applied within {timeout}s (scheduler busy or wedged)"
                    )
            req.event.wait(10.0)
        if not req.event.is_set():
            raise TimeoutError(f"knob change not applied within {timeout}s")
        if req.error is not None:
            raise req.error
        return {"decode_block": self._decode_block, "pipeline_depth": self._pipeline_depth}

    def _apply_pending_knobs(self) -> None:
        """Scheduler thread: install a staged knob change between decode
        blocks (``_loop`` rebinds its local ``depth`` right after)."""
        with self._submit_lock:
            req, self._pending_knobs = self._pending_knobs, None
        if req is None:
            return
        self._drain_window("knobs")
        if req.decode_block is not None:
            self._decode_block = max(1, int(req.decode_block))
        if req.pipeline_depth is not None:
            self._pipeline_depth = max(1, int(req.pipeline_depth))
        reqtrace.mark("engine.knobs", decode_block=self._decode_block,
                      pipeline_depth=self._pipeline_depth)
        req.event.set()
        logger.info("engine knobs applied: decode_block=%d pipeline_depth=%d",
                    self._decode_block, self._pipeline_depth)

    def _abort_pending_knobs(self, err: BaseException) -> None:
        """Fail a waiting knob change when the scheduler exits before
        applying it — its caller must not hang."""
        with self._submit_lock:
            req, self._pending_knobs = self._pending_knobs, None
        if req is not None:
            req.error = RuntimeError(f"knob change aborted: {err}")
            req.event.set()

    @contextlib.contextmanager
    def _phase(self, phase: str):
        """Measure one scheduler phase into the span ring (``/stats``
        percentiles) and the phase histogram, and name the phase for the
        watchdog/close diagnostics ("stuck in fetch")."""
        t0 = time.monotonic()
        self._current_phase = phase
        try:
            with self._tracer.span("engine." + phase):
                yield
        finally:
            self._current_phase = None
        self._m_phase.observe(time.monotonic() - t0, phase=phase)

    def _observe_queue_wait(self, p: _Pending) -> None:
        now = time.monotonic()
        dur = now - p.submitted_at
        self._tracer.record("engine.queue", dur)
        self._m_phase.observe(dur, phase="queue")
        if p.trace is not None:
            reqtrace.segment(p.trace, "engine.queue", dur)
            p.trace_mark = now

    def health(self) -> dict:
        """Liveness vs readiness, split (the ``/healthz`` contract):
        ``live`` = the scheduler thread runs; ``ready`` = live AND warmup
        is not in progress AND the engine is not closed/draining."""
        live = self._thread.is_alive()
        return {
            "live": live,
            "ready": bool(live and not self._warming and not self._closed),  # lint: lockfree-read: advisory health probe
            "warming": self._warming,
            "closed": self._closed,  # lint: lockfree-read: same advisory snapshot as above
            "weights_version": self._weights_version,
        }

    def unresolved(self) -> int:
        """Accepted-but-not-yet-resolved request count — the drain
        quiescence metric ``close(drain=True)`` polls."""
        return self._accepted_total - (  # lint: lockfree-read: monotonic counters
            self.completed + self._failed_total
        )

    def stats(self) -> dict:
        """Scheduler observability (served at the HTTP ``/stats``
        endpoint): slot occupancy, queue depth, lifetime counters."""
        # a chunked prefill holds a reserved slot that is not yet in
        # _live — it IS load
        busy = sum(e is not None for e in self._live) + (self._job is not None)
        done = self._latency_n
        return {
            "slots": self._slots,
            "slots_busy": busy,
            "queue_depth": self._queue.qsize(),
            "steps": self.steps,
            "decode_block": self._decode_block,
            "pipeline_depth": self._pipeline_depth,
            "inflight_depth": len(self._window),
            "drain_stalls": self._drain_stalls,
            "overlap_hidden_ms": round(self._overlap_hidden_s * 1e3, 3),
            "admitted": self.admitted,
            "completed": self.completed,
            "cancelled": self.cancelled,
            "unresolved": self.unresolved(),
            "tokens_emitted": self.tokens_emitted,
            "deadline_expired": self.deadline_expired,
            "watchdog_fires": self.watchdog_fires,
            "stopped_cleanly": self._stopped_cleanly,
            "weights_version": self._weights_version,
            "weights_swaps": self._weights_swaps,
            "prefill_in_progress": self._job is not None,
            # queue wait + prefill, averaged over completed requests
            "ttft_avg_ms": round(self._ttft_sum / done * 1e3, 3) if done else None,
            "request_avg_ms": round(self._duration_sum / done * 1e3, 3) if done else None,
            # Per-phase latency percentiles over the span ring. Units
            # differ by phase: queue and prefill are per REQUEST; dispatch,
            # fetch and sweep are per k-step decode BLOCK shared by every
            # live slot.
            "phase_ms": {
                name.split(".", 1)[1]: v
                for name, v in self._tracer.summary(prefix="engine.").items()
            },
            "closed": self._closed,  # lint: lockfree-read: advisory /stats snapshot
            **({"adapters": self._n_adapters} if self._n_adapters else {}),
            **(
                {
                    "prefix_cache_entries": len(self._prefix_store),
                    "prefix_hits": self._prefix_store.hits,
                    "prefix_misses": self._prefix_store.misses,
                    "prefix_tokens_saved": self._prefix_store.tokens_saved,
                }
                if self._prefix_store is not None
                else {}
            ),
            **(
                {f"prefix_{k}": v for k, v in self._prefix_l2.stats().items()}
                if self._prefix_l2 is not None
                else {}
            ),
        }

    def close(self, drain: bool = False, drain_timeout: float = 300.0) -> None:
        """Stop the loop. Default: queued requests fail and live rows are
        failed once the STOP marker is reached (abrupt shutdown).
        ``drain=True``: refuse new submits immediately but let every
        already-accepted request run to completion first, up to
        ``drain_timeout`` seconds before falling back to the abrupt
        path."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            if not drain:
                self._queue.put(self._STOP)
        if drain:
            deadline = time.monotonic() + drain_timeout
            while time.monotonic() < deadline:
                # quiescence by ACCOUNTING: every accepted request
                # resolves as exactly one of completed/failed
                unresolved = self._accepted_total - (  # lint: lockfree-read: drain quiescence poll
                    self.completed + self._failed_total
                )
                if unresolved == 0:
                    break
                time.sleep(0.05)
            self._queue.put(self._STOP)
        # The queued STOP only wakes a loop BLOCKED on the queue; the event
        # reaches a loop busy decoding full slots too.
        self._stop_now.set()
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            logger.warning(
                "engine scheduler did not stop within 60s (stuck in %s); resources may "
                "leak until process exit",
                self._current_phase or "between phases",
            )
            self._stopped_cleanly = False
        else:
            self._stopped_cleanly = True
        if self._prefix_store is not None and not self._thread.is_alive():
            # Drop the stored KV buffers — only once the loop thread is
            # truly gone: it reads the store without a lock.
            self._prefix_store.clear()
        if self._prefix_l2 is not None and not self._thread.is_alive():
            # Stop the L2 filler thread (pending offers drain or drop);
            # the underlying client/tier belongs to the fleet, not this
            # engine, so only the facade winds down here.
            self._prefix_l2.close()
        if not self._thread.is_alive():
            # the slot cache goes with the loop: a closed engine that is
            # still referenced must not pin it
            self._state = None

    def attach_prefix_l2(self, l2) -> None:
        """Attach (or detach with None) the fleet-global prefix L2 on a
        RUNNING engine — the ServingFleet injection path for factory-
        built replicas. The rebind is a single atomic reference swap;
        the scheduler reads ``_prefix_l2`` racily and a one-iteration-
        stale view is benign (one extra miss or offer)."""
        if l2 is not None and self._prefix_store is None:
            raise ValueError("prefix_l2 requires prefix_cache")
        self._prefix_l2 = l2

    def _l2_offer(self, tokens: list[int], cache_1, adapter) -> None:
        """Publish one L1-inserted prefix to the fleet L2, fire-and-
        forget: the entry is never written again, so the L2 takes its
        tensors as they are and copies them to the host on its filler
        thread, after an event recorded here on the scheduler's stream."""
        l2 = self._prefix_l2
        if l2 is None or self._warming:
            # warmup's throwaway prompts are cleared from L1 afterwards;
            # publishing them fleet-wide would be respawn-time junk
            return
        try:
            l2.offer(tokens, _cache_leaves(cache_1), adapter, self._weights_version)
        except Exception:  # noqa: BLE001 - a lost offer is a later miss
            logger.warning("prefix L2 offer failed", exc_info=True)

    def _l2_reconstruct(self, leaves):
        """A single-row cache on the engine's device from L2 host
        tensors, or None when they do not match this engine's cache (a
        foreign config's entry — a miss; the count, dtype and shape
        check is the exactness guard). The upload is asynchronous."""
        template = self._cache_shapes(1)
        flat = _cache_leaves(template)
        if not isinstance(leaves, list) or len(leaves) != len(flat):
            return None
        if any(not isinstance(x, torch.Tensor) or x.dtype != want.dtype
               or tuple(x.shape) != tuple(want.shape) for x, want in zip(leaves, flat)):
            return None
        placed = iter(x.to(self._device, non_blocking=x.is_pinned()) for x in leaves)
        return [{name: next(placed) for name in sorted(layer)} for layer in template]

    # -- device programs -----------------------------------------------

    def _upload(self, arr, dtype):
        """A host array on the engine's device without a host sync: a
        copy from a pinned buffer, ordered on the stream."""
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
        if not self._cuda:
            return t.to(self._device)
        return t.pin_memory().to(self._device, non_blocking=True)

    def _start_fetch(self, t):
        """Start the copy of device tensor ``t`` to a pinned host buffer
        and return (buffer, event); :meth:`_block_ready` polls it and
        :meth:`_finish_fetch` waits for it. On the CPU the copy is done
        at once."""
        if not self._cuda:
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _finish_fetch(fetch) -> np.ndarray:
        host, ev = fetch
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    def _forward(self, tokens, positions, cache, ads):
        """``ads``: each row's LoRA bank slot (unused without a bank)."""
        return self._runner(tokens, positions=positions, decode=True, padded=True, cache=cache,
                            adapter_ids=ads if self._n_adapters else None)

    def _decode_body(self):
        """One decode step over every slot — the body shared by every k in
        :meth:`_block_fn`. Updates ``st`` (cache in place, each row's
        token, position and generated-token counts) and returns the
        sampled tokens (B,) and their logprobs (B,)."""
        max_pos = self._model.cfg.max_seq_len - 1

        def body(st, gates):
            logits = self._forward(st.tok[:, None], st.pos[:, None], st.cache, st.ads)[:, -1]
            # the sampled token will occupy position pos+1 (unclamped:
            # the cache-write clamp below must not alias two counters)
            counter = st.pos + 1
            nxt, lp = _sample_rows(logits, st.temps, st.kps, st.seeds, counter, st.pens,
                                   st.counts, st.bids, st.bvals, gates=gates)
            if gates[2]:
                # the emitted token enters its row's generated-token
                # counts; all-unpenalized batches never write the plane
                st.counts.scatter_add_(1, nxt[:, None], torch.ones_like(lp)[:, None])
            st.tok = nxt
            # Clamp so a retired-but-not-yet-reused row parked at the
            # cache edge never writes out of bounds (its writes are
            # garbage either way; admission overwrites the whole row).
            st.pos = torch.clamp(st.pos + 1, max=max_pos)
            return nxt, lp

        return body

    def _block_fn(self, k: int):
        """k decode steps issued back to back with no host sync. Returns
        ``block(st, gates) -> packed``, ONE (2, k, slots) int32 tensor —
        row 0 the sampled tokens, row 1 their fp32 logprobs viewed as
        int32 — so the host retires a whole block with a single copy.
        Memoized per engine."""
        cached = self._block_cache.get(k)
        if cached is not None:
            return cached
        body = self._decode_body()

        def block(st, gates):
            toks, lps = [], []
            for _ in range(k):
                nxt, lp = body(st, gates)
                toks.append(nxt)
                lps.append(lp)
            return torch.stack([torch.stack(toks).to(torch.int32),
                                torch.stack(lps).view(torch.int32)])

        self._block_cache[k] = block
        return block

    def _prefill_fn(self, width: int):
        """The (1, width) padded prefill into a fresh single-row cache;
        returns ``prefill(prompt, length, vals, gates) -> (cache_1, tok,
        lp)`` with the first token sampled at the true last position
        ``length - 1``. Memoized per width bucket."""
        cached = self._prefill_cache.get(width)
        if cached is not None:
            return cached

        def prefill(prompt, length: int, vals, gates):
            cache_1 = self._single_row_cache()
            positions = torch.arange(width, device=self._device)[None, :]
            logits = self._forward(prompt, positions, cache_1, vals["adapter"])
            # the first sampled token occupies position `length`;
            # logit_bias shapes it too (penalties don't - zero counts)
            tok, lp = _sample_rows(
                logits[:, length - 1], vals["temp"], vals["kp"], vals["seed"], vals["length"],
                bias_ids=vals["bid"], bias_vals=vals["bval"], gates=gates,
            )
            return cache_1, tok, lp

        self._prefill_cache[width] = prefill
        return prefill

    def _admit_fn(self, st: _DeviceState, cache_1, row: int, tok_1, vals) -> None:
        """Copy a single-row cache and its request's sampling state into
        slot ``row`` of the engine's tensors."""
        for layer_b, layer_1 in zip(st.cache, cache_1):
            for name, leaf in layer_b.items():
                if leaf.dim() == 0:  # the scalar write index: unused on the padded path
                    continue
                leaf[row].copy_(layer_1[name][0])
        st.tok[row:row + 1].copy_(tok_1)
        st.pos[row:row + 1].copy_(vals["length"])
        st.temps[row:row + 1].copy_(vals["temp"])
        st.kps[row:row + 1].copy_(vals["kp"])
        st.seeds[row:row + 1].copy_(vals["seed"])
        st.pens[row:row + 1].copy_(vals["pen"])
        # the row's generated-token counts restart at ONE for the
        # prefill-sampled first token (the prompt is not penalized)
        st.counts[row].zero_()
        st.counts[row].scatter_(0, tok_1, 1.0)
        st.bids[row:row + 1].copy_(vals["bid"])
        st.bvals[row:row + 1].copy_(vals["bval"])
        st.ads[row:row + 1].copy_(vals["adapter"])

    def _chunk_fn(self, cache_1, tokens, positions, ads):
        """One prompt chunk (1, C) through the model against the
        single-row cache — the unit a chunked prefill interleaves with
        decode steps. Returns the chunk's logits (1, C, vocab)."""
        return self._forward(tokens, positions, cache_1, ads)

    @staticmethod
    def _sample1_fn(logits_chunk, idx: int, vals, gates):
        """The first token from the prompt's true last position ``idx``
        of the final chunk's logits."""
        return _sample_rows(
            logits_chunk[:, idx], vals["temp"], vals["kp"], vals["seed"], vals["length"],
            bias_ids=vals["bid"], bias_vals=vals["bval"], gates=gates,
        )

    def _cache_shapes(self, batch: int):
        """The cache of a ``batch``-row decode on the meta device — its
        tensors' shapes and dtypes, from the model's ``init_cache``, so
        the per-row and engine-batch caches can never drift apart
        structurally."""
        from tensorflowonspark_tpu_torch.models.llama import init_cache

        return init_cache(self._model.cfg, batch, device="meta")

    def _single_row_cache(self):
        from tensorflowonspark_tpu_torch.models.llama import init_cache

        # the model owns its cache-leaf init values (rolling caches
        # init the position plane to -1, not 0)
        return init_cache(self._model.cfg, 1, self._device)

    def _empty_state(self) -> _DeviceState:
        from tensorflowonspark_tpu_torch.models.llama import init_cache

        b, vocab, dev = self._slots, self._model.cfg.vocab_size, self._device
        st = _DeviceState()
        st.cache = init_cache(self._model.cfg, b, dev)
        for layer, shapes in zip(st.cache, self._cache_shapes(b)):
            assert {n: (t.shape, t.dtype) for n, t in layer.items()} == {
                n: (t.shape, t.dtype) for n, t in shapes.items()}
        st.tok = torch.zeros(b, dtype=torch.long, device=dev)
        # Parked rows decode at position 0 against their own slot only;
        # their K/V writes stay inside their row and are overwritten on
        # admission.
        st.pos = torch.zeros(b, dtype=torch.long, device=dev)
        st.temps = torch.zeros(b, device=dev)
        # per-row [top_k, top_p, min_p], truncation disabled (k=vocab,
        # p=1, m=0)
        st.kps = torch.tensor([float(vocab), 1.0, 0.0], device=dev).repeat(b, 1)
        st.seeds = torch.zeros(b, dtype=torch.long, device=dev)
        st.pens = torch.zeros(b, 2, device=dev)
        st.counts = torch.zeros(b, vocab, device=dev)
        st.bids = torch.full((b, _BIAS_SLOTS), -1, dtype=torch.long, device=dev)
        st.bvals = torch.zeros(b, _BIAS_SLOTS, device=dev)
        # parked rows route to slot 0 (the base): any valid slot would do
        st.ads = torch.zeros(b, dtype=torch.long, device=dev)
        return st

    def _effective_knobs(self, p: _Pending):
        """Resolved (top_k, top_p, min_p) for one request — the request
        value, else the engine-wide default, else disabled (k = vocab /
        p = 1.0 / m = 0.0). A row whose EFFECTIVE temperature is 0
        decodes greedily, so its k/p/min_p resolve to disabled outright.
        THE single source for both the device kps rows and the host
        gates (_step_gates)."""
        vocab = self._model.cfg.vocab_size
        temp = self._temperature if p.temperature is None else p.temperature
        if temp <= 0:
            return float(vocab), 1.0, 0.0
        k = p.top_k if p.top_k is not None else self._top_k
        k = vocab if k is None else min(int(k), vocab)
        q = p.top_p if p.top_p is not None else self._top_p
        q = 1.0 if q is None else float(q)
        m = p.min_p if p.min_p is not None else self._min_p
        m = 0.0 if m is None else float(m)
        return float(k), q, m

    def _row_gates(self, p: _Pending) -> tuple:
        """(sort, min_p, penalties, bias, sample) for one request, from
        its host values."""
        vocab = self._model.cfg.vocab_size
        k, q, m = self._effective_knobs(p)
        temp = self._temperature if p.temperature is None else p.temperature
        return (k < vocab or q < 1.0, m > 0.0,
                bool(p.frequency_penalty or p.presence_penalty),  # they shape greedy rows too
                bool(p.logit_bias), temp > 0)

    def _row_values(self, p: _Pending) -> dict:
        """The request's resolved sampling state as (1, ...) device
        tensors: temperature, [top_k, top_p, min_p], seed (the request's,
        else one drawn from the engine's stream), [frequency, presence]
        penalties, logit_bias ids/values (unused slots id -1), and its
        prompt length (the first sampled token's position)."""
        temp = self._temperature if p.temperature is None else float(p.temperature)
        if p.seed is not None:
            seed = int(p.seed) % (2**32)
        else:
            seed = int(self._seed_rng.integers(2**32, dtype=np.uint32))
        ids = np.full((1, _BIAS_SLOTS), -1, np.int64)
        vals = np.zeros((1, _BIAS_SLOTS), np.float32)
        for i, (t, v) in enumerate((p.logit_bias or {}).items()):
            ids[0, i] = t
            vals[0, i] = v
        f32 = torch.float32
        return {
            "temp": self._upload(np.array([temp], np.float32), f32),
            "kp": self._upload(np.array([self._effective_knobs(p)], np.float32), f32),
            "seed": self._upload(np.array([seed], np.int64), torch.long),
            "pen": self._upload(np.array([[float(p.frequency_penalty or 0.0),
                                           float(p.presence_penalty or 0.0)]], np.float32), f32),
            "bid": self._upload(ids, torch.long),
            "bval": self._upload(vals, f32),
            "length": self._upload(np.array([len(p.tokens)], np.int64), torch.long),
            "adapter": self._upload(np.array([p.adapter], np.int64), torch.long),
        }

    def _gates_now(self) -> tuple:
        """The gates of the decode step, cached across steps: the live
        set (and with it every resolved knob) only changes at
        admission/retire. Every ``_live`` mutation site clears
        ``_gates``."""
        if self._gates is None:
            self._gates = self._step_gates()
        return self._gates

    def _step_gates(self) -> tuple:
        """(sort, min_p, penalties, bias, sample) from the LIVE rows'
        resolved knobs — the host's bookkeeping, not the device tensors,
        so a retired row's stale state can't keep a branch (and its
        full-vocab sort / count-plane update) running for the rest of
        the batch."""
        gates = [False] * 5
        for e in self._live:
            if e is not None:
                gates = [a or b for a, b in zip(gates, self._row_gates(e[0]))]
        return tuple(gates)

    def _bucket(self, n: int) -> int:
        for w in self._widths:
            if n <= w:
                return w
        raise AssertionError  # submit() validated against widths[-1]

    def _admit_one(self, p: _Pending, row: int) -> None:
        w = self._bucket(len(p.tokens))
        prompt = np.zeros((1, w), np.int64)
        prompt[0, : len(p.tokens)] = p.tokens
        vals = self._row_values(p)
        cache_1, tok_1, lp_1 = self._prefill_fn(w)(
            self._upload(prompt, torch.long), len(p.tokens), vals, self._row_gates(p)
        )
        self._admit_fn(self._state, cache_1, row, tok_1, vals)
        # Async admission: prefill + admit are issued without a host
        # sync; the first token's copy to the host is resolved later on
        # the fetch path, so a burst of admissions issues back to back.
        self._live[row] = (p, [], [])
        self._gates = None
        self.admitted += 1
        self._pending_first.append((row, self._start_fetch(torch.stack([
            tok_1.to(torch.int32), lp_1.view(torch.int32)]))))
        if self._pipeline_depth == 1:
            # serial mode: resolve immediately
            self._resolve_first_tokens()

    def _start_job(self, p: _Pending, row: int) -> _PrefillJob:
        cache_1, resume = None, 0
        if self._prefix_store is not None:
            # Longest stored prompt that prefixes this one: resume the
            # chunked prefill from its end instead of position 0, on a
            # copy (the continuation writes the cache in place). The
            # stored buffer's padding rows beyond its own prompt are
            # overwritten by the first continuation chunk before any
            # query position can attend them.
            stored, resume = self._prefix_store.lookup(p.tokens, p.adapter)
            if stored is None and self._prefix_l2 is not None:
                # L1 miss → bounded-latency fleet-global probe. A hit is
                # a prefix some OTHER replica prefilled under the SAME
                # weights version (the version is in the key). The
                # rebuilt cache is inserted into L1 so repeats on this
                # replica stay on the device.
                hit = self._prefix_l2.lookup(p.tokens, p.adapter, self._weights_version)
                if hit is not None:
                    rebuilt = self._l2_reconstruct(hit[0])
                    if rebuilt is not None:
                        depth = hit[1]
                        stored, resume = rebuilt, min(depth, len(p.tokens) - 1)
                        self._prefix_store.insert(p.tokens[:depth], rebuilt, p.adapter)
            if stored is not None:
                cache_1 = _clone_cache(stored)
        if cache_1 is None:
            cache_1 = self._single_row_cache()
        return _PrefillJob(
            p=p, row=row, cache_1=cache_1, next_pos=resume, length=len(p.tokens),
            vals=self._row_values(p), gates=self._row_gates(p),
            # first boundary entry lands at the first chunk boundary
            # past the resume point, then depths double
            next_insert_depth=self._prefill_chunk or 0,
        )

    def _advance_job(self) -> None:
        """Run ONE chunk of the in-flight prefill; on the final chunk,
        sample the first token and copy the row into the batch. Chunks
        cover only the true prompt length."""
        job = self._job
        if job.p.cancelled:
            self._resolve_unadmitted_cancel(job.p)
            self._job = None
            return
        c = self._prefill_chunk
        # Shift the window back rather than letting positions run past
        # max_seq_len: re-processing the overlap start_w..start (already
        # in the cache) recomputes identical K/V rows, and every position
        # stays in [0, max_seq_len).
        start_w = min(job.next_pos, self._model.cfg.max_seq_len - c)
        toks = np.zeros((1, c), np.int64)
        piece = job.p.tokens[start_w : start_w + c]
        toks[0, : len(piece)] = piece
        positions = np.arange(start_w, start_w + c, dtype=np.int64)[None, :]
        logits = self._chunk_fn(job.cache_1, self._upload(toks, torch.long),
                                self._upload(positions, torch.long), job.vals["adapter"])
        job.next_pos = start_w + c
        if job.next_pos < job.length:
            if (
                self._prefix_store is not None
                and job.next_pos >= job.next_insert_depth
                and job.boundary_inserts < self._prefix_store.capacity // 2
            ):
                # Chunk-boundary prefix: the cache now covers exactly
                # tokens[:next_pos] with no padding junk (only final
                # chunks pad), so a later prompt sharing just the system
                # prefix can resume here. A copy: this job goes on
                # writing its cache. Depths are exponentially spaced and
                # capped at capacity//2 per request, shallowest first.
                entry = _clone_cache(job.cache_1)
                self._prefix_store.insert(job.p.tokens[: job.next_pos], entry, job.p.adapter)
                self._l2_offer(job.p.tokens[: job.next_pos], entry, job.p.adapter)
                job.next_insert_depth = 2 * job.next_pos
                job.boundary_inserts += 1
            return
        if self._prefix_store is not None:
            # The completed single-row cache covers the whole prompt; the
            # job ends here, so nothing writes it again.
            self._prefix_store.insert(job.p.tokens, job.cache_1, job.p.adapter)
            self._l2_offer(job.p.tokens, job.cache_1, job.p.adapter)
        # final chunk: it contains the prompt's last true position
        tok_1, lp_1 = self._sample1_fn(logits, job.length - 1 - start_w, job.vals, job.gates)
        self._admit_fn(self._state, job.cache_1, job.row, tok_1, job.vals)
        self._live[job.row] = (job.p, [], [])
        self._gates = None
        self.admitted += 1
        self._pending_first.append((job.row, self._start_fetch(torch.stack([
            tok_1.to(torch.int32), lp_1.view(torch.int32)]))))
        if self._pipeline_depth == 1:
            self._resolve_first_tokens()
        self._job = None

    # -- engine loop ---------------------------------------------------

    def _emit(self, p: _Pending, token: int, logprob: float) -> None:
        """Emit one decoded token: bookkeeping (TTFT stamp) stays on the
        scheduler thread; the sink delivery runs on the emitter thread."""
        if p.first_token_at is None:
            p.first_token_at = time.monotonic()
            if p.trace is not None and p.trace_mark is not None:
                reqtrace.segment(p.trace, "engine.prefill", p.first_token_at - p.trace_mark)
                p.trace_mark = p.first_token_at
        if p.sink is not None:
            self._emitter.deliver(p.sink, (token, logprob))

    def _resolve_first_tokens(self) -> None:
        """Fetch the first tokens of async admissions, emit them, and
        retire rows that are already finished (budget 1, eos, stop, or
        cancel at token 0). MUST run before any sweep that could touch
        these rows."""
        if not self._pending_first:
            return
        for row, fetch in self._pending_first:
            p, out, lps = self._live[row]
            if p.resolved:  # failed (watchdog/deadline) before token 0
                self._live[row] = None
                self._gates = None
                continue
            host = self._finish_fetch(fetch)
            first = int(host[0, 0])
            lp = float(host[1:].view(np.float32)[0, 0])
            out.append(first)
            lps.append(lp)
            self._emit(p, first, lp)
            if self._finished(p, out, first):
                self._retire(row)
        self._pending_first.clear()

    @staticmethod
    def _block_ready(fetch) -> bool:
        """True when a dispatched block's result has reached its host
        buffer — the non-blocking probe behind the opportunistic early
        fetch (``event.query()``)."""
        return fetch[1] is None or fetch[1].query()

    def _fetch_packed(self, fetch) -> np.ndarray:
        """Wait for one block's (2, k, slots) result to reach the host:
        only until THIS block is done — with dispatch-ahead the next
        block keeps the device busy while the host sweeps this one."""
        # chaos: a delay armed here models a wedged device transfer
        failpoint("engine.fetch")
        host = self._finish_fetch(fetch)
        self._progress_ts = time.monotonic()
        return host

    def _sweep_block(self, k: int, host: np.ndarray) -> None:
        """Host sweep of one fetched block: append tokens/logprobs, emit
        to streams, retire finished rows. Time spent here while another
        block is still in flight is overlap the pipeline hid."""
        host_tok = host[0]
        host_lp = host[1].view(np.float32)
        t0 = time.monotonic()
        with self._phase("sweep"):
            for j in range(k):
                for row, entry in enumerate(self._live):
                    if entry is None:
                        continue  # free, or finished earlier in block
                    p, out, lps = entry
                    if p.resolved:
                        # failed off-thread (watchdog) mid-flight: the
                        # terminal already went out — free the slot and
                        # discard the block's tokens for this row
                        self._live[row] = None
                        self._gates = None
                        continue
                    t = int(host_tok[j, row])
                    out.append(t)
                    lps.append(float(host_lp[j, row]))
                    self._emit(p, t, lps[-1])
                    if self._finished(p, out, t):
                        self._retire(row)
            now = time.monotonic()
            for entry in self._live:
                if entry is None:
                    continue
                p = entry[0]
                if p.trace is not None and p.trace_mark is not None:
                    reqtrace.segment(p.trace, "engine.decode", now - p.trace_mark, tokens=k)
                    p.trace_mark = now
        if self._window:
            dur = time.monotonic() - t0
            self._overlap_hidden_s += dur
            self._m_overlap.observe(dur)

    def _drain_window(self, reason: str) -> None:
        """Fetch + sweep every in-flight block, oldest first — the
        pipeline's synchronization point, required before any change of
        the shared batch state (admission, final-chunk prefill admit): an
        unswept block's retires haven't freed slots yet. Counted as a
        drain stall only when the window actually held work."""
        if not self._window:
            return
        self._resolve_first_tokens()
        if all(e is None for e in self._live):
            # every row already retired: the in-flight blocks hold only
            # discards — drop the references without fetching
            self._window.clear()
            return
        self._drain_stalls += 1
        self._m_drains.inc(reason=reason)
        while self._window:
            k0, fetch = self._window.popleft()
            with self._phase("fetch"):
                host = self._fetch_packed(fetch)
            self._sweep_block(k0, host)

    def _finished(self, p: _Pending, out: list[int], last: int) -> bool:
        if p.cancelled:
            return True  # consumer went away; free the slot now
        for seq in p.stop:
            # the match can only complete on the token just emitted
            if last == seq[-1] and tuple(out[-len(seq):]) == seq:
                return True
        # Per-request eos: None = engine default; negative = DISABLED.
        if p.eos_id is None:
            eos = self._eos_id
        else:
            eos = None if p.eos_id < 0 else p.eos_id
        return len(out) >= p.max_new_tokens or (eos is not None and last == eos)

    def _retire(self, row: int) -> None:
        p, out, lps = self._live[row]
        self._live[row] = None
        self._gates = None
        if not self._try_resolve(p):
            # the watchdog (or a deadline expiry) already failed this
            # request and delivered its terminal — only free the slot
            return
        now = time.monotonic()
        self.tokens_emitted += len(out)  # decoded count, pre-trim
        self._m_tokens.inc(len(out))
        matched = max(
            (seq for seq in p.stop if len(out) >= len(seq) and tuple(out[-len(seq):]) == seq),
            key=len,
            default=None,
        )
        if matched is not None:
            # the completion ends BEFORE the stop text (streams already
            # saw the tokens); LONGEST tail match
            out = out[: len(out) - len(matched)]
            lps = lps[: len(out)]
        if p.cancelled:
            self.cancelled += 1
        if p.first_token_at is not None:
            self._ttft_sum += p.first_token_at - p.submitted_at
            self._m_ttft.observe(p.first_token_at - p.submitted_at)
        self._m_completed.inc()
        self._duration_sum += now - p.submitted_at
        self._latency_n += 1
        # Incremented LAST: stats() divides the sums by this count from
        # another thread.
        self.completed += 1
        p.result = out
        p.logprobs = lps
        p.weights_version = self._weights_version
        if p.trace is not None:
            if p.trace_mark is not None:
                reqtrace.segment(p.trace, "engine.decode", now - p.trace_mark)
                p.trace_mark = now
            reqtrace.event(p.trace, "engine.retire", tokens=len(out),
                           weights_version=p.weights_version, cancelled=p.cancelled)
        # result/logprobs are set BEFORE the terminal marker is queued
        if p.sink is not None:
            self._emitter.deliver(p.sink, True)
        p.event.set()

    def _resolve_unadmitted_cancel(self, p: _Pending) -> None:
        """A request cancelled while still queued (or mid-prefill): no
        slot to retire, no tokens; resolve as completed-empty so drain
        accounting closes and nothing prefills for a dead consumer."""
        if not self._try_resolve(p):
            return
        p.result = []
        p.logprobs = []
        p.weights_version = self._weights_version
        self.cancelled += 1
        self.completed += 1
        self._m_completed.inc()
        if p.sink is not None:
            self._emitter.deliver(p.sink, True)
        p.event.set()

    def _try_resolve(self, p: _Pending) -> bool:
        """Flip the request's resolve-once latch; True means the caller
        owns delivering the terminal (result or error)."""
        with self._resolve_lock:
            if p.resolved:
                return False
            p.resolved = True
            return True

    def _fail_one(self, p: _Pending, err: BaseException) -> bool:
        """Fail a request; False when something else already resolved it."""
        if not self._try_resolve(p):
            return False
        with self._resolve_lock:
            self._failed_total += 1
        self._m_failed.inc()
        p.error = err
        if p.trace is not None:
            reqtrace.event(p.trace, "engine.fail", error=type(err).__name__)
            reqtrace.flag(p.trace, error=type(err).__name__)
        if p.sink is not None:
            self._emitter.deliver(p.sink, err)
        p.event.set()
        return True

    def _fail_all(self, err: BaseException) -> None:
        for row, entry in enumerate(self._live):
            if entry is not None:
                self._fail_one(entry[0], err)
                self._live[row] = None
        self._gates = None
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is self._STOP or item is self._WAKE:
                continue
            self._fail_one(item, RuntimeError("engine shutting down"))

    # -- degradation: watchdog + deadlines -----------------------------

    def _watchdog_loop(self) -> None:
        """Sidecar thread: fire when the scheduler has made no progress
        for ``watchdog_s`` seconds WHILE work was in flight. It reads
        host bookkeeping only, never a device tensor."""
        poll = max(0.05, min(1.0, self._watchdog_s / 4.0))
        while self._thread.is_alive():
            time.sleep(poll)
            if self._watchdog_suspended or self._watchdog_abort.is_set():
                continue
            busy = (
                bool(self._window)
                or self._job is not None
                or self._inflight is not None
                or any(e is not None for e in self._live)
            )
            if not busy:
                continue
            stuck = time.monotonic() - self._progress_ts
            if stuck > self._watchdog_s:
                self._watchdog_fire(stuck)

    def _watchdog_fire(self, stuck_for: float) -> None:
        """Abort every in-flight request with a terminal EngineWedged so
        their callers unblock NOW, then flag the scheduler to reset its
        window/slots when (if) it unwedges. Queued requests stay queued."""
        phase = self._current_phase or "between phases"
        self.watchdog_fires += 1
        self._m_watchdog.inc()
        err = EngineWedged(
            f"engine scheduler made no progress for {stuck_for:.1f}s "
            f"(stuck in {phase}); request aborted by watchdog"
        )
        logger.error(
            "engine watchdog fired: no scheduler progress for %.1fs (stuck in %s); aborting "
            "in-flight requests", stuck_for, phase,
        )
        from tensorflowonspark_tpu_torch.obs import flightrec

        flightrec.note("engine_watchdog", stuck_for=round(stuck_for, 3), phase=phase)
        flightrec.dump_now("engine_watchdog")
        for entry in list(self._live):
            if entry is not None:
                self._fail_one(entry[0], err)
        job = self._job
        if job is not None:
            self._fail_one(job.p, err)
        inflight = self._inflight
        if inflight is not None:
            self._fail_one(inflight, err)
        self._watchdog_abort.set()

    def _recover_from_watchdog(self) -> None:
        """Scheduler-side cleanup after a watchdog fire: drop in-flight
        blocks unfetched (their rows' requests already failed), free every
        slot whose request the watchdog resolved, and keep going."""
        self._window.clear()
        self._pending_first.clear()
        for row, entry in enumerate(self._live):
            if entry is not None and entry[0].resolved:
                self._live[row] = None
        if self._job is not None and self._job.p.resolved:
            self._job = None
        if self._inflight is not None and self._inflight.resolved:
            self._inflight = None
        self._gates = None
        self._watchdog_abort.clear()
        logger.warning("engine scheduler recovered after watchdog fire; resuming")

    def _expired(self, p: _Pending, now: float) -> bool:
        return p.deadline_s is not None and now - p.submitted_at > p.deadline_s

    def _expire_one(self, p: _Pending, detail: str) -> None:
        delivered = self._fail_one(
            p, DeadlineExceeded(f"request exceeded deadline_s={p.deadline_s} {detail}")
        )
        if delivered:
            self.deadline_expired += 1
            self._m_deadline.inc()

    def _expire_deadlines(self) -> None:
        """Retire every live/prefilling request whose wall-clock budget
        expired — terminal DeadlineExceeded, never a silent truncation."""
        now = time.monotonic()
        for row, entry in enumerate(self._live):
            if entry is None:
                continue
            p = entry[0]
            if self._expired(p, now):
                self._expire_one(p, f"({len(entry[1])} token(s) decoded)")
                self._live[row] = None
                self._gates = None
        if self._job is not None and self._expired(self._job.p, now):
            self._expire_one(self._job.p, "(mid-prefill)")
            self._job = None

    def _loop(self) -> None:
        # Grad mode and the current device are per thread: the scheduler
        # sets both for itself (without inference mode every decode step
        # would record an autograd graph).
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.inference_mode())
            if self._cuda:
                stack.enter_context(torch.cuda.device(self._device))
            self._run()

    def _run(self) -> None:
        depth = self._pipeline_depth
        try:
            while True:
                self._progress_ts = time.monotonic()
                if self._watchdog_abort.is_set():
                    self._recover_from_watchdog()
                self._expire_deadlines()
                if self._stop_now.is_set():
                    err = RuntimeError("engine shutting down")
                    # abrupt shutdown: in-flight device work and
                    # unresolved first tokens are dropped unfetched —
                    # every owning request fails below anyway
                    self._window.clear()
                    self._pending_first.clear()
                    if self._job is not None:
                        self._fail_one(self._job.p, err)
                        self._job = None
                    self._abort_pending_swap(err)
                    self._abort_pending_knobs(err)
                    self._fail_all(err)
                    return
                if self._pending_swap is not None and self._job is None:  # lint: lockfree-read: claim is re-checked under _submit_lock in _apply_pending_swap
                    # between decode blocks, never mid-chunked-prefill (a
                    # prompt half-prefilled under two weight versions
                    # would hold inconsistent K/V)
                    self._apply_pending_swap()
                if self._pending_knobs is not None and self._job is None:  # lint: lockfree-read: claim is re-checked under _submit_lock in _apply_pending_knobs
                    self._apply_pending_knobs()
                    depth = self._pipeline_depth  # rebind loop snapshot
                if self._window and all(e is None for e in self._live):
                    # every row retired mid-window: the remaining
                    # in-flight blocks hold only discards
                    self._window.clear()
                idle = (
                    all(e is None for e in self._live)
                    and self._job is None
                    and not self._window
                )
                # Admit queued requests into free slots (chunked mode:
                # start at most one prefill job, advanced one chunk per
                # iteration below); block only when fully idle. The FIRST
                # admissible pop drains the in-flight window; later pops
                # in the same sweep see an empty window.
                while True:
                    free = [
                        i for i, e in enumerate(self._live)
                        if e is None and (self._job is None or self._job.row != i)
                    ]
                    if not free:
                        break
                    if self._prefill_chunk is not None and self._job is not None:
                        break  # one chunked prefill at a time
                    try:
                        item = self._queue.get() if idle else self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if idle:
                        # waiting for work is not a stall: without this
                        # stamp (the JAX package's engine has none) an
                        # engine idle for longer than watchdog_s fires its
                        # watchdog on its next request
                        self._progress_ts = time.monotonic()
                    if item is self._STOP:
                        self._drain_window("shutdown")
                        self._pending_first.clear()
                        err = RuntimeError("engine shutting down")
                        self._abort_pending_swap(err)
                        self._abort_pending_knobs(err)
                        self._fail_all(err)
                        return
                    if item is self._WAKE:
                        # woke only so the top-of-loop swap check runs
                        break
                    if item.cancelled:
                        self._resolve_unadmitted_cancel(item)
                        continue
                    if self._expired(item, time.monotonic()):
                        # expired while queued: fail WITHOUT a prefill
                        self._expire_one(item, "(while queued)")
                        continue
                    self._observe_queue_wait(item)
                    self._inflight = item
                    self._drain_window("admit")
                    # the drain may have retired rows — recompute the
                    # target slot from the freshest free set
                    free = [
                        i for i, e in enumerate(self._live)
                        if e is None and (self._job is None or self._job.row != i)
                    ]
                    if self._state is None:
                        self._state = self._empty_state()
                    if self._prefill_chunk is None:
                        with self._phase("prefill"):
                            self._admit_one(item, free[0])
                    else:
                        self._job = self._start_job(item, free[0])
                    self._inflight = None
                    idle = False

                if self._job is not None:
                    c = self._prefill_chunk
                    if not self._job.p.cancelled and self._job.next_pos + c >= self._job.length:
                        # this chunk is the FINAL one: it samples the
                        # first token and writes the row into the shared
                        # batch state — same drain rule as admission.
                        self._drain_window("prefill_admit")
                    with self._phase("prefill"):
                        self._advance_job()

                if all(e is None for e in self._live):
                    continue  # nothing decoding; admit/chunk again

                # Block size for this iteration: the full decode_block
                # unless an admission could proceed right now (a queued
                # request with a FREE slot) or a chunked prefill is in
                # flight (it advances one chunk per loop iteration).
                k = self._decode_block
                if k > 1 and (
                    self._job is not None
                    or (not self._queue.empty() and any(e is None for e in self._live))
                ):
                    k = 1
                # A live row's decode_block_pin caps the block while it is
                # in flight.
                for e in self._live:
                    if e is not None and e[0].decode_block_pin:
                        k = min(k, max(1, int(e[0].decode_block_pin)))
                # Dispatch-ahead: refill the in-flight window from the
                # device-resident state — block N+1 needs no host data.
                with self._phase("dispatch"):
                    while len(self._window) < depth:
                        failpoint("engine.dispatch")
                        packed = self._block_fn(k)(self._state, self._gates_now())
                        self.steps += k
                        self._m_steps.inc(k)
                        self._window.append((k, self._start_fetch(packed)))
                        self._progress_ts = time.monotonic()
                # Admission first tokens resolve AFTER the dispatch above
                # and BEFORE any sweep below can touch their rows.
                self._resolve_first_tokens()
                # Fetch the oldest block: blocking once the window is
                # full, opportunistically early when it is already done.
                if self._window and (
                    len(self._window) >= depth or self._block_ready(self._window[0][1])
                ):
                    k0, fetch = self._window.popleft()
                    with self._phase("fetch"):
                        host = self._fetch_packed(fetch)
                    self._sweep_block(k0, host)
        except BaseException as e:  # noqa: BLE001 - ferry to waiters
            logger.exception("continuous-batcher loop died")
            # Refuse new submits FIRST (a dead loop never answers), then
            # fail the request caught mid-admission and everything parked
            # or queued.
            with self._submit_lock:
                self._closed = True
            self._window.clear()
            self._pending_first.clear()
            if self._inflight is not None:
                self._fail_one(self._inflight, e)
                self._inflight = None
            if self._job is not None:
                self._fail_one(self._job.p, e)
                self._job = None
            self._abort_pending_swap(e)
            self._abort_pending_knobs(e)
            self._fail_all(e)
        finally:
            # Wind down the delivery thread once the scheduler is done:
            # everything enqueued above flushes before the sentinel.
            if not self._emitter.stop():
                logger.warning(
                    "engine emitter did not flush within its stop timeout (a stream sink "
                    "put() is blocking); undelivered stream items dropped"
                )
