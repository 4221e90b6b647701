"""Speculative decoding: draft-and-verify generation (port of
:mod:`tensorflowonspark_tpu.models.speculative`).

A DRAFT model proposes ``k`` tokens one at a time; the TARGET scores all
``k+1`` positions in one forward and keeps the longest prefix it agrees
with plus its own next token. Greedy speculative decoding emits exactly
the target's greedy sequence (the rule only keeps tokens the target picks
itself); sampled, the rejection rule (:func:`speculative_accept`) keeps the
emitted tokens distributed as the target's samples.

Cache discipline (no rollback): both models decode with ``padded=True``,
where a token's cache slot is its position and each forward writes its
K/V into the cache (in place, ``models.llama.cached_attention``) before
its queries attend. Rejected drafts leave stale slots only at positions
at or past the next iteration's write window, and that window overwrites
each of them before any query's position reaches it: acceptance only moves
the position counters. So no caller may hold a cache tensor and expect it
unchanged across a call.

The reference's ``while_loop`` runs on the device; here each iteration
reads one flag on the host (whether every row is done), and the draft's
``k`` steps, the draft's step on its own last proposal and the verify
forward are issued without a host read. ``stats`` counts the reads.

Not ported yet: ``mesh`` (decode on a device mesh, ROADMAP A9b), which
raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["speculative_generate", "speculative_accept"]


def _gumbel_pick(log_weights, generator):
    """One categorical draw per row of ``log_weights`` (B, V) by
    Gumbel-max on uniforms from ``generator``."""
    u = torch.rand(log_weights.shape, generator=generator, device=log_weights.device)
    return (log_weights - torch.log(-torch.log(u))).argmax(-1)


def speculative_accept(generator, t_probs, d_probs, drafts):
    """One speculative-sampling verification (the Leviathan/Chen rejection
    rule): accept draft ``x_j`` with probability ``min(1, p_j(x_j) /
    q_j(x_j))``; at the first rejection sample from ``normalize(max(p_j -
    q_j, 0))``; if all ``k`` drafts survive, sample the bonus token from
    ``p_k``. The emitted tokens are then distributed as samples of the
    target ``p``, for any draft ``q``.

    ``t_probs`` (B, k+1, V) target probabilities, ``d_probs`` (B, k, V)
    draft probabilities, ``drafts`` (B, k) the draft's samples; the draws
    come from ``generator``. Returns ``(emit (B, k+1), accepted (B,))``:
    the accepted drafts in ``emit[:, :accepted]``, the residual or bonus
    sample at ``accepted`` (later entries are padding), ``accepted`` in
    ``[0, k]``."""
    b, kp1, v = t_probs.shape
    k = kp1 - 1
    dev = t_probs.device
    u = torch.rand((b, k), generator=generator, device=dev)
    p_x = t_probs[:, :k].gather(-1, drafts[..., None])[..., 0]
    q_x = d_probs.gather(-1, drafts[..., None])[..., 0]
    # u < p/q  <=>  u*q < p (no divide; q=0 with p>0 accepts, both 0 rejects)
    accept = u * q_x < p_x
    accepted = torch.cumprod(accept.long(), dim=1).sum(1)
    # q padded with a zero row at j=k: the all-accepted bonus falls out of
    # the same residual formula (residual = p_k - 0 = p_k)
    q_pad = torch.cat([d_probs, d_probs.new_zeros(b, 1, v)], dim=1)
    at = accepted[:, None, None].expand(b, 1, v)
    p_at = t_probs.gather(1, at)[:, 0].float()
    q_at = q_pad.gather(1, at)[:, 0].float()
    residual = (p_at - q_at).clamp_min(0.0)
    # p == q exactly leaves an empty residual, where a rejection has
    # probability zero anyway: draw from p itself
    degenerate = residual.sum(-1, keepdim=True) <= 0
    weights = torch.where(degenerate, p_at, residual)
    corr = _gumbel_pick(torch.log(weights + 1e-38), generator)
    pad = torch.cat([drafts, drafts[:, -1:]], dim=1)
    j_idx = torch.arange(k + 1, device=dev)[None, :]
    emit = torch.where(j_idx == accepted[:, None], corr[:, None], pad)
    return emit, accepted


@torch.no_grad()
def speculative_generate(model, draft_model, prompt, max_new_tokens: int, k: int = 4,
                         eos_id: int | None = None, prompt_lengths=None, mesh=None,
                         temperature: float = 0.0, generator: torch.Generator | None = None,
                         stats: dict | None = None):
    """Speculative decode: (B, S) tokens -> (B, max_new_tokens).

    ``temperature == 0`` (the default): token for token the target's greedy
    :func:`models.llama.generate` for any draft; the draft moves only the
    speed. ``temperature > 0``: speculative sampling, the draft sampling
    its ``k`` proposals at the same temperature and the target accepting
    or resampling by :func:`speculative_accept`, all draws from
    ``generator`` (a fresh one seeded 0 on the target's device when None).
    No top-k/top-p truncation: it would change the distribution the rule
    preserves.

    ``model`` and ``draft_model`` are ``models.llama.Llama`` modules on one
    device, each decoding with its own weights; both need ``max_seq_len >=
    S + max_new_tokens + k`` (the verify window may write up to ``k`` slots
    past the emitted text). Rows finish independently on ``eos_id`` and
    the loop ends once every row is done. Mixed-length prompts: right-pad
    and pass ``prompt_lengths`` (B,), as for ``generate``. The two
    vocabularies may differ when greedy (a token id past a model's
    vocabulary is clamped to its last row, as the JAX package's gather
    does); sampling with two vocabularies raises ``ValueError``.

    ``stats``: a dict that gets ``iterations`` (verify forwards),
    ``host_reads`` (the loop's flag reads), ``accepted`` (drafts accepted
    over every live row's verifies) and ``row_verifies`` (those verifies).
    """
    from tensorflowonspark_tpu_torch.models.llama import init_cache, sample_logits

    device = model.device
    prompt = torch.as_tensor(prompt, device=device).long()
    b, s = prompt.shape
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    for name, cfg in (("model", model.cfg), ("draft_model", draft_model.cfg)):
        if s + max_new_tokens + k > cfg.max_seq_len:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) + k ({k}) exceeds "
                f"{name}.cfg.max_seq_len ({cfg.max_seq_len})"
            )
    if mesh is not None:
        raise NotImplementedError(
            "speculative decoding on a device mesh is not ported yet: ROADMAP A9b")
    if draft_model.device != device:
        raise ValueError(f"the draft is on {draft_model.device}, the target on {device}")
    lengths = None
    if prompt_lengths is not None:
        host = np.asarray(torch.as_tensor(prompt_lengths).cpu())
        if host.shape != (b,):
            raise ValueError(f"prompt_lengths must have shape ({b},), got {host.shape}")
        if (host < 1).any() or (host > s).any():
            raise ValueError(
                f"prompt_lengths must be in [1, {s}] (the padded prompt width); "
                f"got {host.tolist()}"
            )
        lengths = torch.as_tensor(host, dtype=torch.long, device=device)
    sampled = temperature > 0.0
    t_vocab, d_vocab = model.cfg.vocab_size, draft_model.cfg.vocab_size
    if sampled and t_vocab != d_vocab:
        raise ValueError(
            f"speculative sampling needs one vocabulary: the target has {t_vocab} tokens, "
            f"the draft {d_vocab}"
        )
    if sampled and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    temperature = float(temperature)

    def pick(logits):
        return sample_logits(logits, generator, temperature)

    def probs_of(logits):
        return torch.softmax(logits.float() / temperature, dim=-1)

    # prefill both caches on the prompt; padded everywhere: slots are
    # positions, which lets each row advance by its own acceptance
    positions = torch.arange(s, device=device).expand(b, s)
    t_cache, d_cache = init_cache(model.cfg, b, device), init_cache(draft_model.cfg, b, device)
    t_logits = model(prompt, positions=positions, decode=True, padded=True, cache=t_cache)
    # a token past a model's vocabulary reads its last row, as the JAX
    # package's gather clamps the index
    draft_model(prompt.clamp(max=d_vocab - 1), positions=positions, decode=True, padded=True,
                cache=d_cache)
    # the first token is the target's own pick at each row's last real
    # position; from here `last` is in neither cache and `pos` is the
    # position after it
    rows = torch.arange(b, device=device)
    if lengths is None:
        last = pick(t_logits[:, -1])
        pos = torch.full((b,), s + 1, dtype=torch.long, device=device)
    else:
        last = pick(t_logits[rows, lengths - 1])
        pos = lengths + 1
    fill = eos_id if eos_id is not None else 0
    # one scratch column past the end takes the writes of full rows
    buf = torch.full((b, max_new_tokens + 1), fill, dtype=torch.long, device=device)
    buf[:, 0] = last
    done = last == eos_id if eos_id is not None else torch.zeros(b, dtype=torch.bool,
                                                                 device=device)
    n_out = torch.ones(b, dtype=torch.long, device=device)
    j_idx = torch.arange(k + 1, device=device)[None, :]
    accepted_sum = torch.zeros((), dtype=torch.long, device=device)
    live_sum = torch.zeros((), dtype=torch.long, device=device)
    iterations = reads = 0

    def draft_step(tok, at):
        return draft_model(tok.clamp(max=d_vocab - 1)[:, None], positions=at[:, None],
                           decode=True, padded=True, cache=d_cache)[:, -1]

    while True:
        reads += 1
        if bool((done | (n_out >= max_new_tokens)).all()):
            break
        iterations += 1
        # the draft proposes k tokens one at a time
        tok, drafts, d_probs = last, [], []
        for j in range(k):
            logits = draft_step(tok, pos - 1 + j)
            tok = pick(logits)
            drafts.append(tok)
            if sampled:
                d_probs.append(probs_of(logits))
        drafts = torch.stack(drafts, dim=1)  # (B, k)
        # feed the draft its own last proposal: when all k are accepted the
        # next iteration queries slot pos+k-1, which only this write fills
        # (left unwritten it would degrade the next proposals, never the
        # tokens, which the target alone decides)
        draft_step(drafts[:, -1], pos - 1 + k)
        # one target forward over [last, drafts]; logits[:, j] predict the
        # token at position pos + j
        # a proposal past the target's vocabulary is clamped here and never
        # equals the target's pick below, so it is rejected
        verify_in = torch.cat([last[:, None], drafts.clamp(max=t_vocab - 1)], dim=1)
        t_logits = model(verify_in, positions=pos[:, None] - 1 + j_idx, decode=True,
                         padded=True, cache=t_cache)
        if sampled:
            emit, accepted = speculative_accept(generator, probs_of(t_logits),
                                                torch.stack(d_probs, dim=1), drafts)
        else:
            # the longest prefix where the draft equals the target's pick;
            # every emitted token is a target pick (the drafts where they
            # agree, then the correction or bonus): why output == greedy
            emit = t_logits.argmax(-1)  # (B, k+1)
            accepted = torch.cumprod((emit[:, :k] == drafts).long(), dim=1).sum(1)
        valid = j_idx <= accepted[:, None]
        if eos_id is not None:
            is_eos = (emit == eos_id).long()
            valid &= (is_eos.cumsum(1) - is_eos) == 0  # nothing after a row's first eos
        valid &= ~done[:, None]
        live = ~done
        accepted_sum += (accepted * live).sum()
        live_sum += live.sum()
        cols = torch.where(valid, n_out[:, None] + j_idx, max_new_tokens).clamp(
            max=max_new_tokens)
        buf[rows[:, None].expand(b, k + 1), cols] = emit
        emitted = valid.sum(1)
        if eos_id is not None:
            done = done | ((emit == eos_id) & valid).any(1)
        n_out = torch.clamp(n_out + emitted, max=max_new_tokens)
        done = done | (n_out >= max_new_tokens)
        # the next `last` is the last token the row emitted; finished rows
        # keep their position and last token
        new_last = emit.gather(1, (emitted - 1).clamp_min(0)[:, None])[:, 0]
        last = torch.where(emitted > 0, new_last, last)
        pos = torch.where(done, pos, pos + emitted)
    if stats is not None:
        stats.update(iterations=iterations, host_reads=reads, accepted=int(accepted_sum),
                     row_verifies=int(live_sum))
    return buf[:, :max_new_tokens]
