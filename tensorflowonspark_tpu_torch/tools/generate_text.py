"""Decode CLI over a Llama checkpoint of the port: the counterpart of the
JAX package's ``tools/generate_text.py``.

Load a Llama checkpoint written by the port's ``compute/checkpoint.py``
(a ``CheckpointManager`` directory or a ``save_checkpoint`` path), read
JSONL prompt rows, batch them with right-padding and per-row true lengths
(``generate(prompt_lengths=...)``), sample greedily or with top-k/top-p/
min-p and an optional EOS early stop, and write JSONL completions trimmed
at each row's first EOS. ``--score`` writes each row's next-token logprobs
and their sum instead.

Prompts are token ids (``{"tokens": [1, 5, 9]}`` per line). The model runs
on CUDA unless ``--device`` names another device (``--device cpu``).

The checkpoint may hold an int8 weight set (``ops.quant.quantize_tree``),
which decodes as it is, or LoRA adapters or a bank (``ops.lora``), whose
scale is the one the weight set stores; ``--lora-scale`` overrides it
through ``rewrap_lora``, and a set that stores none (converted from the
JAX package, whose checkpoints keep no scale) gets 1.0, ``add_lora``'s
default alpha = rank. A bank decodes as its slot 0.

``--draft-checkpoint`` decodes speculatively (``models.speculative``): a
draft model (``--draft-model``, ``--draft-config-overrides``; loaded like
the target) proposes ``--spec-k`` tokens per verify forward of the target.
Greedy output is token for token the plain greedy decode; at a temperature
the rejection rule keeps the target's sampling distribution, so top-k,
top-p and min-p do not combine with a draft, nor does ``--score``.

Usage::

    python -m tensorflowonspark_tpu_torch.tools.generate_text \\
        --checkpoint ckpt_dir/ --model 1b --prompts prompts.jsonl \\
        --output out.jsonl [--max-new-tokens 64] [--eos-id N] \\
        [--temperature 0.8 --top-k 40 --top-p 0.95] [--batch-size 8] \\
        [--config-overrides '{"num_layers": 4}'] [--device cpu] [--score] \\
        [--draft-checkpoint draft_dir/ --draft-model 1b \\
         --draft-config-overrides '{"num_layers": 2}' --spec-k 4]

Not ported yet, raising ``NotImplementedError``: ``--mesh`` (decode on a
device mesh, ROADMAP A9b).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="generate_text",
        description="KV-cache decode over a Llama checkpoint of the PyTorch port",
    )
    p.add_argument(
        "--checkpoint", required=True,
        help="a CheckpointManager model dir (latest step is used; TrainState or "
        "bare param trees both work) or a save_checkpoint path",
    )
    p.add_argument("--model", choices=("tiny", "1b", "7b"), default="tiny")
    p.add_argument(
        "--config-overrides", default=None,
        help='JSON dict of LlamaConfig field overrides, e.g. \'{"vocab_size": 1024}\'',
    )
    p.add_argument("--prompts", required=True, help="JSONL: {'tokens': [...]}")
    p.add_argument("--output", required=True, help="output JSONL path ('-' = stdout)")
    p.add_argument(
        "--score", action="store_true",
        help="score instead of decode: each input row's per-token next-token logprobs "
        "(+ summed total) as JSONL (decode flags are ignored)",
    )
    p.add_argument("--lora-scale", type=float, default=None,
                   help="override the LoRA adapters' scale alpha/rank (default: the scale "
                   "the checkpoint stores, else 1.0, add_lora's default alpha = rank; "
                   "0 turns them off)")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--min-p", type=float, default=None)
    p.add_argument("--eos-id", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device to decode on (default: CUDA; 'cpu' to run there)")
    p.add_argument("--mesh", default=None,
                   help="decode sharded over a device mesh (not ported: ROADMAP A9b)")
    p.add_argument("--draft-checkpoint", default=None,
                   help="speculative decoding: a checkpoint of a (smaller) draft model that "
                   "proposes --spec-k tokens per verify forward of the target; greedy output "
                   "equals the plain greedy decode, a temperature keeps the target's sampling "
                   "distribution (the rejection rule). No --top-k/--top-p/--min-p")
    p.add_argument("--draft-model", choices=("tiny", "1b", "7b"), default="tiny")
    p.add_argument("--draft-config-overrides", default=None,
                   help="JSON LlamaConfig overrides of the draft model")
    p.add_argument("--spec-k", type=int, default=4)
    return p


def _refuse_unported(args) -> None:
    if args.mesh:
        raise NotImplementedError("--mesh (decode on a device mesh) is not ported yet: "
                                  "ROADMAP A9b")


def _load_config(args):
    import torch

    from tensorflowonspark_tpu_torch.models.llama import LlamaConfig, RopeScaling

    base = {"tiny": LlamaConfig.tiny, "1b": LlamaConfig.llama_1b,
            "7b": LlamaConfig.llama2_7b}[args.model]()
    if args.config_overrides:
        overrides = json.loads(args.config_overrides)
        if "dtype" in overrides:  # JSON carries it as a name string
            overrides["dtype"] = getattr(torch, overrides["dtype"])
        if isinstance(overrides.get("rope_scaling"), dict):
            overrides["rope_scaling"] = RopeScaling(**overrides["rope_scaling"])
        base = dataclasses.replace(base, **overrides)
    return base


def _load_params(checkpoint: str, cfg, lora_scale: float | None = None) -> dict:
    """Restore params (name -> tensor, on the CPU) from a CheckpointManager
    dir (latest step) or a bare save_checkpoint path; a ``TrainState``, a
    ``{'state': ...}`` or ``{'params': ...}`` wrapper, or a bare param dict.
    LoRA adapters get ``lora_scale`` through ``rewrap_lora``; with None
    each keeps the scale the set stores, and one that stores none (a set
    converted from the JAX package) gets 1.0. Floating tensors (int8 and LoRA scales too, as the
    JAX package casts them) are cast to ``cfg.dtype`` here, once, so that
    decode reads weights in the compute dtype; int8 codes stay int8."""
    from tensorflowonspark_tpu_torch.compute.checkpoint import (
        CheckpointManager,
        restore_checkpoint,
    )
    from tensorflowonspark_tpu_torch.ops.lora import S, rewrap_lora

    with CheckpointManager(checkpoint) as mgr:
        step = mgr.latest_step()
        tree = mgr.restore(step) if step is not None else None
    if tree is None:
        tree = restore_checkpoint(checkpoint)
    tree = llama_params_of(tree, checkpoint)
    if lora_scale is not None:
        tree = rewrap_lora(tree, float(lora_scale))
    else:  # the stored scales win over the 1.0 default
        tree = {**rewrap_lora(tree, 1.0), **{n: t for n, t in tree.items() if n.endswith(S)}}
    return {n: t.to(cfg.dtype) if t.is_floating_point() else t for n, t in tree.items()}


def llama_params_of(tree, checkpoint: str) -> dict:
    """The Llama param dict (name -> tensor) of a restored checkpoint tree:
    a ``TrainState``, a ``{'state': ...}`` or ``{'params': ...}`` wrapper,
    or a bare param dict, int8 and LoRA entries included (``ops.quant``,
    ``ops.lora``). Raises ``ValueError`` for a tree that holds no Llama
    params or a leaf that is not a tensor."""
    import torch

    for key in ("state", "params"):
        if isinstance(tree, dict) and key in tree:
            tree = tree[key]
    tree = getattr(tree, "params", tree)  # a TrainState
    if isinstance(tree, dict) and "params" in tree:
        tree = tree["params"]
    if not (isinstance(tree, dict) and "embed" in tree):
        raise ValueError(
            f"checkpoint {checkpoint} does not contain a Llama param tree (top-level keys: "
            f"{sorted(tree) if isinstance(tree, dict) else type(tree)})"
        )
    for name, leaf in tree.items():
        if not isinstance(leaf, torch.Tensor):
            raise ValueError(f"checkpoint {checkpoint}: {name} is not a tensor")
    return tree


def load_model(cfg, params: dict, device=None):
    """A ``Llama`` on ``device`` (CUDA unless named) whose parameters are
    ``params`` in ``cfg.dtype`` (int8 codes stay int8): decode reads them
    as they are, with no cast per call. The weight set's format (plain,
    int8, LoRA adapters or a bank) becomes the model's
    (``models.llama.adopt_params``)."""
    from tensorflowonspark_tpu_torch.models.llama import Llama, adopt_params

    model = Llama(cfg, device=device)
    adopt_params(model, {n: t.to(cfg.dtype) if t.is_floating_point() else t
                         for n, t in params.items()})
    return model


class PromptError(ValueError):
    """A problem with the caller's prompts (empty, longer than the decode
    width): servers map this to a 4xx, unlike configuration errors."""


def decode_batches(model, prompts: list[list[int]], *, batch_size: int, width: int,
                   max_new_tokens: int, generator=None, temperature: float = 0.0,
                   top_k: int | None = None, top_p: float | None = None,
                   min_p: float | None = None, eos_id: int | None = None,
                   uniform: bool = False, mesh=None, pad_to_batch: bool = False,
                   draft=None, spec_k: int = 4):
    """Decode ``prompts`` at one (batch_size, width) shape: short chunks pad
    rows by repeating the last prompt (results trimmed), short prompts
    right-pad to ``width`` (``generate``'s prompt_lengths path;
    ``uniform=True`` skips it when every prompt is exactly ``width``).
    ``pad_to_batch``: decode at exactly ``batch_size`` rows even when
    fewer prompts are given (a server's one shape: a prompt's greedy
    completion then does not depend on how many prompts came with it).
    Returns ``(completions, generator)``, each completion trimmed at its
    first ``eos_id``; the generator (advanced) continues the stream.

    ``draft``: a draft ``Llama`` on the target's device makes the decode
    speculative (``models.speculative``), ``spec_k`` proposals per verify
    forward: greedy output equals the plain greedy decode token for token,
    a temperature keeps the target's sampling distribution; top_k, top_p
    and min_p do not combine with a draft.
    ``mesh`` (decode on a device mesh, ROADMAP A9b) is not ported yet.
    """
    import numpy as np

    from tensorflowonspark_tpu_torch.models.llama import generate
    from tensorflowonspark_tpu_torch.models.speculative import speculative_generate

    if mesh is not None:
        raise NotImplementedError("decode on a device mesh is not ported yet: ROADMAP A9b")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if draft is not None and (top_k is not None or top_p is not None or min_p is not None):
        raise ValueError(
            "speculative decoding supports greedy (temperature 0) and plain-temperature "
            "sampling, not top_k/top_p/min_p truncation (truncation would change the "
            "distribution the rejection rule preserves)"
        )
    if not prompts:
        raise PromptError("no prompts given")
    bad = [i for i, p in enumerate(prompts) if not p or len(p) > width]
    if bad:
        raise PromptError(f"prompt rows {bad} are empty or exceed the decode width ({width})")
    bsz = batch_size if pad_to_batch else min(batch_size, len(prompts))
    out: list[list[int]] = []
    for lo in range(0, len(prompts), bsz):
        chunk = prompts[lo:lo + bsz]
        n_real = len(chunk)
        chunk = chunk + [chunk[-1]] * (bsz - n_real)
        padded = np.zeros((bsz, width), np.int64)
        lengths = np.zeros(bsz, np.int64)
        for i, p in enumerate(chunk):
            padded[i, :len(p)] = p
            lengths[i] = len(p)
        if draft is not None:
            toks = speculative_generate(
                model, draft, padded, max_new_tokens=max_new_tokens, k=spec_k, eos_id=eos_id,
                prompt_lengths=None if uniform else lengths, temperature=temperature,
                generator=generator,
            ).cpu().numpy()
        else:
            toks = generate(
                model, padded, max_new_tokens=max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, min_p=min_p, generator=generator, eos_id=eos_id,
                prompt_lengths=None if uniform else lengths,
            ).cpu().numpy()
        for row in toks[:n_real]:
            row = row.tolist()
            if eos_id is not None and eos_id in row:
                row = row[:row.index(eos_id) + 1]
            out.append(row)
    return out, generator


def build_score_fn(model, width: int, bsz: int):
    """``sequences -> per-token next-token logprobs`` over a Llama: a plain
    forward (no KV cache) at one (bsz, width) shape, rows right-padded."""
    import numpy as np
    import torch

    def score(tokens):
        with torch.no_grad():
            logits = model(tokens[:, :-1])
        logp = torch.log_softmax(logits.float(), dim=-1)
        return torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]

    def score_rows(rows: list[list[int]]) -> list[list[float]]:
        if not rows:
            raise PromptError("'sequences' must be a non-empty list")
        if len(rows) > bsz:
            raise PromptError(f"at most {bsz} sequences per request (the compiled batch shape)")
        vocab = model.cfg.vocab_size
        for r in rows:
            if len(r) < 2:
                raise PromptError("each sequence needs >= 2 tokens (scores are next-token "
                                  "logprobs)")
            if len(r) > width:
                raise PromptError(f"sequence length {len(r)} exceeds the score width {width}")
            bad = [t for t in r if not 0 <= t < vocab]
            if bad:
                raise PromptError(f"token ids {bad[:5]} outside the vocabulary [0, {vocab})")
        arr = np.zeros((bsz, width), np.int64)
        for i, r in enumerate(rows):
            arr[i, :len(r)] = r
        lp = score(torch.from_numpy(arr).to(model.device)).cpu().numpy()
        return [lp[i, :len(r) - 1].tolist() for i, r in enumerate(rows)]

    return score_rows


def _open_output(path: str):
    return open(path, "w") if path != "-" else sys.stdout


def _score_main(args, model, cfg, seqs) -> int:
    """--score: per-token next-token logprobs and their sum for each row."""
    width = min(max(len(s) for s in seqs), cfg.max_seq_len)
    score_rows = build_score_fn(model, width=width, bsz=args.batch_size)
    out = _open_output(args.output)
    try:
        for i in range(0, len(seqs), args.batch_size):
            for row in score_rows(seqs[i:i + args.batch_size]):
                out.write(json.dumps({"logprobs": row, "total": float(sum(row))}) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)

    import torch

    from tensorflowonspark_tpu_torch import resolve_device

    if args.batch_size < 1:
        raise SystemExit("--batch-size must be >= 1")
    device = resolve_device(args.device)
    cfg = _load_config(args)
    model = load_model(cfg, _load_params(args.checkpoint, cfg, args.lora_scale), device)

    with open(args.prompts) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    prompts = [list(map(int, r["tokens"])) for r in rows]
    if not prompts:
        raise ValueError(f"no prompts in {args.prompts}")
    if args.score and args.draft_checkpoint:
        raise SystemExit("--score is a plain forward; --draft-checkpoint (speculative "
                         "decoding) does not apply")
    if args.score:
        return _score_main(args, model, cfg, prompts)
    width = max(len(p) for p in prompts)
    if width + args.max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"longest prompt ({width}) + max_new_tokens ({args.max_new_tokens}) exceeds "
            f"max_seq_len ({cfg.max_seq_len})"
        )
    draft = None
    if args.draft_checkpoint:
        dcfg = _load_config(argparse.Namespace(model=args.draft_model,
                                               config_overrides=args.draft_config_overrides))
        draft = load_model(dcfg, _load_params(args.draft_checkpoint, dcfg), device)
    completions, _ = decode_batches(
        model, prompts, batch_size=args.batch_size, width=width,
        max_new_tokens=args.max_new_tokens,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p, min_p=args.min_p,
        eos_id=args.eos_id,
        # uniform corpora skip the padded path's scatter writes
        uniform=all(len(p) == width for p in prompts),
        draft=draft, spec_k=args.spec_k,
    )
    out = _open_output(args.output)
    try:
        for row in completions:
            out.write(json.dumps({"tokens": row}) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
