"""Llama training on the port's cluster: the counterpart of the JAX
package's ``examples/llama/llama_fsdp.py``.

The nodes train the port's :class:`~tensorflowonspark_tpu_torch.models.
llama.Llama` on a device mesh over all of them (one device each, CUDA
unless ``--cpu``), as the JAX example does: ``ctx.mesh`` from ``--dp``,
``--fsdp`` (``-1``: every rank left) and ``--tp``, the 'llama' table's
placements (``llama_param_shardings``), ``shard_state``, the mesh
``build_train_step`` with ZeRO, and ``shard_batch`` for each batch, with
``adamw(moment_dtype=bf16)`` by default. It resumes from ``--model-dir``
with ``restore_latest``, saves every ``--save-every`` steps with
``CheckpointManager`` (sharded: every node writes its shards) and at the
end with ``chief_final_save``, and prints the same per-node line as the
JAX example: step ms, tokens/s and MFU against ``--peak-tflops``
(default: the H100's dense bf16 peak). With ``--generate N`` the chief then
decodes N tokens after a seeded (2, 8) prompt with the trained weights
(``models.llama.generate``, KV-cache decode) and prints the same line as the
JAX example.

``--lora-rank R`` fine-tunes rank-R adapters (``ops.lora.add_lora`` on the
seed-0 weights, factors drawn from a generator seeded 1) with
``lora_optimizer``: the base gets no gradient and no optimizer moment.
With ``--generate`` the adapters are merged first (``merge_lora``), and
``--quantize-decode`` then decodes int8 weights (``ops.quant.quantize_tree``)
and prints how many it quantized, as the JAX example does.

Same flags and defaults as the JAX example, except ``--peak-tflops``. Not
ported yet, each raising ``NotImplementedError``: ``--sp`` above 1
(sequence parallel, ROADMAP A10), ``--generate`` on a mesh of more than one
rank (mesh decode, A9b), ``--packed`` (A12).

Usage::

    python -m tensorflowonspark_tpu_torch.launcher --num-executors 1 \\
        tensorflowonspark_tpu_torch/examples/llama_fsdp.py \\
        [--model tiny|7b] [--steps 20] [--seq 512] [--batch-size 8] \\
        [--dp N] [--fsdp N] [--tp N] [--remat full|dots|none] \\
        [--model-dir DIR] [--cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

# run as a script: the repository root (two levels up) holds the package
_sys.path.insert(0, _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", "..")))

import argparse  # noqa: E402
import time  # noqa: E402

# NVIDIA H100 SXM5 data sheet: 989 TFLOP/s dense bf16 on the tensor cores
# (1979 with 2:4 sparsity); the JAX example's default is a TPU v4's 275.
H100_BF16_PEAK_TFLOPS = 989.0


def _config(name: str, seq: int):
    import torch

    from tensorflowonspark_tpu_torch.models.llama import LlamaConfig

    if name == "7b":
        return LlamaConfig(
            hidden_size=4096,
            intermediate_size=11008,
            num_layers=32,
            num_heads=32,
            num_kv_heads=32,
            vocab_size=32000,
            max_seq_len=seq,
            dtype=torch.bfloat16,
            remat=True,
        )
    return LlamaConfig.tiny(
        hidden_size=256,
        intermediate_size=512,
        num_layers=4,
        num_heads=8,
        num_kv_heads=4,
        vocab_size=1024,
        max_seq_len=seq,
        dtype=torch.bfloat16,
        remat=True,
    )


def _refuse_unported(args, world: int = 1) -> None:
    refused = [
        (args.sp > 1, "--sp above 1 (sequence parallel)", "A10"),
        (bool(args.generate) and world > 1, "--generate on a mesh of more than one rank "
         "(mesh decode)", "A9b"),
        (args.packed, "--packed (data/packing.py)", "A12"),
    ]
    for hit, what, item in refused:
        if hit:
            raise NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


def main_fun(args, ctx):
    import dataclasses

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import resolve_device
    from tensorflowonspark_tpu_torch.compute import TrainState, build_train_step, optim
    from tensorflowonspark_tpu_torch.compute.checkpoint import (
        CheckpointManager,
        chief_final_save,
        restore_latest,
        saves_on_this_process,
    )
    from tensorflowonspark_tpu_torch.compute.mesh import shard_batch
    from tensorflowonspark_tpu_torch.compute.train import shard_state
    from tensorflowonspark_tpu_torch.models.llama import (
        Llama,
        adopt_params,
        llama_loss_fn,
        llama_param_shardings,
    )

    mesh = ctx.mesh({"data": args.dp, "fsdp": args.fsdp, "model": args.tp, "seq": args.sp})
    _refuse_unported(args, mesh.size())
    device = resolve_device(ctx.device)
    cfg = _config(args.model, args.seq)
    if args.remat != "full":
        cfg = dataclasses.replace(cfg, remat=args.remat != "none", remat_policy=args.remat)
    if args.attention != "auto":
        cfg = dataclasses.replace(cfg, attention_impl=args.attention)
    model = Llama(cfg, device=device, seed=0)
    if ctx.executor_id == 0:
        print(f"device: {device}, mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")

    rng = np.random.default_rng(ctx.executor_id)
    params = dict(model.named_parameters())
    if args.lora_rank:
        from tensorflowonspark_tpu_torch.ops.lora import add_lora

        # parameter-efficient fine-tune: only rank-r adapters train; the
        # frozen base carries no gradients and no optimizer moments
        gen = torch.Generator(device=device).manual_seed(1)
        params = adopt_params(model, add_lora(params, rank=int(args.lora_rank), generator=gen))
    n_params = sum(p.numel() for p in params.values())

    moment_dtype = torch.bfloat16 if args.moments == "bf16" else None
    # linear warmup -> cosine decay to 10% of peak over --total-steps (the
    # horizon of every resume leg: the schedule reads the restored count)
    if args.warmup > 0:
        total = args.total_steps or args.steps
        lr = optim.warmup_cosine_decay_schedule(
            init_value=0.0,
            peak_value=float(args.lr),
            warmup_steps=args.warmup,
            decay_steps=max(total, args.warmup + 1),
            end_value=0.1 * float(args.lr),
        )
    else:
        lr = float(args.lr)
    if args.precision == "mixed":
        # bf16 stored params + fp32 master in the optimizer state
        with torch.no_grad():
            for p in params.values():
                p.data = p.data.to(torch.bfloat16)
        tx = optim.mixed_precision_adamw(lr, moment_dtype=moment_dtype)
    else:
        tx = optim.adamw(lr, moment_dtype=moment_dtype)
    if args.clip > 0:
        # global-norm clip BEFORE the optimizer
        tx = optim.chain(optim.clip_by_global_norm(float(args.clip)), tx)
    if args.lora_rank:
        from tensorflowonspark_tpu_torch.ops.lora import lora_optimizer

        # moments for the adapters alone
        tx = lora_optimizer(tx, params)
    psh = llama_param_shardings(params, mesh)
    # every tensor of the state placed on the mesh, the params also in the
    # model (its remat recomputes blocks from its own parameters)
    state = shard_state(TrainState.create(params, tx), mesh, psh, module=model)
    token_loss = llama_loss_fn(model, logit_chunk=args.logit_chunk)
    step = build_train_step(
        lambda p, b: token_loss(p, b["tokens"]), tx, mesh, param_shardings=psh,
        accum_steps=args.accum,
    )

    ckpt = None
    if args.model_dir:
        ckpt = CheckpointManager(
            ctx.absolute_path(args.model_dir),
            save_interval_steps=args.save_every or 1,
        )
        latest, restored = restore_latest(ckpt, state)
        if latest is not None:
            if ctx.is_chief:
                print(f"resuming from step {latest}")
            state = restored

    def batch():
        return shard_batch(mesh, {
            "tokens": rng.integers(
                0, cfg.vocab_size, size=(args.batch_size, args.seq + 1)
            ).astype(np.int32)
        })

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # warm-up (first kernel builds and allocations) excluded from timing
    state, loss = step(state, batch())
    sync()
    step_base = state.step
    t0 = time.time()
    for i in range(args.steps):
        state, loss = step(state, batch())
        if (i + 1) % 10 == 0:
            print(f"node{ctx.executor_id} step {i + 1} loss {float(loss):.4f}")
        if ckpt is not None and args.save_every and saves_on_this_process(ctx.is_chief, state):
            # async save (host snapshot first) overlapped with the next
            # steps; the manager's save_interval policy decides which land
            ckpt.save(step_base + 1 + i, state)
    sync()
    dt = time.time() - t0

    step_time = dt / args.steps
    tokens_per_step = args.batch_size * args.seq
    model_flops = 6 * n_params * tokens_per_step  # fwd+bwd, no attn term
    mfu = model_flops / step_time / (args.peak_tflops * 1e12)
    print(
        f"node{ctx.executor_id}: {n_params / 1e6:.1f}M params, "
        f"step {step_time * 1e3:.1f}ms, "
        f"{tokens_per_step / step_time:.0f} tokens/sec "
        f"({tokens_per_step / step_time:.0f} /chip), "
        f"MFU {mfu * 100:.1f}%"
    )
    if ckpt is not None:
        chief_final_save(ckpt, state, state.step, ctx.is_chief)
        if ctx.is_chief:
            print(f"checkpointed step {state.step} to {args.model_dir}")
    if args.generate and ctx.is_chief:
        _generate(args, cfg, state, device)


def _generate(args, cfg, state, device):
    """Decode ``--generate`` tokens after a seeded (2, 8) prompt with the
    trained params (a mesh of one rank: each DTensor is its whole tensor),
    the adapters merged (``--lora-rank``) and the weights int8
    (``--quantize-decode``)."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models.llama import Llama, adopt_params, generate

    with torch.no_grad():
        params = {n: (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone()
                  for n, t in state.params.items()}
    if args.lora_rank:
        from tensorflowonspark_tpu_torch.ops.lora import merge_lora

        # fold the adapters into plain weights: no adapter products in
        # decode, and quantize_tree takes the merged weights
        params = merge_lora(params)
    if args.quantize_decode:
        from tensorflowonspark_tpu_torch.ops.quant import quantize_tree, quantized_names

        params = quantize_tree(params)
        n_q = len(quantized_names(params))
        print(f"quantized {n_q} weight tensors for decode"
              + (" (NONE met quantize_tree's size threshold — tiny configs decode unquantized)"
                 if n_q == 0 else ""))
    model = Llama(cfg, device=device)
    adopt_params(model, params)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 8))
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.time()
    out = generate(model, prompt, max_new_tokens=args.generate, temperature=args.temperature,
                   top_k=args.top_k, top_p=args.top_p, eos_id=args.eos_id, generator=gen)
    out = out.cpu().numpy()  # waits for the device
    dt = time.time() - t0
    if args.eos_id is None:
        n_generated = float(args.generate)
    else:
        # tokens up to and including each row's first EOS; the eos-filled
        # tail was never decoded (early stop)
        hit = out == args.eos_id
        n_generated = float(np.where(hit.any(axis=1), hit.argmax(axis=1) + 1,
                                     out.shape[1]).mean())
    print(f"generated {n_generated:.1f} tokens/seq (KV-cache decode) in {dt:.1f}s: "
          f"{out[0][:10].tolist()}")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=("tiny", "7b"), default="tiny")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=-1, help="-1: all devices")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1, help="sequence-parallel axis size")
    p.add_argument(
        "--sp-impl", choices=("ring", "ulysses"), default="ring",
        help="sequence-parallel strategy",
    )
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument(
        "--warmup", type=int, default=0,
        help="linear-warmup steps into a cosine decay (0: constant LR)",
    )
    p.add_argument(
        "--total-steps", type=int, default=0,
        help="cosine-decay horizon across ALL resume legs (0: this "
        "invocation's --steps); keep identical when resuming so the "
        "restored optimizer count lands on a coherent schedule",
    )
    p.add_argument("--clip", type=float, default=0.0,
                   help="global-norm gradient clip (0: off)")
    p.add_argument(
        "--precision", choices=("fp32", "mixed"), default="fp32",
        help="mixed: bf16 stored params + fp32 master (compute/optim.py)",
    )
    p.add_argument(
        "--moments", choices=("fp32", "bf16"), default="bf16",
        help="Adam moment storage dtype (bf16 frees 4 bytes/param of device memory)",
    )
    p.add_argument(
        "--accum", type=int, default=1,
        help="gradient-accumulation microbatches per optimizer step "
        "(batch-size must divide evenly)",
    )
    p.add_argument("--packed", action="store_true",
                   help="pack variable-length documents into each row (not ported: A12)")
    p.add_argument("--logit-chunk", type=int, default=None,
                   help="chunked-CE chunk length; skips the (B,S,V) fp32 logits")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="fine-tune rank-R LoRA adapters (ops/lora.py) instead of every "
                   "weight: only adapters train (0 = full fine-tune)")
    p.add_argument("--model-dir", default=None)
    p.add_argument("--save-every", type=int, default=0,
                   help="mid-training checkpoint interval in steps (0: only at end)")
    p.add_argument("--generate", type=int, default=0,
                   help="after training, decode N tokens (KV-cache decode)")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--eos-id", type=int, default=None)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--quantize-decode", action="store_true",
                   help="with --generate: decode int8 weight-only (ops/quant.py; "
                   "merged adapters first)")
    p.add_argument("--peak-tflops", type=float, default=H100_BF16_PEAK_TFLOPS,
                   help="per-device bf16 peak (default: H100 SXM dense)")
    p.add_argument(
        "--remat", choices=("full", "dots", "none"), default="full",
        help="rematerialization policy (none = keep activations)",
    )
    p.add_argument(
        "--attention", choices=("auto", "xla", "flash"), default="auto",
        help="attention impl",
    )
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    if (args.top_k is not None or args.top_p is not None) and args.temperature == 0.0:
        p.error("--top-k/--top-p require --temperature > 0")
    # the node's device (cluster/context.py device_of_args): CUDA unless --cpu
    args.device = "cpu" if args.cpu else None
    return args


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch.cluster import tfcluster
    from tensorflowonspark_tpu_torch.cluster.tfcluster import InputMode
    from tensorflowonspark_tpu_torch.launcher import cluster_args_from_env
    from tensorflowonspark_tpu_torch.utils.util import cpu_only_env

    args = parse_args()
    largs = cluster_args_from_env()
    cluster = tfcluster.run(
        main_fun,
        args,
        num_executors=largs["num_executors"],
        input_mode=InputMode.TENSORFLOW,
        env=cpu_only_env() if args.cpu else None,
        launcher=largs.get("launcher"),
        distributed=largs.get("distributed", False),
    )
    cluster.shutdown()
    print("llama_fsdp done")
