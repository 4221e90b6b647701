"""Drive the PyTorch port on one NVIDIA GPU: build, check and time its kernels,
then train llama_1b, the BatchNorm conv nets and the encoder and small-image
families for a few steps through them.

    python3 chip_smoke.py
    python3 chip_smoke.py --decode-seeds 1 2 3   # phase decode alone, per seed

Phases (one JSON line each, or more; any failure exits non-zero; the
``script`` line gives the whole run's seconds and each phase's):

1. device — the card, its power limit, torch/CUDA versions, the kernel
   builds (one nvcc per source, all started at once) and ptxas' registers
   and spills of each kernel, by its demangled name (the bf16 flash kernels
   are ``fwd_wgmma_kernel<64|128>``, ``dq_wgmma_kernel<64|128>`` and
   ``dkv_wgmma_kernel<64|128>``).
2. kernels — each flash-attention kernel (forward, dQ, dK/dV) against its
   plain PyTorch version on the card, element by element and in Frobenius
   norm (limits in ``TOL``), at the llama_1b training shape (B=8, S=1024,
   H=16, D=128, bf16, causal) and at small GQA, sq != sk, dead-row, window
   and segment cases, ragged lengths (200 causal, and ViT's 197 with no
   causal mask); times of kernel, plain version and
   ``scaled_dot_product_attention`` (a yardstick only: the port never calls
   it; forward for B1; for B2 and B3, which it computes in one call, the
   backward alone on a kept forward, as device time under the profiler), and
   the bound of each kernel on an H100 with the kernel's share of it.
3. train — ``LlamaConfig.llama_1b(remat=False)`` at full depth, batch 8,
   seq 1024, fp32 params, ``adamw(moment_dtype=bf16)``, attention ``auto``:
   one warm-up step, then 5 timed steps on one fixed batch, with the kernel
   launch counts of those 5 steps; and a small model whose logits through
   the kernels must match the plain attention path. Then two more steps
   under ``torch.profiler`` (phase ``profile``): device busy and idle
   share, device time by kind of kernel and of the weight update, and the
   heaviest kernels.
4. bn_kernels — the batch-norm statistics kernels (``pair_stats`` B4,
   ``cross_stats`` B5) against their plain versions on the card, each
   per-channel sum held to ``|a − b| ≤ rtol·Σ|terms| + atol`` (Σ|terms| in
   fp64; limits in ``BN_TOL``), at the 12 (rows, C) shapes of ResNet-50's
   BatchNorm layers at batch 256, 224x224, bf16, and at edge cases (fp32,
   ragged rows with poison past the end, C = 4, 65, 600, a base pointer
   off 16 bytes). Per shape: kernel, plain and library time
   (``torch.batch_norm_stats`` / ``torch.batch_norm_backward_reduce``,
   yardsticks the port never calls) and the byte bound.
5. bn_layer — ``fused_batch_norm`` forward and backward, ``kernel`` route
   against ``xla`` route, at the stem and a stage-4 shape, bf16.
6. conv_train — ResNet-50 (``ResNetConfig.resnet50()``), batch 256,
   224x224, bf16 compute, fp32 params, ``sgd(0.1, momentum=0.9)``, random
   weights and one fixed batch from seed 0, BatchNorm ``auto`` (→ the
   kernels): one warm-up step, 5 timed steps with the launch counts of
   those steps (53 of each kernel per step), then the same with ``xla``
   statistics as the A/B of the dispatch, two steps under the profiler,
   and one step each of Inception-v3 (299x299, batch 32, aux head on) and
   VGG-16 (224x224, batch 32) through the kernels.
7. cluster — the node runtime: ``tfcluster.run`` launches one node
   (SPARK mode, an NCCL process group of 1) that trains llama_1b at full
   width, the configuration of phase train, fed only through
   ``DataFeed`` → ``DevicePrefetcher.from_feed(device="cuda")`` from the
   driver's ``cluster.train`` (rows of 1025 int32 tokens from seed 0).
   The node first pulls one batch per staging slot, then 30 batches while
   the prefetcher's copy stream is held back (an input-bound loop, where a
   staging slot is reused while its copy may still be pending), then runs
   one warm-up and 5 timed
   steps, saves asynchronously with ``CheckpointManager`` and takes the
   next step while the file is written (the step updates the params in
   place), confirms the save with ``chief_final_save``, restores with
   ``restore_latest`` into a state built from seed 1, and takes the same
   next step from the restored state. Checks: every device batch's int64
   checksum equals the host's, taken before staging; the losses fall;
   16 launches of each flash kernel per step; every restored tensor
   equals the saved one bit for bit and the step agrees; the two next-step
   losses are equal. Reports ``step_ms`` beside phase train's, the
   prefetcher's stats and wait per step, and the checkpoint's GB and
   seconds (snapshot, write, restore).
8. mesh — the mesh path on the card, a world of one (an NCCL group of one
   over a mesh whose six axes have extent 1, so DTensor, ``local_map`` and
   the kernels' mesh routes all run and no collective moves data):
   llama_1b at full width and depth with ``remat_policy="dots"`` through
   ``llama_param_shardings`` → ``shard_state`` → ``build_train_step(...,
   mesh, zero_sharding=True)`` on phase train's weights and batch (one
   warm-up, 5 timed steps; the 6 losses against phase train's within
   ``MESH_LOSS_RTOL``; per step 32 forward launches, the 16 of the forward
   and the 16 of the 'dots' recompute, 16 dQ and 16 dK/dV; the attention
   mesh route taken once a layer a step), two profiled steps beside phase
   train's profile; ``build_update_step`` alone on fixed gradients (event
   and device ms per call); ResNet-50 at batch 256 through the mesh BN step
   (one warm-up, 3 timed; losses against phase conv_train's first four; 53
   launches of each statistics kernel a step, all through
   ``mesh_pair_stats``/``mesh_cross_stats``); and a node launched by
   ``tfcluster.run`` that trains llama_1b (at ``SERVING_DEPTH`` when the
   whole script runs) on ``ctx.mesh()`` fed by
   ``DevicePrefetcher.from_feed(mesh=…)``, saves the mesh state sharded,
   restores it into a state from seed 1 and takes one more step from each
   (every restored tensor bit-equal, the two losses equal).
9. elastic — membership changes mid-run (llama_1b at ``SERVING_DEPTH``
   when the whole script runs): first the uninterrupted run
   (phase train's configuration, 24 steps on Zipf batches that are a pure
   function of the step index; its final state to a file), then
   ``tfcluster.run(num_executors=2, elastic=True, input_mode=TENSORFLOW,
   distributed=False)``: two single-controller llama_1b nodes share the
   card, each an ``ElasticTrainer`` loop with its state on its own device.
   Each node publishes its snapshot once at its first step, and the two
   nodes of epochs 0 and 2 wait for each other once past that (and node
   0's checkpoint), so that the rest share the card. Once both have taken 5 steps
   node 1 is SIGKILLed; ``supervise()`` bumps the epoch and
   node 0 reconfigures in memory (``resharded``). ``launch_replacement``
   starts a node that hydrates from node 0's published snapshot
   (``peer_hydrate``); its admission bumps the epoch again, and node 0,
   with ``elastic.reshard_gather`` armed, restores its checkpoint of step
   2 (``checkpoint_fallback``) and replays from there. Checks: the
   outcomes and epochs, the joiner starts at the step of node 0's freshest
   snapshot, every step's loss equals the uninterrupted run's, both
   nodes' final params and optimizer state equal its final state bit for
   bit, and 16 launches of each flash kernel per step in each node.
   Reports each node's step ms with two nodes on the card, one, and two
   again, kill-to-next-epoch seconds, the snapshot, publish, reconfigure
   and hydrate seconds and bytes, and peak device memory.
10. decode — KV-cache decode and scoring of ``LlamaConfig.llama_1b`` at full
   width and depth, weights from seed 0 cast once to bf16 (limits in
   ``DECODE_TOL``): (attn) the cached attention at the decode shape (batch
   8, a full cache of 1024 slots) against its math in fp64, with logits of
   rms ~9; (a) ``generate`` over 8 right-padded prompts of seeded lengths
   64–512 in width 512, 256 new tokens, its logits (captured by driving
   ``prefill``/``decode_step`` as ``generate`` does) against a
   teacher-forced forward without a cache at every generated position, and
   its tokens against that forward's argmax wherever the top-2 gap exceeds
   the limit; (b) at batch 1 and 8, prompt 128: prefill ms, ms per decode
   step, tokens/s, the step's byte bound (bf16 weights plus the whole cache
   the step reads) and its share, host issue ms against device busy ms over
   two profiled steps, a whole ``generate`` of 256 tokens, peak device
   memory; (c) ``eos_id`` on rows of (a) that share a token: each row is
   its (a) decode up to its first eos, then eos, and the loop stops after
   the last row's first eos (steps counted); (d) an int8 cache on (a)'s
   tokens, logits against the bf16 cache's, and the caches' bytes; (e) a
   rolling cache (window 256, 512 slots) against the dense windowed cache,
   prompt 256 and 384 new tokens (the cache wraps); (f) ``build_score_fn``
   at width 513, whose forward sends 512 positions to B1 (16 launches a
   call), logprobs against the plain attention; (g) ``python -m
   tensorflowonspark_tpu_torch.tools.generate_text`` as two subprocesses
   on the card (decode and ``--score``) over a checkpoint that
   ``save_checkpoint`` wrote of those weights, against the in-process
   ``decode_batches`` and scorer.
11. serve — the continuous-batching engine and the HTTP server on phase
   decode's model (``LlamaConfig.llama_1b`` at full width, its depth cut
   to ``SERVING_DEPTH`` = 4 layers when the whole script runs, bf16
   weights from seed 0, 1024 cache slots; limits in ``SERVE_TOL``), the
   engine at 8
   slots, prompt widths 128/256/512, decode_block 8, pipeline_depth 2:
   (sampler) ``_sample_rows`` on the card against its plain version in
   fp64 (penalties, logit_bias, top-k, top-p, min_p; tokens equal);
   (a) 24 greedy requests (prompts 16–500, budgets 16–256, stop sequences
   on the first three) and 8 seeded sampled ones (temperature 0.8, top_p
   0.9, min_p on some) as streams from 8 threads at staggered times: each
   greedy completion against generate() of its prompt alone (the first
   three) and against a teacher-forced forward (all), by phase decode's
   confident-token rule, logprobs within the limit; TTFT p50/p95; (b) the
   same traffic on the same engine at decode_block 1 / depth 1
   (``set_knobs``) in reverse arrival order, every completion token for
   token equal; (c) chunked prefill (chunk 128) with the prefix cache: a
   hit equals a miss exactly, chunked against bucketed by the confident
   rule; (f) the engine's ms per step with 8 live rows beside
   ``decode_step``'s at batch 8 under ``inference_mode``, in three
   alternating rounds (the engine tax: the median of their ratios),
   sync-debug warnings per block, device busy and idle over two profiled
   blocks; (d) ``serve_model.make_server`` in process at budget 256:
   concurrent ``/generate`` equal to the engine's, a streamed
   ``/generate``, ``/v1/completions``, ``/score`` (width 769, one B1
   launch a layer a call, against the plain attention), ``/metrics``,
   ``/stats``, then
   ``--gen-engine fixed`` against ``decode_batches``; (e) ``python -m
   tensorflowonspark_tpu_torch.tools.serve_model`` as a process on the
   card over a ``save_checkpoint`` of the weights: one ``/generate`` and
   one ``/score`` against the in-process results, then stopped. Peak
   device memory, the phase's ``wall_s`` and each part's seconds.
12. fleet — the serving fleet on phase serve's model and traffic (8 slots
   an engine, widths 128/256/512, prefill chunk 128, a 4-entry prefix
   cache): (a) ``ServingFleet(factory=..., replicas=2, prefix_l2=
   {"mode": "inproc", "capacity_bytes": 1 << 30})`` behind
   ``FleetRouter`` against one engine on the same traffic: no confident
   greedy token different, each replica a quarter of the requests or
   more, tokens/s and TTFT p50/p95 of both, sync-debug warnings per block
   over the fleet's traffic (L2 offers and lookups included); (b) a
   384-token prompt on
   replica 0, its extension on replica 1: an L2 hit (the tier filled),
   tokens equal to a miss's, another weights version a miss, the lookup's
   ms and the blob's bytes; the filler's blob of an entry written behind
   a device stall equal to the entry; 50 lookups after
   ``CacheServer.close()``, every one a miss; (c) under traffic, a dropped dispatch
   (``fleet.dispatch``) and a wedged replica (``engine.fetch`` held past
   the watchdog): every request resolved once (a completion, or one
   terminal error after its first token), failovers, the seats READY
   again and the seconds it took; (d) ``ServingFleet(spawn_argv=[serve_model
   ... --device cuda], replicas=2, prefix_l2={"mode": "spawn", ...})``,
   built in the background from a checkpoint of the weights while (a)
   warms: the L2 across the children (the lookup bound from a timed
   loopback lookup of one entry), a child SIGKILLed under streaming load
   (queued streams fail over, decoding ones end with ``ReplicaGone``) and
   respawned, both children's greedy tokens against (a)'s engine, the
   cachetier daemon SIGKILLed (lookups miss in their bound, the fleet
   serves, the daemon respawns on its port); (e) ``serve_model`` in
   process with ``replicas=2`` and ``cachetier_l2`` at a daemon:
   ``/generate`` equal to the engine's, ``/healthz`` per replica,
   ``/metrics`` with both replica labels, ``/score`` at width 769 with one
   B1 launch a layer. Peak device memory, ``wall_s``, each part's seconds.
13. rollout — zero-downtime weight rollout (``serving/rollout.py``) on
   phase fleet's engine settings, limits in ``ROLLOUT_TOL``, llama_1b at
   ``SERVING_DEPTH`` when the whole script runs: (a) the port's train
   step trains llama_1b from the seed-0 weights (fp32 params,
   ``adamw(1e-3, moment_dtype=bf16)``, batch 4, seq 1024, 3 steps, B1–B3
   counted) and ``CheckpointManager`` saves its ``TrainState``;
   ``publish_checkpoint`` points a channel at the step, and a
   ``RolloutController`` watching it (``checkpoint_loader``) rolls it
   across an in-process ``ServingFleet`` of two bf16 engines with a 1 GiB
   in-process L2 while 16 greedy requests stream from 4 threads, again
   and again until the roll completed: every request resolves, stamped v0
   or v1, each against a fresh engine of its version by the confident-token
   rule; ≥ 1 of 8 prompts decodes otherwise under v1; the gauge at v1's
   ordinal on both seats, one ``rollout_total{completed}``; after the roll
   a 384-token prefix hits the L2 across seats, equal to a miss, and no hit
   is of v0. Per-seat drain, load, install and warm-up seconds, the roll's
   wall seconds, TTFT p50 before and during it. (b) Rollbacks, each
   leaving every seat at v1 with exactly v1's tokens on the prompts whose
   tokens v0 and v1 part on: a checkpoint with one leaf's shape cut
   (``publish_params``), a committed checkpoint whose ``state.pt`` is cut
   short, v0 by path loaded against seat 0's running tensors with seat 1's
   verification raising (``rollout.verify``) after seat 0 swapped, a torn
   ``LATEST`` (CRC mismatch) that must be ignored; then ``publish`` of the
   trainer's live params, one more train step in place and seat 0
   respawned: the re-synced seat's weights equal seat 1's, the snapshot.
   (c) ``serve_model.main`` on a thread of this process (its ``/score``
   launches are counted) with ``--gen-replicas 2 --admin-token-file
   --rollout-channel``: ``/admin/reload`` 403 without the token, with a
   wrong one and with the file's path, 202 with it and completed in
   ``/stats``; a channel publish of the trained step rolls both replicas;
   ``/generate`` stamped v1 and equal to a fresh v1 engine; ``/score`` at
   width 769 with 16 B1 launches, equal to a fresh scoring under v1; a
   single-engine server answers 409 on a checkpoint that does not fit.
   (d) Two ``serve_model`` children (4 layers) with the fleet's
   ``TFOS_ADMIN_TOKEN`` roll through ``SubprocessReplica.reload`` under
   streaming load; once seat 0 swapped, child 1 is SIGKILLed and skipped,
   and its respawn rejoins at the target version: no request lost, the
   children against a 4-layer engine of v1. Peak device memory per part,
   ``wall_s``, each part's seconds.
14. lora — LoRA and int8 weights (``ops/lora.py``, ``ops/quant.py``) on
   ``LlamaConfig.llama_1b`` at full width and depth, seed 0, limits in
   ``LORA_TOL``: (a) ``add_lora(rank=16)`` on the seven projections of the
   seed-0 weights (fp32 params, bf16 compute) fine-tuned with
   ``lora_optimizer(adamw(1e-3, moment_dtype=bf16))`` at batch 8, seq 1024,
   4 steps: the first logits equal the base model's (b = 0), every base
   leaf bit-unchanged, no gradient and no moment for a frozen leaf, the
   optimizer state's bytes those of the adapters' moments, the loss falls,
   16 launches of each of B1-B3 a step; step ms beside phase train's full
   fine-tune. (b) ``merge_lora`` then ``quantize_tree``: the int8 model's
   greedy decode at batch 8 (prompts 64-512, 128 new) against the merged
   bf16 model's teacher-forced forward by the confident-token rule, the rms
   of their logits' difference and of the int8 logits' against a bf16 model
   of the same codes dequantized, resident weight bytes int8 against bf16,
   ms per decode step at batch 1 and 8 for both with device busy against
   host time over two profiled steps; ``examples/llama_fsdp.py --lora-rank
   16 --generate 16 --quantize-decode`` once through ``tfcluster.run`` (its
   tiny 4-layer config). (c) A bank of (a)'s adapters after steps 1, 2 and 4 plus the
   zero slot: rows routed through it in fp32 against each adapter merged
   alone; a ``ContinuousBatcher`` (8 slots, widths 128/256/512) under 24
   greedy requests with adapters 0-3 from 8 threads against ``generate`` on
   each adapter merged alone (slot 0: the base model) by the confident-token
   rule; a prompt under two adapters a prefix-cache miss, under the same
   one a hit equal to the miss; tokens/s and TTFT p50 beside the same
   engine without a bank. (d) ``lora_state`` of a second bank (the adapters
   reordered) through ``swap_weights(kind="lora")`` under traffic: every
   request resolves stamped v0 or v1, each against a fresh engine of its
   version; the bases the same tensors, the prior bit-unchanged; install
   seconds beside a full swap on the same engine; then a ``RolloutController``
   of kind lora from a channel across an in-process two-seat fleet.
   (e) ``serve_model.make_server`` over a bank checkpoint with
   ``lora_scale``: ``/generate`` with ``adapter`` 2 equal to the engine's,
   ``adapter`` 9 a 400, ``/admin/reload`` of kind lora 200 and the new
   adapters served, ``/score`` at width 769 (16 B1 launches) against the
   plain attention. Each part runs guarded: an exception fails its check by
   name. Parts (c)-(e) serve the first ``SERVING_DEPTH`` blocks of (a)'s
   weights and adapters when the whole script runs. Peak device memory per
   part, ``wall_s``, each part's seconds.
15. moe — MoE experts (``parallel/moe.py``) on ``LlamaConfig.llama_1b(
   num_experts=8, moe_top_k=2)`` (capacity factor 2.0), seed 0, limits in
   ``MOE_TOL``: (a) the train step at 4 layers (depth cut for memory),
   batch 8, seq 1024, fp32 params, bf16 compute, ``adamw(1e-4, moment_dtype=
   bf16)``: one warm-up and 5 timed steps, the loss falls, 4 launches of
   each of B1-B3 a step, each layer's aux loss and dropped share, two
   profiled steps; the first loss against cross entropy plus the aux losses
   of the same forward; a tiny MoE Llama's ``llama_loss_fn`` on the card
   against cross entropy plus aux losses on the CPU. (b) One MoE block at
   full width in bf16 on a (2, 256) batch against a plain fp32 version on
   the CPU, at capacity factor 2.0 and 0.25 (drops: the priority order
   decides): kept assignments equal, output within the limit. (c) 16
   layers, in fp32 and in bf16: greedy ``generate`` at batch 8 (prompts
   64-512, right-padded, 64 new) against a teacher-forced forward at each
   row's positions before its first token routed otherwise in the two (an
   expert chosen otherwise or an assignment dropped; in bf16 one rounding
   step flips near-tied choices, so few positions are held there): fp32
   to 1e-3 with at least half the positions held, bf16 by phase decode's
   limit and rule; the dropped shares of both; the bf16 decode step's ms at
   batch 1 and 8 against the bytes a step reads (every expert). (d) ``ContinuousBatcher`` (8 slots)
   at ``SERVING_DEPTH`` over (c)'s first blocks: one request alone against
   ``generate`` alone (parted only where generate's top-2 gap is within the
   limit), then 8 staggered requests, each against ``generate`` alone and
   the dropped share, reported with no limit (dead slots and batch mates
   take capacity, and prefill at a bucket's width rounds otherwise than at
   the prompt's, which flips near-tied expert choices in bf16). Peak
   memory per part, ``wall_s``, each part's seconds.
16. spec — speculative decoding (``models/speculative.py``) on
   ``LlamaConfig.llama_1b`` at full depth, seed 0, k = 4, limits in
   ``SPEC_TOL``, three drafts: the target itself, an early exit (its
   embedding, first 2 blocks, final norm and head, shared tensors) and a
   random 2-layer llama_1b (seed 1): (a) in fp32 and in bf16, at batch 8
   (prompts 64-512, right-padded, 64 new) each draft against plain greedy
   ``generate`` (fp32: equal but at a near-tie; bf16: parted only where
   plain's top-2 gap is within phase serve's), accepted drafts per verify
   (the target itself k in fp32), host reads; tokens/s at batch 1 and 8
   against ``generate`` (32 new tokens); (b) ``speculative_accept`` on the card at V=8 over
   20,000 draws against the target's p, and one sampled decode through the
   early exit; (c) ``serve_model`` (fixed path) with the random draft saved
   and loaded by ``--draft-model 1b --draft-config-overrides
   '{"num_layers": 2}'``: ``/generate`` equal to ``generate_text``'s CLI on
   the same prompts, and ``--gen-engine continuous`` with a draft refused
   with the reference's ``ValueError``.
17. families — the encoder and small-image families (``models/{bert,vit,
   unet,mnist,zoo}.py``) at full width, seed 0, bf16, limits in
   ``FAMILIES_TOL``: (a) ``BertForClassification`` (BERT-base) at batch 32,
   seq 512, each row's length drawn from 128-512 and its 0/1 mask passed as
   segment ids: the first loss and the gradients of ``layer_0``'s query
   and of the pooler through ``impl="auto"`` (the flash kernels, no causal
   mask) against ``impl="xla"`` on the same weights and batch, then one
   warm-up and 3 timed ``build_train_step`` steps (``adamw(1e-4)``) with
   launches of the forward, dQ and dK/dV kernels; ``zoo.build("bert_base")``
   (masked LM) the same at seq 128. (b) ``zoo.build("vit_b16")`` at batch
   64, 224x224: one warm-up and 3 timed steps under ``auto`` (the plain
   attention at 197 tokens, as the gate sends it), then one forward with
   ``attention_impl="flash"`` against ``"xla"`` (forward launches > 0).
   (c) ``zoo.build("unet")`` at widths (64, 128, 256, 512) / 1024 and 3
   classes, batch 16, 128x128, ``adamw(1e-3)`` without decay, one warm-up
   and 3 timed steps on one batch: losses finite and falling. (d) The three
   examples through ``tfcluster.run``, one node each: ``resnet_imagenet``
   (ResNet-50, batch 64, 3 steps, a checkpoint; its node's launches of the
   batch-norm kernels > 0), ``mnist_spark`` (``InputMode.SPARK``, 2,048
   records pushed by ``cluster.train``, the CNN, the chief's export) and
   ``unet_segmentation`` (full width, 64x64, 3 steps, mIoU, the export).
   Step ms and images/s or tokens/s per part, launches, ``wall_s``, each
   part's seconds.

The last lines are the ``kernels`` summary (the bn kernels' ``ms``,
``plain_ms``, ``bound_ms`` and ``library_ms`` are per ResNet-50 step: the
sum over its 53 BatchNorm layers; ``mesh_launches`` counts phase mesh's
timed steps, ``elastic_launches`` phase elastic's steps in both nodes,
``score_launches`` phase decode's scoring call, ``serve_launches`` the
``/score`` call of phase serve's server, ``fleet_launches`` that of phase
fleet's server, ``rollout_launches`` phase rollout's trainer steps and
its server's ``/score``, ``lora_launches`` phase lora's fine-tune steps
and its server's ``/score``, ``moe_launches`` phase moe's timed train
steps, ``spec_launches`` phase spec's greedy decodes, none,
``families_launches`` phase families' BERT steps, ViT's flash forward and
the ResNet example's node),
the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, same data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3
SLICE = dict(b=8, s=1024, h=16, d=128)
KERNEL_SOURCE = "tensorflowonspark_tpu_torch/csrc/flash_attention.cu"
BN_SOURCE = "tensorflowonspark_tpu_torch/csrc/bn_stats.cu"
REPLACES = {
    "fwd": "tensorflowonspark_tpu/ops/flash_attention.py:134",
    "dq": "tensorflowonspark_tpu/ops/flash_attention.py:343",
    "dkv": "tensorflowonspark_tpu/ops/flash_attention.py:400",
    "pair": "tensorflowonspark_tpu/ops/bn_kernels.py:101",
    "cross": "tensorflowonspark_tpu/ops/bn_kernels.py:109",
}
# Each kernel output a against its plain version b, element by element,
# |a - b| <= atol + rtol*|b| with atol = atol_rms * rms(b) (the tensor's own
# scale), and as a whole, rms(a - b) <= frob * rms(b) (the Frobenius-
# relative error). bf16: both sides round the output to bf16 once, which
# leaves them one bf16 step apart (rtol = 2^-7) wherever the values before
# rounding agree to better than a step; the tensor-core kernels also round
# P and dS to bf16 before their products, an error that does not shrink
# with |b| where the sum cancels (atol). fp32 differs only by summation
# order. The limits sit 2.5-5x above the largest readings of the unchanged
# kernels and far below those of the faults that chip_faults.py plants
# (PERF.md, Findings). With inputs of rms 1, a tensor of rms under
# RMS_FLOOR is zero up to rounding (window 1 makes dQ and dK exactly 0),
# and is held at that scale instead of its own.
TOL = {
    torch.bfloat16: dict(rtol=2**-7, atol_rms=1.5e-1, frob=1e-2),
    torch.float32: dict(rtol=1e-5, atol_rms=3e-5, frob=3e-6),
}
RMS_FLOOR = 1e-3
LSE_TOL = 1e-3  # LSE is fp32 on both sides; bf16 inputs only shift the order


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=10, warmup=2) -> float:
    """Device time of one call of ``fn``: the kernels' own time under
    torch.profiler, summed and averaged over ``iters`` calls. Unlike
    time_ms it leaves out the gaps where the card waits for the host, which
    set the event time of a call whose host side is nearly as long as its
    kernels (the library's backward)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in prof.key_averages()
                   if "CUDA" in str(e.device_type))
    return total_us / 1e3 / iters


def compare(a, b, rtol) -> dict:
    """How far a is from b, in units of b's rms (at least RMS_FLOOR): the
    least atol_rms that passes at this rtol, and the Frobenius-relative
    error; and max |a - b| and max |b|."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    scale = (b.norm() / math.sqrt(b.numel())).clamp_min(RMS_FLOOR)
    return {
        "atol_rms": ((diff - rtol * b.abs()).max() / scale).clamp_min(0).item(),
        "frob": (diff.norm() / math.sqrt(b.numel()) / scale).item(),
        "max_abs": diff.max().item(),
        "plain_max": b.abs().max().item(),
    }


def demangle(text: str) -> str:
    """``text`` with its C++ symbols demangled by ``c++filt``, where the
    machine has it; else as it is."""
    try:
        return subprocess.run(["c++filt"], input=text, capture_output=True, text=True,
                              timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return text


def phase_device(build):
    t0 = time.perf_counter()
    build.build(["flash_attention", "bn_stats"])  # compiles what is not built, in parallel
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in ("flash_attention", "bn_stats"):
        log = build.library_path(name).with_suffix(".log")
        ptxas[name] = [
            line.strip() for line in demangle(log.read_text() if log.exists() else "").splitlines()
            if any(w in line for w in ("entry function", "registers", "spill", "warning"))
        ]
    emit({
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi(),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_s": build_s,
        "ptxas": ptxas,
    })


def make_case(b, sq, sk, hq, hk, d, dtype, seed, segments=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda s, h: torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)  # noqa: E731
    q, k, v, do = mk(sq, hq), mk(sk, hk), mk(sk, hk), mk(sq, hq)
    seg = None
    if segments:
        # three documents per row, boundaries differing by row
        pos = torch.arange(sq, device="cuda")[None, :]
        cut = torch.tensor([[sq // 3 + 7 * r, 2 * sq // 3 + 5 * r] for r in range(b)], device="cuda")
        seg = (pos >= cut[:, :1]).int() + (pos >= cut[:, 1:]).int() + 1
    return q, k, v, do, seg


def check_case(fa, name, case, causal, window=None):
    """Every kernel against its plain version on one input; returns errors."""
    q, k, v, do, seg = case
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    out, lse = fa.flash_forward(q, k, v, causal, None, window, seg)
    out_p, lse_p = fa.attention_plain(q, k, v, causal, None, window, seg)
    live = lse_p > fa.NEG_INF / 2
    delta = fa.row_delta(out_p, do)
    dq = fa.flash_dq(q, k, v, do, lse_p, delta, causal, None, window, seg)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_p, delta, causal, None, window, seg)
    dq_p = fa.dq_plain(q, k, v, do, lse_p, delta, causal, None, window, seg)
    dk_p, dv_p = fa.dkv_plain(q, k, v, do, lse_p, delta, causal, None, window, seg)
    torch.cuda.synchronize()
    tol = TOL[q.dtype]
    lse_ok = torch.equal(lse <= fa.NEG_INF / 2, ~live)
    lse_err = (lse[live] - lse_p[live]).abs().max().item() if live.any() else 0.0
    errs = {
        n: compare(x, y, tol["rtol"])
        for n, (x, y) in {"fwd": (out, out_p), "dq": (dq, dq_p),
                          "dk": (dk, dk_p), "dv": (dv, dv_p)}.items()
    }
    ok = (
        lse_ok
        and lse_err <= LSE_TOL
        and all(e["atol_rms"] <= tol["atol_rms"] and e["frob"] <= tol["frob"]
                for e in errs.values())
    )
    emit({"phase": "kernels", "case": name, "dtype": str(q.dtype), "causal": causal,
          "window": window, "segments": seg is not None, "err": errs, "lse_err": lse_err,
          "tol": tol, "lse_tol": LSE_TOL, "dead_rows_match": lse_ok, "ok": ok})
    if not ok:
        raise SystemExit(f"kernel check failed: {name}")
    return {"fwd": errs["fwd"]["max_abs"], "dq": errs["dq"]["max_abs"],
            "dkv": max(errs["dk"]["max_abs"], errs["dv"]["max_abs"])}


def bound(kind, b, sq, sk, hq, hk, d, n_live, elem):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and the
    products' FLOPs over the bf16 tensor-core peak, for these inputs."""
    qo = b * sq * hq * d * elem
    kv = b * sk * hk * d * elem
    rows = b * hq * sq * 4  # one fp32 per row (LSE or delta)
    matmuls = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2 * matmuls * n_live * d
    nbytes = {
        "fwd": qo + 2 * kv + qo + rows,  # q, k, v in; o, lse out
        "dq": 2 * qo + 2 * kv + 2 * rows + qo,  # q, do, k, v, lse, delta in; dq out
        "dkv": 2 * qo + 2 * kv + 2 * rows + 2 * kv,  # ... in; dk, dv out
    }[kind]
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# (name, shape, options) of the small cases, run in bf16 and in fp32
SMALL_CASES = [
    ("gqa_8_2", dict(b=2, sq=256, sk=256, hq=8, hk=2, d=128), dict(causal=True)),
    ("multibatch_6_3_d64", dict(b=3, sq=128, sk=128, hq=6, hk=3, d=64), dict(causal=False)),
    ("cross_sq128_sk256", dict(b=2, sq=128, sk=256, hq=4, hk=4, d=64), dict(causal=True)),
    ("dead_rows_sq256_sk128", dict(b=2, sq=256, sk=128, hq=4, hk=2, d=64), dict(causal=True)),
    ("window_100", dict(b=2, sq=384, sk=384, hq=4, hk=2, d=128), dict(causal=True, window=100)),
    ("window_1", dict(b=1, sq=128, sk=128, hq=2, hk=2, d=64), dict(causal=True, window=1)),
    ("ragged_sq200", dict(b=1, sq=200, sk=200, hq=2, hk=1, d=64), dict(causal=True)),
    # ViT-B/16's 197 tokens: no causal mask hides the columns past sk in
    # the last key tile, so the kernels mask them themselves
    ("ragged_sq197_noncausal", dict(b=2, sq=197, sk=197, hq=12, hk=12, d=64),
     dict(causal=False)),
]


def check_slice(fa):
    """The three kernels against their plain versions at the llama_1b
    training shape (bf16, causal); returns the case and each max |error|."""
    b, s, h, d = SLICE["b"], SLICE["s"], SLICE["h"], SLICE["d"]
    case = make_case(b, s, s, h, h, d, torch.bfloat16, seed=99)
    return case, check_case(fa, "llama_1b_slice", case, causal=True)


def phase_kernels(fa):
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, shape, opts) in enumerate(SMALL_CASES):
            check_case(fa, name, make_case(**shape, dtype=dtype, seed=i), **opts)
        seg_shape = dict(b=2, sq=256, sk=256, hq=4, hk=2, d=128)
        check_case(fa, "segments", make_case(**seg_shape, dtype=dtype, seed=10, segments=True),
                   causal=True)
        check_case(fa, "segments_window", make_case(**seg_shape, dtype=dtype, seed=11,
                                                    segments=True), causal=True, window=50)

    case, abs_errs = check_slice(fa)
    b, s, h, d = SLICE["b"], SLICE["s"], SLICE["h"], SLICE["d"]
    q, k, v, do, _ = case
    out_p, lse_p = fa.attention_plain(q, k, v, True)
    delta = fa.row_delta(out_p, do)
    n_live = b * h * s * (s + 1) // 2
    times = {
        "fwd": (lambda: fa.flash_forward(q, k, v, True),
                lambda: fa.attention_plain(q, k, v, True)),
        "dq": (lambda: fa.flash_dq(q, k, v, do, lse_p, delta, True),
               lambda: fa.dq_plain(q, k, v, do, lse_p, delta, True)),
        "dkv": (lambda: fa.flash_dkv(q, k, v, do, lse_p, delta, True),
                lambda: fa.dkv_plain(q, k, v, do, lse_p, delta, True)),
    }
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(qt, kt, vt, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dot)

    kept = sdpa(qt, kt, vt, is_causal=True)  # the backward alone runs on a kept forward

    def sdpa_bwd():
        torch.autograd.grad(kept, (qt, kt, vt), dot, retain_graph=True)

    # the library's backward computes dQ, dK and dV in one call: the
    # yardstick of B2 + B3 together, given to each of the two, as device
    # time (its host side takes ~0.2 ms a call, near its kernels' time)
    bwd_ms = device_ms(sdpa_bwd)
    library = {"fwd": time_ms(sdpa_fwd), "dq": bwd_ms, "dkv": bwd_ms}
    bwd_event_ms, fwd_bwd_ms = time_ms(sdpa_bwd), time_ms(sdpa_fwd_bwd)
    rows = {}
    for kind, (kern, plain) in times.items():
        k_ms, p_ms = time_ms(kern), time_ms(plain, iters=3, warmup=1)
        b_ms, by = bound(kind, b, s, s, h, h, d, n_live, 2)
        rows[kind] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                          library_ms=library[kind], max_abs_err=abs_errs[kind])
        emit({"phase": "kernels", "kernel": kind, "shape": SLICE, "dtype": "bfloat16",
              "causal": True, "kernel_ms": k_ms, "plain_ms": p_ms, "bound_us": b_ms * 1e3,
              "bound_by": by, "share_of_bound": b_ms / k_ms, "library_ms": library[kind],
              "library": "scaled_dot_product_attention "
                         + ("fwd" if kind == "fwd" else "bwd (device time)")})
    emit({"phase": "kernels", "kernel": "dq+dkv", "kernel_ms": rows["dq"]["ms"] + rows["dkv"]["ms"],
          "library_bwd_device_ms": bwd_ms, "library_bwd_event_ms": bwd_event_ms,
          "library_fwd_bwd_event_ms": fwd_bwd_ms,
          "bound_ms": rows["dq"]["bound_ms"] + rows["dkv"]["bound_ms"]})
    return rows


KINDS = (  # (kind, substrings of the kernel's name), first match wins
    ("flash", ("fwd_wgmma_kernel", "dq_wgmma_kernel", "dkv_wgmma_kernel", "::fwd_kernel",
               "::dq_kernel", "::dkv_kernel")),
    ("bn_stats", ("stats_partial_kernel", "stats_finalize_kernel")),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "implicit", "cudnn")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce_kernel",)),
    ("pool", ("pool",)),
)


def kind_of_kernel(name: str) -> str:
    lower = name.lower()
    for kind, marks in KINDS:
        if any(m.lower() in lower for m in marks):
            return kind
    return "other"


def profile_steps(run_step, n=2, model=None):
    """Device time of ``n`` calls of ``run_step()`` (one train step each)
    under torch.profiler, by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from tensorflowonspark_tpu_torch.compute.train import WEIGHT_UPDATE_SCOPE

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds, kernels, update_ms, aten_calls = {}, [], 0.0, 0
    for evt in prof.key_averages():
        if evt.key.startswith("aten::"):
            aten_calls += evt.count  # nested calls included: the host's dispatch count
        dev_us = getattr(evt, "self_device_time_total", 0) or 0
        if evt.key == WEIGHT_UPDATE_SCOPE:
            update_ms = (getattr(evt, "device_time_total", 0) or 0) / 1e3 / n
        elif evt.key.startswith("train."):
            continue  # a span's range (train.step#N): its device time is its kernels'
        elif dev_us > 0 and "CUDA" in str(evt.device_type):
            kind = kind_of_kernel(evt.key)
            kinds[kind] = kinds.get(kind, 0.0) + dev_us / 1e3 / n
            kernels.append((dev_us / 1e3 / n, evt.count // n, kind, evt.key[:90]))
    busy = sum(kinds.values())
    kernels.sort(reverse=True)
    line = {"phase": "profile", "model": model, "steps": n, "wall_ms_per_step": wall_ms / n,
          "device_busy_ms_per_step": busy, "device_idle_share": 1 - busy * n / wall_ms,
          "device_ms_by_kind": kinds, "weight_update_device_ms": update_ms,
          "aten_calls_per_step": aten_calls / n,
          "top_kernels": [dict(ms=k[0], launches=k[1], kind=k[2], name=k[3])
                          for k in kernels[:15]],
          "port_kernels": [dict(ms=k[0], launches=k[1], name=k[3]) for k in kernels
                           if k[2] in ("flash", "bn_stats")]}
    emit(line)
    return line


def phase_train(fa):
    from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step
    from tensorflowonspark_tpu_torch.models.llama import Llama, LlamaConfig, llama_loss_fn

    # small model: logits through the kernels against the plain attention path
    small = LlamaConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2, remat=False,
                             dtype=torch.float32, attention_impl="flash")
    m_flash = Llama(small, seed=1)
    m_xla = Llama(dataclasses.replace(small, attention_impl="xla"), seed=1)
    toks = torch.randint(0, small.vocab_size, (2, 256), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.no_grad():
        lf, lx = m_flash(toks), m_xla(toks)
    small_err = (lf - lx).abs().max().item()
    small_ok = bool(torch.isfinite(lf).all()) and lf.shape == (2, 256, small.vocab_size) \
        and small_err <= 1e-3
    emit({"phase": "train", "check": "tiny_logits_flash_vs_xla", "max_abs_err": small_err,
          "tol": 1e-3, "ok": small_ok})
    if not small_ok:
        raise SystemExit("small-model logits through the kernels disagree")
    del m_flash, m_xla

    b, seq, steps = 8, 1024, 5
    cfg = LlamaConfig.llama_1b(max_seq_len=seq, remat=False, attention_impl="auto")
    model = Llama(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    tx = adamw(1e-4, moment_dtype=torch.bfloat16)
    state = TrainState.create(dict(model.named_parameters()), tx)
    loss_fn = llama_loss_fn(model)
    step = build_train_step(lambda p, bt: loss_fn(p, bt["tokens"]), tx)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, seq + 1), device="cuda",
                                     generator=gen)}
    state, loss0 = step(state, batch)  # warm-up
    torch.cuda.synchronize()
    fa.reset_launches()
    losses = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    losses = [loss0.item()] + [x.item() for x in losses]
    step_s = dt / steps
    tokens = b * seq
    ok = (
        all(math.isfinite(x) for x in losses)
        and losses[-1] < losses[0]
        and all(n == cfg.num_layers * steps for n in launches.values())
    )
    emit({"phase": "train", "config": "llama_1b", "layers": cfg.num_layers,
          "hidden": cfg.hidden_size, "batch": b, "seq": seq, "n_params": n_params,
          "steps": steps, "losses": losses, "step_ms": step_s * 1e3,
          "tokens_per_s": tokens / step_s,
          "model_tflops_per_s": 6 * n_params * tokens / step_s / 1e12,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "expected_launches": cfg.num_layers * steps, "ok": ok})
    if not ok:
        raise SystemExit("train phase failed")

    def run_step():
        nonlocal state
        state, _ = step(state, batch)

    prof = profile_steps(run_step, model="llama_1b")
    return launches, step_s * 1e3, {"losses": losses, "profile": prof}


# where the bn and conv phases run (a CPU rehearsal at tiny sizes sets "cpu")
DEVICE = "cuda"


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# (rows, C, layers) of ResNet-50's BatchNorm inputs at batch 256, 224x224;
# phase conv_train checks it against the model
RESNET50_BN = [
    (3211264, 64, 1), (802816, 64, 6), (802816, 128, 1), (802816, 256, 4),
    (200704, 128, 7), (200704, 256, 1), (200704, 512, 5), (50176, 256, 11),
    (50176, 512, 1), (50176, 1024, 7), (12544, 512, 5), (12544, 2048, 4),
]
# Each per-channel sum of a bn kernel against its plain version:
# |a - b| <= rtol * sum|terms| + atol, sum|terms| in fp64 (the scale of a
# sum that may cancel). Both sides read the same values and sum in fp32 in
# different orders (the kernel's last pass over its row splits in fp64).
# The unchanged kernels read at most 3.7e-7 of sum|terms| (PERF.md, Findings);
# the limit sits 5x above, far below what a lost row split costs (1/splits).
BN_TOL = dict(rtol=2e-6, atol=1e-6)
# rows past the end of a ragged input hold this: a kernel that reads them
# is off by far more than BN_TOL allows
POISON = 100.0
# name, rows, C, dtype, elements the view starts into its buffer, poisoned rows after it
BN_EDGE_CASES = [
    ("stem_bf16", 3211264, 64, torch.bfloat16, 0, 0),
    ("ragged_bf16", 100003, 64, torch.bfloat16, 0, 2048),
    ("ragged_fp32", 100003, 256, torch.float32, 0, 2048),
    ("c4_scalar", 50001, 4, torch.bfloat16, 0, 2048),
    ("c65_scalar", 30011, 65, torch.bfloat16, 0, 2048),
    ("c600_bf16", 20011, 600, torch.bfloat16, 0, 2048),
    ("c600_fp32", 20011, 600, torch.float32, 0, 2048),
    ("misaligned_bf16", 100003, 64, torch.bfloat16, 1, 2048),
    ("stage4_fp32", 12544, 2048, torch.float32, 0, 0),
]
# fused_batch_norm, kernel route against xla route (bf16): compare() limits.
# The two routes share every rounding but the order of the fp32 sums and
# the derivation of sum(dy*xhat); readings: y exact, dx frob <= 1.3e-8,
# dgamma/dbeta frob <= 3.7e-7 (PERF.md, Findings).
BN_LAYER_TOL = dict(rtol=2**-7, atol_rms=1e-3, frob=1e-5)


def bn_inputs(rows, c, dtype, seed, offset=0, tail=0):
    """x ~ normal(0.5, 2) and dy ~ normal(0, 1), (rows, c) views on the card
    that start ``offset`` elements into their buffers and are followed by
    ``tail`` rows of POISON."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def make(mean, std):
        buf = torch.full(((rows + tail) * c + offset,), POISON, dtype=dtype, device=DEVICE)
        body = buf[offset:offset + rows * c]
        body.copy_(torch.randn(rows * c, generator=g, device=DEVICE).mul_(std).add_(mean))
        return body.view(rows, c)

    return make(0.5, 2.0), make(0.0, 1.0)


def check_bn_case(bn, name, x, dy):
    """Both statistics kernels against their plain versions on (x, dy);
    returns the largest |kernel - plain|."""
    got = dict(zip(("sum_x", "sum_xx"), bn.pair_stats(x)))
    got.update(zip(("sum_dy", "sum_dyx"), bn.cross_stats(dy, x)))
    want = dict(zip(("sum_x", "sum_xx"), bn.pair_stats_plain(x)))
    want.update(zip(("sum_dy", "sum_dyx"), bn.cross_stats_plain(dy, x)))
    x64, dy64 = x.double(), dy.double()
    scale = {"sum_x": x64.abs().sum(0), "sum_xx": (x64 * x64).sum(0),
             "sum_dy": dy64.abs().sum(0), "sum_dyx": (dy64 * x64).abs().sum(0)}
    del x64, dy64
    errs, ok = {}, True
    for k in got:
        diff = (got[k].double() - want[k].double()).abs()
        limit = BN_TOL["rtol"] * scale[k] + BN_TOL["atol"]
        errs[k] = {"rel": (diff / scale[k].clamp_min(1e-30)).max().item(),
                   "max_abs": diff.max().item(), "worst_over_limit": (diff / limit).max().item()}
        ok &= bool(torch.isfinite(got[k]).all()) and bool((diff <= limit).all())
    rows, c = x.shape
    vec = bn.vector_width((dy, x), c)
    tx, splits, per = bn.launch_geometry(rows, c, vec)
    emit({"phase": "bn_kernels", "case": name, "rows": rows, "C": c, "dtype": str(x.dtype),
          "vec": vec, "tx": tx, "splits": splits, "rows_per_split": per, "err": errs,
          "tol": BN_TOL, "ok": ok})
    if not ok:
        raise SystemExit(f"bn kernel check failed: {name}")
    return max(e["max_abs"] for e in errs.values())


def check_bn_edges(bn):
    """The statistics kernels at the edge cases (the check chip_faults.py runs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    for i, (name, rows, c, dtype, offset, tail) in enumerate(BN_EDGE_CASES):
        x, dy = bn_inputs(rows, c, dtype, seed=100 + i, offset=offset, tail=tail)
        worst = max(worst, check_bn_case(bn, name, x, dy))
        del x, dy
    return worst


def bn_bound(kind, rows, c, elem):
    """(bound_ms, bound_by): bytes (inputs once, two fp32 (C,) outputs) over
    HBM rate against 3 fp32 operations an element over the fp32 peak."""
    streams = 1 if kind == "pair" else 2
    t_bytes = (streams * rows * c * elem + 2 * c * 4) / H100_BYTES_PER_S
    t_ops = 3 * rows * c / H100_FP32_FLOPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def phase_bn_kernels(bn):
    """Edge cases, then the 12 ResNet-50 shapes in bf16: check and time
    each kernel; returns the per-step rows of the kernels line."""
    worst = check_bn_edges(bn)
    tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=worst)
           for k in ("pair", "cross")}
    for i, (rows, c, layers) in enumerate(RESNET50_BN):
        x, dy = bn_inputs(rows, c, torch.bfloat16, seed=i)
        err = check_bn_case(bn, f"resnet50_{rows}x{c}", x, dy)
        var, mean = torch.var_mean(x.float(), 0, correction=0)
        invstd = torch.rsqrt(var + 1e-5)
        fns = {
            "pair": (lambda: bn.pair_stats(x), lambda: bn.pair_stats_plain(x),
                     lambda: torch.batch_norm_stats(x, 1e-5)),
            "cross": (lambda: bn.cross_stats(dy, x), lambda: bn.cross_stats_plain(dy, x),
                      lambda: torch.batch_norm_backward_reduce(dy, x, mean, invstd, None,
                                                               True, False, False)),
        }
        line = {"phase": "bn_kernels", "shape": [rows, c], "layers": layers, "dtype": "bfloat16"}
        for kind, (kern, plain, lib) in fns.items():
            k_ms, p_ms, l_ms = time_ms(kern), time_ms(plain, iters=3, warmup=1), time_ms(lib)
            b_ms, by = bn_bound(kind, rows, c, 2)
            line[kind] = dict(kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                              bound_us=b_ms * 1e3, bound_by=by, share_of_bound=b_ms / k_ms)
            t = tot[kind]
            t["ms"] += layers * k_ms
            t["plain_ms"] += layers * p_ms
            t["library_ms"] += layers * l_ms
            t["bound_ms"] += layers * b_ms
            t["bound_by"] = by
            t["max_abs_err"] = max(t["max_abs_err"], err)
        emit(line)
        del x, dy
    emit({"phase": "bn_kernels", "per_resnet50_step": tot,
          "library": "torch.batch_norm_stats / torch.batch_norm_backward_reduce"})
    return tot


def phase_bn_layer():
    """fused_batch_norm, kernel route against xla route, forward and backward."""
    from tensorflowonspark_tpu_torch.ops.batch_norm import fused_batch_norm

    for name, shape in (("stem", (256, 112, 112, 64)), ("stage4", (256, 7, 7, 2048))):
        g = torch.Generator(device=DEVICE).manual_seed(7)
        c = shape[-1]
        x = (torch.randn(shape, generator=g, device=DEVICE) * 2 + 0.5).bfloat16()
        gamma = torch.randn(c, generator=g, device=DEVICE) * 0.3 + 1
        beta = torch.randn(c, generator=g, device=DEVICE)
        t = torch.randn(shape, generator=g, device=DEVICE).bfloat16()
        outs = {}
        for impl in ("kernel", "xla"):
            xi, gi, bi = (v.clone().requires_grad_() for v in (x, gamma, beta))
            y = fused_batch_norm(xi, gi, bi, 1e-5, impl=impl)
            y.backward(t)
            outs[impl] = {"y": y.detach(), "dx": xi.grad, "dgamma": gi.grad, "dbeta": bi.grad}
        sync()
        errs = {k: compare(outs["kernel"][k], outs["xla"][k], BN_LAYER_TOL["rtol"])
                for k in outs["kernel"]}
        ok = all(e["atol_rms"] <= BN_LAYER_TOL["atol_rms"] and e["frob"] <= BN_LAYER_TOL["frob"]
                 for e in errs.values())
        emit({"phase": "bn_layer", "case": name, "shape": list(shape), "dtype": "bfloat16",
              "err": errs, "tol": BN_LAYER_TOL, "ok": ok})
        if not ok:
            raise SystemExit(f"bn layer check failed: {name}")
        del outs, x, t


def conv_shapes(model, size):
    """(BatchNorm (rows per image, C) in call order, forward MACs per image)
    from one no-grad forward of one image, read off the model's layers."""
    from tensorflowonspark_tpu_torch.models.conv import Conv, Dense
    from tensorflowonspark_tpu_torch.ops.batch_norm import FusedBatchNorm

    bn_shapes, macs, hooks = [], [0], []

    def on_conv(mod, inp, out):
        macs[0] += out[0].numel() * mod.weight[0].numel()

    def on_dense(mod, inp, out):
        macs[0] += mod.weight.numel()

    def on_bn(mod, inp, out):
        bn_shapes.append((inp[0].numel() // inp[0].shape[-1], inp[0].shape[-1]))

    for mod in model.modules():
        hook = {Conv: on_conv, Dense: on_dense, FusedBatchNorm: on_bn}.get(type(mod))
        if hook is not None:
            hooks.append(mod.register_forward_hook(hook))
    with torch.no_grad():
        model(torch.zeros(1, size, size, 3, device=DEVICE), train=True)
    for h in hooks:
        h.remove()
    from tensorflowonspark_tpu_torch.ops.batch_norm import pop_batch_stats

    pop_batch_stats(model)
    return bn_shapes, macs[0]


def image_batch(n, size, classes, seed=0):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return {"image": torch.randn(n, size, size, 3, generator=g, device=DEVICE),
            "label": torch.randint(0, classes, (n,), generator=g, device=DEVICE)}


class ConvRun:
    """One conv net, its SGD state and batch: ``steps(n)`` runs n train steps."""

    def __init__(self, model, loss_fn, batch):
        from tensorflowonspark_tpu_torch.compute import TrainState, build_bn_train_step, sgd

        self.model, self.batch = model, batch
        self.tx = sgd(0.1, momentum=0.9)
        self.step = build_bn_train_step(loss_fn, self.tx, device=DEVICE)
        self.init = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.stats0 = {n: b.clone() for n, b in model.named_buffers()}
        self._make_state = lambda: TrainState.create(model.named_parameters(), self.tx)
        self.reset()

    def reset(self):
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(self.init[n])
        self.state = self._make_state()
        self.stats = {n: b.clone() for n, b in self.stats0.items()}

    def advance(self):
        self.state, self.stats, loss = self.step(self.state, self.stats, self.batch)
        return loss

    def steps(self, n):
        """Losses and wall ms per step of n steps ending in a synchronize."""
        sync()
        t0 = time.perf_counter()
        losses = [self.advance() for _ in range(n)]
        sync()
        return [x.item() for x in losses], (time.perf_counter() - t0) * 1e3 / n


def phase_conv_train(bn):
    from tensorflowonspark_tpu_torch.models import inception, resnet, vgg
    from tensorflowonspark_tpu_torch.ops.batch_norm import FusedBatchNorm, set_impl

    b, size, steps = 256, 224, 5
    cfg = resnet.ResNetConfig.resnet50()
    model = resnet.ResNet(cfg, device=DEVICE, seed=0)
    shapes, macs = conv_shapes(model, size)
    distinct = {}
    for rows, c in shapes:
        distinct[(rows * b, c)] = distinct.get((rows * b, c), 0) + 1
    shapes_ok = sorted((r, c, n) for (r, c), n in distinct.items()) == sorted(RESNET50_BN)
    run = ConvRun(model, resnet.loss_fn(model), image_batch(b, size, cfg.num_classes))
    n_params = sum(p.numel() for p in model.parameters())
    flop_per_step = 2 * 3 * macs * b  # 2 FLOP per MAC; backward twice the forward

    # the main path: BatchNorm 'auto', i.e. the kernels
    loss0, _ = run.steps(1)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    bn.reset_launches()
    losses, step_ms = run.steps(steps)
    launches = dict(bn.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = loss0 + losses
    # the A/B: the same steps from the same weights with 'xla' statistics,
    # then in turns (kernel, xla, xla, kernel)
    set_impl(model, "xla")
    run.reset()
    x_loss0, _ = run.steps(1)
    x_losses, x_ms = run.steps(steps)
    x_losses = x_loss0 + x_losses
    _, x_ms2 = run.steps(steps)
    set_impl(model, "auto")
    _, k_ms2 = run.steps(steps)
    want = [steps * len(shapes)] * 2
    ok = (shapes_ok and all(math.isfinite(v) for v in losses + x_losses)
          and losses[-1] < losses[0] and [launches["pair"], launches["cross"]] == want
          and abs(losses[0] - x_losses[0]) <= 1e-2 * abs(x_losses[0]))
    emit({"phase": "conv_train", "config": "resnet50", "batch": b, "image": size,
          "n_params": n_params, "bn_layers": len(shapes), "bn_shapes_match": shapes_ok,
          "gmac_per_image": macs / 1e9, "steps": steps, "losses": losses,
          "step_ms": step_ms, "images_per_s": b / step_ms * 1e3,
          "model_tflops_per_s": flop_per_step / step_ms / 1e9,
          "peak_mem_gb": peak_gb, "launches": launches, "expected_launches": want[0],
          "ab": {"kernel_step_ms": [step_ms, k_ms2], "xla_step_ms": [x_ms, x_ms2],
                 "xla_losses": x_losses,
                 "max_rel_loss_gap": max(abs(a - c) / abs(c) for a, c in zip(losses, x_losses))},
          "ok": ok})
    if not ok:
        raise SystemExit("conv_train failed: resnet50")
    main_launches = launches
    main_losses = losses
    profile_steps(run.advance, model="resnet50")
    del run, model
    torch.cuda.empty_cache()

    for name, build, size, make_loss in (
        ("inception_v3", lambda: inception.InceptionV3(inception.InceptionConfig.v3(), DEVICE, seed=0),
         299, inception.loss_fn),
        ("vgg16", lambda: vgg.VGG(vgg.VGGConfig.vgg16(), DEVICE, seed=0), 224, vgg.loss_fn),
    ):
        model = build()
        n_bn = sum(isinstance(m, FusedBatchNorm) for m in model.modules())
        run = ConvRun(model, make_loss(model), image_batch(32, size, 1000, seed=1))
        loss0, _ = run.steps(1)
        bn.reset_launches()
        loss1, ms = run.steps(1)
        launches = dict(bn.LAUNCHES)
        ok = (all(math.isfinite(v) for v in loss0 + loss1)
              and [launches["pair"], launches["cross"]] == [n_bn, n_bn])
        emit({"phase": "conv_train", "config": name, "batch": 32, "image": size,
              "losses": loss0 + loss1, "step_ms": ms, "images_per_s": 32 / ms * 1e3,
              "bn_layers": n_bn, "launches": launches, "ok": ok})
        if not ok:
            raise SystemExit(f"conv_train failed: {name}")
        del run, model
        torch.cuda.empty_cache()
    return main_launches, main_losses


# phase cluster: batch, sequence, batches pulled while the copy stream is
# held back, timed steps, prefetch depth, learning rate; the hold is a sleep
# of this many clock cycles on the copy stream (~1 s on an H100)
CLUSTER = dict(batch=8, seq=1024, stress=30, steps=5, depth=8, lr=1e-4,
               hold_cycles=2_000_000_000)


def cluster_batches(c: dict) -> int:
    """Batches the node pulls: one per staging slot (depth + 2) before the
    hold, the held ones, a warm-up, the timed steps and the next step."""
    return c["depth"] + 2 + c["stress"] + 1 + c["steps"] + 1


def cluster_rows(n_rows: int, seq: int, vocab: int, seed: int = 0) -> list:
    """Token rows (seq + 1 int32 each) as feed records, from ``seed``: ids
    drawn Zipf-distributed, as the tokens of text are, so that the loss
    falls over a few steps of fresh batches."""
    rng = np.random.default_rng(seed)
    toks = np.minimum(rng.zipf(1.2, size=(n_rows, seq + 1)), vocab) - 1
    return [(row,) for row in toks.astype(np.int32)]


def state_tensors(state) -> dict:
    """Every tensor of a TrainState of ``adamw`` (params, moments, count)."""
    adam = state.opt_state[0]
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"mu/{k}": v for k, v in adam.mu.items()})
    out.update({f"nu/{k}": v for k, v in adam.nu.items()})
    out["count"] = adam.count
    return out


def cluster_node(args, ctx):
    """map_fun of phase cluster, run in the node process that
    ``tfcluster.run`` spawns (module level, so spawn pickles it by name)."""
    from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step
    from tensorflowonspark_tpu_torch.compute.checkpoint import (
        CheckpointManager, chief_final_save, restore_latest)
    from tensorflowonspark_tpu_torch.feed.prefetch import DevicePrefetcher
    from tensorflowonspark_tpu_torch.models.llama import Llama, LlamaConfig, llama_loss_fn
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    c = {**CLUSTER, **args.get("sizes", {})}
    device = ctx.device  # set by initialize_distributed: cuda:0 and NCCL (or the CPU, gloo)
    cuda = device.type == "cuda"
    if args.get("tiny"):  # the CPU rehearsal
        cfg = LlamaConfig.tiny(max_seq_len=c["seq"], remat=False, dtype=torch.float32)
    else:
        cfg = LlamaConfig.llama_1b(max_seq_len=c["seq"], remat=False, attention_impl="auto",
                                   num_layers=args["layers"])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def trainer(seed):
        model = Llama(cfg, device=device, seed=seed)
        tx = adamw(c["lr"], moment_dtype=torch.bfloat16)
        loss_fn = llama_loss_fn(model)
        step = build_train_step(lambda p, b: loss_fn(p, b["tokens"]), tx, device=device)
        return model, TrainState.create(dict(model.named_parameters()), tx), step

    model, state, step = trainer(0)
    n_params = sum(p.numel() for p in model.parameters())
    host_sums, dev_sums = [], []

    def host_checksum(cols):  # producer thread, before staging
        host_sums.append(int(cols["tokens"].sum(dtype=np.int64)))
        return cols

    def pull(pf):
        batch = next(pf)
        dev_sums.append(batch["tokens"].sum(dtype=torch.int64))
        return batch

    copy_stream = torch.cuda.Stream(device) if cuda else None
    feed = ctx.get_data_feed(input_mapping={"tokens": "tokens"})
    pf = DevicePrefetcher.from_feed(feed, c["batch"], depth=c["depth"], device=device,
                                    copy_stream=copy_stream, prepare=host_checksum)
    # one batch per staging slot first: the first batches allocate the
    # pinned slots and the device memory of the copies, and an allocation
    # can wait for the device, which would hold the producer back with the
    # copies. Then the copy stream is held and the loop turns input-bound
    # (no host sync), so the producer reuses slots whose copies are pending
    for _ in range(c["depth"] + 2):
        pull(pf)
    sync()
    if cuda:
        with torch.cuda.stream(copy_stream):
            torch.cuda._sleep(c["hold_cycles"])
    for _ in range(c["stress"]):
        pull(pf)
    state, loss0 = step(state, pull(pf))  # warm-up
    sync()
    before = pf.stats()
    fa.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(c["steps"]):
        state, loss = step(state, pull(pf))
        losses.append(loss)
    sync()
    dt = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    after = pf.stats()
    nxt = pull(pf)
    sync()
    pf.close()
    stats = pf.stats()
    dev_sums = [int(x) for x in dev_sums]
    bad_batches = [i for i, (h, d) in enumerate(zip(host_sums, dev_sums)) if h != d]

    # checkpoint: async save, then the next step updates the params in place
    # while the file is written
    saved_step = state.step
    saved = {k: v.detach().to("cpu", copy=True) for k, v in state_tensors(state).items()}
    ckpt_dir = tempfile.mkdtemp(prefix="tfos_ckpt_")
    free_gb = shutil.disk_usage(ckpt_dir).free / 1e9
    print(f"node{ctx.executor_id}: checkpoint dir {ckpt_dir}, {free_gb:.1f} GB free", flush=True)
    mgr = CheckpointManager(ckpt_dir, async_save=True)
    t1 = time.perf_counter()
    mgr.save(saved_step, state)
    save_return_s = time.perf_counter() - t1
    state, next_loss = step(state, nxt)
    next_loss = next_loss.item()
    chief_final_save(mgr, state, saved_step, ctx.is_chief)  # waits; the step has landed
    timing = dict(mgr.last_save)
    step_dir = mgr.step_path(saved_step)
    ckpt_gb = sum(f.stat().st_size for f in os.scandir(step_dir)) / 1e9
    del state, model, step
    if cuda:
        torch.cuda.empty_cache()

    model2, fresh, step2 = trainer(1)
    t2 = time.perf_counter()
    got_step, restored = restore_latest(CheckpointManager(ckpt_dir), fresh)
    sync()
    restore_s = time.perf_counter() - t2
    unequal = [k for k, v in state_tensors(restored).items()
               if v.dtype != saved[k].dtype or not torch.equal(v.cpu(), saved[k])]
    _, restored_loss = step2(restored, nxt)
    restored_loss = restored_loss.item()
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    step_s = dt / c["steps"]
    tokens = c["batch"] * c["seq"]
    result = {
        "layers": cfg.num_layers, "hidden": cfg.hidden_size, "batch": c["batch"],
        "seq": c["seq"], "n_params": n_params, "device": str(device),
        "backend": torch.distributed.get_backend(), "world": torch.distributed.get_world_size(),
        "losses": [loss0.item()] + [x.item() for x in losses],
        "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "model_tflops_per_s": 6 * n_params * tokens / step_s / 1e12,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        "launches": launches, "launches_per_step": {k: v / c["steps"] for k, v in launches.items()},
        "prefetch": {**stats, "wait_ms_per_timed_step":
                     (after["data_wait_s"] - before["data_wait_s"]) / c["steps"] * 1e3,
                     "transfer_ms_per_batch": stats["transfer_s"] / max(stats["transferred"], 1) * 1e3},
        "batches_checked": len(dev_sums), "host_sums": len(host_sums), "bad_batches": bad_batches,
        "checkpoint": {"gb": ckpt_gb, "free_gb_before": free_gb, "save_return_s": save_return_s,
                       **timing, "restore_s": restore_s, "saved_step": saved_step,
                       "restored_step": got_step, "restored_state_step": restored.step,
                       "tensors": len(saved), "unequal": unequal[:10], "n_unequal": len(unequal)},
        "next_loss_saved": next_loss, "next_loss_restored": restored_loss,
    }
    with open(os.path.join(args["out_dir"], f"node{ctx.executor_id}.json"), "w") as f:
        json.dump(result, f)


def phase_cluster(train_step_ms=None, layers=16, rehearse=None):
    """The node runtime end to end (see the module docstring, phase 7);
    raises SystemExit when a check fails or the node failed. ``layers``
    cuts the depth (chip_faults.py); ``rehearse`` (node args: ``tiny``,
    ``sizes``, ``device="cpu"``) runs it at a tiny size on the CPU."""
    from tensorflowonspark_tpu_torch.cluster import tfcluster
    from tensorflowonspark_tpu_torch.cluster.tfcluster import InputMode

    args = {"layers": layers, "device": "cuda", **(rehearse or {})}
    cuda = args["device"] == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        emit({"phase": "cluster", "parent_memory_reserved_gb": torch.cuda.memory_reserved() / 1e9})
    c = {**CLUSTER, **args.get("sizes", {})}
    n_batches = cluster_batches(c)
    rows = cluster_rows(n_batches * c["batch"], c["seq"], c.get("vocab", 32000))
    out_dir = tempfile.mkdtemp(prefix="tfos_cluster_")
    args["out_dir"] = out_dir
    t0 = time.perf_counter()
    cluster = tfcluster.run(cluster_node, args, num_executors=1, input_mode=InputMode.SPARK,
                            distributed=True, reservation_timeout=600,
                            env=None if cuda else {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
    cluster.train(tfcluster.contiguous_split(rows, 4), feed_timeout=600, close_feed=True)
    cluster.shutdown(timeout=900)  # raises with the node's traceback if it failed
    wall_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, "node0.json")) as f:
        r = json.load(f)
    shutil.rmtree(out_dir, ignore_errors=True)
    ck = r["checkpoint"]
    want_launches = r["layers"] if cuda else 0  # CPU tensors take the plain versions
    err = {
        "bad_batches": len(r["bad_batches"]),
        "batches_checked": r["batches_checked"],
        "launches_per_step": r["launches_per_step"],
        "restored_unequal": ck["n_unequal"],
        "step_agrees": ck["restored_step"] == ck["saved_step"] == ck["restored_state_step"],
        "next_loss_gap": abs(r["next_loss_saved"] - r["next_loss_restored"]),
        "losses_fall": r["losses"][-1] < r["losses"][0],
    }
    ok = (
        err["bad_batches"] == 0 and r["batches_checked"] == n_batches == r["host_sums"]
        and all(v == want_launches for v in r["launches_per_step"].values())
        and sorted(r["launches_per_step"]) == ["dkv", "dq", "fwd"]
        and err["restored_unequal"] == 0 and err["step_agrees"] and err["next_loss_gap"] == 0.0
        and err["losses_fall"] and all(math.isfinite(x) for x in r["losses"])
        and r["backend"] == ("nccl" if cuda else "gloo") and r["world"] == 1
    )
    emit({"phase": "cluster", **r, "train_phase_step_ms": train_step_ms, "wall_s": wall_s,
          "nvidia_smi": nvidia_smi() if cuda else None})
    emit({"phase": "cluster", "case": "cluster_checks", "err": err,
          "tol": {"bad_batches": 0, "launches_per_step": want_launches, "restored_unequal": 0,
                  "next_loss_gap": 0.0}, "ok": ok})
    if not ok:
        raise SystemExit("cluster phase failed")


# phase mesh: llama_1b and ResNet-50 through the mesh step, the weight update
# alone, and a node that trains on its mesh and restores a sharded checkpoint
MESH = dict(batch=8, seq=1024, steps=5, lr=1e-4, update_calls=10, conv_batch=256,
            conv_steps=3, depth=4)
# The mesh step at world 1 against phase train's plain step on the same
# weights and batch: both run the same kernels and products on the same
# values (DTensor at extent 1 moves nothing; 'dots' recomputes what it drops
# with the same deterministic kernels). Both the llama and the ResNet-50
# losses read equal to the last bit on the H100 (PERF.md, Findings); the
# limit leaves room only for another choice of library kernel.
MESH_LOSS_RTOL = 1e-5


def mesh_llama(cfg, mesh, seed, lr, device):
    """A Llama of ``cfg`` from ``seed`` on ``mesh`` through the port's mesh
    path: the 'llama' table's placements, ``shard_state`` (ZeRO, the params
    put into the model) and the mesh ``build_train_step``."""
    from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step
    from tensorflowonspark_tpu_torch.compute.train import shard_state
    from tensorflowonspark_tpu_torch.models.llama import (Llama, llama_loss_fn,
                                                          llama_param_shardings)

    model = Llama(cfg, device=device, seed=seed)
    psh = llama_param_shardings(dict(model.named_parameters()), mesh)
    tx = adamw(lr, moment_dtype=torch.bfloat16)
    state = shard_state(TrainState.create(model.named_parameters(), tx), mesh, psh,
                        zero_sharding=True, module=model)
    loss_fn = llama_loss_fn(model)
    step = build_train_step(lambda p, b: loss_fn(p, b["tokens"]), tx, mesh, psh,
                            zero_sharding=True)
    return model, psh, tx, state, step


def mesh_cfg(layers, tiny, seq):
    from tensorflowonspark_tpu_torch.models.llama import LlamaConfig

    if tiny:  # the CPU rehearsal: plain versions of the kernels, fp32
        return LlamaConfig.tiny(max_seq_len=seq, remat=True, remat_policy="dots",
                                dtype=torch.float32, attention_impl="flash")
    return LlamaConfig.llama_1b(max_seq_len=seq, remat=True, remat_policy="dots",
                                attention_impl="auto", num_layers=layers)


def full(t):
    """A DTensor gathered whole, on the host."""
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().to("cpu", copy=True)


def mesh_check(name, err, tol, ok):
    emit({"phase": "mesh", "case": name, "err": err, "tol": tol, "ok": ok})
    if not ok:
        raise SystemExit(f"mesh phase failed: {name}")


def phase_mesh(fa, bn, ref=None, layers=16, conv_batch=None, rehearse=None, node_layers=None):
    """The mesh path on one card, a world of one (see the module docstring,
    phase 8); raises SystemExit when a check fails. ``ref`` holds phase
    train's and phase conv_train's losses and profile to compare with;
    ``layers`` and ``conv_batch`` cut the sizes (chip_faults.py),
    ``node_layers`` the node's depth alone (``layers`` when None);
    ``rehearse`` (``sizes``, ``device="cpu"``) runs it at a tiny size on the
    CPU, where the wrappers take their plain versions."""
    import torch.distributed as dist

    rehearse = rehearse or {}
    owns_group = not dist.is_initialized()
    try:
        return _phase_mesh(fa, bn, ref, layers, conv_batch, rehearse,
                           layers if node_layers is None else node_layers)
    finally:  # a group this phase started ends with it, failed or not
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _phase_mesh(fa, bn, ref, layers, conv_batch, rehearse, node_layers):
    from tensorflowonspark_tpu_torch.compute.mesh import make_mesh, shard_batch
    from tensorflowonspark_tpu_torch.compute.train import build_update_step, place
    from tensorflowonspark_tpu_torch.parallel.context import MESH_ROUTES, reset_mesh_routes

    c = {**MESH, **rehearse.get("sizes", {})}
    device = rehearse.get("device", "cuda")
    cuda = device == "cuda"
    mesh = make_mesh(device_type=device)
    group = torch.distributed
    result = {"world": group.get_world_size(), "backend": group.get_backend(),
              "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}

    # 1. llama through the mesh step
    cfg = mesh_cfg(layers, not cuda, c["seq"])
    model, psh, tx, state, step = mesh_llama(cfg, mesh, 0, c["lr"], device)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=device).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (c["batch"], c["seq"] + 1),
                                     device=device, generator=gen)}
    batch = shard_batch(mesh, batch)
    state, loss0 = step(state, batch)  # warm-up
    sync_on(cuda)
    fa.reset_launches()
    reset_mesh_routes()
    losses, dispatch = [], []
    t0 = time.perf_counter()
    for _ in range(c["steps"]):
        t1 = time.perf_counter()
        state, loss = step(state, batch)
        dispatch.append(time.perf_counter() - t1)
        losses.append(loss)
    sync_on(cuda)
    step_ms = (time.perf_counter() - t0) / c["steps"] * 1e3
    launches = dict(fa.LAUNCHES)
    routes = dict(MESH_ROUTES)
    losses = [loss0.item()] + [x.item() for x in losses]
    per_step = {k: v / c["steps"] for k, v in launches.items()}
    want = {"fwd": 2 * cfg.num_layers, "dq": cfg.num_layers, "dkv": cfg.num_layers} if cuda \
        else {"fwd": 0, "dq": 0, "dkv": 0}
    ref_losses = (ref or {}).get("train_losses")
    gap = None if ref_losses is None else max(
        abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    emit({"phase": "mesh", "part": "llama", "config": "llama_1b" if cuda else "tiny",
          "layers": cfg.num_layers, "remat_policy": cfg.remat_policy, "batch": c["batch"],
          "seq": c["seq"], "n_params": n_params, **result, "steps": c["steps"],
          "losses": losses, "train_phase_losses": ref_losses, "max_rel_loss_gap": gap,
          "step_ms": step_ms, "train_phase_step_ms": (ref or {}).get("train_step_ms"),
          "dispatch_ms_per_step": sum(dispatch) / len(dispatch) * 1e3,
          "tokens_per_s": c["batch"] * c["seq"] / step_ms * 1e3,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
          "launches": launches, "launches_per_step": per_step, "mesh_routes": routes})
    mesh_check("llama_mesh_step", {"launches_per_step": per_step, "attention_routes":
                                   routes["attention"], "max_rel_loss_gap": gap},
               {"launches_per_step": want, "max_rel_loss_gap": MESH_LOSS_RTOL},
               # the route runs in the forward and again in the 'dots' recompute
               per_step == want and routes["attention"] == 2 * cfg.num_layers * c["steps"]
               and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
               and (gap is None or gap <= MESH_LOSS_RTOL))
    flash_mesh_launches = launches
    if cuda:
        def run_step():
            nonlocal state
            state, _ = step(state, batch)

        prof = profile_steps(run_step, model="llama_1b_mesh")
        train_prof = (ref or {}).get("train_profile") or {}
        keys = ("wall_ms_per_step", "device_busy_ms_per_step", "device_idle_share")
        emit({"phase": "mesh", "part": "llama_profile", **{k: prof[k] for k in keys},
              "host_exposed_ms_per_step": prof[keys[0]] - prof[keys[1]],
              "train_phase": {k: train_prof.get(k) for k in keys}})

    # 2. the weight update alone, on fixed gradients
    upd = build_update_step(tx, mesh, psh, zero_sharding=True)
    g = torch.Generator(device=device).manual_seed(3)
    grads = {n: place(torch.randn(p.shape, generator=g, device=device) * 1e-3, psh[n])
             for n, p in state.params.items()}
    held = {"state": state}

    def update():
        held["state"] = upd(held["state"], grads)

    if cuda:
        upd_ms = time_ms(update, iters=c["update_calls"])
        upd_dev_ms = device_ms(update, iters=c["update_calls"])
    else:
        for _ in range(2):
            update()
        upd_ms = upd_dev_ms = None
    emit({"phase": "mesh", "part": "update_step", "calls": c["update_calls"], "ms": upd_ms,
          "device_ms": upd_dev_ms, "n_params": n_params})
    del model, state, step, held, grads, upd, batch
    if cuda:
        torch.cuda.empty_cache()

    # 3. ResNet-50 through the mesh step
    bn_mesh_launches = phase_mesh_conv(bn, mesh, ref, conv_batch or c["conv_batch"], c, cuda)

    # 4. a node trains on its mesh and restores a sharded checkpoint
    phase_mesh_node(node_layers, rehearse)
    return flash_mesh_launches, bn_mesh_launches


def sync_on(cuda):
    if cuda:
        torch.cuda.synchronize()


def phase_mesh_conv(bn, mesh, ref, b, c, cuda):
    """ResNet-50 (a tiny ResNet in the rehearsal) through the mesh BN step:
    the 'resnet' table's placements, BatchNorm auto, the statistics through
    the mesh route."""
    from tensorflowonspark_tpu_torch.compute import TrainState, sgd
    from tensorflowonspark_tpu_torch.compute.train import build_bn_train_step, shard_state
    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.ops.batch_norm import FusedBatchNorm, set_impl
    from tensorflowonspark_tpu_torch.parallel.context import MESH_ROUTES, reset_mesh_routes

    device = "cuda" if cuda else "cpu"
    cfg = resnet.ResNetConfig.resnet50() if cuda else resnet.ResNetConfig.tiny(dtype=torch.float32)
    size = 224 if cuda else 32
    model = resnet.ResNet(cfg, device=device, seed=0)
    if not cuda:
        set_impl(model, "kernel")  # the mesh route with the plain versions
    n_bn = sum(isinstance(m, FusedBatchNorm) for m in model.modules())
    tx = sgd(0.1, momentum=0.9)
    psh = resnet.resnet_param_shardings(dict(model.named_parameters()), mesh)
    state = shard_state(TrainState.create(model.named_parameters(), tx), mesh, psh, module=model)
    step = build_bn_train_step(resnet.loss_fn(model), tx, mesh, psh)
    stats = {n: t.clone() for n, t in model.named_buffers()}
    g = torch.Generator(device=device).manual_seed(0)
    batch = {"image": torch.randn(b, size, size, 3, generator=g, device=device),
             "label": torch.randint(0, cfg.num_classes, (b,), generator=g, device=device)}
    state, stats, loss0 = step(state, stats, batch)  # warm-up
    sync_on(cuda)
    bn.reset_launches()
    reset_mesh_routes()
    t0 = time.perf_counter()
    losses = []
    for _ in range(c["conv_steps"]):
        state, stats, loss = step(state, stats, batch)
        losses.append(loss)
    sync_on(cuda)
    step_ms = (time.perf_counter() - t0) / c["conv_steps"] * 1e3
    launches, routes = dict(bn.LAUNCHES), dict(MESH_ROUTES)
    losses = [loss0.item()] + [x.item() for x in losses]
    ref_losses = (ref or {}).get("conv_losses") if b == MESH["conv_batch"] else None
    gap = None if ref_losses is None else max(
        abs(x - y) / abs(y) for x, y in zip(losses, ref_losses))
    want = n_bn * c["conv_steps"]
    emit({"phase": "mesh", "part": "resnet", "config": "resnet50" if cuda else "tiny",
          "batch": b, "image": size, "steps": c["conv_steps"], "losses": losses,
          "conv_train_phase_losses": ref_losses, "max_rel_loss_gap": gap, "step_ms": step_ms,
          "images_per_s": b / step_ms * 1e3, "bn_layers": n_bn, "launches": launches,
          "mesh_routes": routes})
    mesh_check("resnet_mesh_step",
               {"launches": launches, "bn_routes": [routes["bn_pair"], routes["bn_cross"]],
                "max_rel_loss_gap": gap},
               {"launches": want if cuda else 0, "bn_routes": want,
                "max_rel_loss_gap": MESH_LOSS_RTOL},
               [launches["pair"], launches["cross"]] == ([want] * 2 if cuda else [0, 0])
               and [routes["bn_pair"], routes["bn_cross"]] == [want] * 2
               and all(math.isfinite(x) for x in losses)
               and (gap is None or gap <= MESH_LOSS_RTOL))
    del model, state, step, stats, batch
    if cuda:
        torch.cuda.empty_cache()
    return launches


def mesh_node(args, ctx):
    """map_fun of phase mesh's node (module level, so spawn pickles it by
    name): the example's mesh path, fed through the prefetcher."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.compute.checkpoint import (
        CheckpointManager, chief_final_save, restore_latest)
    from tensorflowonspark_tpu_torch.feed.prefetch import DevicePrefetcher
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    c = {**MESH, **args.get("sizes", {})}
    device = ctx.device
    cuda = device.type == "cuda"
    cfg = mesh_cfg(args["layers"], not cuda, c["seq"])
    mesh = ctx.mesh()
    model, _, _, state, step = mesh_llama(cfg, mesh, 0, c["lr"], device.type)
    host_sums, dev_sums = [], []

    def host_checksum(cols):  # producer thread, before staging
        host_sums.append(int(cols["tokens"].sum(dtype=np.int64)))
        return cols

    def pull(pf):
        batch = next(pf)
        dev_sums.append(batch["tokens"].to_local().sum(dtype=torch.int64))
        return batch

    feed = ctx.get_data_feed(input_mapping={"tokens": "tokens"})
    pf = DevicePrefetcher.from_feed(feed, c["batch"], mesh=mesh, depth=c["depth"],
                                    prepare=host_checksum)
    state, loss0 = step(state, pull(pf))  # warm-up
    sync_on(cuda)
    fa.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(c["steps"]):
        state, loss = step(state, pull(pf))
        losses.append(loss)
    sync_on(cuda)
    dt = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    nxt = pull(pf)
    sync_on(cuda)
    pf.close()
    dev_sums = [int(x) for x in dev_sums]

    saved_step = state.step
    t1 = time.perf_counter()
    saved = {k: full(v) for k, v in state_tensors(state).items()}
    snapshot_s = time.perf_counter() - t1
    ckpt_dir = tempfile.mkdtemp(prefix="tfos_mesh_ckpt_")
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(saved_step, state)
    timing = dict(mgr.last_save)
    state, next_loss = step(state, nxt)
    next_loss = next_loss.item()
    chief_final_save(mgr, state, saved_step, ctx.is_chief)
    ckpt_gb = sum(f.stat().st_size for f in os.scandir(mgr.step_path(saved_step))) / 1e9
    del state, model, step
    if cuda:
        torch.cuda.empty_cache()

    model2, _, _, fresh, step2 = mesh_llama(cfg, mesh, 1, c["lr"], device.type)
    t2 = time.perf_counter()
    got_step, restored = restore_latest(CheckpointManager(ckpt_dir), fresh)
    sync_on(cuda)
    restore_s = time.perf_counter() - t2
    unequal = [k for k, v in state_tensors(restored).items()
               if v.dtype != saved[k].dtype or not torch.equal(full(v), saved[k])]
    _, restored_loss = step2(restored, nxt)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    result = {
        "layers": cfg.num_layers, "hidden": cfg.hidden_size, "batch": c["batch"], "seq": c["seq"],
        "device": str(device), "backend": dist.get_backend(), "world": dist.get_world_size(),
        "losses": [loss0.item()] + [x.item() for x in losses],
        "step_ms": dt / c["steps"] * 1e3,
        "launches_per_step": {k: v / c["steps"] for k, v in launches.items()},
        "batches_checked": len(dev_sums), "host_sums": len(host_sums),
        "bad_batches": [i for i, (h, d) in enumerate(zip(host_sums, dev_sums)) if h != d],
        "checkpoint": {"gb": ckpt_gb, "host_copy_s": snapshot_s, **timing,
                       "restore_s": restore_s, "saved_step": saved_step,
                       "restored_step": got_step, "restored_state_step": restored.step,
                       "tensors": len(saved), "unequal": unequal[:10], "n_unequal": len(unequal)},
        "next_loss_saved": next_loss, "next_loss_restored": restored_loss.item(),
    }
    with open(os.path.join(args["out_dir"], f"node{ctx.executor_id}.json"), "w") as f:
        json.dump(result, f)


def phase_mesh_node(layers=16, rehearse=None):
    from tensorflowonspark_tpu_torch.cluster import tfcluster
    from tensorflowonspark_tpu_torch.cluster.tfcluster import InputMode

    rehearse = rehearse or {}
    args = {"layers": layers, "device": rehearse.get("device", "cuda"),
            "sizes": rehearse.get("sizes", {})}
    cuda = args["device"] == "cuda"
    c = {**MESH, **args["sizes"]}
    n_batches = 1 + c["steps"] + 1
    rows = cluster_rows(n_batches * c["batch"], c["seq"], c.get("vocab", 32000), seed=2)
    out_dir = tempfile.mkdtemp(prefix="tfos_mesh_")
    args["out_dir"] = out_dir
    t0 = time.perf_counter()
    cpu_env = {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    cluster = tfcluster.run(mesh_node, args, num_executors=1, input_mode=InputMode.SPARK,
                            distributed=True, reservation_timeout=600,
                            env=None if cuda else cpu_env)
    cluster.train(tfcluster.contiguous_split(rows, 4), feed_timeout=600, close_feed=True)
    cluster.shutdown(timeout=900)  # raises with the node's traceback if it failed
    wall_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, "node0.json")) as f:
        r = json.load(f)
    shutil.rmtree(out_dir, ignore_errors=True)
    ck = r["checkpoint"]
    want = {"fwd": 2 * r["layers"], "dq": r["layers"], "dkv": r["layers"]} if cuda \
        else {"fwd": 0, "dq": 0, "dkv": 0}
    err = {
        "bad_batches": len(r["bad_batches"]), "batches_checked": r["batches_checked"],
        "launches_per_step": r["launches_per_step"], "restored_unequal": ck["n_unequal"],
        "step_agrees": ck["restored_step"] == ck["saved_step"] == ck["restored_state_step"],
        "next_loss_gap": abs(r["next_loss_saved"] - r["next_loss_restored"]),
    }
    emit({"phase": "mesh", "part": "node", **r, "wall_s": wall_s,
          "nvidia_smi": nvidia_smi() if cuda else None})
    mesh_check("mesh_node", err, {"bad_batches": 0, "launches_per_step": want,
                                  "restored_unequal": 0, "next_loss_gap": 0.0},
               err["bad_batches"] == 0 and r["batches_checked"] == n_batches == r["host_sums"]
               and r["launches_per_step"] == want and err["restored_unequal"] == 0
               and err["step_agrees"] and err["next_loss_gap"] == 0.0
               and all(math.isfinite(x) for x in r["losses"])
               and r["backend"] == ("nccl" if cuda else "gloo") and r["world"] == 1)



# phase elastic: two llama_1b nodes of one elastic cluster share the card.
# Batch, sequence, steps, learning rate; node 1 is killed once both nodes
# have taken kill_after steps; node 0 saves a checkpoint of step ckpt_step;
# the first nodes wait at step hold[e - 1] (at most wait_s seconds) for
# membership epoch e, node 0 at the second also for the replacement to have
# hydrated, so each change lands mid-run and the last steps run on two
# nodes; heartbeat interval and grace (s). The SIGKILL shows in the exit
# code at once; the grace only has to outlast a beat held back while a
# node pickles its snapshot on a busy host
ELASTIC = dict(batch=8, seq=1024, steps=24, lr=1e-4, kill_after=5, ckpt_step=2, hold=(6, 12),
               wait_s=180.0, heartbeat=0.5, grace=15.0, vocab=32000)


def elastic_cfg(layers, tiny, seq):
    from tensorflowonspark_tpu_torch.models.llama import LlamaConfig

    if tiny:  # the CPU rehearsal: plain versions of the kernels, fp32
        return LlamaConfig.tiny(max_seq_len=seq, remat=False, dtype=torch.float32)
    return LlamaConfig.llama_1b(max_seq_len=seq, remat=False, attention_impl="auto",
                                num_layers=layers)


def elastic_batch(i: int, c: dict, vocab: int) -> dict:
    """The batch of step ``i``, a pure function of the step index (the
    replay contract of elastic training): Zipf token ids from seed 1000 + i."""
    rng = np.random.default_rng(1000 + i)
    toks = np.minimum(rng.zipf(1.2, size=(c["batch"], c["seq"] + 1)), vocab) - 1
    return {"tokens": torch.from_numpy(toks.astype(np.int32))}


def elastic_parts(cfg, c, device):
    """Model from seed 0, optimizer, train step and fresh state: the same
    in the oracle and in every node."""
    from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step
    from tensorflowonspark_tpu_torch.models.llama import Llama, llama_loss_fn

    model = Llama(cfg, device=device, seed=0)
    tx = adamw(c["lr"], moment_dtype=torch.bfloat16)
    loss_fn = llama_loss_fn(model)
    step = build_train_step(lambda p, b: loss_fn(p, b["tokens"]), tx, device=device)
    return model, step, TrainState.create(dict(model.named_parameters()), tx)


RECOVERY_OUTCOMES = ("resharded", "checkpoint_fallback", "peer_hydrate", "fresh_init", "failed")


def with_outcome(call):
    """``(call(), outcome)``: the recovery outcome that ``call`` (a
    reconfigure or a hydrate) counted in ``elastic_recoveries_total``."""
    from tensorflowonspark_tpu_torch.obs.registry import default_registry

    counter = default_registry().counter("elastic_recoveries_total")
    before = {o: counter.value(outcome=o) for o in RECOVERY_OUTCOMES}
    out = call()
    return out, next(o for o in RECOVERY_OUTCOMES if counter.value(outcome=o) > before[o])


def reshard_seconds() -> float:
    """Seconds of every reconfigure so far (the ``elastic_reshard_seconds``
    histogram's sum: the reconfigure up to its publish)."""
    from tensorflowonspark_tpu_torch.obs.registry import default_registry

    hist = default_registry().histogram("elastic_reshard_seconds").value()
    return 0.0 if hist is None else hist["sum"]


class LoggedKV:
    """A node's manager KV as its ``ElasticTrainer`` sees it: each ``set``
    of the elastic state key appends the blob's bytes, the seconds of the
    set and the wall time after it to ``log``."""

    def __init__(self, mgr, key, log):
        self._mgr, self._key, self._log = mgr, key, log

    def set(self, key, value):
        t0 = time.perf_counter()
        self._mgr.set(key, value)
        if key == self._key:
            self._log.append({"bytes": len(value), "set_s": time.perf_counter() - t0,
                              "at": time.time()})

    def __getattr__(self, name):
        return getattr(self._mgr, name)


def adopt(model, params) -> None:
    """Point the model's parameters at ``params`` (a resharded state's), so
    the tensors they held before are freed."""
    with torch.no_grad():
        for name, p in params.items():
            model.get_parameter(name).data = p


def elastic_oracle(cfg, c, device, path) -> list:
    """The uninterrupted run: ``steps`` steps on the same batches from the
    same weights; its final state goes to ``path`` (host tensors)."""
    model, step, state = elastic_parts(cfg, c, device)
    losses = []
    for i in range(c["steps"]):
        state, loss = step(state, elastic_batch(i, c, cfg.vocab_size))
        losses.append(loss.item())
    torch.save({k: v.detach().cpu() for k, v in state_tensors(state).items()}, path)
    del model, step, state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return losses


def elastic_node(args, ctx):
    """map_fun of phase elastic (module level, so spawn pickles it by
    name): llama_1b trained by an ``ElasticTrainer`` loop on this node's
    own device, a single-controller node (the trainer's default placement:
    plain tensors there).
    A replacement (``args["rejoin"]``) hydrates first. Node 0 saves a
    checkpoint and arms ``elastic.reshard_gather`` for its reconfigure to
    epoch 2. The node's record goes to ``node{id}.json``, each step's as
    it ends to ``steps{id}.jsonl`` (``steps{id}r.jsonl`` for a
    replacement), each epoch it reconfigured to to ``epoch{id}_{e}``;
    a replacement marks ``ready{id}`` once it has hydrated, and each node
    ``go{id}_{e}`` once past its one-off work in epochs 0 and 2. The
    node times its publishes (through ``LoggedKV``), reconfigures and
    hydrate, and a host snapshot of its final state, which is what it
    compares with the uninterrupted run."""
    from tensorflowonspark_tpu_torch.compute import elastic
    from tensorflowonspark_tpu_torch.compute.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.ops import bn_kernels as bn
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.utils import failpoints

    c = {**ELASTIC, **args.get("sizes", {})}
    eid = ctx.executor_id
    device = torch.device(args["device"])
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cuda = device.type == "cuda"
    out = args["out_dir"]
    cfg = elastic_cfg(args["layers"], args.get("tiny"), c["seq"])
    model, step, state = elastic_parts(cfg, c, device)
    oracle = torch.load(args["oracle"], map_location="cpu", mmap=True, weights_only=True)

    def dtype_changes(st) -> list:
        return [k for k, v in state_tensors(st).items() if v.dtype != oracle[k].dtype]

    chief = eid == 0 and not args.get("rejoin")
    sets, publishes = [], []
    ctx.mgr = LoggedKV(ctx.mgr, elastic.STATE_KEY, sets)
    trainer = elastic.ElasticTrainer(
        ctx, publish_steps=10**9, checkpoint_dir=args["ckpt_dir"] if chief else None)
    fa.reset_launches()
    bn.reset_launches()
    start, hydrate = 0, None
    if args.get("rejoin"):
        t0, t1 = time.time(), time.perf_counter()
        (start, state), outcome = with_outcome(trainer.hydrate)
        if state is None:
            raise RuntimeError(f"the replacement found nothing to hydrate from: {outcome}")
        hydrate = {"step": start, "t_start": t0, "at": time.time(), "outcome": outcome,
                   "seconds": time.perf_counter() - t1, "dtype_changes": dtype_changes(state)}
        adopt(model, state.params)
        open(os.path.join(out, f"ready{eid}"), "w").close()
    steps, outcomes, save_s = [], [], None
    i = start
    while i < c["steps"]:
        # the first nodes wait for each membership change at its step
        # (node 1 is killed while it waits at the first)
        if not args.get("rejoin") and i in c["hold"]:
            want = list(c["hold"]).index(i) + 1
            if trainer.epoch < want:
                elastic.wait_for_epoch(want, timeout=c["wait_s"])
            if chief and want == 2:
                _wait_for(lambda: os.path.exists(os.path.join(out, "ready1")), c["wait_s"],
                          "the replacement to hydrate")
        if trainer.changed():
            epoch = elastic.current_epoch()
            if chief and epoch >= 2:
                failpoints.arm("elastic.reshard_gather", "raise", count=1)
            n_sets, reshard0, t1 = len(sets), reshard_seconds(), time.perf_counter()
            (state, _), outcome = with_outcome(lambda: trainer.reconfigure(state))
            call_s, reshard_s = time.perf_counter() - t1, reshard_seconds() - reshard0
            adopt(model, state.params)
            if len(sets) > n_sets:  # its publish: the rest of the call
                label = i if trainer.resume_step is None else trainer.resume_step
                publishes.append({"step": label, "seconds": call_s - reshard_s, **sets[-1]})
            outcomes.append({"epoch": trainer.epoch, "outcome": outcome,
                             "resume_step": trainer.resume_step, "at_step": i,
                             "seconds": reshard_s, "call_s": call_s,
                             "dtype_changes": dtype_changes(state)})
            open(os.path.join(out, f"epoch{eid}_{trainer.epoch}"), "w").close()
            if trainer.resume_step is not None:
                i = trainer.resume_step
        if sum(s["epoch"] == trainer.epoch for s in steps) == {0: c["ckpt_step"], 2: 1}.get(
                trainer.epoch):
            # in an epoch with two nodes, past its one-off work there (the
            # snapshot published after its first step, node 0's checkpoint),
            # each waits for the other, so that the rest of their steps
            # share the card
            open(os.path.join(out, f"go{eid}_{trainer.epoch}"), "w").close()
            _wait_for(lambda: os.path.exists(os.path.join(out, f"go{1 - eid}_{trainer.epoch}")),
                      c["wait_s"], f"the other node's first step of epoch {trainer.epoch}")
        batch = elastic_batch(i, c, cfg.vocab_size)
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        loss = loss.item()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append({"i": i, "loss": loss, "epoch": trainer.epoch, "ms": ms, "t": time.time()})
        n_sets, t1 = len(sets), time.perf_counter()
        trainer.publish(state, i + 1)
        if len(sets) > n_sets:
            publishes.append({"step": i + 1, "seconds": time.perf_counter() - t1, **sets[-1]})
        if chief and i + 1 == c["ckpt_step"]:
            with CheckpointManager(args["ckpt_dir"], async_save=False) as mgr:
                t1 = time.perf_counter()
                mgr.save(i + 1, state)
                save_s = time.perf_counter() - t1
        with open(os.path.join(out, f"steps{eid}{'r' if args.get('rejoin') else ''}.jsonl"),
                  "a") as f:
            f.write(json.dumps(steps[-1]) + "\n")
        i += 1
    launches, bn_launches = dict(fa.LAUNCHES), dict(bn.LAUNCHES)
    t1 = time.perf_counter()
    mine = state_tensors(elastic.host_snapshot(state))
    snapshot = {"seconds": time.perf_counter() - t1,
                "bytes": sum(v.numel() * v.element_size() for v in mine.values())}
    unequal, gaps = [], {}
    for k, ref in oracle.items():
        got = mine[k]
        if got.dtype != ref.dtype or not torch.equal(got, ref):
            unequal.append(k)
            gaps[k] = (got.double() - ref.double()).abs().max().item() \
                if got.shape == ref.shape else None
    result = {
        "executor_id": eid, "rejoin": bool(args.get("rejoin")), "start": start,
        "hydrate": hydrate, "outcomes": outcomes, "steps": steps, "publishes": publishes,
        "snapshot": snapshot, "final_epoch": trainer.epoch, "launches": launches,
        "bn_launches": bn_launches, "steps_run": len(steps), "save_s": save_s,
        "tensors": len(oracle),
        "state_bytes": sum(v.numel() * v.element_size()
                           for v in state_tensors(state).values()),
        "unequal": unequal[:10],
        "n_unequal": len(unequal), "max_gap": max((g for g in gaps.values() if g is not None),
                                                  default=0.0),
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None,
    }
    with open(os.path.join(out, f"node{eid}.json"), "w") as f:
        json.dump(result, f)


def host_free_gb() -> float:
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    return int(info["MemAvailable"].split()[0]) / 1e6


def _wait_for(pred, timeout, what):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"elastic phase: timed out waiting for {what}")
        time.sleep(0.1)


def _read(path, default=None):
    try:
        with open(path) as f:
            return f.read()
    except FileNotFoundError:
        return default


def elastic_summary(r: dict, others: list, oracle_losses: list) -> dict:
    """The numbers and checks of one node's record; ``others`` are the
    other nodes' steps, which tell which of this node's ran beside one."""
    steps = r["steps"]
    bad_loss = [s["i"] for s in steps if s["loss"] != oracle_losses[s["i"]]]
    order = [s["i"] for s in steps]
    rewinds = [(a, b) for a, b in zip(order, order[1:]) if b != a + 1]
    theirs = [(s["t"] - s["ms"] / 1e3, s["t"]) for s in others]

    def shared(s) -> bool:  # the other node stepped for over half of this step
        a = s["t"] - s["ms"] / 1e3
        return sum(max(0.0, min(s["t"], e) - max(a, b)) for b, e in theirs) > s["ms"] / 2e3

    def ms(pred):  # median, leaving out each node's first step of an epoch
        xs = [s["ms"] for k, s in enumerate(steps)
              if k > 0 and steps[k - 1]["epoch"] == s["epoch"] and pred(s)]
        return (float(np.median(xs)), len(xs)) if xs else (None, 0)

    return {
        "bad_losses": bad_loss, "rewinds": rewinds,
        # (median ms, steps): stepping beside the other node, in epoch 0 and
        # again in epoch 2, and alone on the card
        "steps_ms": {"two_nodes_epoch0": ms(lambda s: s["epoch"] == 0 and shared(s)),
                     "one_node": ms(lambda s: not shared(s)),
                     "two_nodes_again": ms(lambda s: s["epoch"] >= 2 and shared(s))},
    }


def _drive_elastic(cluster, args, c, out_dir, timeline):
    """Kill node 1, wait for the departure bump and node 0's reconfigure,
    launch the replacement, wait for its admission and for supervise();
    returns the failures of supervise()."""
    import signal
    import threading

    sup_err: list = []

    def supervise():
        try:
            cluster.supervise(poll=0.5)
        except BaseException as e:  # noqa: BLE001 - reported by the caller
            sup_err.append(repr(e))

    sup = threading.Thread(target=supervise, daemon=True)
    sup.start()
    _wait_for(lambda: all(_progress(out_dir, eid) >= c["kill_after"] for eid in (0, 1)),
              c["wait_s"], "both nodes' first steps")
    pid = next(n["pid"] for n in cluster.cluster_info if n["executor_id"] == 1)
    timeline["kill"] = time.time()
    os.kill(pid, signal.SIGKILL)
    _wait_for(lambda: cluster.membership_epoch() >= 1, c["wait_s"], "the departure bump")
    timeline["epoch1"] = time.time()
    # the replacement hydrates from node 0's snapshot of epoch 1
    _wait_for(lambda: os.path.exists(os.path.join(out_dir, "epoch0_1")), c["wait_s"],
              "node 0's reconfigure to epoch 1")
    timeline["launch_replacement"] = time.time()
    cluster.launch_replacement(1, elastic_node, {**args, "rejoin": True})
    _wait_for(lambda: cluster.membership_epoch() >= 2, c["wait_s"], "the admission bump")
    timeline["epoch2"] = time.time()
    sup.join(timeout=c["wait_s"] + 600)
    if sup.is_alive():
        sup_err.append("supervise() did not return")
    return sup_err


def _progress(out_dir, eid) -> int:
    """Steps the first node ``eid`` has taken (lines of its step log)."""
    return _read(os.path.join(out_dir, f"steps{eid}.jsonl"), "").count("\n")


def phase_elastic(layers=16, rehearse=None):
    """Elastic membership on the card (see the module docstring, phase 9);
    raises SystemExit when a check fails or a node failed. ``layers`` cuts
    the depth and ``rehearse`` can change ``sizes`` alone (chip_faults.py);
    with ``tiny`` and ``device="cpu"`` too it runs at a tiny size on the
    CPU."""
    from tensorflowonspark_tpu_torch.cluster import tfcluster
    from tensorflowonspark_tpu_torch.cluster.tfcluster import InputMode

    rehearse = rehearse or {}
    device = torch.device(rehearse.get("device", "cuda"))
    cuda = device.type == "cuda"
    c = {**ELASTIC, **rehearse.get("sizes", {})}
    tmp = tempfile.mkdtemp(prefix="tfos_elastic_")
    out_dir, ckpt_dir = os.path.join(tmp, "out"), os.path.join(tmp, "ckpt")
    os.makedirs(out_dir)
    oracle = os.path.join(tmp, "oracle.pt")
    cfg = elastic_cfg(layers, rehearse.get("tiny"), c["seq"])
    free0 = host_free_gb()
    t0 = time.perf_counter()
    oracle_losses = elastic_oracle(cfg, c, device, oracle)
    oracle_s = time.perf_counter() - t0
    emit({"phase": "elastic", "part": "oracle", "layers": cfg.num_layers,
          "hidden": cfg.hidden_size, "batch": c["batch"], "seq": c["seq"], "steps": c["steps"],
          "losses": oracle_losses, "seconds": oracle_s, "host_free_gb": free0,
          "parent_memory_reserved_gb": torch.cuda.memory_reserved() / 1e9 if cuda else None})
    args = {"layers": layers, "device": device.type, "sizes": rehearse.get("sizes", {}),
            "tiny": rehearse.get("tiny", False), "out_dir": out_dir, "ckpt_dir": ckpt_dir,
            "oracle": oracle}
    env = None if cuda else {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    t_run = time.perf_counter()
    cluster = tfcluster.run(elastic_node, args, num_executors=2, input_mode=InputMode.TENSORFLOW,
                            elastic=True, distributed=False, reservation_timeout=600,
                            heartbeat_interval=c["heartbeat"], heartbeat_grace=c["grace"],
                            env=env)
    timeline, failures, epoch = {}, [], None
    try:
        failures += _drive_elastic(cluster, args, c, out_dir, timeline)
        epoch = cluster.membership_epoch()
        cluster.shutdown(timeout=600)  # raises with a node's traceback if it failed
    except (RuntimeError, TimeoutError) as e:
        failures.append(str(e)[-2000:])
    finally:
        exit_codes = [cluster.launcher.exitcodes()] + [
            launcher.exitcodes() for launcher in cluster._replacement_launchers]
        cluster.launcher.terminate()
        for launcher in cluster._replacement_launchers:
            launcher.terminate()
        cluster.server.stop()
    wall_s = time.perf_counter() - t_run
    nodes = {}
    for eid in (0, 1):
        text = _read(os.path.join(out_dir, f"node{eid}.json"))
        if text is None:
            failures.append(f"node {eid} wrote no record (exit codes of the launchers: "
                            f"{exit_codes}, membership epoch {epoch})")
        else:
            nodes[eid] = json.loads(text)
    # the killed node's step log (its last line may be cut by the SIGKILL)
    killed = _read(os.path.join(out_dir, "steps1.jsonl"), "").split("\n")[:-1]
    killed = [json.loads(x) for x in killed]
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "elastic", "part": "cluster", "wall_s": wall_s, "oracle_s": oracle_s,
          "timeline": {k: v - timeline["kill"] for k, v in timeline.items()} if timeline else {},
          "host_free_gb_before": free0, "nvidia_smi": nvidia_smi() if cuda else None})
    per_step = cfg.num_layers if cuda else 0
    tol = {"unequal": 0, "bad_losses": 0, "dtype_changes": 0, "launches_per_step": per_step,
           "survivor_outcomes": [[1, "resharded", None],
                                 [2, "checkpoint_fallback", c["ckpt_step"]]],
           "joiner_start": "the step of node 0's freshest published snapshot",
           "snapshot_bytes": "the state's bytes"}
    if failures or len(nodes) < 2:
        emit({"phase": "elastic", "case": "elastic_checks", "err": {"failures": failures},
              "tol": tol, "ok": False})
        raise SystemExit("elastic phase failed: " + "; ".join(failures))
    survivor, joiner = nodes[0], nodes[1]
    summary = {0: elastic_summary(nodes[0], killed + nodes[1]["steps"], oracle_losses),
               1: elastic_summary(nodes[1], nodes[0]["steps"], oracle_losses)}
    for eid, r in nodes.items():
        emit({"phase": "elastic", "part": "node", **r, **summary[eid]})
    kill_to_epoch1 = next((s["t"] for s in survivor["steps"] if s["epoch"] == 1), math.inf) \
        - timeline["kill"]
    # the snapshot node 0 had published last when the joiner began to
    # hydrate, or one it published while the joiner hydrated
    hyd = joiner["hydrate"]
    published = survivor["publishes"]
    before = [x["step"] for x in published if x["at"] <= hyd["t_start"]]
    fresh = set(before[-1:]) | {x["step"] for x in published
                                if hyd["t_start"] < x["at"] <= hyd["at"]}
    err = {
        "epoch": epoch,
        "survivor_outcomes": [(o["epoch"], o["outcome"], o["resume_step"])
                              for o in survivor["outcomes"]],
        "joiner": {"hydrate": hyd["outcome"], "start": joiner["start"],
                   "freshest_published": sorted(fresh), "published": [x["step"] for x in published],
                   "outcomes": [(o["epoch"], o["outcome"]) for o in joiner["outcomes"]]},
        "unequal": {eid: r["n_unequal"] for eid, r in nodes.items()},
        "max_gap": {eid: r["max_gap"] for eid, r in nodes.items()},
        "bad_losses": {eid: summary[eid]["bad_losses"][:5] for eid in nodes},
        "dtype_changes": {eid: [x for o in r["outcomes"] + [r["hydrate"] or {}]
                                for x in o.get("dtype_changes", [])] for eid, r in nodes.items()},
        "snapshot_bytes": {eid: r["snapshot"]["bytes"] for eid, r in nodes.items()},
        "state_bytes": {eid: r["state_bytes"] for eid, r in nodes.items()},
        "launches_per_step": {eid: {k: v / r["steps_run"] for k, v in r["launches"].items()}
                              for eid, r in nodes.items()},
        "kill_to_epoch1_s": kill_to_epoch1,
    }
    ok = (
        epoch == 2
        and err["survivor_outcomes"] == [(1, "resharded", None),
                                         (2, "checkpoint_fallback", c["ckpt_step"])]
        and summary[0]["rewinds"] == [(survivor["outcomes"][1]["at_step"] - 1, c["ckpt_step"])]
        and survivor["final_epoch"] == 2 == joiner["final_epoch"]
        and hyd["outcome"] == "peer_hydrate"
        and joiner["start"] in fresh and len(published) >= 2
        and not summary[1]["rewinds"]
        and all(r["steps"][-1]["i"] == c["steps"] - 1 for r in nodes.values())
        and all(r["n_unequal"] == 0 and r["tensors"] > 0 for r in nodes.values())
        and not any(err["bad_losses"].values())
        and not any(err["dtype_changes"].values())
        and all(b == nodes[eid]["state_bytes"] for eid, b in err["snapshot_bytes"].items())
        and all(v == {"fwd": per_step, "dq": per_step, "dkv": per_step}
                for v in err["launches_per_step"].values())
        and math.isfinite(kill_to_epoch1)
    )
    emit({"phase": "elastic", "case": "elastic_checks", "err": err, "tol": tol, "ok": ok})
    if not ok:
        raise SystemExit("elastic phase failed")
    return ({k: sum(r["launches"][k] for r in nodes.values()) for k in ("fwd", "dq", "dkv")},
            {k: sum(r["bn_launches"][k] for r in nodes.values()) for k in ("pair", "cross")})


# phase decode: sizes (a CPU rehearsal passes smaller ones)
DECODE = dict(batch=8, width=512, min_len=64, new=256, time_prompt=128, time_steps=32,
              int8_steps=64, roll_batch=2, roll_window=256, roll_cache=512, roll_prompt=256,
              roll_new=384, score_width=513, attn_scale=3.0)
# Limits of phase decode, bf16 at llama_1b. "logits": the decode's logits at
# every generated position against a teacher-forced forward without a cache
# (flash attention over the whole row), max |diff|; a token must equal that
# forward's argmax where its top-2 gap exceeds the same limit. "attention":
# the cached attention's output at the decode shape against the same math
# in fp64 (probabilities rounded to bf16 as the reference rounds them),
# atol_rms at rtol 2^-7 and frob (compare()); on the CPU, with logits of rms
# 9, the port reads 0.0 and 0.0016, and logits rounded to bf16 0.157 and
# 0.021. "int8": int8-cache logits against the
# bf16 cache's on the same tokens, max |diff|. "rolling": the rolling cache's
# logits against the dense windowed cache's, max |diff|. "score": scoring
# logprobs through flash (B1) against the plain attention, max |diff|.
# "cli_score": the CLI's --score against the in-process scorer, max |diff|.
# logits, int8, rolling and score are each twice the largest sound reading
# over seeds 0-3 (``--decode-seeds``; H100, full depth), rounded up to a
# tenth: largest readings 0.148, 0.195, 0.102 and 0.098; the planted faults
# of chip_faults.py read at least 1.52, 6.70 and 1.73 (none plants score).
DECODE_TOL = dict(logits=0.3, attention=dict(atol_rms=0.05, frob=5e-3), int8=0.4, rolling=0.3,
                  score=0.2, cli_score=1e-4)


def retarget(model, cfg):
    """``model`` with its config (and its layers') replaced by ``cfg``, a
    config of the same shapes (cache, window or attention fields differ)."""
    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = cfg
    return model


def greedy_capture(model, prompt, new, lengths=None, force=None):
    """Drive ``prefill`` and ``decode_step`` (the functions ``generate``
    runs) for ``new`` tokens, greedily or on the tokens ``force`` (B, new):
    returns the tokens (B, new) and the logits that chose each (B, new, V)."""
    from tensorflowonspark_tpu_torch.models.llama import decode_step, init_cache, prefill

    b = prompt.shape[0]
    cache = init_cache(model.cfg, b, prompt.device)
    with torch.no_grad():
        logits, pos = prefill(model, cache, prompt, lengths)
        caps, toks = [logits], []
        for t in range(new):
            tok = logits.argmax(-1) if force is None else force[:, t]
            toks.append(tok)
            if t == new - 1:
                break
            logits = decode_step(model, cache, tok, pos, lengths is not None)
            pos = pos + 1
            caps.append(logits)
    return torch.stack(toks, 1), torch.stack(caps, 1)


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for layer in cache for t in layer.values())


def top2_gap(logits):
    top = logits.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def decode_attention_check(cfg, device, scale, seed=5):
    """The cached attention at the decode shape (a full cache of max_seq_len
    slots, one query a row) against its math in fp64 on the same bf16
    inputs, with logits of rms ``scale**2``: the port keeps the QK^T
    logits fp32, and bf16-rounded logits would move the output by several
    bf16 steps."""
    from tensorflowonspark_tpu_torch.models.llama import cached_attention, init_cache

    b, c, h, hk, d = 8, cfg.max_seq_len, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda s, n, x: (torch.randn(b, s, n, d, generator=g, device=device) * x).to(cfg.dtype)  # noqa: E731
    q, k, v = mk(c, h, scale), mk(c, hk, scale), mk(c, hk, 1.0)
    cache = init_cache(dataclasses.replace(cfg, num_layers=1), b, device)[0]
    pos = torch.arange(c, device=device).expand(b, c)
    with torch.no_grad():
        cached_attention(cfg, q[:, :-1], k[:, :-1], v[:, :-1], pos[:, :-1], cache)  # the prefill
        out = cached_attention(cfg, q[:, -1:], k[:, -1:], v[:, -1:], pos[:, -1:], cache)
    rep = h // hk
    q64 = q[:, -1].double().view(b, hk, rep, d)
    logits = torch.einsum("bhrd,bkhd->bhrk", q64, k.double()) * d**-0.5
    probs = torch.softmax(logits, dim=-1).to(cfg.dtype).double()
    ref = torch.einsum("bhrk,bkhd->bhrd", probs, v.double()).reshape(b, 1, h, d)
    return compare(out, ref, 2**-7), float(logits.std())


def cli_overrides(cfg, base) -> str:
    """The config fields where ``cfg`` differs from the CLI's preset, as
    the JSON of ``--config-overrides``."""
    diff = {}
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        if val != getattr(base, f.name):
            diff[f.name] = str(val).removeprefix("torch.") if f.name == "dtype" else val
    return json.dumps(diff)


def eos_check(model, prompt, lengths, toks, new, err) -> bool:
    """Phase decode (c): ``generate(eos_id=...)`` on rows of (a) that share
    a token (the rows repeated to (a)'s batch, so every row computes as it
    did there): each row is its (a) decode up to its first eos, then eos,
    and the loop stops after the last row's first eos."""
    from tensorflowonspark_tpu_torch.models.llama import generate

    b = toks.shape[0]
    host = toks.cpu().numpy()
    shared: dict[int, list] = {}
    for r in range(b):
        for t in set(host[r].tolist()):
            shared.setdefault(t, []).append(r)
    cands = []  # (eos, rows): rows finish before the last step, one emits more after its eos
    for t, rows in shared.items():
        firsts = [int(np.argmax(host[r] == t)) for r in rows]
        if len(rows) >= 2 and max(firsts) < new - 1 and any(
                (host[r, f:] != t).any() for r, f in zip(rows, firsts)):
            cands.append((t, rows, max(firsts)))
    if not cands:
        err["eos"] = {"error": "no token two rows share before their last step"}
        return False
    eos, rows, _ = min(cands, key=lambda x: (-len(x[1]), x[2], x[0]))
    sel = (rows * b)[:b]
    plain = host[sel]
    firsts = [int(np.argmax(row == eos)) for row in plain]
    calls = []
    hook = model.register_forward_pre_hook(lambda *a: calls.append(1))
    try:
        got = generate(model, prompt[sel], new, eos_id=eos, prompt_lengths=lengths[sel])
    finally:
        hook.remove()
    got = got.cpu().numpy()
    want = plain.copy()
    for row, f in zip(want, firsts):
        row[f:] = eos
    e = err["eos"] = {
        "eos_id": eos, "rows": sel, "first_eos": firsts, "steps_run": len(calls) - 1,
        "max_steps": new - 1, "mismatches": int((got != want).sum()),
        "stickiness_exercised": bool(any((row[f:] != eos).any() for row, f in zip(plain, firsts))),
    }
    return e["mismatches"] == 0 and e["steps_run"] == max(firsts) < new - 1 \
        and e["stickiness_exercised"]


def run_cli(model, prompts, rows, cfg, preset, model_flag, device, tmp, new) -> dict:
    """Phase decode (g): save the weights with ``save_checkpoint`` and start
    ``python -m tensorflowonspark_tpu_torch.tools.generate_text`` twice on
    ``device`` (decode ``prompts``, ``--score`` ``rows``); returns the
    processes."""
    from tensorflowonspark_tpu_torch.compute.checkpoint import save_checkpoint

    ckpt = save_checkpoint(os.path.join(tmp, "ckpt"),
                           {"params": {n: p.detach() for n, p in model.named_parameters()}})
    for name, data in (("prompts", prompts), ("score", rows)):
        with open(os.path.join(tmp, f"{name}.jsonl"), "w") as f:
            f.writelines(json.dumps({"tokens": r}) + "\n" for r in data)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    base = [sys.executable, "-m", "tensorflowonspark_tpu_torch.tools.generate_text",
            "--checkpoint", ckpt, "--model", model_flag,
            "--config-overrides", cli_overrides(cfg, preset), "--batch-size", str(len(prompts)),
            "--device", device.type]
    jobs = {"decode": ["--prompts", os.path.join(tmp, "prompts.jsonl"), "--max-new-tokens",
                       str(new), "--output", os.path.join(tmp, "decode.out")],
            "score": ["--prompts", os.path.join(tmp, "score.jsonl"), "--score",
                      "--output", os.path.join(tmp, "score.out")]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(base + v, cwd=root, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for k, v in jobs.items()}
    return {"procs": procs, "t0": t0}


def cli_result(cli, tmp, completions, logprobs) -> dict:
    """Wait for the CLI's processes of ``run_cli`` and compare their output
    with the in-process completions and logprobs."""
    procs = cli["procs"]
    try:
        outs = {k: p.communicate(timeout=600)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    res = {"seconds": time.perf_counter() - cli["t0"],
           "returncodes": {k: p.returncode for k, p in procs.items()}}
    if any(p.returncode != 0 for p in procs.values()):
        res["output"] = {k: v[-3000:] for k, v in outs.items()}
        return res
    with open(os.path.join(tmp, "decode.out")) as f:
        got = [json.loads(x)["tokens"] for x in f]
    with open(os.path.join(tmp, "score.out")) as f:
        got_lp = [json.loads(x)["logprobs"] for x in f]
    res["completion_mismatches"] = sum(g != w for g, w in zip(got, completions)) + abs(
        len(got) - len(completions))
    res["max_abs_logprob"] = float(np.abs(np.array(got_lp) - np.array(logprobs)).max())
    return res


def phase_decode(fa, layers=16, rehearse=None, seed=0):
    """KV-cache decode, sampling's greedy path and scoring on the card (see
    the module docstring, phase 10); raises SystemExit when a check fails.
    ``seed`` makes the weights and the data; ``layers`` cuts the depth
    (chip_faults.py); with ``rehearse={"device":
    "cpu", "tiny": True, "sizes": {...}}`` it runs at a tiny size on the
    CPU. Returns every kernel's launches in the scoring call."""
    from tensorflowonspark_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        decode_step,
        generate,
        init_cache,
        prefill,
    )
    from tensorflowonspark_tpu_torch.ops import bn_kernels
    from tensorflowonspark_tpu_torch.tools import generate_text

    rehearse = rehearse or {}
    device = torch.device(rehearse.get("device", "cuda"))
    cuda = device.type == "cuda"
    c = {**DECODE, **rehearse.get("sizes", {})}
    if rehearse.get("tiny"):
        preset, model_flag = LlamaConfig.tiny(dtype=torch.bfloat16), "tiny"
        cfg = dataclasses.replace(preset, remat=False, num_layers=layers)
    else:
        preset, model_flag = LlamaConfig.llama_1b(), "1b"
        cfg = dataclasses.replace(preset, remat=False, num_layers=layers)
    t_phase = time.perf_counter()
    model = Llama(cfg, device=device, seed=seed).to(cfg.dtype)  # weights cast once to bf16
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    rng = np.random.default_rng(seed)
    b, width, new = c["batch"], c["width"], c["new"]
    err, ok = {}, {}
    tol = {**DECODE_TOL, "score_launches_per_call": cfg.num_layers if cuda else 0}

    def sync_():
        if cuda:
            torch.cuda.synchronize()

    # (attn) the cached attention keeps fp32 logits
    att, logit_std = decode_attention_check(cfg, device, c["attn_scale"], seed=5 + seed)
    err["attention"] = {**att, "logit_std": logit_std}
    ok["attention"] = all(att[k] <= v for k, v in tol["attention"].items())

    # (a) mixed-length greedy decode (decode_batches -> generate) against a
    # teacher-forced forward
    lengths = rng.integers(c["min_len"], width + 1, b)
    lengths[0], lengths[-1] = width, c["min_len"]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    prompt = torch.zeros(b, width, dtype=torch.long)  # right-padded as decode_batches pads
    for i, row in enumerate(prompts):
        prompt[i, :len(row)] = torch.tensor(row)
    prompt = prompt.to(device)
    t0 = time.perf_counter()
    completions, _ = generate_text.decode_batches(model, prompts, batch_size=b, width=width,
                                                  max_new_tokens=new)
    gen_s = time.perf_counter() - t0
    toks = torch.tensor(completions, device=device)
    cap_toks, cap_logits = greedy_capture(model, prompt, new, torch.from_numpy(lengths).to(device))
    forced = torch.zeros(b, width + new, dtype=torch.long, device=device)
    for i, n in enumerate(lengths):
        forced[i, :n] = prompt[i, :n]
        forced[i, n:n + new] = toks[i]
    with torch.no_grad():
        full = model(forced)
    at = torch.from_numpy(lengths).to(device)[:, None] - 1 + torch.arange(new, device=device)
    ref = full[torch.arange(b, device=device)[:, None], at]
    del full
    confident = top2_gap(ref) > tol["logits"]
    err["mixed"] = {
        "lengths": lengths.tolist(), "generate_s": gen_s,
        "max_abs_logits": (cap_logits - ref).abs().max().item(),
        "capture_equals_generate": bool(torch.equal(cap_toks, toks)),
        "confident_tokens": int(confident.sum()), "tokens": b * new,
        "confident_mismatches": int(((ref.argmax(-1) != toks) & confident).sum()),
        "finite": bool(torch.isfinite(cap_logits).all()),
        "shape": list(toks.shape),
    }
    m = err["mixed"]
    ok["mixed"] = (m["capture_equals_generate"] and m["finite"] and m["shape"] == [b, new]
                   and m["max_abs_logits"] <= tol["logits"] and m["confident_mismatches"] == 0)
    a_logits = cap_logits
    del ref, cap_logits

    # (b) timing at batch 1 and batch 8
    for tb in ((1, b) if cuda else ()):
        p = torch.from_numpy(rng.integers(0, cfg.vocab_size, (tb, c["time_prompt"]))).to(device)
        generate(model, p, 8)  # warm-up
        caches = [init_cache(cfg, tb, device) for _ in range(3)]
        sync_()
        t0 = time.perf_counter()
        for cache in caches:
            with torch.no_grad():
                logits, pos = prefill(model, cache, p)
        sync_()
        prefill_ms = (time.perf_counter() - t0) * 1e3 / len(caches)
        cache, tok = caches[-1], logits.argmax(-1)

        def step():
            nonlocal tok, pos
            with torch.no_grad():
                tok = decode_step(model, cache, tok, pos).argmax(-1)
            pos = pos + 1

        n = c["time_steps"]
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        issue_ms = (time.perf_counter() - t0) * 1e3 / n
        sync_()
        step_ms = (time.perf_counter() - t0) * 1e3 / n
        prof = profile_steps(step, n=2, model=f"llama_decode_b{tb}")
        del caches, cache
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        generate(model, p, new)
        sync_()
        total_ms = (time.perf_counter() - t0) * 1e3
        slots = cfg.kv_cache_len or cfg.max_seq_len
        kv_read = 2 * cfg.num_layers * tb * slots * cfg.num_kv_heads * cfg.head_dim * 2
        # a step reads every weight once, but of the embedding table only its B rows
        step_weights = (weight_bytes - model.embed.numel() * model.embed.element_size()
                        + tb * cfg.hidden_size * model.embed.element_size())
        bound_ms = (step_weights + kv_read) / H100_BYTES_PER_S * 1e3
        emit({"phase": "decode", "part": "timing", "batch": tb, "prompt": c["time_prompt"],
              "new_tokens": new, "prefill_ms": prefill_ms, "step_ms": step_ms,
              "host_issue_ms_per_step": issue_ms, "decode_tokens_per_s": tb / step_ms * 1e3,
              "generate_ms": total_ms, "generate_tokens_per_s": tb * new / total_ms * 1e3,
              "bytes_per_step": step_weights + kv_read, "weight_bytes_per_step": step_weights,
              "kv_read_bytes": kv_read, "bound_ms": bound_ms, "share_of_bound": bound_ms / step_ms,
              "profile_wall_ms_per_step": prof["wall_ms_per_step"],
              "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
              "device_idle_share": prof["device_idle_share"],
              "aten_calls_per_step": prof["aten_calls_per_step"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "nvidia_smi": nvidia_smi()})

    # (g), started here and read at the end: the CLI as two subprocesses on
    # this device over a port checkpoint of these weights
    sw = c["score_width"]
    rows = rng.integers(0, cfg.vocab_size, (b, sw)).tolist()
    tmp = tempfile.mkdtemp(prefix="tfos_decode_")
    try:
        cli = run_cli(model, prompts, rows, cfg, preset, model_flag, device, tmp, new)

        # (c) eos: a token rows of (a) share, in a batch of those rows
        ok["eos"] = eos_check(model, prompt, lengths, toks, new, err)

        # (d) int8 KV cache on (a)'s tokens
        steps8 = c["int8_steps"]
        cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
        retarget(model, cfg8)
        _, logits8 = greedy_capture(model, prompt, steps8, torch.from_numpy(lengths).to(device),
                                    force=toks[:, :steps8])
        retarget(model, cfg)
        err["int8"] = {
            "steps": steps8,
            "max_abs_logits": (logits8 - a_logits[:, :steps8]).abs().max().item(),
            "cache_bytes_int8": cache_bytes(init_cache(cfg8, b, device)),
            "cache_bytes_bf16": cache_bytes(init_cache(cfg, b, device)),
            # the codes widened to bf16 per step (eager torch does not fuse it)
            "widened_bytes_per_step": 2 * cfg.num_layers * b
            * (cfg.kv_cache_len or cfg.max_seq_len) * cfg.num_kv_heads * cfg.head_dim * 2,
        }
        ok["int8"] = err["int8"]["max_abs_logits"] <= tol["int8"]
        del logits8, a_logits

        # (e) rolling cache against the dense windowed cache, on its tokens
        cfg_w = dataclasses.replace(cfg, sliding_window=c["roll_window"])
        cfg_r = dataclasses.replace(cfg_w, kv_cache_len=c["roll_cache"])
        rp = torch.from_numpy(rng.integers(0, cfg.vocab_size, (c["roll_batch"], c["roll_prompt"])))
        rp = rp.to(device)
        retarget(model, cfg_w)
        dtoks, dlogits = greedy_capture(model, rp, c["roll_new"])
        retarget(model, cfg_r)
        _, rlogits = greedy_capture(model, rp, c["roll_new"], force=dtoks)
        retarget(model, cfg)
        sure = top2_gap(dlogits) > tol["rolling"]
        err["rolling"] = {
            "window": c["roll_window"], "cache_len": c["roll_cache"],
            "last_position": c["roll_prompt"] + c["roll_new"] - 1,
            "max_abs_logits": (rlogits - dlogits).abs().max().item(),
            "confident_tokens": int(sure.sum()), "tokens": int(sure.numel()),
            "confident_mismatches": int(((rlogits.argmax(-1) != dtoks) & sure).sum()),
        }
        r = err["rolling"]
        ok["rolling"] = (r["max_abs_logits"] <= tol["rolling"] and r["confident_mismatches"] == 0
                         and r["last_position"] >= c["roll_cache"])
        del dlogits, rlogits

        # (f) scoring through B1, against the plain attention
        score_rows = generate_text.build_score_fn(model, width=sw, bsz=b)
        fa.reset_launches()
        bn_kernels.reset_launches()
        lp = score_rows(rows)
        sync_()
        launches = {**fa.LAUNCHES, **bn_kernels.LAUNCHES}
        retarget(model, dataclasses.replace(cfg, attention_impl="xla"))
        lp_plain = generate_text.build_score_fn(model, width=sw, bsz=b)(rows)
        retarget(model, cfg)
        err["score"] = {"width": sw, "launches": launches,
                        "max_abs_logprob": float(np.abs(np.array(lp) - np.array(lp_plain)).max())}
        ok["score"] = (err["score"]["max_abs_logprob"] <= tol["score"]
                       and launches == {"fwd": tol["score_launches_per_call"], "dq": 0, "dkv": 0,
                                        "pair": 0, "cross": 0})

        # (g) read: completions against decode_batches in (a), logprobs against (f)
        err["cli"] = cli_result(cli, tmp, completions, lp)
        ok["cli"] = (err["cli"].get("completion_mismatches") == 0
                     and err["cli"].get("max_abs_logprob", math.inf) <= tol["cli_score"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    good = all(ok.values())
    emit({"phase": "decode", "case": "decode_checks", "seed": seed, "layers": cfg.num_layers,
          "hidden": cfg.hidden_size, "batch": b, "width": width, "new_tokens": new,
          "weight_bytes": weight_bytes, "wall_s": time.perf_counter() - t_phase,
          "checks": ok, "err": err, "tol": tol, "ok": good})
    if not good:
        raise SystemExit("decode phase failed: " + ", ".join(k for k, v in ok.items() if not v))
    return launches


# phase serve: sizes (a CPU rehearsal passes smaller ones)
# layers of llama_1b, in the whole script, of the paths whose checks hold at
# any depth: phase mesh's node, phases elastic, serve, fleet and rollout,
# phase lora (c)-(e) and phase moe (d) (PERF.md, Findings, PR 15)
SERVING_DEPTH = 4
SERVE = dict(requests=24, sampled=8, threads=8, min_len=16, max_len=500, min_new=16, max_new=256,
             sampled_new=(16, 64), widths=(128, 256, 512), slots=8, block=8, depth=2,
             stagger=0.05, alone=3, alone_new=48, chunk=128, prefix=4, system=256, chunk_new=64,
             timing_prompt=128, timing_new=41, tax_rounds=3, tax_steps=32, profile_new=200,
             fixed_new=64, port_wait_s=600.0, budget=256)
# Limits of phase serve, bf16 at llama_1b. "logits": a completion token must
# equal the reference's argmax wherever the reference's top-2 gap exceeds it
# (phase decode's limit); the references are generate() of the prompt alone
# (the first few requests) and a teacher-forced forward without a cache over
# prompt + completion (every request). "logprob": each returned logprob
# against the reference's, max |diff|. "score": /score through B1 against the
# plain attention, max |diff| (phase decode's). "sampler_logprob": the
# sampler on the card against its plain version in fp64 on the host.
SERVE_TOL = dict(logits=DECODE_TOL["logits"], logprob=0.3, score=DECODE_TOL["score"],
                 sampler_logprob=1e-4)


def stop_trim(tokens, stops):
    """What the engine returns of a greedy decode ``tokens`` under stop
    sequences ``stops``: cut where the first match completes, less the
    longest sequence that matches there."""
    for i in range(len(tokens)):
        done = [s for s in stops if len(s) <= i + 1 and tokens[i + 1 - len(s):i + 1] == s]
        if done:
            return tokens[:i + 1 - max(len(s) for s in done)]
    return tokens


def sampler_check(device, vocab, seed=7):
    """The engine's ``_sample_rows`` on ``device`` against its plain
    version in fp64 on the host, on the same logits and the same noise:
    greedy and sampled rows with frequency/presence penalties (applied
    before the temperature), logit_bias forcing and banning, top-k, top-p
    and min_p. Tokens must be equal; logprobs within
    SERVE_TOL["sampler_logprob"]."""
    from tensorflowonspark_tpu_torch.serving import engine as se

    b = 8
    g = torch.Generator().manual_seed(seed)
    raw = torch.randn(b, vocab, generator=g) * 2.0
    counts = torch.zeros(b, vocab)
    counts[torch.arange(b), raw.argmax(-1)] = 3.0  # the penalties move the top token
    counts[:, :64] += torch.randint(0, 3, (b, 64), generator=g).float()
    temps = torch.tensor([0.0, 0.8, 0.8, 0.8, 0.0, 0.0, 0.0, 1.2])
    kps = torch.tensor([[vocab, 1.0, 0.0], [vocab, 1.0, 0.0], [vocab, 0.9, 0.0],
                        [vocab, 1.0, 0.05], [vocab, 1.0, 0.0], [vocab, 1.0, 0.0],
                        [vocab, 1.0, 0.0], [40, 1.0, 0.0]])
    pens = torch.zeros(b, 2)
    pens[0], pens[1], pens[7] = torch.tensor([2.0, 0.5]), torch.tensor([1.5, 0.5]), \
        torch.tensor([0.5, 0.0])
    bids = torch.full((b, 16), -1, dtype=torch.long)
    bvals = torch.zeros(b, 16)
    bids[4, 0], bvals[4, 0] = 123, 100.0  # forced
    bids[5, :2] = torch.stack([raw[5].argmax(), torch.tensor(7)])
    bvals[5, :2] = torch.tensor([-100.0, 5.0])  # the top token banned
    seeds, counters = torch.arange(b) + 11, torch.arange(b) + 100
    gates = (True, True, True, True, True)
    dev = lambda t: t.to(device)  # noqa: E731
    tok, lp = se._sample_rows(dev(raw), dev(temps), dev(kps), dev(seeds), dev(counters),
                              dev(pens), dev(counts), dev(bids), dev(bvals), gates=gates)
    noise = se._gumbel(dev(seeds), dev(counters), vocab).cpu().double()
    x = raw.double() + torch.zeros(b, vocab, dtype=torch.float64).scatter_add_(
        1, bids.clamp_min(0), torch.where(bids >= 0, bvals, 0.0).double())
    x = x - pens[:, :1].double() * counts - pens[:, 1:].double() * (counts > 0)
    want = []
    for r in range(b):
        if temps[r] == 0:
            want.append(int(x[r].argmax()))
            continue
        s = x[r] / float(temps[r])
        keep = torch.ones(vocab, dtype=torch.bool)
        k, p, m = (float(v) for v in kps[r])
        desc = torch.sort(s, descending=True).values
        if k < vocab:
            keep &= s >= desc[int(k) - 1]
        if p < 1.0:
            kept = desc[:int(k)]
            probs = torch.softmax(kept, -1)
            n_keep = max(1, int(((torch.cumsum(probs, -1) - probs) < p).sum()))
            keep &= s >= kept[n_keep - 1]
        if m > 0.0:
            keep &= s >= s.max() + math.log(m)
        want.append(int(torch.where(keep, s, -math.inf).add(noise[r]).argmax()))
    want_lp = torch.log_softmax(raw.double(), -1)[torch.arange(b), torch.tensor(want)]
    got = tok.cpu().tolist()
    err = {"tokens": got, "plain": want, "mismatches": sum(a != w for a, w in zip(got, want)),
           "max_abs_logprob": float((lp.cpu().double() - want_lp).abs().max()),
           "penalty_moved_greedy": int(raw[0].argmax()) != want[0], "forced": want[4] == 123}
    ok = (err["mismatches"] == 0 and err["max_abs_logprob"] <= SERVE_TOL["sampler_logprob"]
          and err["penalty_moved_greedy"] and err["forced"])
    return err, ok


def serve_requests(rng, c, vocab):
    """Phase serve's traffic: ``requests`` greedy requests (prompt lengths
    and budgets seeded in their ranges; the first ``alone`` get stop
    sequences once their generate() reference is known) and ``sampled``
    seeded sampled ones (temperature 0.8, top_p 0.9, min_p 0.05 on every
    other one)."""
    reqs = []
    for i in range(c["requests"]):
        n = int(rng.integers(c["min_len"], c["max_len"] + 1))
        new = c["alone_new"] if i < c["alone"] else int(rng.integers(c["min_new"],
                                                                      c["max_new"] + 1))
        reqs.append({"tokens": rng.integers(0, vocab, n).tolist(), "max_new_tokens": new})
    for i in range(c["sampled"]):
        n = int(rng.integers(c["min_len"], min(c["max_len"], 200) + 1))
        reqs.append({"tokens": rng.integers(0, vocab, n).tolist(),
                     "max_new_tokens": int(rng.integers(*c["sampled_new"])), "temperature": 0.8,
                     "top_p": 0.9, "seed": 1000 + i, **({"min_p": 0.05} if i % 2 else {})})
    return reqs


def drive_engine(eng, reqs, threads, stagger, order=None):
    """Every request through ``eng`` as a stream, from ``threads`` threads:
    thread t starts at t * stagger and submits its share of ``order`` one
    after another. Returns {i: (tokens, logprobs, ttft_s)} and the wall
    seconds."""
    order = list(range(len(reqs))) if order is None else order
    out, errors = {}, []

    def worker(t):
        time.sleep(t * stagger)
        for i in order[t::threads]:
            try:
                t0 = time.perf_counter()
                s = eng.stream(yield_logprobs=True, **reqs[i])
                first = None
                for _ in s:
                    if first is None:
                        first = time.perf_counter() - t0
                out[i] = (s.result, s.logprobs, first)
            except Exception as e:  # noqa: BLE001 - reported as a failed check
                errors.append(f"{i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in ts):
        raise SystemExit(f"serve phase: requests failed: {errors[:3]}")
    return out, time.perf_counter() - t0


def teacher_forced(model, prompt, completion):
    """Logits (len(completion), V) of a forward without a cache over
    prompt + completion, at the positions that chose each completion
    token."""
    with torch.no_grad():
        row = torch.tensor([prompt + completion], device=model.device)
        logits = model(row)[0]
    return logits[len(prompt) - 1:len(prompt) - 1 + len(completion)].float()


def hold_to_reference(tokens, logprobs, ref_logits, ref_tokens, tol):
    """A completion against a reference's logits at the same positions.
    With ``ref_tokens`` None the reference is teacher-forced on
    ``tokens`` (its logits at every position follow the same prefix):
    mismatches with its argmax where its top-2 gap exceeds
    ``tol["logits"]``, at every position. Otherwise the reference decoded
    ``ref_tokens`` itself: the two agree up to the first position where
    they part, which must be one where the reference's gap is within the
    limit (after it they continue from different prefixes). Also max
    |logprob - the reference's logprob of the same token| over the
    positions compared."""
    n = len(tokens) if ref_tokens is None else min(len(tokens), len(ref_tokens))
    if n == 0:
        return {"confident_mismatches": 0, "parted_at": 0, "max_abs_logprob": 0.0}
    dev = ref_logits.device
    gaps = top2_gap(ref_logits[:n])
    idx = torch.tensor(tokens[:n], device=dev)
    lp_err = (torch.tensor(logprobs[:n], device=dev)
              - torch.log_softmax(ref_logits[:n], -1)[torch.arange(n, device=dev), idx]).abs()
    if ref_tokens is None:
        wrong = (ref_logits[:n].argmax(-1) != idx) & (gaps > tol["logits"])
        return {"confident_mismatches": int(wrong.sum()), "parted_at": n,
                "max_abs_logprob": float(lp_err.max())}
    part = next((i for i in range(n) if tokens[i] != ref_tokens[i]), n)
    return {"confident_mismatches": int(part < n and bool(gaps[part] > tol["logits"])),
            "parted_at": part, "max_abs_logprob": float(lp_err[:part + 1].max())}


def http(url, path, body=None, timeout=900, headers=None):
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data, {"Content-Type": "application/json",
                                                    **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class Serving:
    """An in-process ``serve_model`` server on a free port, stopped on exit."""

    def __init__(self, gen):
        from tensorflowonspark_tpu_torch.tools import serve_model

        self.server = serve_model.make_server(None, port=0, gen=gen)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)


def decode_step_ms(model, batch, prompt_len, steps, vocab, device):
    """ms per ``decode_step`` at ``batch`` rows after a ``prompt_len``
    prefill: phase decode's measure, taken again in this phase so that the
    engine tax compares two numbers of one run, and under the engine's
    grad mode (``inference_mode``, which skips autograd's per-op
    bookkeeping that ``no_grad`` keeps)."""
    from tensorflowonspark_tpu_torch.models.llama import decode_step, init_cache, prefill

    p = torch.randint(0, vocab, (batch, prompt_len), device=device,
                      generator=torch.Generator(device=device).manual_seed(3))
    with torch.inference_mode():
        cache = init_cache(model.cfg, batch, device)
        logits, pos = prefill(model, cache, p)
        tok = logits.argmax(-1)
        for i in range(steps + 2):
            if i == 2:
                sync_on(device.type == "cuda")
                t0 = time.perf_counter()
            tok = decode_step(model, cache, tok, pos).argmax(-1)
            pos = pos + 1
    sync_on(device.type == "cuda")
    return (time.perf_counter() - t0) * 1e3 / steps


def engine_timing(eng, prompts, new):
    """Steady decode with every slot live: one stream per slot, admitted
    together; ms per engine step over the last-admitted row's whole
    blocks, from the sweep of its first block (its tokens 1..k arrive
    together) to its last token. Its first token is no start: it reaches
    the host only after the window's next blocks are dispatched. Also the
    sync-debug warnings the scheduler raised meanwhile, and the engine's
    decode steps over that run."""
    marks, lock = {}, threading.Lock()

    def consume(i, s):
        stamps = [time.perf_counter() for _ in s]
        with lock:
            marks[i] = stamps

    steps0 = eng.steps
    cuda = eng._cuda
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            streams = [eng.stream(p, new, eos_id=-1) for p in prompts]
            ts = [threading.Thread(target=consume, args=(i, s)) for i, s in enumerate(streams)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=900)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
    k = eng._decode_block
    row = max(marks.values(), key=lambda m: m[0])  # admitted last: its blocks are whole
    steps = len(row) - 1 - k
    step_ms = (row[-1] - row[k]) * 1e3 / steps
    # torch's own words for a synchronizing call (its one-time notice that
    # the mode is a prototype is not one)
    syncs = [str(w.message)[:160] for w in caught
             if "called a synchronizing" in str(w.message).lower()]
    blocks = (eng.steps - steps0) / eng._decode_block
    return {"rows": len(prompts), "new_tokens": new, "engine_step_ms": step_ms,
            "tokens_per_s": len(prompts) * steps / (row[-1] - row[k]),
            "sync_warnings": len(syncs), "sync_warnings_per_block": len(syncs) / max(blocks, 1),
            "sync_warning_examples": sorted(set(syncs))[:3], "blocks": blocks}


def profile_blocks(eng, prompts, new, blocks=2):
    """Device busy against idle over ``blocks`` decode blocks of the
    engine with every slot live: the profiler opens once every row
    decodes and closes after ``blocks`` more blocks reach the host; the
    streams are then cancelled."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):  # CUPTI's slow first start, outside
        torch.ones(1, device=eng._device).add_(1)
        torch.cuda.synchronize()
    streams = [eng.stream(p, new, eos_id=-1) for p in prompts]
    got = [0] * len(streams)

    def consume(i, s):
        for _ in s:
            got[i] += 1

    ts = [threading.Thread(target=consume, args=(i, s)) for i, s in enumerate(streams)]
    for t in ts:
        t.start()
    k = eng._decode_block
    deadline = time.perf_counter() + 120
    while min(got) < 2 and time.perf_counter() < deadline:
        time.sleep(0.001)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start, t0 = got[0], time.perf_counter()
        while got[0] < start + blocks * k and time.perf_counter() < deadline:
            time.sleep(0.0005)
        wall_ms = (time.perf_counter() - t0) * 1e3
        tokens = got[0] - start
    for s in streams:
        s.close()
    for t in ts:
        t.join(timeout=120)
    busy = sum((getattr(e, "self_device_time_total", 0) or 0) for e in prof.key_averages()
               if "CUDA" in str(e.device_type)) / 1e3
    return {"blocks": blocks, "tokens_in_window": tokens, "wall_ms": wall_ms,
            "device_busy_ms": busy, "device_idle_share": 1 - busy / wall_ms}


def start_server_process(ckpt, cfg, preset, model_flag, device, tmp, c, budget):
    """``python -m tensorflowonspark_tpu_torch.tools.serve_model`` on
    ``device`` over the checkpoint, on a free port it writes to a file."""
    root = os.path.dirname(os.path.abspath(__file__))
    port_file = os.path.join(tmp, "port")
    log = open(os.path.join(tmp, "server.log"), "w")
    args = [sys.executable, "-m", "tensorflowonspark_tpu_torch.tools.serve_model",
            "--llama-checkpoint", ckpt, "--model", model_flag,
            "--config-overrides", cli_overrides(cfg, preset), "--gen-engine", "continuous",
            "--gen-widths", ",".join(map(str, c["widths"])), "--gen-slots", str(c["slots"]),
            "--gen-batch-size", str(c["slots"]), "--max-new-tokens", str(budget),
            "--gen-decode-block", str(c["block"]), "--port", "0", "--port-file", port_file,
            "--gen-warmup"] + (["--device", "cpu"] if device.type == "cpu" else [])
    proc = subprocess.Popen(args, cwd=root, env=dict(os.environ, PYTHONPATH=root), stdout=log,
                            stderr=subprocess.STDOUT, text=True)
    return {"proc": proc, "port_file": port_file, "log": log, "t0": time.perf_counter()}


def server_process_url(sp, timeout):
    deadline = time.perf_counter() + timeout
    while not os.path.exists(sp["port_file"]):
        if sp["proc"].poll() is not None or time.perf_counter() > deadline:
            return None
        time.sleep(0.2)
    with open(sp["port_file"]) as f:
        return f"http://127.0.0.1:{int(f.read())}"


def stop_server_process(sp) -> int | None:
    proc = sp["proc"]
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    sp["log"].close()
    return proc.returncode


def phase_serve(fa, layers=16, rehearse=None, seed=0):
    """The continuous-batching engine and the HTTP server on the card (see
    the module docstring, phase 11); raises SystemExit when a check fails.
    ``layers`` cuts the depth (chip_faults.py); with ``rehearse={"device":
    "cpu", "tiny": True, "sizes": {...}}`` it runs at a tiny size on the
    CPU. Returns every kernel's launches in one /score call."""
    from tensorflowonspark_tpu_torch.compute.checkpoint import save_checkpoint
    from tensorflowonspark_tpu_torch.models.llama import Llama, LlamaConfig
    from tensorflowonspark_tpu_torch.ops import bn_kernels
    from tensorflowonspark_tpu_torch.serving import ContinuousBatcher
    from tensorflowonspark_tpu_torch.tools import generate_text, serve_model

    rehearse = rehearse or {}
    device = torch.device(rehearse.get("device", "cuda"))
    cuda = device.type == "cuda"
    c = {**SERVE, **rehearse.get("sizes", {})}
    if rehearse.get("tiny"):
        preset, model_flag = LlamaConfig.tiny(dtype=torch.bfloat16), "tiny"
    else:
        preset, model_flag = LlamaConfig.llama_1b(), "1b"
    cfg = dataclasses.replace(preset, remat=False, num_layers=layers)
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = Llama(cfg, device=device, seed=seed).to(cfg.dtype)  # weights cast once to bf16
    rng = np.random.default_rng(seed + 10)
    err, ok, nums = {}, {}, {}
    tol = {**SERVE_TOL, "score_launches_per_call": cfg.num_layers if cuda else 0}
    eng_kw = dict(slots=c["slots"], prompt_widths=c["widths"])
    # the servers' decode budget (README's recipe); their /score width is
    # serve_model.score_width of it: 769, whose 768 positions meet B1's gate
    budget = c["budget"]
    part_s, lap_t = {}, [t_phase]

    def lap(name):  # seconds of each part of the phase
        now = time.perf_counter()
        part_s[name], lap_t[0] = now - lap_t[0], now
    gen = dict(model=model_flag, config_overrides=cli_overrides(cfg, preset), device=device.type,
               widths=",".join(map(str, c["widths"])), width=c["widths"][-1],
               batch_size=c["slots"], max_new_tokens=budget, decode_block=c["block"],
               pipeline_depth=c["depth"])
    tmp = tempfile.mkdtemp(prefix="tfos_serve_")
    sp = None
    try:
        # (e), started first and read at the end: the server as a process
        ckpt = save_checkpoint(os.path.join(tmp, "ckpt"),
                               {"params": {n: p.detach() for n, p in model.named_parameters()}})
        gen["checkpoint"] = ckpt
        sp = start_server_process(ckpt, cfg, preset, model_flag, device, tmp, c, budget)

        # the sampler against its plain version
        err["sampler"], ok["sampler"] = sampler_check(device, cfg.vocab_size)

        # references: generate() alone for the first `alone` requests
        # (whose stop sequences come from it), a teacher-forced forward for all
        reqs = serve_requests(rng, c, cfg.vocab_size)
        alone = {}
        for i in range(c["alone"]):
            r = reqs[i]
            toks, logits = greedy_capture(model, torch.tensor([r["tokens"]], device=device),
                                          r["max_new_tokens"])
            toks = toks[0].tolist()
            r["stop"] = [[toks[12]], [toks[11], toks[12]]] if i % 2 == 0 else [toks[20:23]]
            alone[i] = (stop_trim(toks, r["stop"]), logits[0])
        greedy = [i for i, r in enumerate(reqs) if "temperature" not in r]
        lap("setup_and_references")

        # (a) staggered greedy and sampled traffic, decode_block 8, depth 2
        eng = ContinuousBatcher(model, decode_block=c["block"], pipeline_depth=c["depth"],
                                **eng_kw)
        try:
            if sp is not None:
                # the process's warm-up must not share the card with the
                # timed runs below
                err["process_start_s"] = None
                url_e = server_process_url(sp, c["port_wait_s"])
                err["process_start_s"] = time.perf_counter() - sp["t0"]
                lap("process_wait")
            eng.warmup()
            runs = {}
            runs["k8_d2"], wall = drive_engine(eng, reqs, c["threads"], c["stagger"])
            nums["a_wall_s"] = wall
            ttft = sorted(runs["k8_d2"][i][2] for i in range(len(reqs)))
            nums["ttft_p50_ms"] = float(np.percentile(ttft, 50)) * 1e3
            nums["ttft_p95_ms"] = float(np.percentile(ttft, 95)) * 1e3
            a = {"alone": {}, "teacher_forced": {}, "length_errors": []}
            for i in greedy:
                toks, lps, _ = runs["k8_d2"][i]
                r = reqs[i]
                if len(toks) > r["max_new_tokens"] or (
                        "stop" not in r and len(toks) != r["max_new_tokens"]):
                    a["length_errors"].append(i)
                tf = teacher_forced(model, r["tokens"], toks) if toks else None
                if tf is not None:
                    a["teacher_forced"][i] = hold_to_reference(toks, lps, tf, None, tol)
                if i in alone:
                    want, logits = alone[i]
                    a["alone"][i] = {**hold_to_reference(toks, lps, logits, want, tol),
                                     "equal": toks == want, "length": len(toks),
                                     "want_length": len(want)}
            a["confident_mismatches"] = sum(v["confident_mismatches"]
                                            for part in ("alone", "teacher_forced")
                                            for v in a[part].values())
            a["max_abs_logprob"] = max(v["max_abs_logprob"] for part in ("alone", "teacher_forced")
                                       for v in a[part].values())
            a["alone_equal"] = sum(v["equal"] for v in a["alone"].values())
            a["stops_hit"] = sum(v["want_length"] < reqs[i]["max_new_tokens"]
                                 for i, v in a["alone"].items())
            a["alone_lengths_ok"] = all(
                v["length"] == v["want_length"] or v["confident_mismatches"] == 0
                and v["parted_at"] < v["want_length"] for v in a["alone"].values())
            a["finite"] = all(math.isfinite(x) for i in runs["k8_d2"] for x in runs["k8_d2"][i][1])
            err["staggered"] = {k: v for k, v in a.items() if k not in ("teacher_forced",)}
            ok["staggered"] = (a["confident_mismatches"] == 0 and not a["length_errors"]
                               and a["max_abs_logprob"] <= tol["logprob"] and a["finite"]
                               and a["alone_lengths_ok"] and a["stops_hit"] >= 1)
            lap("a_staggered")

            # (b) the same traffic on the same engine at decode_block 1 and
            # depth 1 (set_knobs), in the reverse order of arrival: block,
            # depth, order, slots and batchmates all differ from (a)
            eng.set_knobs(decode_block=1, pipeline_depth=1)
            runs["k1_d1_reversed"], _ = drive_engine(eng, reqs, c["threads"], c["stagger"],
                                                     list(reversed(range(len(reqs)))))
            eng.set_knobs(decode_block=c["block"], pipeline_depth=c["depth"])
            base = runs["k8_d2"]
            diff = {name: [i for i in base if runs[name][i][0] != base[i][0]]
                    for name in runs if name != "k8_d2"}
            sampled = [i for i in range(len(reqs)) if i not in greedy]
            err["identity"] = {"differing": diff, "sampled": len(sampled),
                               "sampled_distinct": len({tuple(base[i][0]) for i in sampled})}
            ok["identity"] = all(not v for v in diff.values()) and \
                err["identity"]["sampled_distinct"] == len(sampled)
            lap("b_replay")

            # (c) chunked prefill with the prefix cache: a hit equals a
            # miss exactly; chunked against bucketed by the confident rule
            system = rng.integers(0, cfg.vocab_size, c["system"]).tolist()
            tails = [rng.integers(0, cfg.vocab_size, n).tolist()
                     for n in (c["chunk"] // 3, c["chunk"] // 2)]
            prompts_c = [system + t for t in tails]
            new_c = c["chunk_new"]
            chunk_kw = dict(eng_kw, prefill_chunk=c["chunk"], decode_block=c["block"])
            hit_eng = ContinuousBatcher(model, prefix_cache=c["prefix"], **chunk_kw)
            try:
                # a miss (then stored), a hit on the whole prompt, a hit on
                # the system prefix
                miss_lp = [hit_eng.submit(prompts_c[0], new_c, return_logprobs=True)]
                again = hit_eng.submit(prompts_c[0], new_c)
                shared = hit_eng.submit(prompts_c[1], new_c)
                pstats = {k: v for k, v in hit_eng.stats().items() if k.startswith("prefix")}
            finally:
                hit_eng.close()
            miss_eng = ContinuousBatcher(model, **chunk_kw)
            try:
                miss_lp.append(miss_eng.submit(prompts_c[1], new_c, return_logprobs=True))
            finally:
                miss_eng.close()
            miss = [m for m, _ in miss_lp]
            bucketed = eng.submit_many(prompts_c, new_c)
            rule = [hold_to_reference(m, m_lp, teacher_forced(model, p, b), b, tol)
                    for (m, m_lp), p, b in zip(miss_lp, prompts_c, bucketed)]
            err["chunked"] = {"prefix": pstats, "hit_equals_miss": [again == miss[0],
                                                                    shared == miss[1]],
                              "chunked_vs_bucketed": rule}
            ok["chunked"] = (again == miss[0] and shared == miss[1]
                             and pstats.get("prefix_hits", 0) >= 2
                             and all(r["confident_mismatches"] == 0
                                     and r["max_abs_logprob"] <= tol["logprob"] for r in rule))
            lap("c_chunked")

            # (f) the engine's step with every slot live against the bare
            # decode_step at the same batch, in alternating rounds (the
            # host's pace drifts within a run): the tax is the median of
            # the rounds' ratios; host syncs per block, device busy share
            tp = [rng.integers(0, cfg.vocab_size, c["timing_prompt"]).tolist()
                  for _ in range(c["slots"])]
            rounds = []
            for _ in range(c["tax_rounds"]):
                bare = decode_step_ms(model, c["slots"], c["timing_prompt"], c["tax_steps"],
                                      cfg.vocab_size, device)
                rounds.append({**engine_timing(eng, tp, c["timing_new"]),
                               "decode_step_ms_b8": bare})
            mid = lambda k: float(np.median([r[k] for r in rounds]))  # noqa: E731
            nums.update(
                rows=c["slots"], new_tokens=c["timing_new"], rounds=len(rounds),
                engine_step_ms=mid("engine_step_ms"), tokens_per_s=mid("tokens_per_s"),
                decode_step_ms_b8=mid("decode_step_ms_b8"),
                engine_tax=float(np.median([r["engine_step_ms"] / r["decode_step_ms_b8"]
                                            for r in rounds])),
                sync_warnings=sum(r["sync_warnings"] for r in rounds),
                blocks=sum(r["blocks"] for r in rounds),
                sync_warning_examples=sorted({x for r in rounds
                                              for x in r["sync_warning_examples"]})[:3],
                tax_rounds=[{k: r[k] for k in ("engine_step_ms", "decode_step_ms_b8")}
                            for r in rounds])
            nums["sync_warnings_per_block"] = nums["sync_warnings"] / max(nums["blocks"], 1)
            if cuda:
                nums["profile"] = profile_blocks(eng, tp, c["profile_new"])
            lap("f_timing")
            # the server's checks take the greedy requests of the smallest
            # budgets; /v1/completions and the process one without a stop
            short = sorted(greedy, key=lambda i: reqs[i]["max_new_tokens"])[:c["slots"]]
            i1 = min((i for i in greedy if "stop" not in reqs[i]),
                     key=lambda i: reqs[i]["max_new_tokens"])
            bucket_out = {i: runs["k8_d2"][i] for i in short}
        finally:
            eng.close()

        # (d) the HTTP server in process: the continuous engine, then the
        # fixed path
        with Serving({**gen, "engine": "continuous", "warmup": True}) as srv:
            url = srv.url
            got, errors = {}, []

            def post(i):
                r = reqs[i]
                body = {"prompts": [r["tokens"]], "max_new_tokens": r["max_new_tokens"],
                        **({"stop": r["stop"]} if "stop" in r else {})}
                code, text = http(url, "/generate", body)
                if code != 200:
                    errors.append(text[:300])
                else:
                    got[i] = json.loads(text)["completions"][0]

            ts = [threading.Thread(target=post, args=(i,)) for i in bucket_out]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=900)
            i0 = greedy[0]
            code_s, text_s = http(url, "/generate", {"prompts": [reqs[i0]["tokens"]],
                                                     "max_new_tokens": reqs[i0]["max_new_tokens"],
                                                     "stop": reqs[i0]["stop"], "stream": True})
            stream_lines = [json.loads(x) for x in text_s.splitlines()] if code_s == 200 else []
            code_v, text_v = http(url, "/v1/completions", {
                "prompt": reqs[i1]["tokens"], "max_tokens": reqs[i1]["max_new_tokens"],
                "temperature": 0})
            v1 = json.loads(text_v)["choices"][0]["tokens"] if code_v == 200 else None
            score_rows = [reqs[i]["tokens"] + runs["k8_d2"][i][0] for i in short]
            sync_on(cuda)
            fa.reset_launches()
            bn_kernels.reset_launches()
            code_sc, text_sc = http(url, "/score", {"sequences": score_rows})
            sync_on(cuda)
            launches = {**fa.LAUNCHES, **bn_kernels.LAUNCHES}
            lp_kernel = json.loads(text_sc)["logprobs"] if code_sc == 200 else None
            metrics = http(url, "/metrics")
            stats = http(url, "/stats")
        lap("d_server_continuous")
        retarget(model, dataclasses.replace(cfg, attention_impl="xla"))
        score_width = serve_model.score_width(c["widths"][-1], budget, cfg.max_seq_len)
        lp_plain = generate_text.build_score_fn(model, width=score_width, bsz=c["slots"])(
            score_rows)
        retarget(model, cfg)
        score_err = max((float(np.abs(np.array(k) - np.array(p)).max())
                         for k, p in zip(lp_kernel or [], lp_plain)), default=math.inf)
        fixed_prompts = [reqs[i]["tokens"] for i in short]
        with Serving({**gen, "engine": "fixed", "max_new_tokens": c["fixed_new"]}) as srv:
            code_f, text_f = http(srv.url, "/generate", {"prompts": fixed_prompts})
        fixed_want, _ = generate_text.decode_batches(model, fixed_prompts, batch_size=c["slots"],
                                                     width=c["widths"][-1],
                                                     max_new_tokens=c["fixed_new"],
                                                     pad_to_batch=True)
        err["http"] = {
            "generate_errors": errors[:3],
            "generate_mismatches": [i for i in bucket_out if got.get(i) != bucket_out[i][0]],
            "stream_equal": bool(stream_lines) and stream_lines[-1].get("completion")
            == runs["k8_d2"][i0][0],
            "v1_equal": v1 == runs["k8_d2"][i1][0],
            "score_width": score_width, "score_launches": launches,
            "score_max_abs_logprob": score_err,
            "metrics": metrics[0], "metrics_has_engine": "engine_ttft_seconds" in metrics[1],
            "stats": stats[0], "fixed": code_f,
            "fixed_equal": code_f == 200 and json.loads(text_f)["completions"] == fixed_want,
        }
        h = err["http"]
        ok["http"] = (not h["generate_errors"] and not h["generate_mismatches"]
                      and h["stream_equal"] and h["v1_equal"] and h["metrics"] == 200
                      and h["metrics_has_engine"] and h["stats"] == 200 and h["fixed_equal"]
                      and score_err <= tol["score"]
                      and launches == {"fwd": tol["score_launches_per_call"], "dq": 0, "dkv": 0,
                                       "pair": 0, "cross": 0})
        lap("d_server_fixed")

        # (e) read: one /generate and one /score of the process
        e = {"start_s": err.pop("process_start_s", None)}
        if url_e is None:
            e["error"] = "the server process did not come up"
        else:
            code_g, text_g = http(url_e, "/generate", {"prompts": [reqs[i1]["tokens"]],
                                                       "max_new_tokens": reqs[i1]["max_new_tokens"]})
            code_c, text_c = http(url_e, "/score", {"sequences": score_rows[:1]})
            e["generate_equal"] = code_g == 200 and json.loads(text_g)["completions"][0] \
                == runs["k8_d2"][i1][0]
            e["score_max_abs"] = (float(np.abs(np.array(json.loads(text_c)["logprobs"][0])
                                               - np.array(lp_kernel[0])).max())
                                  if code_c == 200 and lp_kernel else math.inf)
        e["returncode"] = stop_server_process(sp)
        sp = None
        lap("e_process")
        err["process"] = e
        ok["process"] = bool(e.get("generate_equal")) and e.get("score_max_abs", math.inf) <= 1e-4
        if not ok["process"]:
            with open(os.path.join(tmp, "server.log")) as f:
                e["log"] = f.read()[-3000:]
    finally:
        if sp is not None:
            stop_server_process(sp)
        shutil.rmtree(tmp, ignore_errors=True)

    nums["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    nums["wall_s"] = time.perf_counter() - t_phase
    nums["part_s"] = part_s
    nums["nvidia_smi"] = nvidia_smi() if cuda else None
    emit({"phase": "serve", "part": "numbers", **nums})
    good = all(ok.values())
    emit({"phase": "serve", "case": "serve_checks", "seed": seed, "layers": cfg.num_layers,
          "hidden": cfg.hidden_size, "requests": len(reqs), "slots": c["slots"],
          "widths": list(c["widths"]), "checks": ok, "err": err, "tol": tol, "ok": good})
    if not good:
        raise SystemExit("serve phase failed: " + ", ".join(k for k, v in ok.items() if not v))
    return launches


# phase fleet: sizes (a CPU rehearsal passes smaller ones). The model,
# traffic, slots and widths are phase serve's (SERVE); the engines prefill
# in chunks of `chunk` with a `prefix`-entry L1, which the L2 needs.
FLEET = dict(replicas=2, l2_bytes=1 << 30, l2_prompt=384, l2_tail=16, l2_new=32, watchdog_s=3.0,
             wedge_s=9.0, drain_s=60.0, probe_s=0.5, close_rounds=50, lookup_bound_s=0.5, spawn_wait_s=600.0, ready_wait_s=300.0,
             stall_cycles=2_000_000_000, lookup_rounds=5, server_requests=4, post_kill=4,
             light_requests=12, light_new=64, kill_rounds=20)
# (c) and (d) drive the `light_requests` greedy requests of phase serve's
# traffic at budgets of at most `light_new` tokens.
# Limits of phase fleet: phase serve's confident-token rule for the fleet's
# greedy completions against one engine's on the same traffic, and each
# replica's share of the requests (at least a quarter).
FLEET_TOL = dict(logits=SERVE_TOL["logits"], logprob=SERVE_TOL["logprob"], share=0.25)


def drive_outcomes(target, reqs, threads, stagger, order=None, started=None):
    """``drive_engine`` that keeps every request's outcome instead of
    failing on the first error: {i: ("ok", tokens, logprobs, ttft_s)} or
    {i: ("err", error type, message, tokens yielded)}; ``started`` (an
    Event) is set once every thread has opened its first stream. Returns
    the outcomes, the wall seconds and whether every thread ended."""
    order = list(range(len(reqs))) if order is None else order
    out, opened = {}, [0]
    lock = threading.Lock()

    def worker(t):
        time.sleep(t * stagger)
        for i in order[t::threads]:
            n, t0, first = 0, time.perf_counter(), None
            try:
                s = target.stream(yield_logprobs=True, **reqs[i])
                with lock:
                    opened[0] += 1
                    if started is not None and opened[0] >= threads:
                        started.set()
                for _ in s:
                    n += 1
                    if first is None:
                        first = time.perf_counter() - t0
                out[i] = ("ok", s.result, s.logprobs, first)
            except Exception as e:  # noqa: BLE001 - an outcome of its own
                out[i] = ("err", type(e).__name__, str(e)[:200], n)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=900)
    return out, time.perf_counter() - t0, not any(t.is_alive() for t in ts)


def against_engine(model, reqs, greedy, got, want, tol):
    """The fleet's greedy completions ``got`` (outcomes) against one
    engine's ``want`` on the same requests, by phase serve's confident
    rule: where the two part, the engine's teacher-forced gap must be
    within the limit. Requests that did not complete are left out."""
    rows = {}
    for i in greedy:
        if i not in got or got[i][0] != "ok":
            continue
        toks, lps = got[i][1], got[i][2]
        ref = want[i][1]
        tf = teacher_forced(model, reqs[i]["tokens"], ref) if ref else None
        # a request at a smaller budget than the engine's is its prefix
        same = toks == ref[:len(toks)]
        rows[i] = ({**hold_to_reference(toks, lps, tf, ref, tol), "equal": same}
                   if tf is not None else {"confident_mismatches": int(not same),
                                           "max_abs_logprob": 0.0, "equal": same})
    return {"compared": len(rows),
            "confident_mismatches": sum(r["confident_mismatches"] for r in rows.values()),
            "max_abs_logprob": max((r["max_abs_logprob"] for r in rows.values()), default=0.0),
            "equal": sum(r["equal"] for r in rows.values()),
            "parted": {i: r.get("parted_at") for i, r in rows.items() if not r["equal"]}}


def close_race_check(rounds):
    """The port's ``CacheServer.close()`` against a lookup on a connection
    it had open: fill, lookup (a hit), close, lookup — ``rounds`` times.
    Every lookup after ``close()`` must miss within the client's timeout,
    and no connection of the server may stay open."""
    from tensorflowonspark_tpu_torch.cachetier import CacheClient, CacheServer, CacheTier

    hits_before = misses_after = open_after = 0
    slowest = 0.0
    for r in range(rounds):
        tier = CacheTier(capacity_bytes=1 << 20)
        srv = CacheServer(tier).start()
        cl = CacheClient(srv.address)
        try:
            cl.fill("prefix", f"k{r}", b"v")
            deadline = time.perf_counter() + 10
            while tier.stats()["fills"] < 1 and time.perf_counter() < deadline:
                time.sleep(0.001)
            hits_before += cl.lookup("prefix", f"k{r}", timeout_s=2.0) == b"v"
            srv.close()
            open_after += len(srv._conns)
            t0 = time.perf_counter()
            misses_after += cl.lookup("prefix", f"k{r}", timeout_s=0.5) is None
            slowest = max(slowest, time.perf_counter() - t0)
        finally:
            cl.close()
            srv.close()
    return {"rounds": rounds, "hits_before_close": hits_before,
            "misses_after_close": misses_after, "conns_open_after_close": open_after,
            "slowest_miss_s": slowest}


def filler_ordering_check(device, cfg, stall_cycles):
    """The L2 filler against the work that writes an entry: a single-row
    cache of ``cfg``'s size is written on the current stream behind a
    device stall (``torch.cuda._sleep``) and offered at once, with no host
    sync. The blob that reaches the tier must equal the written cache bit
    for bit: a filler that copied before the entry's event would read
    the memory's earlier contents (a cache of other values, freed just
    before, which the allocator hands out again)."""
    from tensorflowonspark_tpu_torch.cachetier import CacheTier, LocalClient, PrefixL2
    from tensorflowonspark_tpu_torch.cachetier.prefix import NS, decode_leaves, prefix_key
    from tensorflowonspark_tpu_torch.models.llama import init_cache
    from tensorflowonspark_tpu_torch.serving.engine import _cache_leaves

    tier = CacheTier(capacity_bytes=1 << 31)
    l2 = PrefixL2(LocalClient(tier), chunk=1, lookup_timeout_s=5.0)
    try:
        old = _cache_leaves(init_cache(cfg, 1, device))
        for t in old:
            t.fill_(3)
        del old, t
        leaves = _cache_leaves(init_cache(cfg, 1, device))  # the same memory again
        if device.type == "cuda":
            torch.cuda._sleep(stall_cycles)
        for t in leaves:
            t.fill_(7)  # queued behind the stall
        l2.offer([1, 2], leaves, None, "v0")
        deadline = time.perf_counter() + 60
        while tier.stats()["fills"] < 1 and time.perf_counter() < deadline:
            time.sleep(0.005)
        blob = tier.lookup(NS, prefix_key("v0", None, [1, 2]))
        got = decode_leaves(blob) if blob is not None else None
        sync_on(device.type == "cuda")
        want = [t.cpu() for t in leaves]
        equal = got is not None and len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want))
        return {"blob_bytes": len(blob) if blob is not None else 0, "leaves": len(want),
                "blob_equals_entry": bool(equal)}
    finally:
        l2.close()


def tcp_lookup_ms(nbytes, rounds):
    """ms of one ``CacheClient.lookup`` of an ``nbytes`` blob from a
    ``CacheServer`` over loopback TCP (median of ``rounds``)."""
    from tensorflowonspark_tpu_torch.cachetier import CacheClient, CacheServer, CacheTier

    tier = CacheTier(capacity_bytes=4 * nbytes)
    tier.fill("prefix", "k", bytes(nbytes))
    srv = CacheServer(tier).start()
    cl = CacheClient(srv.address)
    try:
        times = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            blob = cl.lookup("prefix", "k", timeout_s=30.0)
            times.append((time.perf_counter() - t0) * 1e3)
            if blob is None or len(blob) != nbytes:
                return None
        return float(np.median(times))
    finally:
        cl.close()
        srv.close()


def spawn_fleet_checks(model, sf, srouter, reqs, light, want, c, l2_case, tol):
    """Part (d) on a started subprocess fleet ``sf`` behind ``srouter``:
    the daemon L2 across the children, a child SIGKILLed under streaming
    load (the requests ``light`` of ``reqs``) and respawned, the daemon
    SIGKILLed and respawned. Returns the readings with ``ok``."""
    from tensorflowonspark_tpu_torch.cachetier import CacheClient

    d = {}
    views = sf.views()
    # the L2 across processes: the prefix on child 0, the extension on child 1
    prompt, ext, miss = l2_case
    fills0 = sf.cache_stats()["fills"]
    views[0]["handle"].submit_many([prompt], c["l2_new"])
    deadline = time.perf_counter() + 120
    while (sf.cache_stats() or {"fills": fills0})["fills"] - fills0 < 3 and \
            time.perf_counter() < deadline:
        time.sleep(0.05)
    hits0 = views[1]["handle"].stats().get("prefix_l2_hits", 0)
    hit = views[1]["handle"].submit_many([ext], c["l2_new"])[0]
    d["l2"] = {"fills": sf.cache_stats()["fills"] - fills0, "child0": {k: v for k, v in views[0]["handle"].stats().items() if "prefix" in k}, "child1": {k: v for k, v in views[1]["handle"].stats().items() if "prefix" in k},
               "child1_l2_hits": views[1]["handle"].stats().get("prefix_l2_hits", 0) - hits0,
               "hit_equals_inproc_miss": miss is None or hit == miss}
    l2_ok = (d["l2"]["fills"] >= 1 and d["l2"]["child1_l2_hits"] >= 1
             and d["l2"]["hit_equals_inproc_miss"])

    # SIGKILL a child while it holds queued streams (not yet at their first
    # token: they fail over) and decoding ones (they end with ReplicaGone).
    # A round of traffic can end before the victim is seen holding a stream
    # that has no first token (a prefill is a short window on a loaded
    # host); then the round's outcomes are kept and another round starts,
    # up to kill_rounds, so that the kill lands on such a stream.
    fo0 = srouter.stats()["router"]["failovers"]
    victim = views[1]
    earlier, held, at_kill = [], False, {}

    def traffic(res, started):
        res["out"], _, res["ended"] = drive_outcomes(srouter, reqs, c["threads"], c["stagger"],
                                                     order=light, started=started)

    for _ in range(c["kill_rounds"]):
        started, res = threading.Event(), {}
        tr = threading.Thread(target=traffic, args=(res, started))
        tr.start()
        started.wait(timeout=300)
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline and tr.is_alive():
            at_kill = victim["handle"].stats()
            if at_kill.get("queue_depth", 0) >= 1 or at_kill.get("prefill_in_progress"):
                held = True
                break
            time.sleep(0.01)
        if held:
            break
        tr.join(timeout=900)
        earlier.append(res)
    t_kill = time.perf_counter()
    os.kill(victim["handle"].pid, 9)
    post = {}

    def submit_one(i):
        try:
            post[i] = ("ok", srouter.submit(reqs[i]["tokens"], reqs[i]["max_new_tokens"]))
        except Exception as e:  # noqa: BLE001 - an outcome of its own
            post[i] = ("err", type(e).__name__)

    burst = [threading.Thread(target=submit_one, args=(i,)) for i in light[:c["post_kill"]]]
    for t in burst:
        t.start()
    tr.join(timeout=900)
    for t in burst:
        t.join(timeout=900)
    out = res.get("out", {})
    errors = [o for o in out.values() if o[0] != "ok"]
    cmp_d = against_engine(model, reqs, light, out, want, tol)

    # while the child respawns: SIGKILL the cachetier daemon — lookups miss
    # within their bound, the fleet serves, the supervisor respawns it on
    # the same port
    with sf._cache_lock:
        daemon = sf._cache_proc
    addr = sf.cachetier_address
    t_dead = time.perf_counter()
    os.kill(daemon.pid, 9)
    daemon.wait()
    probe = CacheClient(addr)
    try:
        t0 = time.perf_counter()
        missed = probe.lookup("prefix", "any", timeout_s=c["lookup_bound_s"]) is None
        miss_s = time.perf_counter() - t0
    finally:
        probe.close()
    i = light[0]
    served = srouter.submit(reqs[i]["tokens"], reqs[i]["max_new_tokens"]) is not None
    deadline = time.perf_counter() + 60
    while time.perf_counter() < deadline and not (sf._cache_respawns >= 1
                                                  and sf.cache_stats() is not None):
        time.sleep(0.05)
    d["daemon"] = {"lookup_missed": missed, "miss_s": miss_s, "served_while_down": served,
                   "respawns": sf._cache_respawns, "same_address": sf.cachetier_address == addr,
                   "respawn_s": time.perf_counter() - t_dead, "stats": sf.cache_stats()}
    daemon_ok = (missed and miss_s <= c["lookup_bound_s"] + 1.0 and served
                 and sf._cache_respawns >= 1 and sf.cache_stats() is not None
                 and d["daemon"]["same_address"])

    back = wait_seats_ready(sf, 1, c["ready_wait_s"])
    respawn_s = None if back is None else time.perf_counter() - t_kill
    # both children serve again, the respawned one included
    again = {}
    for v in sf.views():
        i = light[-1 - v["rid"]]
        toks = v["handle"].submit_many([reqs[i]["tokens"]], reqs[i]["max_new_tokens"],
                                       return_logprobs=True)
        again[i] = ("ok", toks[0][0], toks[1][0], None)
    cmp_again = against_engine(model, reqs, list(again), again, want, tol)
    earlier_ok = all(r.get("ended") and len(r.get("out", {})) == len(light)
                     and all(o[0] == "ok" for o in r["out"].values()) for r in earlier)
    d["kill"] = {"at_kill": {k: at_kill.get(k) for k in ("queue_depth", "slots_busy",
                                                          "prefill_in_progress")},
                 "held_at_kill": held, "earlier_rounds": len(earlier),
                 "earlier_rounds_ok": earlier_ok,
                 "failovers": srouter.stats()["router"]["failovers"] - fo0,
                 "resolved": len(out), "ended": res.get("ended"),
                 "terminal_errors": [(o[1], o[3]) for o in errors][:6],
                 "post_kill": [o[0] for o in post.values()], "respawn_s": respawn_s,
                 "vs_engine": cmp_d, "children_vs_engine": cmp_again,
                 "outstanding": srouter.stats()["router"]["outstanding"]}
    k = d["kill"]
    kill_ok = (held and earlier_ok and bool(res.get("ended")) and len(out) == len(light)
               and k["failovers"] >= 1
               and all(o[1] == "ReplicaGone" and o[3] > 0 for o in errors)
               and all(x == "ok" for x in k["post_kill"]) and back is not None
               and not k["outstanding"] and cmp_d["confident_mismatches"] == 0
               and cmp_again["confident_mismatches"] == 0 and cmp_again["compared"] == len(again))
    d["checks"] = {"l2": l2_ok, "kill": kill_ok, "daemon": daemon_ok}
    d["ok"] = l2_ok and kill_ok and daemon_ok
    return d


def wait_seats_ready(fleet, respawns, timeout):
    """Seconds until every seat is READY with at least ``respawns``
    respawns in all (None past ``timeout``)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        seats = fleet.stats()["seats"]
        if all(s["state"] == "ready" for s in seats.values()) and \
                sum(s["respawns"] for s in seats.values()) >= respawns:
            return time.perf_counter() - t0
        time.sleep(0.05)
    return None


def start_cache_daemon(tmp, capacity):
    """``python -m tensorflowonspark_tpu_torch.cachetier.service`` on a free
    port; returns (process, address)."""
    root = os.path.dirname(os.path.abspath(__file__))
    pf = os.path.join(tmp, "cachetier.port")
    proc = subprocess.Popen([sys.executable, "-m", "tensorflowonspark_tpu_torch.cachetier.service",
                             "--port", "0", "--port-file", pf, "--capacity-bytes", str(capacity)],
                            cwd=root, env=dict(os.environ, PYTHONPATH=root))
    deadline = time.perf_counter() + 60
    while not os.path.exists(pf):
        if proc.poll() is not None or time.perf_counter() > deadline:
            proc.kill()
            raise SystemExit("fleet phase: the cachetier daemon did not start")
        time.sleep(0.05)
    with open(pf) as f:
        return proc, f"127.0.0.1:{int(f.read())}"


def phase_fleet(fa, layers=16, rehearse=None, seed=0, parts="abcde"):
    """The serving fleet on the card (see the module docstring, phase 12);
    raises SystemExit when a check fails. ``layers`` cuts the depth and
    ``parts`` picks the parts to run (chip_faults.py runs "bc"; d and e
    need a, whose single engine is their reference); with
    ``rehearse={"device": "cpu", "tiny": True, "sizes": {...}}`` it runs at a
    tiny size on the CPU. Returns every kernel's launches in one /score
    call of the fleet server (zeros without part e)."""
    from tensorflowonspark_tpu_torch.cachetier.prefix import NS, prefix_key
    from tensorflowonspark_tpu_torch.compute.checkpoint import save_checkpoint
    from tensorflowonspark_tpu_torch.models.llama import Llama, LlamaConfig, init_cache
    from tensorflowonspark_tpu_torch.ops import bn_kernels
    from tensorflowonspark_tpu_torch.serving import ContinuousBatcher, FleetRouter, ServingFleet
    from tensorflowonspark_tpu_torch.utils import failpoints

    rehearse = rehearse or {}
    device = torch.device(rehearse.get("device", "cuda"))
    cuda = device.type == "cuda"
    c = {**SERVE, **FLEET, **rehearse.get("sizes", {})}
    if rehearse.get("tiny"):
        preset, model_flag = LlamaConfig.tiny(dtype=torch.bfloat16), "tiny"
    else:
        preset, model_flag = LlamaConfig.llama_1b(), "1b"
    cfg = dataclasses.replace(preset, remat=False, num_layers=layers)
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = Llama(cfg, device=device, seed=seed).to(cfg.dtype)
    rng = np.random.default_rng(seed + 10)  # phase serve's traffic
    err, ok, nums = {}, {}, {}
    tol = {**FLEET_TOL, "score_launches_per_call": cfg.num_layers if cuda else 0}
    eng_kw = dict(slots=c["slots"], prompt_widths=c["widths"], decode_block=c["block"],
                  pipeline_depth=c["depth"], prefill_chunk=c["chunk"], prefix_cache=c["prefix"])
    budget = c["budget"]
    entry_bytes = sum(t.numel() * t.element_size()
                      for layer in init_cache(cfg, 1, device="meta") for t in layer.values())
    part_s, lap_t = {}, [t_phase]
    launches = {"fwd": 0, "dq": 0, "dkv": 0, "pair": 0, "cross": 0}

    def lap(name):
        now = time.perf_counter()
        part_s[name], lap_t[0] = now - lap_t[0], now

    reqs = serve_requests(rng, c, cfg.vocab_size)
    for r in reqs:  # phase serve's stop sequences need its generate() references
        r.pop("stop", None)
    greedy = [i for i, r in enumerate(reqs) if "temperature" not in r]
    capped = [dict(r, max_new_tokens=min(r["max_new_tokens"], c["light_new"])) for r in reqs]
    light = greedy[:c["light_requests"]]
    tmp = tempfile.mkdtemp(prefix="tfos_fleet_")
    spawned = {}  # (d)'s fleet, built in the background while (a)'s engines warm up
    fleet = router = None
    try:
        # the lookup bound of the daemon's L2: a lookup of one entry over
        # loopback TCP, with room for a loaded host
        nums["tcp_lookup_ms"] = tcp_lookup_ms(entry_bytes, c["lookup_rounds"])
        nums["entry_bytes"] = entry_bytes
        lookup_s = max(0.5, 10 * (nums["tcp_lookup_ms"] or 100.0) / 1e3)
        nums["spawn_lookup_timeout_s"] = lookup_s
        if "d" in parts or "e" in parts:
            ckpt = save_checkpoint(os.path.join(tmp, "ckpt"),
                                   {"params": {n: p.detach() for n, p in model.named_parameters()}})
        if "d" in parts:
            root = os.path.dirname(os.path.abspath(__file__))
            argv = ["--llama-checkpoint", ckpt, "--model", model_flag, "--seed", str(seed),
                    "--config-overrides", cli_overrides(cfg, preset), "--device", device.type,
                    "--gen-engine", "continuous", "--gen-widths", ",".join(map(str, c["widths"])),
                    "--gen-slots", str(c["slots"]), "--gen-batch-size", str(c["slots"]),
                    "--max-new-tokens", str(budget), "--gen-decode-block", str(c["block"]),
                    "--gen-pipeline-depth", str(c["depth"]), "--gen-prefill-chunk",
                    str(c["chunk"]), "--gen-prefix-cache", str(c["prefix"]), "--gen-warmup",
                    "--cachetier-lookup-timeout", str(lookup_s)]
            env = dict(os.environ, PYTHONPATH=root, **({} if cuda else {"OMP_NUM_THREADS": "1"}))

            def build_spawned():
                t0 = time.perf_counter()
                try:
                    spawned["fleet"] = ServingFleet(
                        spawn_argv=argv, replicas=c["replicas"], probe_interval=c["probe_s"],
                        drain_timeout=10.0, start_timeout=c["spawn_wait_s"],
                        prefix_l2={"mode": "spawn", "capacity_bytes": c["l2_bytes"],
                                   "lookup_timeout_s": lookup_s},
                        spawn_kwargs={"env": env, "spawn_timeout": c["spawn_wait_s"]})
                except BaseException as e:  # noqa: BLE001 - read by part d
                    spawned["error"] = f"{type(e).__name__}: {e}"
                spawned["start_s"] = time.perf_counter() - t0

            spawner = threading.Thread(target=build_spawned, daemon=True)
            spawner.start()
        lap("setup")

        # (a) the in-process fleet against one engine on phase serve's traffic
        def factory():
            return ContinuousBatcher(model, watchdog_s=c["watchdog_s"], **eng_kw)

        single = ContinuousBatcher(model, **eng_kw)
        try:
            single.warmup()
            fleet = ServingFleet(factory=factory, replicas=c["replicas"],
                                 probe_interval=c["probe_s"], drain_timeout=c["drain_s"],
                                 prefix_l2={"mode": "inproc", "capacity_bytes": c["l2_bytes"]})
            router = FleetRouter(fleet)
            if "d" in parts:
                spawner.join(timeout=c["spawn_wait_s"])  # its warm-ups must not share the card
            lap("a_build")
            if "a" in parts:
                want, wall_1, _ = drive_outcomes(single, reqs, c["threads"], c["stagger"])
                before = [v["handle"].stats()["admitted"] for v in fleet.views()]
                steps0 = [v["handle"].engine.steps for v in fleet.views()]
                # the fleet's traffic under sync-debug mode: every L2 offer
                # and lookup of both replicas is in this window
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    if cuda:
                        torch.cuda.set_sync_debug_mode("warn")
                    try:
                        got, wall_f, ended = drive_outcomes(router, reqs, c["threads"],
                                                            c["stagger"])
                    finally:
                        if cuda:
                            torch.cuda.set_sync_debug_mode(0)
                share = [v["handle"].stats()["admitted"] - b for v, b in zip(fleet.views(), before)]
                syncs = [str(w.message)[:160] for w in caught
                         if "called a synchronizing" in str(w.message).lower()]
                blocks = sum(v["handle"].engine.steps - s0
                             for v, s0 in zip(fleet.views(), steps0)) / c["block"]
                offered = sum(v["handle"].stats().get("prefix_l2_offered", 0)
                              for v in fleet.views())
                err["l2_syncs"] = {"sync_warnings": len(syncs),
                                   "sync_warnings_per_block": len(syncs) / max(blocks, 1),
                                   "sync_warning_examples": sorted(set(syncs))[:3],
                                   "blocks": blocks, "offered": offered}
                ok["l2_syncs"] = not syncs and blocks > 0 and offered > 0
                single_ok = all(want.get(i, ("err",))[0] == "ok" for i in range(len(reqs)))
                cmp_a = against_engine(model, reqs, greedy, got, want, tol)

                def rate(out, wall):
                    return sum(len(o[1]) for o in out.values() if o[0] == "ok") / wall

                def ttft(out, q):
                    return float(np.percentile([o[3] for o in out.values() if o[0] == "ok"],
                                               q)) * 1e3
                nums["a"] = {"fleet_tokens_per_s": rate(got, wall_f),
                             "engine_tokens_per_s": rate(want, wall_1),
                             "fleet_ttft_p50_ms": ttft(got, 50), "fleet_ttft_p95_ms": ttft(got, 95),
                             "engine_ttft_p50_ms": ttft(want, 50),
                             "engine_ttft_p95_ms": ttft(want, 95),
                             "fleet_wall_s": wall_f, "engine_wall_s": wall_1}
                errors = {i: o for i, o in got.items() if o[0] != "ok"}
                err["a_inproc"] = {**cmp_a, "share": share, "errors": list(errors.values())[:3],
                                   "sampled_equal": sum(got[i][1] == want[i][1]
                                                        for i in range(len(reqs))
                                                        if i not in greedy and i in got
                                                        and got[i][0] == "ok"),
                                   "single_ok": single_ok}
                ok["a_inproc"] = (ended and single_ok and not errors and len(got) == len(reqs)
                                  and cmp_a["confident_mismatches"] == 0
                                  and cmp_a["compared"] == len(greedy)
                                  and min(share) >= tol["share"] * len(reqs))
                lap("a_traffic")
        finally:
            single.close()

        views = fleet.views()
        version = views[0]["handle"].engine.weights_version
        prompt = rng.integers(0, cfg.vocab_size, c["l2_prompt"]).tolist()
        ext = prompt + rng.integers(0, cfg.vocab_size, c["l2_tail"]).tolist()
        miss = None
        if "b" in parts:
            # (b) a prefix prefilled on replica 0 is an L2 hit on replica 1
            fills0 = fleet.cache_stats()["fills"]
            views[0]["handle"].submit_many([prompt], c["l2_new"])
            deadline = time.perf_counter() + 120
            key = prefix_key(version, None, prompt)
            while fleet.cache_tier.lookup(NS, key) is None and time.perf_counter() < deadline:
                time.sleep(0.01)
            blob = fleet.cache_tier.lookup(NS, key)
            eng1 = views[1]["handle"].engine
            hits0 = eng1.stats().get("prefix_l2_hits", 0)
            hit = views[1]["handle"].submit_many([ext], c["l2_new"])[0]
            hits1 = eng1.stats().get("prefix_l2_hits", 0)
            miss_eng = ContinuousBatcher(model, **eng_kw)
            try:
                miss = miss_eng.submit(ext, c["l2_new"])
            finally:
                miss_eng.close()
            l2 = eng1._prefix_l2
            t0 = time.perf_counter()
            found = l2.lookup(ext, None, version)
            lookup_ms = (time.perf_counter() - t0) * 1e3
            other = l2.lookup(ext, None, version + "-other")
            err["b_l2"] = {"fills": fleet.cache_stats()["fills"] - fills0,
                           "replica1_l2_hits": hits1 - hits0, "hit_equals_miss": hit == miss,
                           "blob_bytes": len(blob) if blob is not None else 0,
                           "lookup_ms": lookup_ms, "hit_depth": found[1] if found else None,
                           "other_version_misses": other is None,
                           "tier": fleet.cache_stats()}
            nums["l2_lookup_ms"], nums["l2_blob_bytes"] = lookup_ms, err["b_l2"]["blob_bytes"]
            ok["b_l2"] = (err["b_l2"]["fills"] >= 1 and err["b_l2"]["replica1_l2_hits"] >= 1
                          and hit == miss and found is not None and other is None)
            # the filler's ordering and the server's close race, at their
            # own checks (chip_faults plants a fault in each)
            err["l2_filler_ordering"] = filler_ordering_check(device, cfg, c["stall_cycles"])
            ok["l2_filler_ordering"] = err["l2_filler_ordering"]["blob_equals_entry"]
            err["close_race"] = close_race_check(c["close_rounds"])
            r = err["close_race"]
            ok["close_race"] = (r["hits_before_close"] == r["rounds"] == r["misses_after_close"]
                                and r["conns_open_after_close"] == 0)
            lap("b_l2")

        if "c" in parts:
            # (c) mid-traffic, a dropped dispatch (round 1), then a wedged
            # replica (round 2): every request resolves once, as a
            # completion or one terminal error after its first token
            cc = {"rounds": []}
            for fault in ("dispatch_drop", "wedge"):
                fo0 = router.stats()["router"]["failovers"]
                resp0 = sum(s["respawns"] for s in fleet.stats()["seats"].values())
                started, res = threading.Event(), {}

                def traffic():
                    res["out"], _, res["ended"] = drive_outcomes(router, capped, c["threads"],
                                                                 c["stagger"], order=light,
                                                                 started=started)

                tr = threading.Thread(target=traffic)
                tr.start()
                started.wait(timeout=300)
                t_fault = time.perf_counter()
                if fault == "dispatch_drop":
                    failpoints.arm("fleet.dispatch", "drop", count=1)
                else:
                    failpoints.arm("engine.fetch", "delay", delay_s=c["wedge_s"], count=1)
                tr.join(timeout=900)
                failpoints.disarm_all()
                back = wait_seats_ready(fleet, resp0 + 1, c["ready_wait_s"])
                out = res.get("out", {})
                errors = [o for o in out.values() if o[0] != "ok"]
                rnd = {"fault": fault, "failovers": router.stats()["router"]["failovers"] - fo0,
                       "resolved": len(out), "ended": res.get("ended"),
                       "terminal_errors": [(o[1], o[3]) for o in errors][:6],
                       "respawn_s": None if back is None else time.perf_counter() - t_fault,
                       "outstanding": router.stats()["router"]["outstanding"],
                       "states": fleet.states()}
                rnd["ok"] = (bool(res.get("ended")) and len(out) == len(light)
                             and back is not None and not rnd["outstanding"]
                             and all(o[1] in ("EngineWedged", "ReplicaGone") and o[3] > 0
                                     for o in errors)
                             and (rnd["failovers"] >= 1 or fault == "wedge"))
                cc["rounds"].append(rnd)
            nums["respawn_s"] = [r["respawn_s"] for r in cc["rounds"]]
            err["c_failover"] = cc
            ok["c_failover"] = all(r["ok"] for r in cc["rounds"])
            lap("c_failover")
        router.close()
        fleet = router = None

        if "d" in parts:
            # (d) the subprocess fleet with the daemon L2
            d = {"start_s": spawned.get("start_s"), "error": spawned.get("error")}
            sf = spawned.get("fleet")
            ok["d_spawn"] = False
            if sf is not None:
                srouter = FleetRouter(sf)
                try:
                    d.update(spawn_fleet_checks(model, sf, srouter, capped, light, want, c,
                                                (prompt, ext, miss), tol))
                finally:
                    srouter.close()
                ok["d_spawn"] = d.pop("ok")
            err["d_spawn"] = d
            lap("d_spawn")

        if "e" in parts:
            # (e) serve_model with --gen-replicas 2 --cachetier-l2, in process
            daemon, addr = start_cache_daemon(tmp, c["l2_bytes"])
            try:
                gen = dict(checkpoint=ckpt, model=model_flag, device=device.type,
                           config_overrides=cli_overrides(cfg, preset), engine="continuous",
                           widths=",".join(map(str, c["widths"])), width=c["widths"][-1],
                           batch_size=c["slots"], max_new_tokens=budget,
                           decode_block=c["block"], pipeline_depth=c["depth"],
                           prefill_chunk=c["chunk"], prefix_cache=c["prefix"], warmup=True,
                           replicas=c["replicas"], probe_interval=c["probe_s"],
                           cachetier_l2=addr, cachetier_lookup_timeout_s=lookup_s)
                pick = sorted(greedy, key=lambda i: reqs[i]["max_new_tokens"])[:c["server_requests"]]
                with Serving(gen) as srv:
                    url = srv.url
                    got_e = {}
                    for i in pick:
                        code, text = http(url, "/generate", {"prompts": [reqs[i]["tokens"]],
                                                             "max_new_tokens":
                                                             reqs[i]["max_new_tokens"]})
                        got_e[i] = json.loads(text)["completions"][0] if code == 200 else None
                    health = http(url, "/healthz")
                    metrics = http(url, "/metrics")
                    stats = http(url, "/stats")
                    rows = [reqs[i]["tokens"] + want[i][1] for i in pick]
                    sync_on(cuda)
                    fa.reset_launches()
                    bn_kernels.reset_launches()
                    code_sc, text_sc = http(url, "/score", {"sequences": rows})
                    sync_on(cuda)
                    launches = {**fa.LAUNCHES, **bn_kernels.LAUNCHES}
                    lp = json.loads(text_sc)["logprobs"] if code_sc == 200 else []
                h = json.loads(health[1]) if health[0] == 200 else {}
                e = {"generate_equal": [got_e[i] == want[i][1] for i in pick],
                     "healthz": health[0], "replicas": sorted(h.get("replicas", {})),
                     "metrics_replica_labels": [f'replica="{r}"' in metrics[1]
                                                for r in range(c["replicas"])],
                     "stats_mode": json.loads(stats[1]).get("mode") if stats[0] == 200 else None,
                     "score_launches": launches,
                     "score_finite": bool(lp) and all(math.isfinite(x) for row in lp for x in row)}
            finally:
                daemon.kill()
                daemon.wait()
            err["e_server"] = e
            ok["e_server"] = (all(e["generate_equal"]) and e["healthz"] == 200
                              and e["replicas"] == [str(r) for r in range(c["replicas"])]
                              and all(e["metrics_replica_labels"]) and e["stats_mode"] == "fleet"
                              and e["score_finite"]
                              and launches == {"fwd": tol["score_launches_per_call"], "dq": 0,
                                               "dkv": 0, "pair": 0, "cross": 0})
            lap("e_server")
    finally:
        failpoints.disarm_all()
        if router is not None:
            router.close()
        if spawned.get("fleet") is not None:
            spawned["fleet"].close()
        shutil.rmtree(tmp, ignore_errors=True)

    nums["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    nums["wall_s"] = time.perf_counter() - t_phase
    nums["part_s"] = part_s
    nums["nvidia_smi"] = nvidia_smi() if cuda else None
    emit({"phase": "fleet", "part": "numbers", **nums})
    good = bool(ok) and all(ok.values())
    emit({"phase": "fleet", "case": "fleet_checks", "seed": seed, "layers": cfg.num_layers,
          "hidden": cfg.hidden_size, "requests": len(reqs), "replicas": c["replicas"],
          "parts": parts, "checks": ok, "err": err, "tol": tol, "ok": good})
    if not good:
        raise SystemExit("fleet phase failed: " + ", ".join(k for k, v in ok.items() if not v))
    return launches


ROLLOUT = dict(train_batch=4, train_seq=1024, train_steps=3, lr=1e-3, roll_requests=16,
               roll_threads=4, roll_new=48, fixed=8, fixed_len=(32, 200), fixed_new=32, probe=4,
               poll_s=0.2, verify_s=300.0, torn_wait_s=3.0, roll_wait_s=600.0,
               spawn_layers=4, truncate_bytes=1 << 24, score_rows=4)
# Phase rollout's trainer: a learning rate high enough that a few AdamW steps
# change the greedy tokens of the seed-0 weights (each step moves a weight by
# up to ~lr, against an init spread of ~0.02). Its limits are phase serve's:
# completions against a fresh engine on the same weights by the confident-
# token rule, /score against a fresh scoring within SERVE_TOL["score"].
ROLLOUT_TOL = dict(logits=SERVE_TOL["logits"], logprob=SERVE_TOL["logprob"],
                   score=SERVE_TOL["score"])


class LaunchWindows:
    """The kernels' launches summed over the windows of the main path only
    (the trainer's steps, the server's ``/score``): each window zeroes the
    counts before it and reads them after it."""

    def __init__(self, fa, bn, cuda):
        self.fa, self.bn, self.cuda = fa, bn, cuda
        self.total = {"fwd": 0, "dq": 0, "dkv": 0, "pair": 0, "cross": 0}

    def __enter__(self):
        sync_on(self.cuda)
        self.fa.reset_launches()
        self.bn.reset_launches()
        return self

    def __exit__(self, *exc):
        sync_on(self.cuda)
        for k, v in {**self.fa.LAUNCHES, **self.bn.LAUNCHES}.items():
            self.total[k] += v


class SwapTimer:
    """Per-seat timestamps of a rolling swap on an in-process fleet: the
    hold, the loader's start and end, ``swap_weights`` (the install) and
    the warm-up probe's end, the release. Wraps the fleet's and the seat
    engines' methods on their instances; the loader calls :meth:`load`."""

    def __init__(self, fleet):
        self.marks = []  # (rid or None, what, time)
        for v in fleet.views():
            eng = v["handle"].engine
            self._wrap(eng, "swap_weights", v["rid"])
            self._wrap(eng, "submit", v["rid"])
        self._wrap(fleet, "hold_seat", None)
        self._wrap(fleet, "release_seat", None)

    def _wrap(self, obj, name, rid):
        inner = getattr(obj, name)

        def timed(*a, **kw):
            who = a[0] if rid is None else rid
            self.marks.append((who, name + ":start", time.perf_counter()))
            try:
                return inner(*a, **kw)
            finally:
                self.marks.append((who, name + ":end", time.perf_counter()))

        setattr(obj, name, timed)

    def load(self, fn, update):
        self.marks.append((None, "load:start", time.perf_counter()))
        try:
            return fn(update)
        finally:
            self.marks.append((None, "load:end", time.perf_counter()))

    def seats(self, since=0.0):
        """{rid: {drain_s, load_s, install_s, warmup_s, verify_s, swap_s}} of
        the swaps after ``since``: a seat's segment runs from its hold to its
        release, the loads between them are its own."""
        out, open_seat = {}, None
        t = {}
        for who, what, ts in self.marks:
            if ts < since:
                continue
            if what == "hold_seat:end":
                open_seat, t = who, {"hold": ts}
            elif open_seat is None:
                continue
            elif what in ("load:start", "load:end") or (who == open_seat and what in (
                    "swap_weights:start", "swap_weights:end", "submit:end")):
                t.setdefault(what, ts)
            elif what == "release_seat:start" and who == open_seat:
                t["release"] = ts
                if "swap_weights:end" in t:
                    ls, le = t.get("load:start", t["swap_weights:start"]), t.get(
                        "load:end", t["swap_weights:start"])
                    warm = t.get("submit:end", t["swap_weights:end"])
                    out[open_seat] = {"drain_s": ls - t["hold"], "load_s": le - ls,
                                      "install_s": t["swap_weights:end"] - t["swap_weights:start"],
                                      "warmup_s": warm - t["swap_weights:end"],
                                      "verify_s": ts - warm, "swap_s": ts - ls}
                open_seat = None
        return out


def version_traffic(target, reqs, threads, until=None, started=None):
    """Every request of ``reqs`` as a greedy stream through ``target`` from
    ``threads`` threads; with ``until`` (an Event) each thread cycles
    through its share again and again until it is set. Returns the
    outcomes {(round, i): ("ok", tokens, logprobs, ttft_s, weights_version,
    start, end) or ("err", type, message, tokens yielded, None, start,
    end)} (start and end on ``time.perf_counter``), the wall seconds and
    whether every thread ended."""
    out, opened, lock = {}, [0], threading.Lock()

    def worker(t):
        rnd = 0
        while True:
            for i in range(t, len(reqs), threads):
                n, t0, first = 0, time.perf_counter(), None
                try:
                    s = target.stream(yield_logprobs=True, **reqs[i])
                    with lock:
                        opened[0] += 1
                        if started is not None and opened[0] >= threads:
                            started.set()
                    for _ in s:
                        n += 1
                        if first is None:
                            first = time.perf_counter() - t0
                    out[(rnd, i)] = ("ok", s.result, s.logprobs, first, s.weights_version, t0,
                                     time.perf_counter())
                except Exception as e:  # noqa: BLE001 - an outcome of its own
                    out[(rnd, i)] = ("err", type(e).__name__, str(e)[:200], n, None, t0,
                                     time.perf_counter())
            rnd += 1
            if until is None or until.is_set():
                return

    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=900)
    return out, time.perf_counter() - t0, not any(t.is_alive() for t in ts)


def by_version(model_of, reqs, got, want, tol):
    """The stamped completions ``got`` ({(round, i): outcome}) against the
    fresh engine of their own version (``want[version]``,
    ``model_of[version]``) by the confident-token rule, round by round;
    stamps outside ``want`` are listed as strays."""
    rows, stray = {}, []
    for (rnd, i), o in got.items():
        if o[0] != "ok":
            continue
        if o[4] not in want:
            stray.append(o[4])
            continue
        rows.setdefault((o[4], rnd), {})[i] = ("ok", o[1], o[2], o[3])
    res = {"stray_versions": stray}
    for (ver, _), keyed in sorted(rows.items()):
        cmp_ = against_engine(model_of[ver], reqs, sorted(keyed), keyed, want[ver], tol)
        r = res.setdefault(ver, {"compared": 0, "confident_mismatches": 0, "equal": 0,
                                 "max_abs_logprob": 0.0})
        for k in ("compared", "confident_mismatches", "equal"):
            r[k] += cmp_[k]
        r["max_abs_logprob"] = max(r["max_abs_logprob"], cmp_["max_abs_logprob"])
    return res


def gauge_of(text, name):
    """{labels: value} of metric ``name`` in a Prometheus exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{"):
            labels, val = line[len(name):].rsplit(" ", 1)
            out[labels] = float(val)
    return out


def wait_outcome(ctl, outcome, count, timeout):
    """Seconds until ``ctl`` has counted ``count`` rollouts of ``outcome``
    (None past ``timeout``)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if ctl.stats()["outcomes"].get(outcome, 0) >= count:
            return time.perf_counter() - t0
        time.sleep(0.05)
    return None


def truncated_copy(src, dst, nbytes):
    """A committed checkpoint directory at ``dst`` whose ``state.pt`` is the
    first ``nbytes`` of ``src``'s (its spec and marker whole)."""
    os.makedirs(dst)
    for name in ("tree.json", "_CHECKPOINT_METADATA"):
        shutil.copy(os.path.join(src, name), dst)
    with open(os.path.join(src, "state.pt"), "rb") as f, \
            open(os.path.join(dst, "state.pt"), "wb") as g:
        g.write(f.read(nbytes))
    return dst


def torn_latest(channel, version, path):
    """A ``LATEST`` pointer whose CRC does not match its manifest (a torn
    write across a non-atomic filesystem)."""
    manifest = {"version": version, "kind": "full", "path": os.path.abspath(path), "step": None}
    with open(os.path.join(channel, "LATEST"), "w") as f:
        json.dump({"crc": 12345, "manifest": manifest}, f)


def rollout_server_checks(c, cfg, preset, model_flag, device, tmp, boot, v1_path, v1_step, cut,
                          model_v1, fixed, fixed_v1, windows, tol):
    """Part (c): ``serve_model.main`` (the CLI entry, on a thread of this
    process so its ``/score`` launches are counted) with two replicas, an
    admin token file and a watched channel; then a single-engine server
    for the 409. Returns the readings with ``ok``."""
    import logging
    import secrets

    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.serving import rollout
    from tensorflowonspark_tpu_torch.tools import serve_model
    from tensorflowonspark_tpu_torch.tools.generate_text import build_score_fn

    root = logging.getLogger()
    if not root.handlers:  # keep main()'s basicConfig from logging every request
        root.addHandler(logging.NullHandler())
    token = secrets.token_hex(8)
    token_file = os.path.join(tmp, "admin.token")
    with open(token_file, "w") as f:
        f.write(token + "\n")
    ch = os.path.join(tmp, "server-channel")
    port_file = os.path.join(tmp, "server.port")
    argv = ["--llama-checkpoint", boot, "--model", model_flag,
            "--config-overrides", cli_overrides(cfg, preset), "--gen-engine", "continuous",
            "--gen-replicas", str(c["replicas"]), "--gen-widths", ",".join(map(str, c["widths"])),
            "--gen-slots", str(c["slots"]), "--gen-batch-size", str(c["slots"]),
            "--max-new-tokens", str(c["budget"]), "--gen-decode-block", str(c["block"]),
            "--gen-prefill-chunk", str(c["chunk"]), "--gen-prefix-cache", str(c["prefix"]),
            "--gen-warmup", "--gen-probe-interval", str(c["probe_s"]),
            "--admin-token-file", token_file, "--rollout-channel", ch,
            "--rollout-poll", str(c["poll_s"]), "--port", "0", "--port-file", port_file]
    if device.type == "cpu":
        argv += ["--device", "cpu"]
    d, t0 = {}, time.perf_counter()
    thread = threading.Thread(target=serve_model.main, args=(argv,), daemon=True)
    thread.start()
    while not os.path.exists(port_file) and thread.is_alive() and \
            time.perf_counter() - t0 < c["spawn_wait_s"]:
        time.sleep(0.1)
    if not os.path.exists(port_file):
        return {"ok": False, "error": "the server did not start"}
    d["start_s"] = time.perf_counter() - t0
    with open(port_file) as f:
        url = f"http://127.0.0.1:{int(f.read())}"

    def reload(body, headers):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(url + "/admin/reload", json.dumps(body).encode(),
                                     {"Content-Type": "application/json", **headers})
        try:
            with urllib.request.urlopen(req, timeout=900) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    def rollout_stats():
        return json.loads(http(url, "/stats")[1])["rollout"]

    def until(pred, timeout):
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < timeout:
            if pred():
                return time.perf_counter() - t1
            time.sleep(0.1)
        return None

    try:
        body = {"version": "v0-reload", "path": boot}
        d["codes"] = {"no_token": reload(body, {}),
                      "wrong_token": reload(body, {"Authorization": "Bearer " + token[::-1]}),
                      "file_path_as_token": reload(body, {"X-Admin-Token": token_file}),
                      "token": reload(body, {"Authorization": "Bearer " + token})}
        d["reload_s"] = until(lambda: rollout_stats()["outcomes"].get("completed", 0) >= 1,
                              c["roll_wait_s"])
        d["after_reload"] = rollout_stats()
        t1 = time.perf_counter()
        rollout.publish_checkpoint(ch, version="v1", path=v1_path, step=v1_step)
        d["channel_s"] = until(lambda: rollout_stats()["applied"] == {
            str(r): "v1" for r in range(c["replicas"])}, c["roll_wait_s"])
        d["channel_wall_s"] = time.perf_counter() - t1
        st = rollout_stats()
        d["after_channel"] = st
        code, text = http(url, "/generate", {"prompts": fixed[:2], "versions": True,
                                             "max_new_tokens": c["fixed_new"]})
        out = json.loads(text) if code == 200 else {}
        d["generate"] = {"code": code, "versions": out.get("weights_versions"),
                         "equal_v1": out.get("completions") == fixed_v1[:2]}
        metrics = http(url, "/metrics")[1]
        d["metrics"] = {"weights_version": gauge_of(metrics, "fleet_weights_version"),
                        "rollout_total": gauge_of(metrics, "rollout_total")}
        width = serve_model.score_width(max(c["widths"]), c["budget"], cfg.max_seq_len)
        rows = [p + t for p, t in zip(fixed[:c["score_rows"]], fixed_v1)]
        with windows:
            code_sc, text_sc = http(url, "/score", {"sequences": rows})
            got = {**fa.LAUNCHES}
        d["score"] = {"code": code_sc, "width": width, "launches": got}
        if code_sc == 200:
            lp = json.loads(text_sc)["logprobs"]
            ref = build_score_fn(model_v1, width=width, bsz=c["slots"])(rows)
            d["score"]["max_abs_diff"] = max(abs(a - b) for x, y in zip(lp, ref)
                                             for a, b in zip(x, y))
    finally:
        server = serve_model._last_server
        if server is not None:
            server.shutdown()
            server.server_close()
        thread.join(timeout=120)
    d["stopped"] = not thread.is_alive()
    # the single-engine server: a checkpoint that does not fit is a 409
    gen = dict(checkpoint=boot, model=model_flag, device=device.type,
               config_overrides=cli_overrides(cfg, preset), engine="continuous",
               widths=",".join(map(str, c["widths"])), width=c["widths"][-1],
               batch_size=c["slots"], max_new_tokens=c["budget"], admin_token=token)
    with Serving(gen) as srv:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(srv.url + "/admin/reload",
                                     json.dumps({"version": "cut", "path": cut}).encode(),
                                     {"Content-Type": "application/json",
                                      "Authorization": "Bearer " + token})
        try:
            with urllib.request.urlopen(req, timeout=900) as r:
                d["single_cut_code"] = r.status
        except urllib.error.HTTPError as e:
            d["single_cut_code"] = e.code
            d["single_cut_error"] = json.loads(e.read().decode()).get("error_type")
    ready = {str(r): "v1" for r in range(c["replicas"])}
    d["ok"] = (d["codes"] == {"no_token": 403, "wrong_token": 403, "file_path_as_token": 403,
                              "token": 202}
               and d["reload_s"] is not None
               and d["after_reload"]["target_version"] == "v0-reload"
               and d["channel_s"] is not None and d["after_channel"]["applied"] == ready
               and d["after_channel"]["target_version"] == "v1"
               and d["generate"]["versions"] == ["v1", "v1"] and d["generate"]["equal_v1"]
               and d["score"]["code"] == 200
               and d["score"]["launches"] == {"fwd": tol["score_launches_per_call"], "dq": 0,
                                              "dkv": 0}
               and d["score"].get("max_abs_diff", math.inf) <= tol["score"]
               and d["stopped"] and d["single_cut_code"] == 409
               and d.get("single_cut_error") == "WeightsIncompatible")
    return d


def rollout_spawn_checks(sf, srouter, reqs, cfg4, model4_v1, want4, upd, c, tol):
    """Part (d) on a started subprocess fleet ``sf``: a roll through the
    children's ``/admin/reload`` under streaming load; once seat 0 has
    swapped, child 1 is SIGKILLed before its turn, which comes once the
    probe loop has drained its seat (so it is skipped). Its respawn must
    rejoin at the target version. Returns the readings with ``ok``."""
    from tensorflowonspark_tpu_torch.serving import RolloutController

    ctl = RolloutController(sf, drain_timeout=c["drain_s"], verify_timeout=c["verify_s"])
    d, reload_s = {}, {}
    for v in sf.views():
        handle, inner = v["handle"], v["handle"].reload

        def timed(*a, _inner=inner, _rid=v["rid"], **kw):
            t0 = time.perf_counter()
            out = _inner(*a, **kw)
            reload_s[_rid] = {"wall_s": time.perf_counter() - t0,
                              "child_swap_s": out.get("swap_seconds")}
            return out

        handle.reload = timed
    victim = sf.views()[1]
    hold, killed = sf.hold_seat, {}

    def hold_and_kill(rid, reason="rollout"):
        # seat 0 has swapped; child 1 dies before its turn, and its turn
        # comes once the probe loop has drained the seat (it is skipped)
        if rid == 1 and not killed:
            killed["t"] = time.perf_counter()
            os.kill(victim["handle"].pid, 9)
            deadline = time.perf_counter() + 60
            while sf.states()[1] == "ready" and time.perf_counter() < deadline:
                time.sleep(0.02)
            killed["drained_s"] = time.perf_counter() - killed["t"]
        return hold(rid, reason)

    sf.hold_seat = hold_and_kill
    stop, started, res = threading.Event(), threading.Event(), {}

    def traffic():
        res["out"], _, res["ended"] = version_traffic(srouter, reqs, c["roll_threads"],
                                                      until=stop, started=started)

    tr = threading.Thread(target=traffic)
    tr.start()
    started.wait(timeout=300)
    t0 = time.perf_counter()
    try:
        outcome = ctl.roll(upd)
        d["roll_s"] = time.perf_counter() - t0
        back = wait_seats_ready(sf, 1, c["ready_wait_s"])
        d["respawn_s"] = None if back is None else time.perf_counter() - killed.get("t", t0)
    finally:
        stop.set()
        tr.join(timeout=900)
        sf.hold_seat = hold
    versions = {v["rid"]: v["handle"].health().get("weights_version") for v in sf.views()}
    out = res.get("out", {})
    errors = [o for o in out.values() if o[0] != "ok"]
    cmp_ = by_version({upd.version: model4_v1}, reqs,
                      {k: o for k, o in out.items() if o[0] == "ok" and o[4] == upd.version},
                      {upd.version: want4}, tol)
    # both children answer under the target, the respawned one included
    again = {}
    for v in sf.views():
        i = v["rid"]
        toks = v["handle"].submit_many([reqs[i]["tokens"]], reqs[i]["max_new_tokens"],
                                       return_logprobs=True)
        again[i] = ("ok", toks[0][0], toks[1][0], None)
    cmp_again = against_engine(model4_v1, reqs, list(again), again, want4, tol)
    d.update(outcome=outcome, killed_drained_s=killed.get("drained_s"), reload_s=reload_s,
             versions=versions, stats=ctl.stats(), requests=len(out),
             stamps=sorted({o[4] for o in out.values() if o[0] == "ok"}),
             terminal_errors=[(o[1], o[3]) for o in errors][:6], ended=res.get("ended"),
             vs_engine=cmp_, children_vs_engine=cmp_again,
             outstanding=srouter.stats()["router"]["outstanding"])
    ctl.stop()
    d["ok"] = (outcome == "completed" and back is not None and bool(res.get("ended"))
               and set(versions.values()) == {upd.version}
               and ctl.stats()["applied"].get("1") == upd.version
               and all(o[1] == "ReplicaGone" and o[3] > 0 for o in errors)
               and not d["outstanding"] and not cmp_["stray_versions"]
               and all(r["confident_mismatches"] == 0 for k, r in cmp_.items()
                       if k != "stray_versions")
               and cmp_again["confident_mismatches"] == 0
               and cmp_again["compared"] == len(again))
    return d


def phase_rollout(fa, layers=16, rehearse=None, seed=0, parts="abcd"):
    """Zero-downtime weight rollout on the card (see the module docstring,
    phase 13); raises SystemExit when a check fails. ``layers`` cuts the
    depth and ``parts`` picks the parts ("a" is needed by the others;
    chip_faults.py runs "ab"); with ``rehearse={"device": "cpu", "tiny":
    True, "sizes": {...}}`` it runs at a tiny size on the CPU. Returns every
    kernel's launches on the phase's main path: the trainer's steps and the
    server's ``/score``."""
    from tensorflowonspark_tpu_torch.cachetier.prefix import NS, prefix_key, version_prefix
    from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step
    from tensorflowonspark_tpu_torch.compute.checkpoint import CheckpointManager, save_checkpoint
    from tensorflowonspark_tpu_torch.models.llama import Llama, LlamaConfig, llama_loss_fn
    from tensorflowonspark_tpu_torch.ops import bn_kernels
    from tensorflowonspark_tpu_torch.serving import ContinuousBatcher, FleetRouter, ServingFleet
    from tensorflowonspark_tpu_torch.serving import rollout
    from tensorflowonspark_tpu_torch.tools.generate_text import load_model
    from tensorflowonspark_tpu_torch.utils import failpoints

    rehearse = rehearse or {}
    device = torch.device(rehearse.get("device", "cuda"))
    cuda = device.type == "cuda"
    c = {**SERVE, **FLEET, **ROLLOUT, **rehearse.get("sizes", {})}
    if rehearse.get("tiny"):
        preset, model_flag = LlamaConfig.tiny(dtype=torch.bfloat16), "tiny"
    else:
        preset, model_flag = LlamaConfig.llama_1b(), "1b"
    cfg = dataclasses.replace(preset, remat=False, num_layers=layers)
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tol = {**ROLLOUT_TOL, "score_launches_per_call": cfg.num_layers if cuda else 0}
    eng_kw = dict(slots=c["slots"], prompt_widths=c["widths"], decode_block=c["block"],
                  pipeline_depth=c["depth"], prefill_chunk=c["chunk"], prefix_cache=c["prefix"])
    windows = LaunchWindows(fa, bn_kernels, cuda)
    err, ok, nums, part_s, lap_t = {}, {}, {}, {}, [t_phase]
    peak = {}

    def lap(name):
        now = time.perf_counter()
        part_s[name], lap_t[0] = now - lap_t[0], now
        if cuda:
            peak[name] = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()

    rng = np.random.default_rng(seed + 20)
    vocab = cfg.vocab_size
    fixed = [rng.integers(0, vocab, int(rng.integers(*c["fixed_len"]))).tolist()
             for _ in range(c["fixed"])]
    reqs = [{"tokens": rng.integers(0, vocab, int(rng.integers(c["min_len"],
                                                               c["max_len"] + 1))).tolist(),
             "max_new_tokens": c["roll_new"]} for _ in range(c["roll_requests"])]
    l2_prompt = rng.integers(0, vocab, c["l2_prompt"]).tolist()
    l2_ext = l2_prompt + rng.integers(0, vocab, c["l2_tail"]).tolist()
    tmp = tempfile.mkdtemp(prefix="tfos_rollout_")
    ch = os.path.join(tmp, "channel")
    spawned, fleet, router, ctl = {}, None, None, None
    refs = []
    try:
        # (a) the trainer: llama_1b from the seed-0 weights, fp32 params
        tmodel = Llama(cfg, device=device, seed=seed)
        v0 = {n: p.detach().to(cfg.dtype, copy=True) for n, p in tmodel.named_parameters()}
        smodel = load_model(cfg, v0, device)  # the boot weights every seat starts on
        boot = save_checkpoint(os.path.join(tmp, "boot"), {"params": v0})
        if "d" in parts:
            # (d)'s children boot on a cut depth of the same weights, in the
            # background while (a) trains
            cfg4 = dataclasses.replace(cfg, num_layers=min(layers, c["spawn_layers"]))
            keep = {f"layers.{i}." for i in range(cfg4.num_layers)}

            def cut_depth(params):
                return {n: t for n, t in params.items()
                        if not n.startswith("layers.") or any(n.startswith(k) for k in keep)}

            boot4 = save_checkpoint(os.path.join(tmp, "boot4"), {"params": cut_depth(v0)})
            root = os.path.dirname(os.path.abspath(__file__))
            argv = ["--llama-checkpoint", boot4, "--model", model_flag, "--seed", str(seed),
                    "--config-overrides", cli_overrides(cfg4, preset), "--device", device.type,
                    "--gen-engine", "continuous", "--gen-widths",
                    ",".join(map(str, c["widths"])), "--gen-slots", str(c["slots"]),
                    "--gen-batch-size", str(c["slots"]), "--max-new-tokens", str(c["budget"]),
                    "--gen-decode-block", str(c["block"]), "--gen-pipeline-depth",
                    str(c["depth"]), "--gen-prefill-chunk", str(c["chunk"]),
                    "--gen-prefix-cache", str(c["prefix"]), "--gen-warmup"]
            env = dict(os.environ, PYTHONPATH=root, **({} if cuda else {"OMP_NUM_THREADS": "1"}))

            def build_spawned():
                t0 = time.perf_counter()
                try:
                    spawned["fleet"] = ServingFleet(
                        spawn_argv=argv, replicas=c["replicas"], probe_interval=c["probe_s"],
                        drain_timeout=10.0, start_timeout=c["spawn_wait_s"],
                        spawn_kwargs={"env": env, "spawn_timeout": c["spawn_wait_s"]})
                except BaseException as e:  # noqa: BLE001 - read by part d
                    spawned["error"] = f"{type(e).__name__}: {e}"
                spawned["start_s"] = time.perf_counter() - t0

            spawner = threading.Thread(target=build_spawned, daemon=True)
            spawner.start()
        tx = adamw(c["lr"], moment_dtype=torch.bfloat16)
        state = TrainState.create(dict(tmodel.named_parameters()), tx)
        loss_fn = llama_loss_fn(tmodel)
        step = build_train_step(lambda p, b: loss_fn(p, b["tokens"]), tx, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        batch = {"tokens": torch.randint(0, vocab, (c["train_batch"], c["train_seq"] + 1),
                                         device=device, generator=gen)}
        losses = []
        t0 = time.perf_counter()
        with windows:
            for _ in range(c["train_steps"]):
                state, loss = step(state, batch)
                losses.append(loss.item())
        nums["train_s"] = time.perf_counter() - t0
        mgr = CheckpointManager(os.path.join(tmp, "train"))
        t0 = time.perf_counter()
        mgr.save(c["train_steps"], state)
        mgr.wait()
        nums["train_save_s"] = time.perf_counter() - t0
        v1_path, v1_step = mgr.step_path(c["train_steps"]), c["train_steps"]
        v1 = {n: p.detach().to(cfg.dtype, copy=True) for n, p in state.params.items()}
        err["train"] = {"losses": losses, "steps": c["train_steps"], "lr": c["lr"],
                        "batch": c["train_batch"], "seq": c["train_seq"]}
        ok["train"] = all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
        lap("a_train")

        # fresh single engines on each version: the references
        model_v1 = load_model(cfg, v1, device)
        eng_v0 = ContinuousBatcher(smodel, **eng_kw)
        eng_v1 = ContinuousBatcher(model_v1, **eng_kw)
        refs += [eng_v0, eng_v1]
        fixed_v0 = eng_v0.submit_many(fixed, c["fixed_new"])
        fixed_v1 = eng_v1.submit_many(fixed, c["fixed_new"])
        err["tokens_changed"] = {"prompts": len(fixed),
                                 "differ": sum(a != b for a, b in zip(fixed_v0, fixed_v1))}
        ok["tokens_changed"] = err["tokens_changed"]["differ"] >= 1
        want = {}
        for ver, eng in (("v0", eng_v0), ("v1", eng_v1)):
            toks, lps = eng.submit_many([r["tokens"] for r in reqs], c["roll_new"],
                                        return_logprobs=True)
            want[ver] = {i: ("ok", t, lp, None) for i, (t, lp) in enumerate(zip(toks, lps))}
        lap("a_refs")

        # (a) the in-process fleet, its L2, the controller watching the channel
        def factory():
            return ContinuousBatcher(smodel, **eng_kw)

        fleet = ServingFleet(factory=factory, replicas=c["replicas"],
                             probe_interval=c["probe_s"], drain_timeout=c["drain_s"],
                             prefix_l2={"mode": "inproc", "capacity_bytes": c["l2_bytes"]})
        router = FleetRouter(fleet)
        timer = SwapTimer(fleet)
        target = {"params": dict(smodel.named_parameters())}

        def loader(update):
            return timer.load(rollout.checkpoint_loader(target["params"]), update)

        ctl = rollout.RolloutController(fleet, channel_dir=ch, loader=loader,
                                        poll_interval=c["poll_s"], drain_timeout=c["drain_s"],
                                        verify_timeout=c["verify_s"])
        ctl.start()
        hits, lookup = [], fleet.cache_tier.lookup

        def recorded_lookup(ns, key):
            blob = lookup(ns, key)
            if blob is not None:
                hits.append(key)
            return blob

        fleet.cache_tier.lookup = recorded_lookup
        if "d" in parts:
            spawner.join(timeout=c["spawn_wait_s"])  # its warm-ups must not share the timings
        lap("a_build")
        before, wall_b, ended_b = version_traffic(router, reqs, c["roll_threads"])
        with fleet.cache_tier._lock:
            v0_entries = sum(k[1].startswith(version_prefix("v0")) for k in fleet.cache_tier._entries)
        stop, started, res = threading.Event(), threading.Event(), {}

        def traffic():
            res["out"], res["wall"], res["ended"] = version_traffic(
                router, reqs, c["roll_threads"], until=stop, started=started)

        tr = threading.Thread(target=traffic)
        tr.start()
        started.wait(timeout=300)
        t_pub = time.perf_counter()
        rollout.publish_checkpoint(ch, version="v1", path=v1_path, step=v1_step)
        roll_wait = wait_outcome(ctl, "completed", 1, c["roll_wait_s"])
        roll_wall = time.perf_counter() - t_pub
        n_hits_at_roll = len(hits)
        stop.set()
        tr.join(timeout=900)
        during = res.get("out", {})
        seats = timer.seats(t_pub)
        cmp_ = by_version({"v0": smodel, "v1": model_v1}, reqs, during, want, tol)
        cmp_before = by_version({"v0": smodel}, reqs, before, {"v0": want["v0"]}, tol)
        metrics = fleet.metrics.render()
        gauge = gauge_of(metrics, "fleet_weights_version")
        totals = gauge_of(metrics, "rollout_total")
        st = ctl.stats()
        with fleet.cache_tier._lock:
            v0_left = sum(k[1].startswith(version_prefix("v0")) for k in fleet.cache_tier._entries)

        def ttft_p50(out):
            t = [o[3] for o in out.values() if o[0] == "ok" and o[3] is not None]
            return float(np.percentile(t, 50)) * 1e3 if t else None

        nums["a"] = {"rollout_wall_s": roll_wall, "seats": seats,
                     "ttft_p50_ms_before": ttft_p50(before), "ttft_p50_ms_during": ttft_p50(during),
                     "requests_during": len(during), "traffic_wall_s": res.get("wall"),
                     "before_wall_s": wall_b}
        stamps = {}
        for o in during.values():
            if o[0] == "ok":
                stamps[o[4]] = stamps.get(o[4], 0) + 1
        err["a_roll"] = {"outcome_wait_s": roll_wait, "stamps": dict(stamps),
                         "errors": [o for o in during.values() if o[0] != "ok"][:3],
                         "vs_fresh": cmp_, "before_vs_fresh": cmp_before, "gauge": gauge,
                         "rollout_total": totals, "stats": st, "v0_l2_entries_before": v0_entries,
                         "v0_l2_entries_after": v0_left}
        ordv1 = st["version_ordinals"].get("v1")
        ok["a_roll"] = (roll_wait is not None and bool(res.get("ended")) and ended_b
                        and all(o[0] == "ok" for o in {**before, **during}.values())
                        and set(stamps) <= {"v0", "v1"} and stamps.get("v1", 0) >= 1
                        and not cmp_["stray_versions"]
                        and all(r["confident_mismatches"] == 0 for k, r in cmp_.items()
                                if k != "stray_versions")
                        and cmp_before["v0"]["confident_mismatches"] == 0
                        and sorted(gauge.values()) == [ordv1] * c["replicas"]
                        and totals.get('{outcome="completed"}') == 1
                        and st["applied"] == {str(r): "v1" for r in range(c["replicas"])})
        lap("a_roll")

        # (a) the L2 under v1: a 384-token prefix on seat 0, its extension on
        # seat 1 — a hit, equal to a miss; no hit since the roll is of v0
        views = sorted(fleet.views(), key=lambda v: v["rid"])
        fills0 = fleet.cache_stats()["fills"]
        views[0]["handle"].submit_many([l2_prompt], c["l2_new"])
        deadline = time.perf_counter() + 120
        while lookup(NS, prefix_key("v1", None, l2_prompt)) is None and \
                time.perf_counter() < deadline:
            time.sleep(0.01)
        eng1 = views[1]["handle"].engine
        hits0 = eng1.stats().get("prefix_l2_hits", 0)
        hit = views[1]["handle"].submit_many([l2_ext], c["l2_new"])[0]
        miss = eng_v1.submit(l2_ext, c["l2_new"])
        after = hits[n_hits_at_roll:]
        err["a_l2"] = {"fills": fleet.cache_stats()["fills"] - fills0,
                       "seat1_l2_hits": eng1.stats().get("prefix_l2_hits", 0) - hits0,
                       "hit_equals_miss": hit == miss, "hits_since_roll": len(after),
                       "v0_hits_since_roll": sum(k.startswith(version_prefix("v0")) for k in after)}
        ok["a_l2"] = (err["a_l2"]["seat1_l2_hits"] >= 1 and hit == miss
                      and err["a_l2"]["v0_hits_since_roll"] == 0)
        lap("a_l2")

        if "b" in parts:
            # (b) rollbacks: each case leaves every seat at v1, its probe
            # completions exactly a fresh v1 engine's
            # the fixed prompts whose greedy tokens v0 and v1 part on
            parted = [i for i in range(len(fixed)) if fixed_v0[i] != fixed_v1[i]][:c["probe"]]
            probe = [fixed[i] for i in parted]
            want_probe = [fixed_v1[i] for i in parted]

            def at(version, want_tokens):
                seats_ = sorted(fleet.views(), key=lambda v: v["rid"])
                return {"states": [v["state"] for v in seats_],
                        "versions": [v["handle"].engine.weights_version for v in seats_],
                        "equal": [v["handle"].engine.submit_many(probe, c["fixed_new"])
                                  == want_tokens for v in seats_],
                        "want": version}

            def held(r):
                return (r["states"] == ["ready"] * c["replicas"]
                        and r["versions"] == [r["want"]] * c["replicas"] and all(r["equal"]))

            cases = {}
            host_v1 = {n: t.cpu() for n, t in v1.items()}
            # b1: one leaf's shape cut, published through the channel
            cut_name = "lm_head" if "lm_head" in host_v1 else sorted(host_v1)[0]
            n_rb = ctl.stats()["outcomes"].get("rolled_back", 0)
            cut_upd = rollout.publish_params(ch, {**host_v1, cut_name: host_v1[cut_name][:-1]},
                                             version="v1-cut")
            del cut_upd
            cases["b1_shape_cut"] = {"wait_s": wait_outcome(ctl, "rolled_back", n_rb + 1,
                                                            c["roll_wait_s"]),
                                     "error": ctl.last_error, **at("v1", want_probe)}
            ok_b1 = (cases["b1_shape_cut"]["wait_s"] is not None and held(cases["b1_shape_cut"])
                     and (ctl.last_error or {}).get("type") == "WeightsIncompatible")
            lap("b1_shape_cut")
            # b2: a committed checkpoint whose state.pt is cut short
            trunc = truncated_copy(boot, os.path.join(tmp, "truncated"), c["truncate_bytes"])
            rollout.publish_checkpoint(ch, version="v1-truncated", path=trunc)
            cases["b2_truncated"] = {"wait_s": wait_outcome(ctl, "rolled_back", n_rb + 2,
                                                            c["roll_wait_s"]),
                                     "error": ctl.last_error, **at("v1", want_probe)}
            ok_b2 = (cases["b2_truncated"]["wait_s"] is not None and held(cases["b2_truncated"])
                     and (ctl.last_error or {}).get("type") not in (None, "WeightsIncompatible"))
            lap("b2_truncated")
            # b3: v0 by path, loaded against seat 0's running tensors; seat 1's
            # verification raises after seat 0 swapped
            seat0 = sorted(fleet.views(), key=lambda v: v["rid"])[0]["handle"].engine
            target["params"] = seat0.current_weights()[1]
            release = fleet.release_seat

            def arm_after_seat0(rid):
                release(rid)
                if rid == 0:
                    failpoints.arm("rollout.verify", "raise", count=1)

            fleet.release_seat = arm_after_seat0
            try:
                out_b3 = ctl.roll(rollout.WeightsUpdate(version="v0-path", path=boot))
            finally:
                fleet.release_seat = release
                target["params"] = dict(smodel.named_parameters())
                failpoints.disarm_all()
            cases["b3_verify_seat1"] = {"outcome": out_b3, "error": ctl.last_error,
                                        **at("v1", want_probe)}
            ok_b3 = (out_b3 == "rolled_back" and held(cases["b3_verify_seat1"])
                     and (ctl.last_error or {}).get("stage") == "verify")
            lap("b3_verify_seat1")
            # b4: a torn LATEST (CRC mismatch) naming a committed checkpoint
            outcomes0 = dict(ctl.stats()["outcomes"])
            torn_latest(ch, "torn", boot)
            time.sleep(c["torn_wait_s"])
            cases["b4_torn_latest"] = {"outcomes": ctl.stats()["outcomes"],
                                       **at("v1", want_probe)}
            ok_b4 = held(cases["b4_torn_latest"]) and ctl.stats()["outcomes"] == outcomes0
            if not ok_b4:  # a roll the check refused may still be running
                wait_seats_ready(fleet, 0, c["ready_wait_s"])
            lap("b4_torn_latest")
            # b5: the trainer's live params published in process, one more
            # step in place, then a seat respawned: it re-syncs to the snapshot
            out_b5 = ctl.publish(state.params, version="v3")
            with windows:
                state, loss = step(state, batch)
            resp0 = sum(s["respawns"] for s in fleet.stats()["seats"].values())
            t0 = time.perf_counter()
            fleet.force_respawn(0, "phase rollout: re-sync after the trainer's next step")
            back = wait_seats_ready(fleet, resp0 + 1, c["ready_wait_s"])
            seats_ = sorted(fleet.views(), key=lambda v: v["rid"])
            w = [v["handle"].engine.current_weights() for v in seats_]
            same = all(torch.equal(w[0][1][n], w[1][1][n]) for n in w[1][1])
            moved = any(not torch.equal(p.detach().to(cfg.dtype), w[1][1][n])
                        for n, p in state.params.items())
            probes = [v["handle"].engine.submit_many(probe, c["fixed_new"]) for v in seats_]
            cases["b5_publish_snapshot"] = {
                "outcome": out_b5, "respawn_s": None if back is None else time.perf_counter() - t0,
                "versions": [x[0] for x in w], "respawned_equals_snapshot": same,
                "trainer_moved_on": moved, "probes_equal": probes[0] == probes[1],
                "stats": ctl.stats()}
            ok_b5 = (out_b5 == "completed" and back is not None and same and moved
                     and [x[0] for x in w] == ["v3"] * c["replicas"] and probes[0] == probes[1])
            lap("b5_publish_snapshot")
            err["b_rollback"] = cases
            ok.update(b1_shape_cut=ok_b1, b2_truncated=ok_b2, b3_verify_seat1=ok_b3,
                      b4_torn_latest=ok_b4, b5_publish_snapshot=ok_b5)
        ctl.stop()
        router.close()
        fleet = router = None
        for eng in refs:
            eng.close()
        refs = []
        del state, tmodel, step, loss_fn
        if cuda:
            torch.cuda.empty_cache()

        if "c" in parts:
            cut = save_checkpoint(os.path.join(tmp, "cut"),
                                  {"params": {**v0, "embed": v0["embed"][:-1]}})
            err["c_server"] = rollout_server_checks(
                c, cfg, preset, model_flag, device, tmp, boot, v1_path, v1_step, cut, model_v1,
                fixed, fixed_v1, windows, tol)
            ok["c_server"] = err["c_server"].pop("ok")
            nums["c"] = {k: err["c_server"].get(k) for k in ("start_s", "reload_s", "channel_s")}
            lap("c_server")

        if "d" in parts:
            d = {"start_s": spawned.get("start_s"), "error": spawned.get("error")}
            sf = spawned.get("fleet")
            ok["d_spawn"] = False
            if sf is not None:
                srouter = FleetRouter(sf)
                model4_v1 = load_model(cfg4, cut_depth(v1), device)
                eng4 = ContinuousBatcher(model4_v1, **eng_kw)
                try:
                    toks, lps = eng4.submit_many([r["tokens"] for r in reqs], c["roll_new"],
                                                 return_logprobs=True)
                    want4 = {i: ("ok", t, lp, None) for i, (t, lp) in enumerate(zip(toks, lps))}
                    upd = rollout.publish_params(os.path.join(tmp, "spawn-channel"),
                                                 {n: t.cpu() for n, t in cut_depth(v1).items()},
                                                 version="v1")
                    upd = rollout.WeightsUpdate(version=upd.version, path=upd.path)
                    d.update(rollout_spawn_checks(sf, srouter, reqs, cfg4, model4_v1, want4,
                                                  upd, c, tol))
                finally:
                    eng4.close()
                    srouter.close()
                ok["d_spawn"] = d.pop("ok")
            err["d_spawn"] = d
            lap("d_spawn")
    finally:
        failpoints.disarm_all()
        if ctl is not None:
            ctl.stop()
        if router is not None:
            router.close()
        for eng in refs:
            eng.close()
        if spawned.get("fleet") is not None:
            spawned["fleet"].close()
        shutil.rmtree(tmp, ignore_errors=True)

    nums["peak_mem_gb"] = peak or None
    nums["wall_s"] = time.perf_counter() - t_phase
    nums["part_s"] = part_s
    nums["launches"] = windows.total
    nums["nvidia_smi"] = nvidia_smi() if cuda else None
    emit({"phase": "rollout", "part": "numbers", **nums})
    good = bool(ok) and all(ok.values())
    emit({"phase": "rollout", "case": "rollout_checks", "seed": seed, "layers": cfg.num_layers,
          "hidden": cfg.hidden_size, "replicas": c["replicas"], "parts": parts, "checks": ok,
          "err": err, "tol": tol, "ok": good})
    if not good:
        raise SystemExit("rollout phase failed: " + ", ".join(k for k, v in ok.items() if not v))
    return windows.total


# phase lora: LoRA fine-tuning through B1-B3, merge + int8 decode, a bank of
# adapters served and rolled, the server over a bank checkpoint
LORA = dict(rank=16, batch=8, seq=1024, steps=4, lr=1e-3, snapshots=(1, 2, 4),
            dec_batch=8, dec_min=64, dec_width=512, dec_new=128, time_prompt=128,
            time_steps=16, example_args=["--steps", "4", "--seq", "128", "--batch-size", "8",
                                         "--lora-rank", "16", "--generate", "16",
                                         "--quantize-decode"],
            requests=24, threads=8, min_len=16, max_len=500, min_new=16, max_new=64,
            widths=(128, 256, 512), slots=8, block=8, depth=2, chunk=128, prefix=4,
            prefix_prompt=300, route_rows=4, route_len=256, roll_requests=12, roll_threads=4,
            roll_new=24, replicas=2, probe_s=0.5, drain_s=60.0, poll_s=0.2, roll_wait_s=300.0,
            budget=256, score_rows=4, quant_min=1 << 16)
# Limits of phase lora. "logits" / "logprob": phase serve's confident-token
# rule and logprob limit (bf16 decodes against references on the same
# weights). "route": a forward in fp32 of rows routed through the bank
# against each row's adapter merged alone, max |diff| of the logits (the
# same fp32 numbers summed in other orders; the adapters themselves must
# move the logits by "route_separation" times the limit or more). "int8_rms":
# the int8 model's teacher-forced logits against the merged bf16 model's,
# rms of the difference; "int8_dequant_rms": against a bf16 model of the
# same codes dequantized, where only the product's rounding differs;
# "int8_gap": the top-2 gap of the bf16 logits above which the int8 greedy
# token must be their argmax. "score": /score through B1 against the plain
# attention (phase decode's). On the H100 at seed 0 (PERF.md, Findings) route
# read 2.98e-5 with the smallest adapter effect 0.176 (the limit 3.4x); int8
# read rms 0.0751 against bf16 and 0.0274 against the dequantized model
# (max |diff| 0.445, under half the gap): each limit is twice its reading,
# and scales applied on the input axis of the square projections read 0.41
# on both at 4 layers (chip_faults.py), where the sound code reads 0.049
# and 0.017.
LORA_TOL = dict(logits=SERVE_TOL["logits"], logprob=SERVE_TOL["logprob"], route=1e-4,
                route_separation=10.0, int8_rms=0.15, int8_dequant_rms=0.055, int8_gap=1.0,
                score=DECODE_TOL["score"])


class Guarded:
    """Runs one part of a phase: an exception fails that part's check by
    name (its message kept in ``err``) instead of ending the phase, so the
    phase's check line still names every check that failed."""

    def __init__(self, name, ok, err):
        self.name, self.ok, self.err = name, ok, err

    def __enter__(self):
        return self

    def __exit__(self, kind, exc, tb):
        if exc is None or not isinstance(exc, Exception):
            return False
        import traceback

        self.ok[self.name] = False
        self.err[self.name + "_error"] = "".join(
            traceback.format_exception_only(kind, exc)).strip()[-600:]
        return True


def bank_forward(module, tokens, ids=None):
    """fp32 logits (B, S, V) of ``module`` on ``tokens`` with each row's
    bank slot ``ids`` (None: slot 0)."""
    with torch.no_grad():
        return module(tokens, adapter_ids=ids).float()


def bank_teacher_forced(module, prompt, completion, k):
    """:func:`teacher_forced` through a bank module with the row routed to
    adapter ``k``."""
    with torch.no_grad():
        row = torch.tensor([prompt + completion], device=module.device)
        ids = torch.tensor([k], device=module.device)
        logits = module(row, adapter_ids=ids)[0]
    return logits[len(prompt) - 1:len(prompt) - 1 + len(completion)].float()


def captured(fn):
    """``fn()`` with the process's standard output (the nodes' too, which
    share it) captured: (result, output, seconds)."""
    with tempfile.TemporaryFile(mode="w+") as cap:
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(cap.fileno(), 1)
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as e:
            sys.stdout.flush()
            cap.seek(0)
            raise RuntimeError(f"{e}; the output: {cap.read()[-3000:]}") from e
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        wall = time.perf_counter() - t0
        cap.seek(0)
        return out, cap.read(), wall


def run_example(argv, cuda):
    """``examples/llama_fsdp.py``'s ``main_fun`` on one node launched by the
    port's ``tfcluster.run`` (a process group of one), its printed lines
    captured from the shared standard output."""
    from tensorflowonspark_tpu_torch.cluster import tfcluster
    from tensorflowonspark_tpu_torch.cluster.tfcluster import InputMode
    from tensorflowonspark_tpu_torch.examples import llama_fsdp

    args = llama_fsdp.parse_args(argv + ([] if cuda else ["--cpu"]))

    def drive():
        cluster = tfcluster.run(llama_fsdp.main_fun, args, num_executors=1,
                                input_mode=InputMode.TENSORFLOW, distributed=True,
                                reservation_timeout=600,
                                env=None if cuda else {"CUDA_VISIBLE_DEVICES": "",
                                                       "OMP_NUM_THREADS": "1"})
        cluster.shutdown(timeout=600)

    _, out, wall = captured(drive)
    return out, wall


def start_example(argv, cuda):
    """:func:`run_example` on a thread of its own; ``join`` it through
    :func:`example_check`."""
    res = {}

    def run():
        try:
            res["out"], res["wall"] = run_example(argv, cuda)
        except Exception as e:  # noqa: BLE001 - read by example_check
            res["error"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, res


def example_check(example, c, ok, err):
    """Phase lora (b)'s check of the example's run: its decode line and its
    count of quantized weights."""
    t, res = example
    t.join(timeout=900)
    if "out" not in res:
        ok["b_example"] = False
        err["b_example"] = {"error": res.get("error", "the example did not end")[-3000:]}
        return
    out = res["out"]
    gen_line = [x for x in out.splitlines() if x.startswith("generated ")]
    q_line = [x for x in out.splitlines() if x.startswith("quantized ")]
    n_q = int(q_line[0].split()[1]) if q_line else 0
    err["b_example"] = {"wall_s": res["wall"], "generated": gen_line[:1], "quantized": q_line[:1],
                        "mfu": [x for x in out.splitlines() if "MFU" in x][:1]}
    n_gen = c["example_args"][c["example_args"].index("--generate") + 1]
    ok["b_example"] = (bool(gen_line) and n_q > 0
                       and f"{float(n_gen)} tokens/seq" in gen_line[0])
    if not ok["b_example"]:
        err["b_example"]["output_tail"] = out[-3000:]


def phase_lora(fa, layers=16, rehearse=None, seed=0, parts="abcde", train_step_ms=None,
               serve_layers=None):
    """LoRA and int8 weights on the card (see the module docstring, phase
    14); raises SystemExit when a check fails. ``layers`` cuts the depth,
    ``serve_layers`` cuts parts (c)-(e) further to the first blocks of (a)'s
    weights and adapters, and ``parts`` picks the parts ("a" is needed by the others;
    chip_faults.py runs "abcd"); with ``rehearse={"device": "cpu", "tiny":
    True, "sizes": {...}}`` it runs at a tiny size on the CPU. Returns every
    kernel's launches on the phase's main path: the fine-tune's steps and
    the server's ``/score``."""
    from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step
    from tensorflowonspark_tpu_torch.compute.checkpoint import save_checkpoint
    from tensorflowonspark_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        adopt_params,
        decode_step,
        generate,
        init_cache,
        llama_loss_fn,
        prefill,
    )
    from tensorflowonspark_tpu_torch.ops import bn_kernels
    from tensorflowonspark_tpu_torch.ops import lora as L
    from tensorflowonspark_tpu_torch.ops import quant as Q
    from tensorflowonspark_tpu_torch.serving import ContinuousBatcher, FleetRouter, ServingFleet
    from tensorflowonspark_tpu_torch.serving import rollout
    from tensorflowonspark_tpu_torch.tools import generate_text, serve_model

    rehearse = rehearse or {}
    device = torch.device(rehearse.get("device", "cuda"))
    cuda = device.type == "cuda"
    c = {**LORA, **rehearse.get("sizes", {})}
    if rehearse.get("tiny"):
        preset, model_flag = LlamaConfig.tiny(dtype=torch.bfloat16), "tiny"
    else:
        preset, model_flag = LlamaConfig.llama_1b(), "1b"
    cfg = dataclasses.replace(preset, remat=False, num_layers=layers,
                              max_seq_len=max(preset.max_seq_len, c["seq"]))
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tol = {**LORA_TOL, "launches_per_step": cfg.num_layers if cuda else 0,
           "score_launches_per_call": cfg.num_layers if cuda else 0}
    eng_kw = dict(slots=c["slots"], prompt_widths=c["widths"], decode_block=c["block"],
                  pipeline_depth=c["depth"], prefill_chunk=c["chunk"], prefix_cache=c["prefix"])
    windows = LaunchWindows(fa, bn_kernels, cuda)
    err, ok, nums, part_s, lap_t, peak = {}, {}, {}, {}, [t_phase], {}
    bf16 = cfg.dtype

    def lap(name):
        now = time.perf_counter()
        part_s[name], lap_t[0] = now - lap_t[0], now
        if cuda:
            peak[name] = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()

    def cast(params):
        return {n: t.detach().to(bf16) if t.is_floating_point() else t.detach()
                for n, t in params.items()}

    def model_of(params):
        m = Llama(cfg, device=device, seed=seed)
        adopt_params(m, params)
        return m

    rng = np.random.default_rng(seed + 30)
    vocab = cfg.vocab_size
    tmp = tempfile.mkdtemp(prefix="tfos_lora_")
    engines, fleet, router, ctl = [], None, None, None
    try:
        # (a) the fine-tune: rank-r adapters on the seven projections of the
        # seed-0 weights (fp32 params, bf16 compute), adamw on the adapters
        model = Llama(cfg, device=device, seed=seed)
        base = {n: p for n, p in model.named_parameters()}
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        batch = {"tokens": torch.randint(0, vocab, (c["batch"], c["seq"] + 1), device=device,
                                         generator=gen)}
        probe = batch["tokens"][:1, :-1]
        with torch.no_grad():
            base_logits = model(probe)
        params = adopt_params(model, L.add_lora(base, c["rank"], gen))
        with torch.no_grad():
            first_equal = bool(torch.equal(model(probe), base_logits))
        del base_logits
        trained = sorted(n for n, lab in L.lora_labels(params).items() if lab == "train")
        frozen = [n for n in params if n not in trained]
        frozen_copy = {n: params[n].detach().clone() for n in frozen}
        tx = L.lora_optimizer(adamw(c["lr"], moment_dtype=torch.bfloat16), params)
        state = TrainState.create(params, tx)
        loss_fn = llama_loss_fn(model)
        step = build_train_step(lambda p, bt: loss_fn(p, bt["tokens"]), tx, device=device)
        losses, step_s, snaps = [], [], {}
        with windows:
            for i in range(c["steps"]):
                t0 = time.perf_counter()
                state, loss = step(state, batch)
                losses.append(loss.item())  # waits for the step
                step_s.append(time.perf_counter() - t0)
                if i + 1 in c["snapshots"]:
                    snaps[i + 1] = {n: params[n].detach().clone() for n in trained}
        a_launches = dict(windows.total)

        def run_step():
            nonlocal state
            state, _ = step(state, batch)

        prof = profile_steps(run_step, n=1, model="llama_1b_lora") if cuda else {}
        adam = state.opt_state.inner_states["train"][0]
        opt_bytes = sum(t.numel() * t.element_size() for d in (adam.mu, adam.nu)
                        for t in d.values())
        adapter_elems = sum(params[n].numel() for n in trained)
        unchanged = [n for n in frozen if torch.equal(params[n], frozen_copy[n])]
        del frozen_copy
        no_grad = all(params[n].grad is None and not params[n].requires_grad for n in frozen)
        n_params = sum(p.numel() for p in params.values())
        tokens = c["batch"] * c["seq"]
        ms = float(np.median(step_s[1:])) * 1e3 if len(step_s) > 1 else step_s[0] * 1e3
        nums["a"] = {"step_ms": ms, "step_ms_each": [s * 1e3 for s in step_s],
                     "train_phase_full_step_ms": train_step_ms, "tokens_per_s": tokens / ms * 1e3,
                     "device_busy_ms_per_step": prof.get("device_busy_ms_per_step"),
                     "device_idle_share": prof.get("device_idle_share"),
                     "aten_calls_per_step": prof.get("aten_calls_per_step"),
                     "trainable_params": adapter_elems, "params": n_params,
                     "opt_state_bytes": opt_bytes, "launches": a_launches}
        err["a_train"] = {"losses": losses, "first_logits_equal_base": first_equal,
                          "frozen": len(frozen), "frozen_unchanged": len(unchanged),
                          "trained": len(trained), "moment_leaves": len(adam.mu) + len(adam.nu),
                          "opt_state_bytes": opt_bytes,
                          "adapter_moment_bytes": 2 * 2 * adapter_elems,
                          "frozen_no_grad": no_grad, "launches": a_launches}
        want = c["steps"] * tol["launches_per_step"]
        ok["a_train"] = (first_equal and all(math.isfinite(x) for x in losses)
                         and losses[-1] < losses[0] and len(unchanged) == len(frozen) and no_grad
                         and sorted(adam.mu) == sorted(adam.nu) == trained
                         and opt_bytes == 2 * 2 * adapter_elems
                         and state.opt_state.inner_states["freeze"] is not None
                         and a_launches["fwd"] == a_launches["dq"] == a_launches["dkv"] == want)
        del state, adam, step
        lap("a_train")

        # the adapters of (a) after steps 1, 2 and 4, each over the same base
        # tensors, and the bank of them (slot 0 the zero adapter)
        adapters = [{**{n: t for n, t in params.items() if n not in trained}, **snaps[k]}
                    for k in c["snapshots"]]
        bank32 = L.multi_lora_bank(adapters)
        n_slots = L.bank_size(bank32)
        base16 = cast({n: t for n, t in params.items() if n in base})
        merged16 = cast(L.merge_lora(params))

        if "b" in parts:
            with Guarded("b_int8", ok, err):
                # (b) merge, then quantize, then decode
                merged32 = L.merge_lora(params)
                n_big = sum(t.dim() == 2 and t.numel() >= c["quant_min"] for t in merged32.values())
                q8 = Q.quantize_tree(merged32, min_size=c["quant_min"])
                del merged32
                q8 = {n: (t if n in Q.quantized_names(q8) or n.endswith(Q.SCALE)
                          else t.to(bf16)) for n, t in q8.items()}
                m_bf16, m_int8 = model_of(merged16), model_of(q8)
                bytes_of = lambda ps: sum(t.numel() * t.element_size() for t in ps.values())  # noqa: E731
                b, width, new = c["dec_batch"], c["dec_width"], c["dec_new"]
                lengths = rng.integers(c["dec_min"], width + 1, b)
                lengths[0], lengths[-1] = width, c["dec_min"]
                prompts = [rng.integers(0, vocab, n).tolist() for n in lengths]
                t0 = time.perf_counter()
                comps, _ = generate_text.decode_batches(m_int8, prompts, batch_size=b,
                                                        width=width, max_new_tokens=new)
                gen_s = time.perf_counter() - t0
                forced = torch.zeros(b, width + new, dtype=torch.long, device=device)
                for i, n in enumerate(lengths):
                    forced[i, :n] = torch.tensor(prompts[i], device=device)
                    forced[i, n:n + new] = torch.tensor(comps[i], device=device)
                at = torch.from_numpy(lengths).to(device)[:, None] - 1 + torch.arange(
                    new, device=device)
                rows_ = torch.arange(b, device=device)[:, None]
                with torch.no_grad():
                    ref = m_bf16(forced)[rows_, at]
                    got = m_int8(forced)[rows_, at]
                    # the same codes dequantized into a bf16 model: only the
                    # product's rounding parts it from the int8 forward
                    m_deq = model_of(cast(Q.dequantize_tree(q8, torch.float32)))
                    deq = m_deq(forced)[rows_, at]
                    del m_deq
                toks = torch.tensor(comps, device=device)
                confident = top2_gap(ref) > tol["int8_gap"]
                diff = (got - ref).abs()
                err["b_int8"] = {
                    "lengths": lengths.tolist(), "generate_s": gen_s,
                    "max_abs_logits": diff.max().item(),
                    "rms_logits_err": diff.square().mean().sqrt().item(),
                    "rms_vs_dequantized": (got - deq).square().mean().sqrt().item(),
                    "ref_logit_rms": ref.square().mean().sqrt().item(),
                    "confident_tokens": int(confident.sum()), "tokens": b * new,
                    "confident_mismatches": int(((ref.argmax(-1) != toks) & confident).sum()),
                    "agree_with_bf16_argmax": float((ref.argmax(-1) == toks).float().mean()),
                    "quantized_leaves": len(Q.quantized_names(q8)),
                    "int8_bytes": bytes_of(q8), "bf16_bytes": bytes_of(merged16)}
                e = err["b_int8"]
                ok["b_int8"] = (bool(torch.isfinite(got).all()) and list(toks.shape) == [b, new]
                                and e["rms_logits_err"] <= tol["int8_rms"]
                                and e["rms_vs_dequantized"] <= tol["int8_dequant_rms"]
                                and e["confident_mismatches"] == 0
                                and e["quantized_leaves"] == n_big
                                and e["int8_bytes"] < 0.6 * e["bf16_bytes"])
                del ref, got, deq, forced
                lap("b_int8_check")
                timing = {}
                for tb in ((1, b) if cuda else ()):
                    p = torch.from_numpy(rng.integers(0, vocab, (tb, c["time_prompt"]))).to(device)
                    for name, m in (("bf16", m_bf16), ("int8", m_int8)):
                        generate(m, p, 4)  # warm-up
                        cache = init_cache(cfg, tb, device)
                        with torch.no_grad():
                            logits, pos = prefill(m, cache, p)
                        tok = logits.argmax(-1)

                        def one(m=m, cache=cache):
                            nonlocal tok, pos
                            with torch.no_grad():
                                tok = decode_step(m, cache, tok, pos).argmax(-1)
                            pos = pos + 1

                        sync_on(cuda)
                        t0 = time.perf_counter()
                        for _ in range(c["time_steps"]):
                            one()
                        issue = (time.perf_counter() - t0) * 1e3 / c["time_steps"]
                        sync_on(cuda)
                        step_ms = (time.perf_counter() - t0) * 1e3 / c["time_steps"]
                        prof = profile_steps(one, n=2, model=f"lora_{name}_decode_b{tb}")
                        timing[f"{name}_b{tb}"] = {
                            "step_ms": step_ms, "host_issue_ms": issue,
                            "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
                            "profile_wall_ms_per_step": prof["wall_ms_per_step"],
                            "device_idle_share": prof["device_idle_share"]}
                        del cache
                nums["b"] = {"timing": timing, "int8_bytes": e["int8_bytes"],
                             "bf16_bytes": e["bf16_bytes"]}
                del m_bf16, m_int8, q8
                lap("b_int8_timing")
            # the example through tfcluster.run: a process of its own, which
            # runs beside part (e) (nothing of (e) is timed), or here
            if "e" not in parts:
                example_check(start_example(c["example_args"], cuda), c, ok, err)
                lap("b_example")

        if serve_layers is not None and serve_layers < cfg.num_layers:
            # (c)-(e) serve the first serve_layers blocks of (a)'s weights and
            # adapters, through a module tree of that depth
            def keep(tree):
                return {n: t for n, t in tree.items()
                        if not n.startswith("layers.") or int(n.split(".")[1]) < serve_layers}

            cfg = dataclasses.replace(cfg, num_layers=serve_layers)
            tol["score_launches_per_call"] = serve_layers if cuda else 0
            params, base, bank32, base16 = keep(params), keep(base), keep(bank32), keep(base16)
            adapters = [keep(a) for a in adapters]
            model = Llama(cfg, device=device, seed=seed)

        if "c" in parts:
            with Guarded("c_bank", ok, err):
                # (c) routing in fp32: each row through the bank against its
                # adapter merged alone
                rows = torch.from_numpy(rng.integers(0, vocab, (c["route_rows"], c["route_len"])))
                rows = rows.to(device)
                ids = torch.arange(c["route_rows"], device=device) % n_slots
                cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
                m32 = Llama(cfg32, device=device, seed=seed)
                adopt_params(m32, bank32)
                got = bank_forward(m32, rows, ids)
                route_err, separation = 0.0, math.inf
                for r in range(c["route_rows"]):
                    k = int(ids[r])
                    adopt_params(m32, L.merge_lora(L.select_adapter(bank32, k)))
                    want_r = bank_forward(m32, rows[r:r + 1])[0]
                    route_err = max(route_err, (got[r] - want_r).abs().max().item())
                    if k:
                        adopt_params(m32, {n: t for n, t in params.items() if n in base})
                        effect = (bank_forward(m32, rows[r:r + 1])[0] - want_r).abs().max().item()
                        separation = min(separation, effect)
                del m32, got
                err["c_bank_rows"] = {"max_abs_logits": route_err, "adapter_effect_min": separation,
                                      "slots": n_slots}
                ok["c_bank_rows"] = (route_err <= tol["route"]
                                     and separation >= tol["route_separation"] * tol["route"])
                lap("c_route")

                # (c) the bank served: 8 slots, mixed adapters from 8 threads
                bank16 = cast(bank32)
                reqs = []
                for i in range(c["requests"]):
                    n = int(rng.integers(c["min_len"], c["max_len"] + 1))
                    new = int(rng.integers(c["min_new"], c["max_new"] + 1))
                    reqs.append({"tokens": rng.integers(0, vocab, n).tolist(),
                                 "max_new_tokens": new, "adapter": i % n_slots})
                eng = ContinuousBatcher(model, params=bank16, **eng_kw)
                engines.append(eng)
                out_b, wall_b = drive_engine(eng, reqs, c["threads"], 0.05)
                plain = ContinuousBatcher(model, params=base16, **eng_kw)
                engines.append(plain)
                reqs0 = [{k: v for k, v in r.items() if k != "adapter"} for r in reqs]
                out_p, wall_p = drive_engine(plain, reqs0, c["threads"], 0.05)
                plain.close()
                # references: each adapter merged alone, decoded with generate
                cmp_ = {}
                for k in range(n_slots):
                    idx = [i for i, r in enumerate(reqs) if r["adapter"] == k]
                    ref_params = base16 if k == 0 else cast(
                        L.merge_lora(L.select_adapter(bank32, k)))
                    mk = model_of(ref_params)
                    ref_toks, _ = generate_text.decode_batches(
                        mk, [reqs[i]["tokens"] for i in idx], batch_size=len(idx),
                        width=c["widths"][-1], max_new_tokens=max(reqs[i]["max_new_tokens"]
                                                                  for i in idx))
                    want_k = {i: ("ok", t[:reqs[i]["max_new_tokens"]], None, None)
                              for i, t in zip(idx, ref_toks)}
                    got_k = {i: ("ok", out_b[i][0], out_b[i][1], out_b[i][2]) for i in idx}
                    cmp_[k] = against_engine(mk, reqs, idx, got_k, want_k, tol)
                    del mk
                ttft = lambda o: float(np.percentile([v[2] for v in o.values()], 50)) * 1e3  # noqa: E731
                ntok = lambda o: sum(len(v[0]) for v in o.values())  # noqa: E731
                nums["c"] = {"bank_tokens_per_s": ntok(out_b) / wall_b,
                             "plain_tokens_per_s": ntok(out_p) / wall_p,
                             "bank_ttft_p50_ms": ttft(out_b), "plain_ttft_p50_ms": ttft(out_p),
                             "bank_wall_s": wall_b, "plain_wall_s": wall_p}
                err["c_serve"] = {str(k): v for k, v in cmp_.items()}
                ok["c_serve"] = (len(out_b) == len(reqs) and all(
                    v["confident_mismatches"] == 0 and v["max_abs_logprob"] <= tol["logprob"]
                    for v in cmp_.values()))
                # the prefix cache is keyed by adapter
                pp = rng.integers(0, vocab, c["prefix_prompt"]).tolist()
                s0 = eng.stats()
                first = eng.submit(pp, 16, adapter=1)
                s1 = eng.stats()
                other = eng.submit(pp, 16, adapter=2)
                s2 = eng.stats()
                again = eng.submit(pp, 16, adapter=1)
                s3 = eng.stats()
                err["c_prefix"] = {
                    "first_misses": s1["prefix_misses"] - s0["prefix_misses"],
                    "other_adapter_hits": s2["prefix_hits"] - s1["prefix_hits"],
                    "other_adapter_misses": s2["prefix_misses"] - s1["prefix_misses"],
                    "same_adapter_hits": s3["prefix_hits"] - s2["prefix_hits"],
                    "hit_equals_miss": again == first}
                p_ = err["c_prefix"]
                ok["c_prefix"] = (p_["other_adapter_hits"] == 0 and p_["other_adapter_misses"] >= 1
                                  and p_["same_adapter_hits"] >= 1 and again == first)
                lap("c_serve")

        if "d" in parts:
            with Guarded("d_swap", ok, err):
                # (d) adapters only: a second bank (the adapters in another
                # order) swapped in under traffic
                from tensorflowonspark_tpu_torch.serving.engine import _bound_module

                bank2 = cast(L.multi_lora_bank([adapters[i] for i in (2, 0, 1)]))
                payload = rollout.lora_state(bank2)  # host copies, as a loader gives them
                dreqs = [{**r, "max_new_tokens": min(r["max_new_tokens"], c["roll_new"])}
                         for r in reqs[:c["roll_requests"]]]
                # the references: v0 is (c)'s run of the same engine while it
                # was fresh (greedy: a prefix of its longer budget), v1 a
                # fresh engine on the second bank
                f = ContinuousBatcher(model, params=bank2, **eng_kw)
                try:
                    done, _ = drive_engine(f, dreqs, c["threads"], 0.0)
                finally:
                    f.close()
                fresh = {"v1": {i: t for i, (t, _, _) in done.items()},
                         "v0": {i: out_b[i][0][:r["max_new_tokens"]] for i, r in enumerate(dreqs)}}
                _, before = eng.current_weights()
                old_factors = {n: before[n].clone() for n in payload}
                done0 = eng.completed
                stop, started, res = threading.Event(), threading.Event(), {}

                def traffic():
                    res["out"], res["wall"], res["ended"] = version_traffic(
                        eng, dreqs, c["roll_threads"], until=stop, started=started)

                tr = threading.Thread(target=traffic)
                tr.start()
                started.wait(timeout=300)
                deadline = time.perf_counter() + 300
                while eng.completed < done0 + c["roll_threads"] and time.perf_counter() < deadline:
                    time.sleep(0.01)  # some requests finish under v0 first
                t0 = time.perf_counter()
                eng.swap_weights(payload, version="v1", kind="lora")
                t1 = time.perf_counter()
                lora_traffic_s = t1 - t0
                time.sleep(0.5)
                stop.set()
                tr.join(timeout=900)
                _, after = eng.current_weights()
                bases = [n for n in after if n not in payload]
                same_storage = all(after[n] is before[n] for n in bases)
                intact = (all(torch.equal(before[n], bank16[n]) for n in bases)
                          and all(torch.equal(before[n], old_factors[n]) for n in payload))
                mods = {"v0": _bound_module(model, before), "v1": _bound_module(model, after)}
                # a request that ended before the install decoded under v0
                # alone, one that started after it under v1 alone; one that
                # spans it may decode under both (the engine drains no
                # request at a swap: a fleet's controller does) and is only
                # held to its stamp
                rows_, spanning, stamps = {}, 0, {}
                for (rnd, i), o in res.get("out", {}).items():
                    stamps[o[4]] = stamps.get(o[4], 0) + 1
                    if o[0] != "ok" or o[4] not in fresh:
                        continue
                    if o[5] < t1 and o[6] > t0:
                        spanning += 1
                        continue
                    ref = fresh[o[4]][i]
                    tf = bank_teacher_forced(mods[o[4]], dreqs[i]["tokens"], ref,
                                             dreqs[i]["adapter"])
                    rows_[(rnd, i)] = hold_to_reference(o[1], o[2], tf, ref, tol)
                del mods
                # the install alone on the idle engine, from host memory: the
                # adapters (payload) against the whole weight set
                t0 = time.perf_counter()
                eng.swap_weights(rollout.lora_state(bank16), version="v2", kind="lora")
                lora_idle_s = time.perf_counter() - t0
                host_full = {n: t.to("cpu") for n, t in bank2.items()}
                t0 = time.perf_counter()
                eng.swap_weights(host_full, version="v3")
                full_idle_s = time.perf_counter() - t0
                del host_full
                err["d_swap"] = {"stamps": stamps, "requests": len(res.get("out", {})),
                                 "spanning": spanning,
                                 "errors": [o for o in res.get("out", {}).values()
                                            if o[0] != "ok"][:3],
                                 "confident_mismatches": sum(r["confident_mismatches"]
                                                             for r in rows_.values()),
                                 "compared": len(rows_),
                                 "max_abs_logprob": max((r["max_abs_logprob"] for r in
                                                         rows_.values()), default=0.0)}
                err["d_prior_intact"] = {"bases_same_storage": same_storage,
                                         "prior_bit_equal": intact}
                d_ = err["d_swap"]
                ok["d_swap"] = (bool(res.get("ended")) and not d_["errors"]
                                and set(stamps) <= {"v0", "v1"} and stamps.get("v0", 0) >= 1
                                and stamps.get("v1", 0) >= 1
                                and d_["compared"] + spanning == d_["requests"]
                                and d_["confident_mismatches"] == 0
                                and d_["max_abs_logprob"] <= tol["logprob"])
                ok["d_prior_intact"] = same_storage and intact
                nums["d"] = {"lora_install_under_traffic_s": lora_traffic_s,
                             "lora_install_idle_s": lora_idle_s,
                             "full_install_idle_s": full_idle_s,
                             "lora_payload_bytes": sum(t.numel() * t.element_size()
                                                       for t in payload.values()),
                             "full_bytes": sum(t.numel() * t.element_size()
                                               for t in bank2.values())}
                eng.close()
                del before, after
                lap("d_swap")

            with Guarded("d_fleet", ok, err):
                # (d) a RolloutController of kind lora from a channel across
                # an in-process two-seat fleet
                def factory():
                    return ContinuousBatcher(model, params=bank16, **eng_kw)

                fleet = ServingFleet(factory=factory, replicas=c["replicas"],
                                     probe_interval=c["probe_s"], drain_timeout=c["drain_s"])
                router = FleetRouter(fleet)
                seat_w = {v["rid"]: v["handle"].engine.current_weights()[1]
                          for v in fleet.views()}
                ch = os.path.join(tmp, "channel")
                ctl = rollout.RolloutController(
                    fleet, channel_dir=ch, loader=rollout.checkpoint_loader(bank16),
                    poll_interval=c["poll_s"], drain_timeout=c["drain_s"])
                ctl.start()
                stop, started, res = threading.Event(), threading.Event(), {}

                def traffic():
                    res["out"], res["wall"], res["ended"] = version_traffic(
                        router, dreqs, c["roll_threads"], until=stop, started=started)

                tr = threading.Thread(target=traffic)
                tr.start()
                started.wait(timeout=300)
                t0 = time.perf_counter()
                rollout.publish_params(ch, payload, version="v1", kind="lora")
                waited = wait_outcome(ctl, "completed", 1, c["roll_wait_s"])
                roll_s = time.perf_counter() - t0
                stop.set()
                tr.join(timeout=900)
                rows_, stamps = {}, {}
                for (rnd, i), o in res.get("out", {}).items():
                    stamps[o[4]] = stamps.get(o[4], 0) + 1
                    if o[0] != "ok" or o[4] not in fresh:
                        continue
                    rows_[(rnd, i)] = (o[1], fresh[o[4]][i], i, o[4], o[2])
                # every resolved request against the fresh engine of its version
                checked = {}
                refmods = {"v0": _bound_module(model, seat_w[0]),
                           "v1": _bound_module(model, {**seat_w[0], **{
                               n: t.to(device) for n, t in payload.items()}})}
                for key, (toks, ref, i, ver, lps) in rows_.items():
                    tf = bank_teacher_forced(refmods[ver], dreqs[i]["tokens"], ref,
                                             dreqs[i]["adapter"])
                    checked[key] = hold_to_reference(toks, lps, tf, ref, tol)
                kept = all(v["handle"].engine.current_weights()[1][n] is seat_w[v["rid"]][n]
                           for v in fleet.views() for n in seat_w[v["rid"]] if n not in payload)
                st = ctl.stats()
                err["d_fleet"] = {"outcome_wait_s": waited, "stamps": stamps,
                                  "errors": [o for o in res.get("out", {}).values()
                                             if o[0] != "ok"][:3],
                                  "compared": len(checked),
                                  "confident_mismatches": sum(r["confident_mismatches"]
                                                              for r in checked.values()),
                                  "bases_kept": kept, "applied": st["applied"]}
                f_ = err["d_fleet"]
                ok["d_fleet"] = (waited is not None and bool(res.get("ended"))
                                 and not f_["errors"] and set(stamps) <= {"v0", "v1"}
                                 and stamps.get("v1", 0) >= 1 and f_["confident_mismatches"] == 0
                                 and kept and st["applied"] == {str(r): "v1"
                                                                for r in range(c["replicas"])})
                nums["d"] = {**nums.get("d", {}), "fleet_roll_s": roll_s,
                             "fleet_requests": len(res.get("out", {}))}
                ctl.stop()
                ctl = None
                router.close()
                router = None
                fleet.close()
                fleet = None
                del refmods
                lap("d_fleet")

        if "e" in parts:
            example = start_example(c["example_args"], cuda) if "b" in parts else None
            with Guarded("e_server", ok, err):
                # (e) serve_model in process over a bank checkpoint
                ckpt = save_checkpoint(os.path.join(tmp, "bank"), {"params": bank16})
                lora_ckpt = save_checkpoint(os.path.join(tmp, "adapters"), payload)
                gen_ = dict(checkpoint=ckpt, model=model_flag,
                            config_overrides=cli_overrides(cfg, preset), device=device.type,
                            engine="continuous", widths=",".join(map(str, c["widths"])),
                            slots=c["slots"], batch_size=c["slots"], max_new_tokens=c["budget"],
                            decode_block=c["block"], pipeline_depth=c["depth"],
                            prefill_chunk=c["chunk"], prefix_cache=c["prefix"],
                            lora_scale=1.0, admin_token="lora-smoke")
                # a request of (d) with adapter 2: its engine completions
                # under each bank are (d)'s references (an engine's greedy
                # row does not depend on its batchmates: every step runs
                # all slots, every prefill one row)
                i2 = next(i for i, r in enumerate(dreqs) if r["adapter"] == min(2, n_slots - 1))
                r2, k2 = dreqs[i2], dreqs[i2]["adapter"]
                want_v0, want_v1 = fresh["v0"][i2], fresh["v1"][i2]
                with Serving(gen_) as srv:
                    body = {"prompts": [r2["tokens"]], "max_new_tokens": r2["max_new_tokens"],
                            "adapter": k2}
                    code_g, text_g = http(srv.url, "/generate", body)
                    code_bad, _ = http(srv.url, "/generate", {**body, "adapter": 9})
                    score_rows = [r["tokens"][:200] + [1, 2, 3] for r in reqs[:c["score_rows"]]]
                    with windows:
                        code_sc, text_sc = http(srv.url, "/score", {"sequences": score_rows})
                        sync_on(cuda)
                        score_launches = {**fa.LAUNCHES, **bn_kernels.LAUNCHES}
                    code_r, _ = http(srv.url, "/admin/reload",
                                     {"version": "adapters-v1", "path": lora_ckpt, "kind": "lora"},
                                     headers={"Authorization": "Bearer lora-smoke"})
                    code_g1, text_g1 = http(srv.url, "/generate", body)
                score_width = serve_model.score_width(c["widths"][-1], c["budget"],
                                                      cfg.max_seq_len)
                m0 = model_of(base16)
                retarget(m0, dataclasses.replace(cfg, attention_impl="xla"))
                lp_plain = generate_text.build_score_fn(m0, width=score_width,
                                                        bsz=c["slots"])(score_rows)
                del m0
                lp = json.loads(text_sc)["logprobs"] if code_sc == 200 else []
                score_err = max((float(np.abs(np.array(a) - np.array(b)).max())
                                 for a, b in zip(lp, lp_plain)), default=math.inf)
                g0 = json.loads(text_g)["completions"][0] if code_g == 200 else None
                g1 = json.loads(text_g1)["completions"][0] if code_g1 == 200 else None
                err["e_server"] = {"generate": code_g, "adapter_equal": g0 == want_v0,
                                   "adapter_9": code_bad, "reload": code_r,
                                   "after_reload_equal": g1 == want_v1,
                                   "score_width": score_width, "score_launches": score_launches,
                                   "score_max_abs_logprob": score_err}
                e_ = err["e_server"]
                ok["e_server"] = (g0 == want_v0 and code_bad == 400 and code_r in (200, 202)
                                  and g1 == want_v1 and score_err <= tol["score"]
                                  and score_launches == {"fwd": tol["score_launches_per_call"],
                                                         "dq": 0, "dkv": 0, "pair": 0,
                                                         "cross": 0})
            if example is not None:
                example_check(example, c, ok, err)
            lap("e_server_and_example")
    finally:
        if ctl is not None:
            ctl.stop()
        if router is not None:
            router.close()
        if fleet is not None:
            fleet.close()
        for eng in engines:
            eng.close()
        shutil.rmtree(tmp, ignore_errors=True)

    nums["peak_mem_gb"] = peak or None
    nums["wall_s"] = time.perf_counter() - t_phase
    nums["part_s"] = part_s
    nums["launches"] = windows.total
    nums["nvidia_smi"] = nvidia_smi() if cuda else None
    emit({"phase": "lora", "part": "numbers", **nums})
    good = bool(ok) and all(ok.values())
    emit({"phase": "lora", "case": "lora_checks", "seed": seed, "layers": cfg.num_layers,
          "hidden": cfg.hidden_size, "rank": c["rank"], "parts": parts, "checks": ok,
          "err": err, "tol": tol, "ok": good})
    if not good:
        raise SystemExit("lora phase failed: " + ", ".join(k for k, v in ok.items() if not v))
    return windows.total


MOE = dict(layers=4, experts=8, top_k=2, batch=8, seq=1024, steps=5, lr=1e-4, block_batch=2,
           block_seq=256, low_cf=0.25, check_seq=64, dec_batch=8, dec_width=512, dec_min=64,
           dec_new=64, time_prompt=128, time_steps=16, eng_slots=8, eng_widths=(128, 256, 512),
           eng_block=8, eng_depth=2, eng_requests=8, eng_threads=8, eng_min=16, eng_max=500,
           eng_new=64, eng_stagger=0.05, alone_len=128)
# Limits of phase moe. "loss_cpu": a tiny MoE Llama's loss through
# llama_loss_fn on the card in fp32 against cross entropy plus the layers'
# aux losses computed on the CPU in fp32 from the same weights, |diff| (the
# aux losses sum to ~0.02 there, so a loss without them reads ~200x
# the limit). "loss_parts": the train step's first loss against cross entropy
# plus the aux losses of the same bf16 forward, |diff|. "block": one MoE
# block at full width in bf16 on the card against a plain fp32 version on
# the CPU (its own routing loop, token-major priority), max |diff| over the
# reference's rms; the kept assignments must be equal. "logits_fp32" /
# "logits_bf16": decode against a teacher-forced forward, max |diff| of the
# logits and the confident-token gap, at each row's positions before its
# first token routed otherwise (bf16: phase decode's limit); in fp32 at
# least "fp32_held_share" of the positions must be held. "gap": phase
# serve's confident-token gap (the engine against generate alone). On the
# H100 at seed 0 (PERF.md, PR 15): loss_cpu read 3.9e-7 (a loss without
# the aux losses 0.0206), loss_parts 5.8e-7, block 0.037 and 0.074 (the
# choices-major fault 8.45, its kept assignments unequal); fp32 decode held
# 263 of 512 positions (rows 0-3 whole; the later rows lose capacity to the
# rows before them within 0-5 steps) at 4.1e-5, and bf16 held none (a
# prompt token routed otherwise in every row).
MOE_TOL = dict(loss_cpu=1e-4, loss_parts=1e-3, block=0.1, logits_fp32=1e-3,
               logits_bf16=DECODE_TOL["logits"], fp32_held_share=0.25, gap=SERVE_TOL["logits"])


class MoEDrops:
    """Forward hooks on every expert layer of ``model`` while inside: each
    call's ``(layer, MoEAux)`` in call order (``dropped`` (B, S),
    ``experts`` (B, S, k), ``assigned``)."""

    def __init__(self, model):
        self.model, self.calls, self._handles = model, [], []

    def __enter__(self):
        for i, block in enumerate(self.model.layers):
            self._handles.append(block.mlp.register_forward_hook(self._hook(i)))
        return self

    def _hook(self, i):
        def hook(mod, inputs, out):
            self.calls.append((i, out[1]))
        return hook

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()

    def share(self, calls=None) -> float:
        """Dropped assignments over all assignments of ``calls`` (default:
        every call)."""
        calls = self.calls if calls is None else calls
        assigned = sum(a.assigned for _, a in calls)
        return float(sum(int(a.dropped.sum()) for _, a in calls)) / max(assigned, 1)


def moe_routing_prefix(dec, forced, lengths, width, new):
    """Per row of a greedy decode (``dec``: :class:`MoEDrops` of its
    prefill and ``new - 1`` steps) and a teacher-forced forward over the
    same rows (``forced``): how many of the row's generated positions come
    before the first token whose routing differs between the two (another
    expert chosen, or an assignment dropped in one), where the two compute
    the same function. A prompt token routed otherwise leaves none."""
    nl = len(forced.calls)
    b = lengths.shape[0]
    dev = lengths.device
    real = torch.arange(width, device=dev)[None, :] < lengths[:, None]
    gen_pos = lengths[:, None] + torch.arange(new - 1, device=dev)[None, :]  # (B, new-1)
    rows = torch.arange(b, device=dev)[:, None]
    prompt_bad = torch.zeros(b, dtype=torch.bool, device=dev)
    gen_bad = torch.zeros(b, new - 1, dtype=torch.bool, device=dev)
    for layer in range(nl):
        fa_ = forced.calls[layer][1]
        pa = dec.calls[layer][1]
        off = (pa.experts != fa_.experts[:, :width]).any(-1) | (pa.dropped > 0) | (
            fa_.dropped[:, :width] > 0)
        prompt_bad |= (off & real).any(1)
        if new > 1:
            steps = [dec.calls[nl * t + layer][1] for t in range(1, new)]
            de = torch.stack([a.experts[:, 0] for a in steps], 1)  # (B, new-1, k)
            dd = torch.stack([a.dropped[:, 0] for a in steps], 1)
            gen_bad |= ((de != fa_.experts[rows, gen_pos]).any(-1) | (dd > 0)
                        | (fa_.dropped[rows, gen_pos] > 0))
    gen_bad = gen_bad.cpu()
    first = []
    for r in range(b):
        hit = gen_bad[r].nonzero()
        first.append(0 if bool(prompt_bad[r]) else (int(hit[0]) + 1 if len(hit) else new))
    return first


def moe_decode_check(model, prompt, lens, new, tol_logits):
    """Greedy ``generate`` of the MoE ``model`` on right-padded ``prompt``
    (lengths ``lens``) against a teacher-forced forward: ``generate``'s
    tokens equal the driven prefill/decode_step's, the logits within
    ``tol_logits`` and the tokens equal the forward's argmax where its
    top-2 gap exceeds it, at each row's positions before its first token
    routed otherwise (:func:`moe_routing_prefix`); the dropped shares."""
    from tensorflowonspark_tpu_torch.models.llama import generate

    b, width = prompt.shape
    dev = prompt.device
    toks = generate(model, prompt, new, prompt_lengths=lens)
    with MoEDrops(model) as dec:
        cap_toks, cap_logits = greedy_capture(model, prompt, new, lens)
    forced = torch.zeros(b, width + new, dtype=torch.long, device=dev)
    for i, n in enumerate(lens.tolist()):
        forced[i, :n] = prompt[i, :n]
        forced[i, n:n + new] = cap_toks[i]
    with torch.no_grad(), MoEDrops(model) as tf:
        full = model(forced)
    at = lens[:, None] - 1 + torch.arange(new, device=dev)
    ref = full[torch.arange(b, device=dev)[:, None], at]
    del full
    first = moe_routing_prefix(dec, tf, lens, width, new)
    held = (torch.arange(new)[None, :] < torch.tensor(first)[:, None]).to(dev)
    diff = (cap_logits - ref).abs().amax(-1)
    confident = (top2_gap(ref) > tol_logits) & held
    nl = model.cfg.num_layers
    return {
        "capture_equals_generate": bool(torch.equal(cap_toks, toks)),
        "routing_agrees_until_by_row": first, "held_positions": int(held.sum()),
        "positions": b * new,
        "max_abs_logits_held": float(diff[held].max()) if bool(held.any()) else 0.0,
        "max_abs_logits_all": float(diff.max()),
        "confident_mismatches": int(((ref.argmax(-1) != cap_toks) & confident).sum()),
        "confident_tokens": int(confident.sum()),
        "decode_dropped_share": dec.share(dec.calls[nl:]),
        "prefill_dropped_share": dec.share(dec.calls[:nl]),
        "forced_dropped_share": tf.share(),
        "finite": bool(torch.isfinite(cap_logits).all())}


def moe_step_tflop(cfg, b, s) -> float:
    """TFLOP of one train step (forward and backward, 3x the forward's
    products) of an MoE Llama as the reference computes it: the expert
    products run over every capacity slot of every expert."""
    t, d, f, e = b * s, cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    cap = max(math.ceil(t * cfg.moe_top_k * cfg.moe_capacity_factor / e), cfg.moe_top_k)
    kv = cfg.num_kv_heads * cfg.head_dim
    layer = (2 * t * d * (2 * d + 2 * kv) + 2 * b * s * s * d  # projections, causal QK^T and PV
             + 2 * t * d * e + 3 * 2 * e * cap * d * f)  # router, expert products
    return 3 * (cfg.num_layers * layer + 2 * t * d * cfg.vocab_size) / 1e12


def moe_plain(x, router_w, w_gate, w_up, w_down, top_k, capacity_factor):
    """One MoE block's function written out plainly, in fp32 on the CPU: x
    (T, d); the router, the top k by a stable sort (ties to the lower
    index), renormalized gates, and each (token, choice) in token order
    kept while its expert has a slot left. Returns (out (T, d), kept (T, k))."""
    t, e = x.shape[0], w_gate.shape[0]
    probs = torch.softmax(x @ router_w.t(), dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = srt.values[:, :top_k] / srt.values[:, :top_k].sum(-1, keepdim=True)
    experts = srt.indices[:, :top_k].tolist()
    cap = max(math.ceil(t * top_k * capacity_factor / e), top_k)
    used = [0] * e
    kept = torch.zeros(t, top_k, dtype=torch.bool)
    for i in range(t):
        for j in range(top_k):
            if used[experts[i][j]] < cap:
                used[experts[i][j]] += 1
                kept[i, j] = True
    out = torch.zeros_like(x)
    for ex in range(e):
        sel = [(i, j) for i in range(t) for j in range(top_k)
               if experts[i][j] == ex and kept[i, j]]
        if not sel:
            continue
        rows = torch.tensor([i for i, _ in sel])
        g = gates[rows, torch.tensor([j for _, j in sel])]
        h = torch.nn.functional.silu(x[rows] @ w_gate[ex]) * (x[rows] @ w_up[ex])
        out.index_add_(0, rows, g[:, None] * (h @ w_down[ex]))
    return out, kept


def moe_block_check(device, c, d, f, cf, seed):
    """One MoE block (MoEConfig(num_experts, top_k, cf), width d/f) in bf16
    on ``device`` against :func:`moe_plain` on the CPU in fp32, same
    weights and same (bf16-valued) input."""
    from tensorflowonspark_tpu_torch.parallel.moe import MoEConfig, MoEMLP, route

    e, k = c["experts"], c["top_k"]
    g = torch.Generator().manual_seed(seed)
    mlp = MoEMLP(MoEConfig(num_experts=e, top_k=k, capacity_factor=cf, hidden_size=d,
                           intermediate_size=f, dtype=torch.bfloat16), device="cpu")
    with torch.no_grad():
        for p in mlp.parameters():
            p.normal_(0.0, 0.02, generator=g)
    x = torch.randn(c["block_batch"], c["block_seq"], d, generator=g).to(torch.bfloat16)
    x32 = x.float().reshape(-1, d)
    ref, kept_ref = moe_plain(x32, mlp.router.weight.detach(), mlp.w_gate.detach(),
                              mlp.w_up.detach(), mlp.w_down.detach(), k, cf)
    mlp = mlp.to(device)
    with torch.no_grad():
        out, aux = mlp(x.to(device))
        r = route(mlp.router(x.to(device).reshape(-1, d)), mlp.cfg, x32.shape[0])
    out = out.float().reshape(-1, d).cpu()
    scale = float(ref.norm() / math.sqrt(ref.numel()))
    return {"capacity_factor": cf, "capacity": r.capacity,
            "kept_equal": bool(torch.equal(r.kept.cpu(), kept_ref)),
            "dropped_share": float((~kept_ref).float().mean()),
            "card_dropped": int(aux.dropped.sum()),
            "max_abs_over_rms": float((out - ref).abs().max()) / scale,
            "frob": float((out - ref).norm() / ref.norm()), "ref_rms": scale,
            "finite": bool(torch.isfinite(out).all())}


def moe_loss_cpu_check(device, tol):
    """A tiny MoE Llama's loss through ``llama_loss_fn`` on ``device`` in
    fp32 against cross entropy plus the layers' aux losses of a forward on
    the CPU, from the same weights and tokens."""
    from tensorflowonspark_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        adopt_params,
        cross_entropy_loss,
        llama_loss_fn,
    )

    cfg = LlamaConfig.tiny(dtype=torch.float32, remat=False, attention_impl="xla",
                           num_experts=8, moe_top_k=2)
    cpu = Llama(cfg, device="cpu", seed=3)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        logits, auxes = cpu(toks[:, :-1], return_aux=True)
        want = float(cross_entropy_loss(logits, toks[:, 1:])) + sum(float(a.loss) for a in auxes)
        card = Llama(cfg, device=device, seed=3)
        own = adopt_params(card, {n: p.detach().to(device) for n, p in cpu.named_parameters()})
        got = float(llama_loss_fn(card)(own, toks.to(device)))
    aux = sum(float(a.loss) for a in auxes)
    return {"card_loss": got, "cpu_loss": want, "aux_sum": aux, "abs_diff": abs(got - want),
            "ok": abs(got - want) <= tol}


def phase_moe(fa, layers=None, rehearse=None, seed=0, parts="abcd", dec_layers=16,
              eng_layers=SERVING_DEPTH):
    """MoE experts on the card (see the module docstring, phase 15); raises
    SystemExit when a check fails. ``layers`` is (a)'s training depth
    (``MOE["layers"]`` when None), ``dec_layers`` (c)'s decode depth and
    ``eng_layers`` (d)'s engine depth; ``parts`` picks the parts
    (chip_faults.py runs "ab"); with ``rehearse={"device": "cpu", "tiny":
    True, "sizes": {...}}`` it runs at a tiny size on the CPU. Returns every
    kernel's launches over (a)'s timed steps."""
    from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step
    from tensorflowonspark_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        adopt_params,
        cross_entropy_loss,
        generate,
        llama_loss_fn,
    )
    from tensorflowonspark_tpu_torch.ops import bn_kernels
    from tensorflowonspark_tpu_torch.serving import ContinuousBatcher

    rehearse = rehearse or {}
    device = torch.device(rehearse.get("device", "cuda"))
    cuda = device.type == "cuda"
    c = {**MOE, **rehearse.get("sizes", {})}
    layers = c["layers"] if layers is None else layers
    moe_kw = dict(num_experts=c["experts"], moe_top_k=c["top_k"])
    if rehearse.get("tiny"):
        preset = LlamaConfig.tiny(dtype=torch.bfloat16, **moe_kw)
    else:
        preset = LlamaConfig.llama_1b(**moe_kw)
    tol = {**MOE_TOL, "launches_per_step": layers if cuda else 0}
    windows = LaunchWindows(fa, bn_kernels, cuda)
    err, ok, nums, part_s, lap_t, peak = {}, {}, {}, {}, [time.perf_counter()], {}
    t_phase = lap_t[0]
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def lap(name):
        now = time.perf_counter()
        part_s[name], lap_t[0] = now - lap_t[0], now
        if cuda:
            peak[name] = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()

    rng = np.random.default_rng(seed + 40)
    try:
        if "a" in parts:
            # (a) the train step on an MoE llama_1b cut to `layers` (fp32
            # params, bf16 compute), B1-B3 counted over the timed steps
            with Guarded("a_train", ok, err):
                cfg = dataclasses.replace(preset, num_layers=layers, remat=False,
                                          max_seq_len=max(preset.max_seq_len, c["seq"]))
                model = Llama(cfg, device=device, seed=seed)
                n_params = sum(p.numel() for p in model.parameters())
                tx = adamw(c["lr"], moment_dtype=torch.bfloat16)
                state = TrainState.create(dict(model.named_parameters()), tx)
                loss_fn = llama_loss_fn(model)
                step = build_train_step(lambda p, bt: loss_fn(p, bt["tokens"]), tx,
                                        device=device)
                batch = {"tokens": torch.randint(
                    0, cfg.vocab_size, (c["batch"], c["seq"] + 1), device=device,
                    generator=torch.Generator(device=device).manual_seed(seed))}
                inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
                with torch.no_grad():  # the step-0 loss in parts, one forward
                    logits0, aux0 = model(inputs, return_aux=True)
                    parts0 = float(cross_entropy_loss(logits0, targets)) + sum(
                        float(a.loss) for a in aux0)
                del logits0
                state, loss0 = step(state, batch)  # warm-up
                loss0 = loss0.item()
                losses = []
                with windows:
                    t0 = time.perf_counter()
                    for _ in range(c["steps"]):
                        state, loss = step(state, batch)
                        losses.append(loss)
                    sync_on(cuda)
                    step_ms = (time.perf_counter() - t0) * 1e3 / c["steps"]
                launches = dict(windows.total)
                losses = [loss0] + [x.item() for x in losses]
                with torch.no_grad():
                    _, auxes = model(inputs, return_aux=True)
                tokens = c["batch"] * c["seq"]
                tflop = moe_step_tflop(cfg, c["batch"], c["seq"])
                nums["a_train"] = {
                    "layers": cfg.num_layers, "n_params": n_params, "losses": losses,
                    "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
                    "step_tflop": tflop, "tflops_per_s": tflop / step_ms * 1e3,
                    "launches": launches,
                    "aux_loss_by_layer": [float(a.loss) for a in auxes],
                    "dropped_share_by_layer": [float(a.dropped.sum()) / a.assigned
                                               for a in auxes],
                    "capacity": math.ceil(tokens * c["top_k"] * 2.0 / c["experts"]),
                    "loss_parts_step0": parts0}
                if cuda:
                    nums["a_train"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
                ok["a_train"] = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                                 and all(launches[k] == tol["launches_per_step"] * c["steps"]
                                         for k in ("fwd", "dq", "dkv")))
                err["a_loss_parts"] = abs(loss0 - parts0)
                ok["a_loss_parts"] = err["a_loss_parts"] <= tol["loss_parts"]

                def run_step():
                    nonlocal state
                    state, _ = step(state, batch)

                if cuda:
                    prof = profile_steps(run_step, model="llama_1b_moe")
                    nums["a_train"]["profile"] = {
                        k: prof[k] for k in ("wall_ms_per_step", "device_busy_ms_per_step",
                                             "device_idle_share", "device_ms_by_kind",
                                             "weight_update_device_ms", "aten_calls_per_step")}
                del model, state, step, loss_fn, batch, inputs, targets, run_step
            with Guarded("a_loss_cpu", ok, err):
                err["a_loss_cpu"] = moe_loss_cpu_check(device, tol["loss_cpu"])
                ok["a_loss_cpu"] = err["a_loss_cpu"]["ok"]
            lap("a_train")

        if "b" in parts:
            # (b) one MoE block at full width, default and low capacity
            for name, cf in (("b_block", 2.0), ("b_block_low_cf", c["low_cf"])):
                with Guarded(name, ok, err):
                    err[name] = moe_block_check(device, c, preset.hidden_size,
                                                preset.intermediate_size, cf, seed + 7)
                    e_ = err[name]
                    ok[name] = (e_["kept_equal"] and e_["finite"]
                                and e_["max_abs_over_rms"] <= tol["block"]
                                and (e_["dropped_share"] > 0) == (cf < 1))
            lap("b_block")

        dec_model = None
        if "c" in parts:
            # (c) decode at full depth: greedy at batch 8 against a
            # teacher-forced forward in fp32 (where the two route alike,
            # which bf16 noise rarely allows, since one rounding step can
            # flip a near-tied expert choice) and in bf16; drops in both
            with Guarded("c_decode", ok, err):
                b, width, new = c["dec_batch"], c["dec_width"], c["dec_new"]
                lengths = rng.integers(c["dec_min"], width + 1, b)
                lengths[0], lengths[-1] = width, c["dec_min"]
                prompt = torch.zeros(b, width, dtype=torch.long)
                for i, n in enumerate(lengths):
                    prompt[i, :n] = torch.from_numpy(rng.integers(0, preset.vocab_size, n))
                prompt, lens = prompt.to(device), torch.from_numpy(lengths).to(device)
                res = {}
                for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                    cfg = dataclasses.replace(preset, num_layers=dec_layers, remat=False, dtype=dt)
                    dec_model = Llama(cfg, device=device, seed=seed).to(dt)
                    res[name] = moe_decode_check(dec_model, prompt, lens, new,
                                                 tol[f"logits_{name}"])
                    if name == "fp32":
                        del dec_model
                weight_bytes = sum(p.numel() * p.element_size() for p in dec_model.parameters())
                err["c_decode"] = {"layers": dec_layers, "lengths": lengths.tolist(), **res}
                f32 = res["fp32"]
                ok["c_decode"] = (
                    all(r["capture_equals_generate"] and r["finite"]
                        and r["max_abs_logits_held"] <= tol[f"logits_{n}"]
                        and r["confident_mismatches"] == 0 for n, r in res.items())
                    and f32["held_positions"] >= tol["fp32_held_share"] * f32["positions"])
                nl = dec_layers
                timing = {}
                for tb in ((1, b) if cuda else ()):
                    ms = decode_step_ms(dec_model, tb, c["time_prompt"], c["time_steps"],
                                        cfg.vocab_size, device)
                    slots = cfg.max_seq_len
                    kv = 2 * nl * tb * slots * cfg.num_kv_heads * cfg.head_dim * 2
                    # every expert's bank is read each step (C >= 1 slot an
                    # expert), the embedding only its B rows
                    step_w = (weight_bytes - dec_model.embed.numel() * 2
                              + tb * cfg.hidden_size * 2)
                    bound = (step_w + kv) / H100_BYTES_PER_S * 1e3
                    timing[f"b{tb}"] = {"step_ms": ms, "tokens_per_s": tb / ms * 1e3,
                                        "bytes_per_step": step_w + kv, "bound_ms": bound,
                                        "share_of_bound": bound / ms}
                nums["c_decode"] = {"weight_bytes": weight_bytes, "timing": timing}
            lap("c_decode")

        if "d" in parts:
            # (d) the continuous engine over the first eng_layers blocks of
            # (c)'s weights: one request alone, then 8 staggered requests
            with Guarded("d_engine", ok, err):
                cfg = dataclasses.replace(preset, num_layers=eng_layers, remat=False)
                eng_model = Llama(cfg, device=device, seed=seed).to(cfg.dtype)
                if dec_model is not None:
                    src = dict(dec_model.named_parameters())
                    adopt_params(eng_model, {n: src[n] for n, _ in eng_model.named_parameters()})
                del dec_model
                eng = ContinuousBatcher(eng_model, slots=c["eng_slots"],
                                        prompt_widths=c["eng_widths"],
                                        decode_block=c["eng_block"],
                                        pipeline_depth=c["eng_depth"])
                try:
                    alone = rng.integers(0, cfg.vocab_size, c["alone_len"]).tolist()
                    p1 = torch.tensor([alone], device=device)
                    ref_toks, ref_logits = greedy_capture(eng_model, p1, c["eng_new"])
                    s = eng.stream(tokens=alone, max_new_tokens=c["eng_new"],
                                   yield_logprobs=True)
                    list(s)
                    held = hold_to_reference(s.result, s.logprobs, ref_logits[0],
                                             ref_toks[0].tolist(), {"logits": tol["gap"]})
                    err["d_alone"] = {"equal": s.result == ref_toks[0].tolist(), **held}
                    ok["d_alone"] = held["confident_mismatches"] == 0
                    reqs = []
                    for _ in range(c["eng_requests"]):
                        n = int(rng.integers(c["eng_min"], c["eng_max"] + 1))
                        reqs.append({"tokens": rng.integers(0, cfg.vocab_size, n).tolist(),
                                     "max_new_tokens": c["eng_new"]})
                    with MoEDrops(eng_model) as eng_drops:
                        got, wall = drive_engine(eng, reqs, c["eng_threads"], c["eng_stagger"])
                    parted = []
                    for i, rq in enumerate(reqs):
                        want = generate(eng_model, torch.tensor([rq["tokens"]], device=device),
                                        c["eng_new"])[0].tolist()
                        toks_i = got[i][0]
                        parted.append(next((j for j in range(len(want))
                                            if j >= len(toks_i) or toks_i[j] != want[j]),
                                           len(want)))
                    err["d_engine"] = {
                        "layers": eng_layers, "requests": len(reqs), "completed": len(got),
                        "wall_s": wall, "parted_at_by_request": parted,
                        "equal_to_generate_alone": sum(p == c["eng_new"] for p in parted),
                        "dropped_share": eng_drops.share()}
                    ok["d_engine"] = len(got) == len(reqs) and all(
                        len(got[i][0]) == c["eng_new"] for i in range(len(reqs)))
                finally:
                    eng.close()
                del eng_model
            lap("d_engine")
    finally:
        if cuda:
            torch.cuda.empty_cache()

    nums["peak_mem_gb"] = peak or None
    nums["wall_s"] = time.perf_counter() - t_phase
    nums["part_s"] = part_s
    nums["nvidia_smi"] = nvidia_smi() if cuda else None
    emit({"phase": "moe", "part": "numbers", **nums})
    good = bool(ok) and all(ok.values())
    emit({"phase": "moe", "case": "moe_checks", "seed": seed, "layers": layers,
          "hidden": preset.hidden_size, "experts": c["experts"], "parts": parts, "checks": ok,
          "err": err, "tol": tol, "ok": good})
    if not good:
        raise SystemExit("moe phase failed: " + ", ".join(k for k, v in ok.items() if not v))
    return windows.total


SPEC = dict(batch=8, width=512, min_len=64, new=64, k=4, early_layers=2, draft_layers=2,
            accept_v=8, accept_draws=20000, time_prompt=128, time_new=32, temperature=0.8,
            server_rows=8)
# Limits of phase spec. "fp32_gap": in fp32 the speculative tokens equal
# plain greedy's; where a row parts from it anyway, plain greedy's top-2 gap
# there must be below this (fp32 rounding of a (B, k+1) verify against (B, 1)
# steps). "gap": in bf16 the first place a row parts from plain greedy must
# be one where plain greedy's top-2 gap is below phase serve's confident-token
# gap. "tv": the rejection rule's first emitted token against the target's p,
# total-variation distance over accept_draws draws (their sampling error at
# V=8 is ~0.01).
SPEC_TOL = dict(fp32_gap=1e-4, gap=SERVE_TOL["logits"], tv=0.02)


def spec_parted(toks, plain, plain_logits, gap):
    """Each row's first position where ``toks`` parts from ``plain`` (the
    row's length when never), and how many rows part at a position where
    plain's top-2 gap exceeds ``gap``."""
    diff = (toks != plain).cpu()
    gaps = top2_gap(plain_logits).cpu()
    parted, confident = [], 0
    for r in range(toks.shape[0]):
        at = diff[r].nonzero()
        p = int(at[0]) if len(at) else toks.shape[1]
        parted.append(p)
        confident += int(p < toks.shape[1] and bool(gaps[r, p] > gap))
    return parted, confident


def early_exit_draft(target, layers):
    """A LayerSkip-style draft: ``target``'s embedding, first ``layers``
    blocks, final norm and head, the same tensors (nothing copied)."""
    from tensorflowonspark_tpu_torch.models.llama import Llama, adopt_params

    cfg = dataclasses.replace(target.cfg, num_layers=layers)
    draft = Llama(cfg, device=target.device)
    own = dict(target.named_parameters())
    adopt_params(draft, {n: own[n] for n, _ in draft.named_parameters()})
    return draft


def phase_spec(fa, layers=16, rehearse=None, seed=0, parts="abc"):
    """Speculative decoding on the card (see the module docstring, phase
    16); raises SystemExit when a check fails. ``layers`` cuts the target's
    depth, ``parts`` picks the parts (chip_faults.py runs "a"); with
    ``rehearse={"device": "cpu", "tiny": True, "sizes": {...}}`` it runs at a
    tiny size on the CPU. Returns every kernel's launches on the phase's main
    path (none: decode runs no kernel of the port)."""
    from tensorflowonspark_tpu_torch.compute.checkpoint import save_checkpoint
    from tensorflowonspark_tpu_torch.models.llama import Llama, LlamaConfig, generate
    from tensorflowonspark_tpu_torch.models.speculative import (
        speculative_accept,
        speculative_generate,
    )
    from tensorflowonspark_tpu_torch.ops import bn_kernels
    from tensorflowonspark_tpu_torch.tools import generate_text, serve_model

    rehearse = rehearse or {}
    device = torch.device(rehearse.get("device", "cuda"))
    cuda = device.type == "cuda"
    c = {**SPEC, **rehearse.get("sizes", {})}
    if rehearse.get("tiny"):
        preset, model_flag = LlamaConfig.tiny(), "tiny"
    else:
        preset, model_flag = LlamaConfig.llama_1b(), "1b"
    tol = dict(SPEC_TOL)
    windows = LaunchWindows(fa, bn_kernels, cuda)
    err, ok, nums, part_s, lap_t = {}, {}, {}, {}, [time.perf_counter()]
    t_phase = lap_t[0]
    k, b, width, new = c["k"], c["batch"], c["width"], c["new"]

    def lap(name):
        now = time.perf_counter()
        part_s[name], lap_t[0] = now - lap_t[0], now

    rng = np.random.default_rng(seed + 50)
    lengths = rng.integers(c["min_len"], width + 1, b)
    lengths[0], lengths[-1] = width, c["min_len"]
    prompts = [rng.integers(0, preset.vocab_size, n).tolist() for n in lengths]
    prompt = torch.zeros(b, width, dtype=torch.long)
    for i, row in enumerate(prompts):
        prompt[i, :len(row)] = torch.tensor(row)
    prompt, lens = prompt.to(device), torch.from_numpy(lengths).to(device)
    tmp = tempfile.mkdtemp(prefix="tfos_spec_")
    models = {}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            name = "fp32" if dtype == torch.float32 else "bf16"
            cfg = dataclasses.replace(preset, num_layers=layers, remat=False, dtype=dtype)
            target = Llama(cfg, device=device, seed=seed).to(dtype)
            rand_cfg = dataclasses.replace(preset, num_layers=c["draft_layers"], remat=False,
                                           dtype=dtype)
            drafts = {"self": target, "early_exit": early_exit_draft(target, c["early_layers"]),
                      "random_2": Llama(rand_cfg, device=device, seed=seed + 1).to(dtype)}
            models[name] = (target, drafts)
        if "a" in parts:
            # (a) greedy, k drafts a verify, at batch 8 against plain greedy
            for name, (target, drafts) in models.items():
                with Guarded(f"a_greedy_{name}", ok, err), windows:
                    plain, plain_logits = greedy_capture(target, prompt, new, lens)
                    res = {}
                    for dname, draft in drafts.items():
                        st = {}
                        toks = speculative_generate(target, draft, prompt, new, k=k,
                                                    prompt_lengths=lens, stats=st)
                        parted, confident = spec_parted(
                            toks, plain, plain_logits,
                            tol["fp32_gap"] if name == "fp32" else tol["gap"])
                        res[dname] = {
                            "identical": bool(torch.equal(toks, plain)), "parted_at": parted,
                            "confident_partings": confident,
                            "accepted_per_verify": st["accepted"] / max(st["row_verifies"], 1),
                            "verifies": st["iterations"], "host_reads": st["host_reads"]}
                    err[f"a_greedy_{name}"] = res
                    ok[f"a_greedy_{name}"] = (
                        all(r["confident_partings"] == 0 for r in res.values())
                        and (name != "fp32" or res["self"]["accepted_per_verify"] == k))
                lap(f"a_greedy_{name}")
            # tokens/s at batch 1 and 8, bf16, each draft against plain generate
            target, drafts = models["bf16"]
            timing = {}
            for tb in ((1, b) if cuda else (b,)):
                p = torch.from_numpy(rng.integers(0, preset.vocab_size,
                                                  (tb, c["time_prompt"]))).to(device)
                row = {}
                tn = c["time_new"]
                generate(target, p, 4)  # warm-up
                sync_on(cuda)
                t0 = time.perf_counter()
                generate(target, p, tn)
                sync_on(cuda)
                row["plain"] = {"tokens_per_s": tb * tn / (time.perf_counter() - t0)}
                for dname, draft in drafts.items():
                    st = {}
                    sync_on(cuda)
                    t0 = time.perf_counter()
                    speculative_generate(target, draft, p, tn, k=k, stats=st)
                    sync_on(cuda)
                    row[dname] = {"tokens_per_s": tb * tn / (time.perf_counter() - t0),
                                  "accepted_per_verify": st["accepted"] / max(
                                      st["row_verifies"], 1),
                                  "host_reads": st["host_reads"]}
                timing[f"b{tb}"] = row
            nums["a_timing"] = timing
            lap("a_timing")

        if "b" in parts:
            # (b) the rejection rule on the card at V=8, then one sampled
            # decode through the early-exit draft
            with Guarded("b_accept", ok, err):
                v, n = c["accept_v"], c["accept_draws"]
                g = torch.Generator(device=device).manual_seed(seed + 9)
                pr = np.random.default_rng(seed + 9)
                p = torch.tensor(pr.dirichlet(np.ones(v), size=k + 1), dtype=torch.float32,
                                 device=device)
                q = torch.tensor(pr.dirichlet(np.ones(v), size=k), dtype=torch.float32,
                                 device=device)
                drafts_q = torch.stack([torch.multinomial(q[j], n, replacement=True,
                                                          generator=g) for j in range(k)], 1)
                first_tok, accepted = speculative_accept(g, p[None].expand(n, k + 1, v),
                                                         q[None].expand(n, k, v), drafts_q)
                freq = torch.bincount(first_tok[:, 0], minlength=v).double().cpu() / n
                tv = float(0.5 * (freq - p[0].double().cpu()).abs().sum())
                err["b_accept"] = {"tv": tv, "accepted_mean": float(accepted.float().mean())}
                ok["b_accept"] = tv <= tol["tv"]
            with Guarded("b_sampled", ok, err):
                target, drafts = models["bf16"]
                st = {}
                toks = speculative_generate(
                    target, drafts["early_exit"], prompt, new, k=k, prompt_lengths=lens,
                    temperature=c["temperature"],
                    generator=torch.Generator(device=device).manual_seed(seed + 11), stats=st)
                err["b_sampled"] = {"accepted_per_verify": st["accepted"] / max(
                    st["row_verifies"], 1), "verifies": st["iterations"]}
                ok["b_sampled"] = (tuple(toks.shape) == (b, new) and int(toks.min()) >= 0
                                   and int(toks.max()) < preset.vocab_size)
            lap("b_sampled")

        if "c" in parts:
            # (c) serve_model's fixed path with the random-2 draft saved, against
            # the CLI's generate_text on the same prompts
            with Guarded("c_server", ok, err):
                target, drafts = models["bf16"]
                models.pop("fp32", None)
                own = {n: t.detach() for n, t in target.named_parameters()}
                tdir = save_checkpoint(os.path.join(tmp, "target"), {"params": own})
                dparams = {n: t.detach() for n, t in drafts["random_2"].named_parameters()}
                ddir = save_checkpoint(os.path.join(tmp, "draft"), {"params": dparams})
                over = cli_overrides(target.cfg, preset)
                dover = json.dumps({"num_layers": c["draft_layers"]})
                rows = prompts[:c["server_rows"]]
                dev = None if cuda else "cpu"
                gen = dict(checkpoint=tdir, model=model_flag, config_overrides=over,
                           device=dev, width=width, batch_size=len(rows), max_new_tokens=new,
                           engine="fixed", draft_checkpoint=ddir, draft_model=model_flag,
                           draft_config_overrides=dover, spec_k=k)
                server = serve_model.make_server(None, port=0, gen=gen)
                th = threading.Thread(target=server.serve_forever, daemon=True)
                th.start()
                try:
                    url = f"http://127.0.0.1:{server.server_address[1]}"
                    code, text = http(url, "/generate", {"prompts": rows})
                finally:
                    server.shutdown()
                    server.server_close()
                    th.join(timeout=60)
                pfile, ofile = os.path.join(tmp, "p.jsonl"), os.path.join(tmp, "o.jsonl")
                with open(pfile, "w") as f:
                    f.writelines(json.dumps({"tokens": r}) + "\n" for r in rows)
                argv = ["--checkpoint", tdir, "--model", model_flag, "--config-overrides", over,
                        "--prompts", pfile, "--output", ofile, "--max-new-tokens", str(new),
                        "--batch-size", str(len(rows)), "--draft-checkpoint", ddir,
                        "--draft-model", model_flag, "--draft-config-overrides", dover,
                        "--spec-k", str(k)] + ([] if cuda else ["--device", "cpu"])
                rc = generate_text.main(argv)
                with open(ofile) as f:
                    cli = [json.loads(line)["tokens"] for line in f]
                got = json.loads(text)["completions"] if code == 200 else None
                try:
                    serve_model.main(["--llama-checkpoint", tdir, "--model", model_flag,
                                      "--config-overrides", over, "--gen-engine", "continuous",
                                      "--draft-checkpoint", ddir, "--port", "0"]
                                     + ([] if cuda else ["--device", "cpu"]))
                    refused = None
                except ValueError as e:
                    refused = str(e)
                err["c_server"] = {"generate": code, "cli_rc": rc, "equal_to_cli": got == cli,
                                   "continuous_refused": refused}
                ok["c_server"] = (code == 200 and rc == 0 and got == cli and refused is not None
                                  and "does not compose with --draft-checkpoint" in refused)
            lap("c_server")
    finally:
        models.clear()
        shutil.rmtree(tmp, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()

    nums["wall_s"] = time.perf_counter() - t_phase
    nums["part_s"] = part_s
    nums["launches"] = windows.total
    nums["nvidia_smi"] = nvidia_smi() if cuda else None
    emit({"phase": "spec", "part": "numbers", **nums})
    good = bool(ok) and all(ok.values())
    emit({"phase": "spec", "case": "spec_checks", "seed": seed, "layers": layers, "k": k,
          "parts": parts, "checks": ok, "err": err, "tol": tol, "ok": good})
    if not good:
        raise SystemExit("spec phase failed: " + ", ".join(k_ for k_, v in ok.items() if not v))
    return windows.total


FAMILIES = dict(bert_batch=32, bert_seq=512, bert_min_len=128, steps=3, lr=1e-4, mlm_batch=32,
                mlm_seq=128, vit_batch=64, unet_batch=16, unet_size=128, unet_lr=1e-3,
                example_wait_s=600,
                resnet_args=["--steps", "3", "--batch-size", "64"],
                mnist_args=["--num-records", "2048", "--batch-size", "256"],
                unet_args=["--steps", "3", "--batch-size", "8", "--size", "64"])
# Limits of phase families, the kernel route (flash attention) against the
# plain route (impl="xla") on the same weights and batch, in bf16: "loss",
# the relative gap of BERT-base's first loss; "grad", the Frobenius-relative
# gap of its gradients of layer_0's query and of the pooler; "logits", the
# rms of ViT-B/16's logits' gap over their own rms.
FAMILIES_TOL = dict(loss=1e-2, grad=5e-2, logits=2e-2)


def rel_gap(a, b) -> float:
    """||a - b|| / ||b|| in fp32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def family_steps(step, state, batch, steps, cuda, stats=None):
    """One warm-up and ``steps`` timed calls of a train step on one batch:
    (state, stats, losses of every call, ms per timed step)."""
    losses = []

    def once(state, stats):
        if stats is None:
            state, loss = step(state, batch)
        else:
            state, stats, loss = step(state, stats, batch)
        losses.append(loss)
        return state, stats

    state, stats = once(state, stats)
    sync_on(cuda)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, stats = once(state, stats)
    sync_on(cuda)
    ms = (time.perf_counter() - t0) / steps * 1e3
    return state, stats, [float(x) for x in losses], ms


def example_node(args, ctx):
    """A family example's ``main_fun`` (``args.example``, a module of
    ``tensorflowonspark_tpu_torch.examples``) on a node, with the kernels'
    launches of the node's run written to ``args.report``."""
    import importlib

    from tensorflowonspark_tpu_torch.ops import bn_kernels as bn
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    bn.reset_launches()
    importlib.import_module(f"tensorflowonspark_tpu_torch.examples.{args.example}").main_fun(
        args, ctx)
    if torch.cuda.is_available() and args.device is None:
        torch.cuda.synchronize()
    with open(args.report, "w") as f:
        json.dump({**fa.LAUNCHES, **bn.LAUNCHES}, f)


def node_line(out, marker):
    """The first ``node…:`` line of an example's output that holds ``marker``."""
    return next((x for x in out.splitlines() if x.startswith("node") and marker in x), None)


def phase_families(fa, bn, rehearse=None, seed=0, parts="abcd"):
    """The encoder and small-image families on the card (see the module
    docstring, phase 17); raises SystemExit when a check fails. ``parts``
    picks the parts; with ``rehearse={"device": "cpu", "tiny": True, "sizes":
    {...}}`` it runs the tiny configs on the CPU, where the kernel route is
    ``impl="flash"`` (the kernels' plain versions) and no kernel launches.
    Returns every kernel's launches on the phase's main path: BERT's train
    steps, ViT's flash forward and the ResNet example's node."""
    from tensorflowonspark_tpu_torch.cluster import tfcluster
    from tensorflowonspark_tpu_torch.cluster.tfcluster import InputMode
    from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step
    from tensorflowonspark_tpu_torch.compute.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.examples import mnist_spark, resnet_imagenet, unet_segmentation
    from tensorflowonspark_tpu_torch.models import bert, vit, zoo

    rehearse = rehearse or {}
    device = torch.device(rehearse.get("device", "cuda"))
    cuda = device.type == "cuda"
    tiny = bool(rehearse.get("tiny"))
    c = {**FAMILIES, **rehearse.get("sizes", {})}
    tol = dict(FAMILIES_TOL)
    route = "auto" if cuda else "flash"
    windows = LaunchWindows(fa, bn, cuda)
    err, ok, nums, part_s, lap_t = {}, {}, {}, {}, [time.perf_counter()]
    t_phase = lap_t[0]
    steps = c["steps"]

    def lap(name):
        now = time.perf_counter()
        part_s[name], lap_t[0] = now - lap_t[0], now

    def peak():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else None

    tmp = tempfile.mkdtemp(prefix="tfos_families_")
    try:
        if "a" in parts:
            # (a) BERT-base classification: ragged rows, the mask as segment ids
            with Guarded("a_bert", ok, err):
                cfg = (bert.BertConfig.tiny(dtype=torch.float32) if tiny
                       else bert.BertConfig.bert_base())
                b, s = c["bert_batch"], c["bert_seq"]
                rng = np.random.default_rng(seed + 60)
                lengths = rng.integers(c["bert_min_len"], s + 1, b)
                lengths[0] = s
                mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
                batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                                                    * mask).to(device),
                         "mask": torch.from_numpy(mask).to(device),
                         "label": torch.from_numpy(rng.integers(0, 2, b)).to(device)}
                models = {}
                for impl in (route, "xla"):
                    m = bert.BertForClassification(dataclasses.replace(cfg, attention_impl=impl),
                                                   device=device, seed=seed)
                    if models:
                        m.load_state_dict(next(iter(models.values())).state_dict())
                    models[impl] = m
                names = ("bert.layer_0.query.weight", "bert.pooler.weight")
                first = {}
                for impl, m in models.items():
                    params = dict(m.named_parameters())
                    loss = bert.classification_loss_fn(m)(params, batch)
                    grads = torch.autograd.grad(loss, [params[n] for n in names])
                    first[impl] = (float(loss.detach()), grads)
                gaps = {"loss": abs(first[route][0] - first["xla"][0]) / abs(first["xla"][0]),
                        **{n: rel_gap(g, gx) for n, g, gx in
                           zip(names, first[route][1], first["xla"][1])}}
                del first
                model = models.pop(route)
                models.clear()
                tx = adamw(c["lr"])
                state = TrainState.create(model.named_parameters(), tx)
                step = build_train_step(bert.classification_loss_fn(model), tx, device=device)
                with windows:
                    state, _, losses, ms = family_steps(step, state, batch, steps, cuda)
                launches = dict(windows.total)
                nums["a_bert"] = {"step_ms": ms, "tokens_per_s": b * s / ms * 1e3,
                                  "real_tokens_per_s": int(mask.sum()) / ms * 1e3,
                                  "launches": launches,
                                  "launches_per_step": {k: v / (steps + 1)
                                                        for k, v in launches.items()},
                                  "peak_mem_gb": peak()}
                err["a_bert"] = {"gaps": gaps, "losses": losses, "lengths": lengths.tolist()}
                kernel_ok = (all(launches[k] > 0 for k in ("fwd", "dq", "dkv")) if cuda
                             else all(v == 0 for v in launches.values()))
                ok["a_bert"] = (kernel_ok and gaps["loss"] <= tol["loss"]
                                and all(gaps[n] <= tol["grad"] for n in names)
                                and all(math.isfinite(x) for x in losses))
                del model, state, step
            lap("a_bert")
            with Guarded("a_mlm", ok, err):
                entry = zoo.build("bert_base", tiny=tiny, device=device, seed=seed)
                inp = entry.make_input(c["mlm_batch"])
                inp = {k: torch.from_numpy(v[:, :c["mlm_seq"]]).to(device) for k, v in inp.items()}
                tx = adamw(c["lr"])
                state = TrainState.create(entry.model.named_parameters(), tx)
                step = build_train_step(entry.make_loss(), tx, device=device)
                before = dict(windows.total)
                with windows:
                    state, _, losses, ms = family_steps(step, state, inp, steps, cuda)
                got = {k: windows.total[k] - before[k] for k in before}
                b, s = inp["tokens"].shape
                nums["a_mlm"] = {"step_ms": ms, "tokens_per_s": b * s / ms * 1e3,
                                 "launches": got, "seq": s}
                err["a_mlm"] = {"losses": losses}
                ok["a_mlm"] = (all(math.isfinite(x) for x in losses)
                               and (all(got[k] > 0 for k in ("fwd", "dq", "dkv")) if cuda
                                    else not any(got.values())))
                del entry, state, step
            lap("a_mlm")

        if "b" in parts:
            # (b) ViT-B/16: 3 steps under auto (the plain path at 197 tokens),
            # then one forward through the kernels against the plain route
            with Guarded("b_vit", ok, err):
                entry = zoo.build("vit_b16", tiny=tiny, device=device, seed=seed)
                model = entry.model
                batch = {k: torch.from_numpy(v).to(device)
                         for k, v in entry.make_input(c["vit_batch"]).items()}
                tx = adamw(c["lr"])
                state = TrainState.create(model.named_parameters(), tx)
                step = build_train_step(entry.make_loss(), tx, device=device)
                fa.reset_launches()
                state, _, losses, ms = family_steps(step, state, batch, steps, cuda)
                auto_launches = dict(fa.LAUNCHES)
                outs = {}
                for impl in ("flash", "xla"):
                    m = vit.ViT(dataclasses.replace(entry.config, attention_impl=impl),
                                device=device, seed=seed)
                    m.load_state_dict(model.state_dict())
                    before = dict(windows.total)
                    with torch.no_grad(), windows:
                        outs[impl] = m(batch["image"])
                    if impl == "flash":
                        fwd = {k: windows.total[k] - before[k] for k in before}
                    del m
                gap = rel_gap(outs["flash"], outs["xla"])
                nums["b_vit"] = {"step_ms": ms, "images_per_s": c["vit_batch"] / ms * 1e3,
                                 "tokens": (entry.config.image_size
                                            // entry.config.patch_size) ** 2 + 1,
                                 "auto_step_launches": auto_launches, "flash_fwd_launches": fwd,
                                 "peak_mem_gb": peak()}
                err["b_vit"] = {"logits_gap": gap, "losses": losses}
                ok["b_vit"] = (gap <= tol["logits"] and all(math.isfinite(x) for x in losses)
                               and (fwd["fwd"] > 0 if cuda else not any(fwd.values())))
                del entry, model, state, step, outs
            lap("b_vit")

        if "c" in parts:
            # (c) U-Net at its published widths, 3 steps on one batch
            with Guarded("c_unet", ok, err):
                entry = zoo.build("unet", tiny=tiny, num_classes=3, device=device, seed=seed)
                rng = np.random.default_rng(seed + 61)
                size, b = c["unet_size"], c["unet_batch"]
                batch = {"image": torch.from_numpy(rng.random((b, size, size, 3),
                                                              dtype=np.float32)).to(device),
                         "mask": torch.from_numpy(rng.integers(0, 3, (b, size, size))).to(device)}
                tx = adamw(c["unet_lr"], weight_decay=0.0)
                state = TrainState.create(entry.model.named_parameters(), tx)
                step = build_train_step(entry.make_loss(), tx, device=device)
                state, _, losses, ms = family_steps(step, state, batch, steps, cuda)
                nums["c_unet"] = {"step_ms": ms, "images_per_s": b / ms * 1e3,
                                  "features": list(entry.config.features),
                                  "bottleneck": entry.config.bottleneck_features,
                                  "size": size, "peak_mem_gb": peak()}
                err["c_unet"] = {"losses": losses}
                ok["c_unet"] = all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                del entry, state, step
            lap("c_unet")
        if cuda:
            torch.cuda.empty_cache()

        if "d" in parts:
            # (d) the three examples, each through tfcluster.run
            env = None if cuda else {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
            cpu = [] if cuda else ["--cpu"]
            small = ["--tiny"] if tiny else []
            wait = c["example_wait_s"]
            with Guarded("d_resnet", ok, err):
                args = resnet_imagenet.parse_args(c["resnet_args"] + small + cpu + [
                    "--model-dir", os.path.join(tmp, "resnet")])
                args.example, args.report = "resnet_imagenet", os.path.join(tmp, "resnet.json")

                def drive():
                    cluster = tfcluster.run(example_node, args, num_executors=1,
                                            input_mode=InputMode.TENSORFLOW, distributed=True,
                                            reservation_timeout=wait, env=env)
                    cluster.shutdown(timeout=wait)

                _, out, wall = captured(drive)
                with open(args.report) as f:
                    launches = json.load(f)
                for k in windows.total:
                    windows.total[k] += launches[k]
                line = node_line(out, "examples/sec")
                saved = CheckpointManager(os.path.join(tmp, "resnet")).all_steps()
                err["d_resnet"] = {"line": line, "launches": launches, "saved_steps": saved,
                                   "wall_s": wall}
                ok["d_resnet"] = (line is not None and "nan" not in line and bool(saved)
                                  and ((launches["pair"] > 0 and launches["cross"] > 0) if cuda
                                       else not any(launches.values())))
                if not ok["d_resnet"]:
                    err["d_resnet"]["output_tail"] = out[-3000:]
            lap("d_resnet")
            with Guarded("d_mnist", ok, err):
                args = mnist_spark.parse_args(c["mnist_args"] + cpu + [
                    "--model-dir", os.path.join(tmp, "mnist")])
                _, out, wall = captured(lambda: mnist_spark.run(args, 1, env=env,
                                                                reservation_timeout=wait))
                line = node_line(out, "final loss")
                want = f"{args.num_records // args.batch_size} steps,"
                exported = os.path.exists(os.path.join(tmp, "mnist", "tree.json"))
                err["d_mnist"] = {"line": line, "exported": exported, "wall_s": wall}
                ok["d_mnist"] = (line is not None and want in line and "nan" not in line
                                 and exported)
                if not ok["d_mnist"]:
                    err["d_mnist"]["output_tail"] = out[-3000:]
            lap("d_mnist")
            with Guarded("d_unet", ok, err):
                args = unet_segmentation.parse_args(c["unet_args"] + small + cpu + [
                    "--model-dir", os.path.join(tmp, "unet")])

                def drive():
                    cluster = tfcluster.run(unet_segmentation.main_fun, args, num_executors=1,
                                            input_mode=InputMode.TENSORFLOW,
                                            reservation_timeout=wait, env=env)
                    cluster.shutdown(timeout=wait)

                _, out, wall = captured(drive)
                line = node_line(out, "mIoU")
                exported = os.path.exists(os.path.join(tmp, "unet", "tree.json"))
                err["d_unet"] = {"line": line, "exported": exported, "wall_s": wall}
                ok["d_unet"] = line is not None and "nan" not in line and exported
                if not ok["d_unet"]:
                    err["d_unet"]["output_tail"] = out[-3000:]
            lap("d_unet")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()

    nums["wall_s"] = time.perf_counter() - t_phase
    nums["part_s"] = part_s
    nums["launches"] = windows.total
    nums["nvidia_smi"] = nvidia_smi() if cuda else None
    emit({"phase": "families", "part": "numbers", **nums})
    good = bool(ok) and all(ok.values())
    emit({"phase": "families", "case": "families_checks", "seed": seed, "parts": parts,
          "route": route, "checks": ok, "err": err, "tol": tol, "ok": good})
    if not good:
        raise SystemExit("families phase failed: "
                         + ", ".join(k_ for k_, v in ok.items() if not v))
    return windows.total


def decode_seeds(fa, seeds: list[int]) -> int:
    """Phase decode alone at each of ``seeds`` (weights and data), to read
    the spread of its checks against ``DECODE_TOL``: every seed's check
    line is printed; non-zero if any seed failed."""
    failed = []
    for seed in seeds:
        try:
            phase_decode(fa, seed=seed)
        except SystemExit:
            failed.append(seed)
        torch.cuda.empty_cache()
    emit({"phase": "decode", "seeds": seeds, "failed": failed})
    return 1 if failed else 0


def main(argv: list[str]) -> int:
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops import bn_kernels as bn
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    phase_s = {}

    def timed(name, fn, *args, **kw):
        """``fn(*args, **kw)``, its seconds kept under ``name``, the card's
        cache emptied after it."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    timed("device", phase_device, _build)
    if argv[:1] == ["--decode-seeds"]:
        return decode_seeds(fa, [int(x) for x in argv[1:]])
    rows = timed("kernels", phase_kernels, fa)
    launches, train_step_ms, train = timed("train", phase_train, fa)
    bn_rows = timed("bn_kernels", phase_bn_kernels, bn)
    timed("bn_layer", phase_bn_layer)
    bn_launches, conv_losses = timed("conv_train", phase_conv_train, bn)
    timed("cluster", phase_cluster, train_step_ms)
    # the node of phase mesh, phase elastic, the serving phases and parts
    # (c)-(e) of phase lora run at SERVING_DEPTH, which keeps the whole
    # script under its limit with the full-depth parts (PERF.md, Findings)
    mesh_flash, mesh_bn = timed("mesh", phase_mesh, fa, bn, ref={
        "train_losses": train["losses"], "train_step_ms": train_step_ms,
        "train_profile": train["profile"], "conv_losses": conv_losses},
        node_layers=SERVING_DEPTH)
    emit({"phase": "mesh", "wall_s": phase_s["mesh"]})
    elastic_flash, elastic_bn = timed("elastic", phase_elastic, layers=SERVING_DEPTH)
    emit({"phase": "elastic", "wall_s": phase_s["elastic"]})
    score = timed("decode", phase_decode, fa)
    serve = timed("serve", phase_serve, fa, layers=SERVING_DEPTH)
    fleet = timed("fleet", phase_fleet, fa, layers=SERVING_DEPTH)
    rollout = timed("rollout", phase_rollout, fa, layers=SERVING_DEPTH)
    moe = timed("moe", phase_moe, fa)
    lora = timed("lora", phase_lora, fa, train_step_ms=train_step_ms,
                 serve_layers=SERVING_DEPTH)
    spec = timed("spec", phase_spec, fa)
    families = timed("families", phase_families, fa, bn)
    emit({"phase": "script", "wall_s": time.perf_counter() - t_script, "phase_s": phase_s})
    counts = {"mesh": (mesh_flash, mesh_bn), "elastic": (elastic_flash, elastic_bn),
              "score": (score, score), "serve": (serve, serve), "fleet": (fleet, fleet),
              "rollout": (rollout, rollout), "moe": (moe, moe), "lora": (lora, lora),
              "spec": (spec, spec), "families": (families, families)}
    emit({"kernels": [
        {"name": f"flash_{kind}", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[kind], "launches": launches[kind],
         **{f"{p}_launches": flash[kind] for p, (flash, _) in counts.items()}, **rows[kind]}
        for kind in ("fwd", "dq", "dkv")
    ] + [
        {"name": f"bn_{kind}_stats", "route": "cuda", "source": BN_SOURCE,
         "replaces": REPLACES[kind], "launches": bn_launches[kind],
         **{f"{p}_launches": bnl[kind] for p, (_, bnl) in counts.items()}, **bn_rows[kind]}
        for kind in ("pair", "cross")
    ]})
    print(nvidia_smi(), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
