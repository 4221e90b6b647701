"""PyTorch/CUDA port of :mod:`tensorflowonspark_tpu`, held to it as the reference.

What is ported:

- the Llama training step: ``models.llama`` → ``ops.attention`` →
  ``ops.flash_attention`` (hand-written CUDA kernels in ``csrc/``) →
  ``compute.optim`` → ``compute.train``;
- the BatchNorm conv nets (``models.resnet``, ``vgg``, ``inception``) over
  ``ops.batch_norm`` → ``ops.bn_kernels`` (CUDA statistics kernels);
- the node runtime: ``cluster.tfcluster.run`` launches nodes
  (``cluster.node``) that join a ``torch.distributed`` process group
  (``cluster.context``), pull batches through ``feed.datafeed.DataFeed``
  into ``feed.prefetch.DevicePrefetcher``, train, and checkpoint with
  ``compute.checkpoint``; ``examples.llama_fsdp`` drives it;
- training on a device mesh: ``compute.mesh`` and ``compute.layout``
  (the JAX package's placement tables as DTensor placements), ZeRO in
  ``compute.train``, the kernels on each rank's shard
  (``parallel.context``), sharded checkpoints;
- elastic membership: ``compute.elastic.ElasticTrainer`` (reshard in
  memory, hydrate from a peer's snapshot, checkpoint fallback) with
  ``cluster.context.reinitialize_distributed`` and ``tfcluster.run(
  elastic=True)``;
- KV-cache decode: ``models.llama`` ``init_cache`` / ``prefill`` /
  ``decode_step`` / ``generate``, sampling, scoring through the flash
  forward, and ``tools.generate_text``;
- serving: ``serving.engine.ContinuousBatcher`` (continuous batching with
  chunked prefill and a prefix cache) and ``tools.serve_model``'s HTTP
  server;
- the serving fleet: ``serving.fleet.ServingFleet`` (in-process or
  subprocess replicas, health probes, respawns) behind
  ``serving.router.FleetRouter`` (placement, shedding, failover), and the
  cache tier ``cachetier`` (store, TCP daemon, clients) with its
  fleet-global prefix L2 ``cachetier.prefix.PrefixL2``;
  ``serve_model --gen-replicas N --cachetier-l2 HOST:PORT`` serves them;
- weight rollout: ``serving.rollout.RolloutController`` and the
  publication channel, ``serve_model``'s ``/admin/reload``;
- LoRA and int8 weights: ``ops.lora`` (adapters fine-tuned with a frozen
  base through ``lora_optimizer``, merged, or served as a bank per
  request and rolled adapters-only) and ``ops.quant`` (int8 weight-only
  decode), consumed by ``models.llama``, the engine, the server, the
  decode CLI and the example;
- speculative decoding (``models.speculative``, through ``generate_text``
  and ``serve_model``'s fixed path) and MoE experts (``parallel.moe``, a
  routed-expert Llama that trains, decodes and serves).

What is not ported yet raises ``NotImplementedError`` naming its ROADMAP
item: sequence, pipeline and expert parallel (A10's parallel remainder),
and decode on a device mesh (A9b). Importing the package imports
nothing heavy and builds no kernel.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no CUDA device and no ``device`` given this raises: the
    port never moves to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
