"""Per-node context handed to the user's ``map_fun``.

Reference parity: ``tensorflowonspark/TFSparkNode.py:TFNodeContext``
(fields ``executor_id``/``worker_num``, ``job_name``, ``task_index``,
``cluster_spec``, ``num_workers``, ``defaultFS``, ``working_dir``, ``mgr``;
methods ``get_data_feed``, ``absolute_path``, ``start_cluster_server``,
``export_saved_model``).

TPU-native differences: instead of a TF ``ClusterSpec``/``TF_CONFIG``, the
context carries the ``jax.distributed`` coordinator address and exposes
:meth:`initialize_distributed` + :meth:`mesh` — the SPMD replacement for
both the PS and MultiWorkerMirroredStrategy wiring.

Port of :mod:`tensorflowonspark_tpu.cluster.context`. Changes from it:

- :meth:`initialize_distributed` joins a ``torch.distributed`` process
  group at the roster's coordinator (``tcp://host:port``, world size
  ``num_workers``, rank ``executor_id``): NCCL on the node's CUDA device,
  gloo when the node runs on the CPU. The device is the context's
  ``device`` (from :func:`device_of_args`: CUDA unless the node's args
  name another); :meth:`shutdown_distributed` leaves the group.
- :meth:`mesh` builds a ``DeviceMesh`` over the process group's ranks
  (``compute.mesh.make_mesh``) on the node's device type.
- :meth:`membership` and :meth:`reinitialize_distributed` raise
  ``NotImplementedError`` (elastic membership is ROADMAP A8b), as does
  :meth:`get_ingest_feed` (the pull plane is ROADMAP A12).
- :meth:`export_saved_model` writes the port's torch checkpoint.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any

from tensorflowonspark_tpu_torch.feed.datafeed import DataFeed

logger = logging.getLogger(__name__)


def device_of_args(tf_args: Any) -> str | None:
    """The device a node's args name: ``tf_args["device"]`` of a mapping,
    else its ``device`` attribute; ``None`` (CUDA) when they name none."""
    if isinstance(tf_args, dict):
        return tf_args.get("device")
    return getattr(tf_args, "device", None)


@dataclass
class TFNodeContext:
    executor_id: int
    job_name: str  # 'chief' | 'worker' | 'evaluator'
    task_index: int
    cluster_info: list[dict[str, Any]]
    num_workers: int
    default_fs: str
    working_dir: str
    mgr: Any = None  # ManagerHandle
    coordinator_address: str | None = None
    distributed: bool = False
    tb_port: int | None = None
    log_dir: str | None = None
    extras: dict[str, Any] = field(default_factory=dict)
    device: Any = None  # None: CUDA (see device_of_args)

    # --- reference-compat aliases -------------------------------------
    @property
    def worker_num(self) -> int:
        """Reference alias for executor_id."""
        return self.executor_id

    @property
    def num_processes(self) -> int:
        return self.num_workers

    @property
    def cluster_spec(self) -> dict[str, list[str]]:
        """TF_CONFIG-shaped view of the roster: {job: ["host:port", ...]}.

        Provided for reference-API compatibility; TPU code should use
        ``coordinator_address`` / ``mesh()`` instead.
        """
        spec: dict[str, list[str]] = {}
        for node in sorted(self.cluster_info, key=lambda n: n["executor_id"]):
            spec.setdefault(node["job_name"], []).append(
                f"{node['host']}:{node['port']}"
            )
        return spec

    # --- data plane ----------------------------------------------------
    def get_data_feed(
        self,
        train_mode: bool = True,
        qname_in: str = "input",
        qname_out: str = "output",
        input_mapping: dict[str, str] | None = None,
        feed_timeout: float | None = None,
    ) -> DataFeed:
        """Reference: ``TFNodeContext.get_data_feed``. ``feed_timeout``
        overrides the driver-published pull-loop policy (see
        ``DataFeed.feed_timeout``)."""
        return DataFeed(
            self.mgr,
            train_mode,
            qname_in,
            qname_out,
            input_mapping,
            feed_timeout=feed_timeout,
            worker_index=self.executor_id,
        )

    def get_ingest_feed(
        self,
        input_mapping: dict[str, str] | None = None,
        reader=None,
        timeout: float = 600.0,
        **kwargs,
    ):
        """The pull plane's feed (``InputMode.TENSORFLOW`` default):
        block for this node's driver-published shard plan
        (``TFCluster.assign_shards``) and return an
        :class:`~tensorflowonspark_tpu_torch.feed.ingest.IngestFeed` reading
        the shard executor-locally — same ``next_batch``/
        ``batch_stream``/``DevicePrefetcher.from_feed`` surface as
        :meth:`get_data_feed`, no driver in the data loop. ``reader``
        overrides manifest expansion (custom formats); extra kwargs
        reach the ``IngestFeed`` constructor (``records_per_chunk``,
        ``retry``, ``publish_blocks``, ``adopt_timeout``).

        Plans published by an elastic cluster carry ``handover: True``:
        the returned feed is then wired into the live-shard-
        redistribution protocol — it watches the membership epoch via
        the elastic watcher, publishes its replay cursor to the
        driver's durable table, and adopts driver re-splits on epoch
        bumps (docs/ROBUSTNESS.md "Live shard redistribution")."""
        raise NotImplementedError(
            "the pull plane (feed/ingest.py) is not ported yet: ROADMAP A12"
        )

    # --- paths ----------------------------------------------------------
    def absolute_path(self, path: str) -> str:
        """Resolve a user path against default_fs / working_dir.

        Reference: ``TFNode.py:hdfs_path`` resolution matrix — scheme-
        qualified paths pass through; absolute paths go under default_fs;
        relative paths resolve against the working dir.
        """
        from tensorflowonspark_tpu_torch.utils.util import resolve_path

        return resolve_path(path, self.default_fs, self.working_dir)

    # --- distributed runtime --------------------------------------------
    def initialize_distributed(self) -> None:
        """Join the ``torch.distributed`` process group of the cluster.

        The counterpart of the JAX package's ``jax.distributed.initialize``
        (and of the reference's ``TFNode.start_cluster_server``): the
        roster agreed through the reservation server names the
        coordinator (the chief's reserved port), where rank 0's TCP store
        listens. The backend follows the node's device: NCCL on CUDA
        (``cuda`` with no index takes ``executor_id`` modulo the visible
        devices), gloo on the CPU.
        """
        if not self.distributed:
            logger.info("single-process mode; skipping torch.distributed")
            return
        import torch
        import torch.distributed as dist

        from tensorflowonspark_tpu_torch import resolve_device

        device = resolve_device(self.device)
        if device.type == "cuda":
            if device.index is None:
                device = torch.device(
                    "cuda", self.executor_id % torch.cuda.device_count()
                )
            torch.cuda.set_device(device)
        self.device = device
        dist.init_process_group(
            backend="nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{self.coordinator_address}",
            world_size=self.num_workers,
            rank=self.executor_id,
        )
        logger.info(
            "torch.distributed initialized (%s): rank %d/%d, coordinator %s",
            dist.get_backend(),
            self.executor_id,
            self.num_workers,
            self.coordinator_address,
        )

    def shutdown_distributed(self) -> None:
        """Leave the process group, if this process joined one."""
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()

    # Reference-compat name.
    def start_cluster_server(self, *_args, **_kwargs) -> None:
        self.initialize_distributed()

    # --- elastic membership ----------------------------------------------
    def membership(self) -> tuple[int, list[dict[str, Any]]]:
        raise NotImplementedError("elastic membership is not ported yet: ROADMAP A8b")

    def reinitialize_distributed(
        self, roster: list[dict[str, Any]]
    ) -> None:
        raise NotImplementedError("elastic membership is not ported yet: ROADMAP A8b")

    def mesh(self, axis_shapes: dict[str, int] | None = None):
        """Build the device mesh for this cluster (every rank of the
        process group, on the node's device type).

        Delegates to :func:`tensorflowonspark_tpu_torch.compute.mesh.make_mesh`;
        defaults to pure data-parallel over every rank.
        """
        from tensorflowonspark_tpu_torch import resolve_device
        from tensorflowonspark_tpu_torch.compute.mesh import make_mesh

        return make_mesh(axis_shapes, device_type=resolve_device(self.device).type)

    def metrics_writer(self, log_dir: str | None = None):
        """Per-node step-metrics writer (SURVEY.md §5.5).

        Writes under ``{log_dir}/node{N}/`` so the chief's tensorboard
        (``run(tensorboard=True, log_dir=...)``) aggregates every node's
        scalars — the host-0-aggregator pattern. TB event files when
        TensorFlow is importable, JSONL otherwise (same API).
        """
        from tensorflowonspark_tpu_torch.utils.metrics import MetricsWriter

        base = log_dir or self.log_dir
        if base is None:
            raise ValueError(
                "no log_dir: pass one here or to TFCluster.run(log_dir=...)"
            )
        return MetricsWriter(
            f"{self.absolute_path(base).rstrip('/')}/node{self.executor_id}"
        )

    def export_saved_model(self, state, export_dir: str, **kwargs) -> str:
        """Chief-only model export (reference: ``TFNodeContext.export_saved_model``).

        Writes a checkpoint of the port's format (``compute/checkpoint.py``).
        """
        from tensorflowonspark_tpu_torch.compute.checkpoint import save_checkpoint

        if self.is_chief:
            return save_checkpoint(self.absolute_path(export_dir), state, **kwargs)
        return export_dir

    @property
    def is_chief(self) -> bool:
        """True on exactly one node: the 'chief' role, or worker:0 only in
        rosters that have no explicit chief (reference convention)."""
        if self.job_name == "chief":
            return True
        has_chief = any(n["job_name"] == "chief" for n in self.cluster_info)
        return (
            not has_chief
            and self.job_name == "worker"
            and self.task_index == 0
        )
