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
- The group meets at a ``TCPStore`` that the context keeps (the
  coordinator's node hosts it), under a prefix per membership epoch:
  :meth:`reinitialize_distributed` destroys the process group and joins a
  new one over the survivors, reusing the store while its host survives
  (a survivor cannot bind the port a second time) and starting one at the
  new coordinator otherwise. A rebuilt group has a finite timeout
  (``REBIND_TIMEOUT_S``), so a dead peer is an error, not a hang.
- :meth:`get_ingest_feed` raises ``NotImplementedError`` (the pull plane
  is ROADMAP A12).
- :meth:`export_saved_model` writes the port's torch checkpoint.
"""

from __future__ import annotations

import datetime
import logging
from dataclasses import dataclass, field
from typing import Any

from tensorflowonspark_tpu_torch.feed.datafeed import DataFeed

logger = logging.getLogger(__name__)

# Collective and store timeout of a group rebuilt by
# reinitialize_distributed: a peer that died during the rebind fails it
# within this many seconds instead of hanging it.
REBIND_TIMEOUT_S = 120.0


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
    # the TCPStore the process group meets at, and the coordinator
    # (host, port, pid) that hosts it
    _store: Any = field(default=None, repr=False)
    _store_host: Any = field(default=None, repr=False)

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
        host, port = self.coordinator_address.rsplit(":", 1)
        chief = next((n for n in self.cluster_info
                      if n.get("host") == host and str(n.get("port")) == port), {})
        self._join_group(self.executor_id, self.num_workers, (host, int(port), chief.get("pid")),
                         generation=0, timeout=dist.default_pg_timeout)
        logger.info(
            "torch.distributed initialized (%s): rank %d/%d, coordinator %s",
            dist.get_backend(),
            self.executor_id,
            self.num_workers,
            self.coordinator_address,
        )

    def _join_group(self, rank: int, world: int, coordinator: tuple, generation: int,
                    timeout: datetime.timedelta) -> None:
        """Join the default process group as ``rank`` of ``world`` at the
        store of ``coordinator`` (host, port, pid), under the prefix of
        ``generation``, with ``timeout`` for the group's collectives and the
        store's waits. The store is kept: a later rebind at a coordinator
        that is still the same process reuses it."""
        import torch.distributed as dist

        if self._store is None or self._store_host != coordinator:
            host, port, _pid = coordinator
            self._store = dist.TCPStore(host, port, is_master=rank == 0, timeout=timeout,
                                        wait_for_workers=False)
            self._store_host = coordinator
        # a store passed to init_process_group keeps its own timeout
        self._store.set_timeout(timeout)
        dist.init_process_group(
            backend="nccl" if self.device.type == "cuda" else "gloo",
            store=dist.PrefixStore(f"membership/{generation}", self._store),
            world_size=world,
            rank=rank,
            timeout=timeout,
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
        """(membership epoch, active roster) as last published by the
        driver (``compute/elastic.py`` watcher, fed by the heartbeater).
        Before any reconfigure: ``(0, cluster_info)`` — the startup
        barrier roster IS epoch 0."""
        from tensorflowonspark_tpu_torch.compute import elastic

        epoch, roster = elastic.membership()
        return epoch, (self.cluster_info if roster is None else roster)

    def reinitialize_distributed(
        self, roster: list[dict[str, Any]]
    ) -> None:
        """Rebind this process to a reconfigured cluster (elastic plane).

        Updates the context's roster bookkeeping (``cluster_info``,
        ``num_workers``, ``coordinator_address``) and — in
        multi-controller mode — leaves the old process group and joins
        a new one over the roster: the lowest surviving executor hosts
        the coordinator, and ranks are the roster order (a dense 0..n−1
        id space, which executor ids no longer are after a departure).
        The group meets under the current membership epoch's prefix, with
        a timeout of ``REBIND_TIMEOUT_S``; the sub-meshes cut from meshes
        of the old group are dropped (``compute.layout.dtensor_mesh``), so
        a mesh made after this call spans the new group.
        Single-controller-per-node runs (``distributed=False``) only
        update the bookkeeping — their local runtime never spanned the
        dead peer.
        """
        roster = sorted(roster, key=lambda n: n["executor_id"])
        if not roster:
            raise ValueError("cannot reconfigure to an empty roster")
        ids = [n["executor_id"] for n in roster]
        if self.executor_id not in ids:
            # A node the driver removed (false-positive death verdict,
            # voluntary leave) must not rebind as if it were a member —
            # and must get a clear diagnosis, not a StopIteration.
            raise RuntimeError(
                f"executor {self.executor_id} is not in the new "
                f"membership {ids}; this node was removed — rejoin via "
                "registration, do not reconfigure"
            )
        self.cluster_info = roster
        self.num_workers = len(roster)
        chief = roster[0]
        self.coordinator_address = f"{chief['host']}:{chief['port']}"
        if not self.distributed:
            return
        import torch.distributed as dist

        from tensorflowonspark_tpu_torch.compute import elastic, layout

        rank = ids.index(self.executor_id)
        if dist.is_initialized():
            dist.destroy_process_group()
        layout.drop_submeshes()
        self._join_group(rank, len(roster), (chief["host"], int(chief["port"]), chief.get("pid")),
                         generation=elastic.current_epoch(),
                         timeout=datetime.timedelta(seconds=REBIND_TIMEOUT_S))
        logger.info(
            "torch.distributed re-initialized (%s): rank %d/%d, coordinator %s",
            dist.get_backend(),
            rank,
            len(roster),
            self.coordinator_address,
        )

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
