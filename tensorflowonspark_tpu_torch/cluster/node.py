"""Node runtime — runs inside each cluster process.

Reference parity: ``tensorflowonspark/TFSparkNode.py`` (``_mapfn``: device
allocation → manager start → port reservation → reservation register →
roster barrier → TF_CONFIG → run ``map_fun``; plus ``_train``/
``_inference``/``_shutdown`` feeder-side partition functions).

Structural difference (deliberate): the reference ran inside borrowed Spark
tasks, so ``InputMode.SPARK`` had to fork the TF process into the background
to free the executor slot for later feed tasks. Our launcher owns the node
processes outright and the driver feeds queues over TCP, so ``map_fun``
always runs in the node process itself — one fewer process hop on the feed
path.

Port of :mod:`tensorflowonspark_tpu.cluster.node`. Changes from it: the
context carries the node's device from its args
(``context.device_of_args``), and a process group joined by
``initialize_distributed`` is left when ``map_fun`` returns; no
``jax.profiler`` server is started (ROADMAP A12). The shm feed ring is
not ported (``native/shmring.py`` reports it unavailable, ROADMAP A7), so
feeders take the TCP manager path.
"""

from __future__ import annotations

import logging
import os
import pickle
import queue as _queue
import socket
import threading
import time
import traceback
from typing import Any, Callable

import numpy as np

from tensorflowonspark_tpu_torch.cluster import manager as tf_manager
from tensorflowonspark_tpu_torch.cluster import reservation
from tensorflowonspark_tpu_torch.cluster import wire
from tensorflowonspark_tpu_torch.cluster.context import TFNodeContext, device_of_args
from tensorflowonspark_tpu_torch.cluster.marker import EndOfFeed, EndPartition
from tensorflowonspark_tpu_torch.utils import util
from tensorflowonspark_tpu_torch.utils.failpoints import failpoint
from tensorflowonspark_tpu_torch.utils.retry import RetryPolicy

logger = logging.getLogger(__name__)

# Chunk size for remote queue puts (records per proxied put).
FEED_CHUNK = 512

# Control-queue message asking the node process to exit.
STOP = "STOP"


def _assign_role(
    executor_id: int, cluster_template: dict[str, list[int]]
) -> tuple[str, int]:
    """Map an executor id to (job_name, task_index) per the role template.

    Reference: the role map built in ``TFCluster.py:run`` and consumed in
    ``TFSparkNode._mapfn``.
    """
    for job_name, ids in cluster_template.items():
        if executor_id in ids:
            return job_name, ids.index(executor_id)
    raise ValueError(f"executor {executor_id} not in cluster template")


def run_node(
    executor_id: int,
    map_fun: Callable[[Any, TFNodeContext], Any],
    tf_args: Any,
    cluster_meta: dict[str, Any],
) -> None:
    """Entry point of one node process (reference: ``TFSparkNode._mapfn``)."""
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s [node{executor_id}] %(levelname)s %(name)s: %(message)s",
    )
    # NOTE: unlike the reference, executor identity is launcher-assigned (the
    # arg above), not rediscovered from a cwd file — co-located local nodes
    # share a cwd, so the reference's write_executor_id pinning would
    # clobber itself here. util.write/read_executor_id remain for remote
    # launchers whose retries do land in a per-node working dir.

    failpoint("node.startup")

    # Cross-process trace context: the cluster id is the run's trace_id
    # (stamped into every SpanTracer export on this node), so driver-
    # and node-side spans of one run stitch into one timeline
    # (obs.cluster / tools/trace_merge.py).
    from tensorflowonspark_tpu_torch.obs import cluster as obs_cluster
    from tensorflowonspark_tpu_torch.obs import flightrec

    obs_cluster.set_trace_context(
        str(cluster_meta.get("trace_id") or cluster_meta.get("id", "")),
        node=f"node{executor_id}",
    )

    job_name, task_index = _assign_role(
        executor_id, cluster_meta["cluster_template"]
    )
    authkey = bytes.fromhex(cluster_meta["authkey"])

    # 1. data-plane manager (queues + KV), reachable by remote feeders
    mgr = tf_manager.start(
        authkey,
        queues=cluster_meta.get("queues") or tf_manager.DEFAULT_QUEUES,
        mode=cluster_meta.get("manager_mode", "remote"),
        maxsize=cluster_meta.get("queue_maxsize", tf_manager.DEFAULT_MAXSIZE),
    )

    # 1b. same-host feed fast path: a shared-memory ring that co-located
    #     feeders use instead of the TCP manager proxy (the reference's
    #     per-item pickle+socket put was its dominant feed overhead —
    #     SURVEY.md §3.2). A drain thread forwards ring records into the
    #     in-process queues so consumers (DataFeed) are oblivious.
    ring_name = None
    if cluster_meta.get("use_shm_ring", True):
        ring_name = _start_ring_drain(
            str(cluster_meta.get("id", "c")),
            executor_id,
            mgr,
            capacity=int(cluster_meta.get("shm_ring_mb", 64)) * 1024 * 1024,
        )

    # 2. reserve a port: the chief's becomes the jax.distributed coordinator
    #    address (replaces the reference's TF server port in TF_CONFIG)
    port = util.find_free_port()
    host = util.get_ip_address()

    # 3. optional tensorboard on chief (reference: _mapfn tensorboard spawn).
    #    The log dir resolves exactly like ctx.metrics_writer's, so the
    #    chief's TB aggregates what the nodes write.
    log_dir = cluster_meta.get("log_dir")
    if log_dir:
        log_dir = util.resolve_path(
            log_dir,
            cluster_meta.get("default_fs", ""),
            cluster_meta.get("working_dir", ""),
        )
    tb_port, tb_pid = None, 0
    if cluster_meta.get("tensorboard") and executor_id == 0:
        tb_port, tb_pid = _maybe_start_tensorboard(log_dir)

    # 3b. optional per-host jax.profiler trace server (SURVEY.md §5.1: the
    #     coordinator-knows-every-host's-profiler-URL pattern; the TPU
    #     equivalent of the reference's per-node tf.profiler endpoints).
    prof_port = None
    if cluster_meta.get("profiler"):
        prof_port = _maybe_start_profiler_server()

    # 3c. per-node Prometheus endpoint: GET /metrics renders the
    #     process-global obs registry (MetricsWriter mirrors, feed/train
    #     instrumentation) so a scraper — or a curl-ing operator — can
    #     read any node's counters without TensorBoard. Advertised in
    #     the reservation roster as metrics_port.
    metrics_port = None
    if cluster_meta.get("metrics", True):
        metrics_port = _maybe_start_metrics_server(host)

    # 3d. failure flight recorder: a rolling atomic snapshot of this
    #     process's recent spans/metrics/events on the heartbeat
    #     cadence, so even a SIGKILL (no goodbye possible) leaves the
    #     last interval at logs/flightrec-node<id>.json for the
    #     postmortem (obs.flightrec; docs/OBSERVABILITY.md).
    fr_dir = cluster_meta.get("flightrec_dir")
    if fr_dir:
        fr_dir = util.resolve_path(
            fr_dir,
            cluster_meta.get("default_fs", ""),
            cluster_meta.get("working_dir", ""),
        )
        rec = flightrec.install(
            os.path.join(fr_dir, f"flightrec-node{executor_id}.json"),
            process=f"node{executor_id}",
            interval=max(
                1.0, float(cluster_meta.get("heartbeat_interval", 2.0) or 2.0)
            ),
        )
        rec.note("node_start", executor_id=executor_id, host=host)
        rec.start()

    # 4. register + roster barrier
    client = reservation.Client(cluster_meta["server_addr"])
    client.register(
        {
            "executor_id": executor_id,
            "host": host,
            "port": port,
            "job_name": job_name,
            "task_index": task_index,
            "addr": list(mgr.address),
            "authkey": cluster_meta["authkey"],
            "tb_port": tb_port,
            "tb_pid": tb_pid,
            "prof_port": prof_port,
            "metrics_port": metrics_port,
            "pid": os.getpid(),
            "shm_ring": ring_name,
        }
    )
    # 4b. liveness plane: a background beat refreshes this node's
    #     last-seen stamp on the driver so a SIGKILL here is detected
    #     within the heartbeat grace, not a feed/shutdown timeout.
    #     Started BEFORE the roster barrier: a straggler can hold the
    #     barrier for minutes, and a node whose only stamp were its
    #     registration would look grace-expired the moment the barrier
    #     completed.
    hb_interval = float(cluster_meta.get("heartbeat_interval", 2.0) or 0)
    if hb_interval > 0:
        _start_heartbeater(
            cluster_meta["server_addr"], executor_id, hb_interval
        )

    cluster_info = client.await_reservations(
        timeout=cluster_meta.get("reservation_timeout", 600)
    )

    chief = next(
        n
        for n in cluster_info
        if n["job_name"] == "chief"
        or (n["job_name"] == "worker" and n["task_index"] == 0)
    )
    ctx = TFNodeContext(
        executor_id=executor_id,
        job_name=job_name,
        task_index=task_index,
        cluster_info=cluster_info,
        num_workers=cluster_meta["num_executors"],
        default_fs=cluster_meta.get("default_fs", ""),
        working_dir=cluster_meta.get("working_dir", os.getcwd()),
        mgr=mgr,
        coordinator_address=f"{chief['host']}:{chief['port']}",
        distributed=cluster_meta.get("distributed", False),
        tb_port=tb_port,
        log_dir=log_dir,
        device=device_of_args(tf_args),
    )
    # The handover protocol's cursor wire needs the reservation server
    # address (cursors must outlive this process — see
    # publish_ingest_cursor); ctx.get_ingest_feed wires it up.
    ctx.extras["server_addr"] = list(cluster_meta["server_addr"])

    # 5. run the user fn; ferry exceptions to the driver via the error queue
    #    (reference: the 'error' queue contract in TFSparkNode)
    try:
        if cluster_meta.get("auto_initialize_distributed", True):
            ctx.initialize_distributed()
        map_fun(tf_args, ctx)
        ctx.shutdown_distributed()
        publish_node_state(mgr, "finished")
    except Exception as map_err:
        tb = traceback.format_exc()
        logger.error("map_fun failed:\n%s", tb)
        flightrec.note("map_fun_error", error=repr(map_err))
        flightrec.dump_now("map_fun_error")
        publish_node_state(mgr, "error")
        try:
            mgr.get_queue("error").put(
                {"executor_id": executor_id, "traceback": tb}, timeout=10
            )
        except _queue.Full:
            pass
        _await_stop(mgr, timeout=cluster_meta.get("error_linger_secs", 60))
        raise
    # 6. linger until the driver collected results and posted STOP, so the
    #    output queue (which lives in this process) survives until drained
    _await_stop(mgr, timeout=cluster_meta.get("linger_secs", 1800))


def _start_heartbeater(
    server_addr, executor_id: int, interval: float
) -> threading.Thread:
    """Daemon thread beating HEARTBEAT every ``interval`` seconds.

    Deliberately fail-fast (no RPC retries): the beat IS the liveness
    signal, so a missed beat should age this node's last-seen stamp,
    not hide inside a backoff loop. Any error just skips the beat;
    the thread exits when the server acks with its stop flag set or
    becomes permanently unreachable after the cluster stops (process
    exit kills the daemon thread anyway).

    Elastic plane: the beat reply piggybacks the driver's membership
    epoch. When it moves, this thread refetches the active roster
    (``QEPOCH``) and publishes both to the process-local watcher
    (``compute.elastic.notify_membership``) — the training loop's
    ``ElasticTrainer.changed()`` flips within one beat of a
    reconfigure.
    """
    client = reservation.Client(
        server_addr, retry=RetryPolicy(max_attempts=1)
    )
    from tensorflowonspark_tpu_torch.obs import cluster as obs_cluster

    def note_epoch(reply: dict) -> int | None:
        epoch = reply.get("epoch")
        if epoch is None:
            return None
        epoch = int(epoch)
        try:
            info = client.membership()
            # Lazy: compute.elastic stays unimported on the (common)
            # epoch-0-forever path.
            from tensorflowonspark_tpu_torch.compute import elastic

            elastic.notify_membership(info["epoch"], info["roster"])
        except Exception as e:  # noqa: BLE001 - next beat retries
            logger.warning("membership refetch failed: %s", e)
            return None
        return epoch

    def beat() -> None:
        last_epoch = 0
        while True:
            try:
                t0 = time.time()
                reply = client.heartbeat(executor_id)
                t1 = time.time()
                # NTP-style clock sample off the beat we already pay
                # for: offset = driver wall clock minus the round-trip
                # midpoint; obs.cluster keeps the minimum-RTT sample
                # (tightest error bound) for trace alignment.
                server_unix = reply.get("server_unix")
                if server_unix is not None:
                    obs_cluster.note_clock_sync(
                        float(server_unix) - (t0 + t1) / 2.0, t1 - t0
                    )
                if int(reply.get("epoch") or 0) > last_epoch:
                    got = note_epoch(reply)
                    if got is not None:
                        last_epoch = got
                if reply.get("stop"):
                    return  # cluster kill: no point beating on
            except Exception as e:  # noqa: BLE001 - a missed beat is the signal
                logger.debug("heartbeat skipped: %s", e)
            time.sleep(interval)

    t = threading.Thread(target=beat, daemon=True, name="heartbeater")
    t.start()
    return t


def _await_stop(mgr, timeout: float) -> None:
    """Block until the driver posts STOP on the control queue (or timeout)."""
    control = mgr.get_queue("control")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            msg = control.get(block=True, timeout=1.0)
            control.task_done()
            if msg == STOP:
                return
        except _queue.Empty:
            continue
    logger.warning("node linger timeout (%ss) without STOP; exiting", timeout)


def _start_ring_drain(
    cluster_id: str, executor_id: int, mgr, capacity: int
) -> str | None:
    """Create this node's shm ring and start the drain thread.

    Ring records are either COLUMNAR FRAMES (``feed/columnar.py``; the
    drain decodes them into zero-copy column views over the ring memory
    — the refcounted frame keeps the slot alive until the batch is
    consumed or transferred) or pickled ``(qname, payload)`` tuples (the
    row-pickle fallback and all markers). Either way the drain forwards
    into the named in-process queue (bounded, so queue backpressure
    propagates to the ring and from there to the producer's ``push``
    timeout). Returns the ring name to advertise in the reservation
    roster, or None when native support is unavailable.
    """
    try:
        from tensorflowonspark_tpu_torch.native.shmring import ShmRing, available
    except Exception:  # pragma: no cover - import guard
        return None
    if not available():
        return None
    name = f"/tfos_{cluster_id[:12]}_{executor_id}"
    try:
        ring = ShmRing.create(name, capacity)
    except OSError as e:
        logger.warning("shm ring unavailable (%s); TCP feed only", e)
        return None
    # The segment must not outlive this node process even if no producer
    # ever attaches (close() is idempotent and unlinks as owner).
    import atexit

    atexit.register(ring.close)

    def drain() -> None:
        from tensorflowonspark_tpu_torch.feed import columnar

        try:
            data = chunk = None
            while True:
                # drop the previous frame's refs BEFORE blocking: a view
                # held across the wait would pin its ring slot and
                # deadlock a producer waiting for that space
                data = chunk = None
                try:
                    data = ring.pop_frame(timeout=1.0)
                except TimeoutError:
                    continue
                if data is None:  # producer closed and ring drained
                    return
                if columnar.is_frame(data):
                    if failpoint("columnar.frame") == "drop":
                        # chaos: frame lost mid-stream — the consumer's
                        # per-stream sequence check surfaces the gap
                        continue
                    chunk = columnar.decode_frame(data, path="shm")
                    zero_copy = isinstance(data, np.ndarray)
                    nbytes = data.nbytes if zero_copy else len(data)
                    data = None
                    if zero_copy and (
                        nbytes > ring.capacity // 4
                        or ring.outstanding_bytes() > ring.capacity // 2
                    ):
                        # liveness guard: a consumer assembling one
                        # batch pins the views of ALL its frames while
                        # blocking for the next, so pinned views nearing
                        # ring capacity (a batch bigger than the ring,
                        # or one unsplittable over-quarter frame) would
                        # starve the producer of push space forever.
                        # Copy out — releases the slot now; costs one
                        # memcpy only under backlog.
                        chunk = chunk.materialize()
                    mgr.get_queue(chunk.qname or "input").put(chunk)
                    continue
                qname, payload = pickle.loads(data)
                mgr.get_queue(qname).put(payload)
        except Exception:
            # Ferry the real error to the driver; dying silently would
            # surface as an opaque feed timeout on the producer side.
            tb = traceback.format_exc()
            logger.error("ring drain failed:\n%s", tb)
            try:
                mgr.get_queue("error").put(
                    {"executor_id": executor_id, "traceback": tb}, timeout=10
                )
            except _queue.Full:
                pass
        finally:
            ring.close()

    threading.Thread(target=drain, daemon=True, name="ring-drain").start()
    logger.info("shm ring %s ready (%d MiB)", name, capacity // (1024 * 1024))
    return name


# Producer-side cache: one ring handle per advertised name, shared by all
# driver threads so pushes are serialized by the handle's lock.
_ring_cache: dict[str, Any] = {}  # guarded-by: _ring_cache_lock
_ring_cache_lock = threading.Lock()


def _node_ring(node: dict[str, Any] | None):
    """Return an attached ShmRing for a co-located node, else None."""
    if not node or not node.get("shm_ring"):
        return None
    try:
        from tensorflowonspark_tpu_torch.native.shmring import ShmRing, available
    except Exception:  # pragma: no cover - import guard
        return None
    if not available() or node["host"] != util.get_ip_address():
        return None
    name = node["shm_ring"]
    with _ring_cache_lock:
        ring = _ring_cache.get(name)
        if ring is None:
            try:
                ring = ShmRing.open(name)
            except OSError:
                return None
            _ring_cache[name] = ring
        return ring


def _maybe_start_metrics_server(host: str) -> int | None:
    """Serve the process-global obs registry at ``GET /metrics``
    (Prometheus text format) on a free port; returns the port, or None
    when the server cannot bind. Runs in a daemon thread; the endpoint
    is read-only and allocation-free per scrape beyond the rendered
    text. This is what the driver's MetricsAggregator scrapes on the
    heartbeat cadence (``TFCluster.cluster_stats()``)."""
    from tensorflowonspark_tpu_torch.obs.cluster import serve_text
    from tensorflowonspark_tpu_torch.obs.registry import default_registry

    _server, port = serve_text(
        lambda: default_registry().render(), host=host
    )
    return port


def _maybe_start_profiler_server() -> int | None:
    """The JAX package starts a ``jax.profiler`` trace server here; the
    port has none yet (ROADMAP A12), so no port is advertised and
    :meth:`TFCluster.profiler_urls` is empty, as when the server is
    unavailable in the JAX package."""
    logger.warning("profiler server unavailable: not ported yet (ROADMAP A12)")
    return None


def _maybe_start_tensorboard(log_dir: str | None) -> tuple[int | None, int]:
    """Spawn a tensorboard subprocess if the binary exists (chief only).

    Reference: ``TFSparkNode._mapfn`` tensorboard block
    (``util.find_in_path`` + subprocess + record tb_port/tb_pid).
    """
    import subprocess

    tb_bin = util.find_in_path(os.environ.get("PATH", ""), "tensorboard")
    if tb_bin is None or not log_dir:
        return None, 0
    tb_port = util.find_free_port()
    try:
        proc = subprocess.Popen(
            [tb_bin, "--logdir", log_dir, "--port", str(tb_port), "--bind_all"],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        return tb_port, proc.pid
    except OSError:
        return None, 0


# ---------------------------------------------------------------------------
# Feeder-side partition functions (driver/feeder process side).
# Reference: TFSparkNode.train/_train, inference/_inference, shutdown/_shutdown.
# ---------------------------------------------------------------------------


def connect_manager(node: dict[str, Any]) -> tf_manager.ManagerHandle:
    """Reconnect to a node's long-lived manager (reference: ``_get_manager``)."""
    return tf_manager.connect(node["addr"], bytes.fromhex(node["authkey"]))


def publish_node_state(mgr: tf_manager.ManagerHandle, state: str) -> None:
    """Publish this node's lifecycle state to its manager KV (schema
    ``kv.node_state`` — a closed enum, so a typo'd state string dies at
    the producer instead of silently never matching a reader's
    comparison)."""
    mgr.set(wire.NODE_STATE_KEY, wire.encode("kv.node_state", value=state))


def fetch_node_state(mgr: tf_manager.ManagerHandle) -> str:
    """The node's current lifecycle state (``"running"`` when nothing
    was ever published — the manager seeds the key at startup)."""
    raw = mgr.get(wire.NODE_STATE_KEY)
    if raw is None:
        return "running"
    return wire.decode("kv.node_state", str(raw))["value"]


# Manager KV key carrying a node's pull-plane shard assignment
# (TFCluster.assign_shards publishes it; fetch_ingest_plan probes it).
# Declared in cluster/wire.py (schema ``kv.ingest_plan``); re-exported
# here because this module is the wire's producer/consumer home.
INGEST_PLAN_KEY = wire.INGEST_PLAN_KEY


def publish_ingest_plan(
    mgr: tf_manager.ManagerHandle,
    manifests,
    epoch: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
    plan_id: str | None = None,
    handover: bool = False,
    complete: bool = False,
    seq: int | None = None,
) -> None:
    """Driver side of the pull-plane handshake: publish one node's
    shard plan to its manager KV, keyed by the membership ``epoch``.
    THE owner of the plan's wire shape — `TFCluster._publish_ingest_plan`
    and the feed-plane bench's staggered mode both go through here, so
    the dict :func:`fetch_ingest_plan` returns cannot fork between
    producers. ``handover`` arms the consumer's live-redistribution
    protocol (``ctx.get_ingest_feed`` wires the watcher + cursor
    publisher); ``complete`` is the driver's end-of-dataset marker —
    lingering consumers stop instead of waiting for more work. ``seq``
    is the plan GENERATION within one membership epoch (the growing-
    dataset wire — ``TFCluster.extend_shards`` bumps it so a lingering
    consumer adopts appended shards without a membership bump)."""
    mgr.set(
        INGEST_PLAN_KEY,
        wire.encode(
            "kv.ingest_plan",
            epoch=int(epoch),
            plan_id=plan_id,
            shard_index=int(shard_index),
            num_shards=int(num_shards),
            manifests=list(manifests),
            handover=bool(handover),
            complete=bool(complete),
            seq=None if seq is None else int(seq),
        ),
    )


def fetch_ingest_plan(
    mgr: tf_manager.ManagerHandle,
    timeout: float = 600.0,
    poll: float = 0.25,
    min_epoch: int = 0,
) -> dict[str, Any]:
    """Node side of the pull plane's control handshake: block until the
    driver publishes this node's shard plan (``TFCluster.assign_shards``
    — a dict of manifests + epoch, O(files) bytes, the ONLY thing that
    crosses the driver on the pull plane) and return it.

    Probed rather than pushed: ``map_fun`` typically asks for its feed
    before the driver has planned shards, exactly like the feed-timeout
    KV. ``min_epoch`` is the handover protocol's adoption wait: plans
    stamped with an older membership epoch (the pre-reconfigure shard
    this consumer just drained) are skipped until the driver publishes
    the re-split. Raises TimeoutError after ``timeout`` seconds — an
    ingest consumer on a cluster whose driver never planned shards is a
    programming error that must not block forever.
    """
    failpoint("ingest.manifest_fetch")
    deadline = time.monotonic() + timeout
    while True:
        raw = mgr.get(INGEST_PLAN_KEY)
        if raw is not None:
            plan = wire.decode("kv.ingest_plan", raw)
            if plan["epoch"] >= int(min_epoch):
                return plan
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"no ingest plan (epoch >= {min_epoch}) published within "
                f"{timeout}s — did the driver call "
                "TFCluster.assign_shards()?"
            )
        time.sleep(poll)


# Manager KV key carrying driver-pushed feed knobs (autotune): the
# driver-side controller re-publishes tuned node-side knobs here;
# IngestFeed polls it at block boundaries and adopts by seq.
# Declared in cluster/wire.py (schema ``kv.feed_knobs``).
FEED_KNOBS_KEY = wire.FEED_KNOBS_KEY


def publish_feed_knobs(
    mgr: tf_manager.ManagerHandle,
    knobs: dict[str, Any],
    seq: int = 0,
) -> None:
    """Driver side of the feed-knob wire, beside
    :func:`publish_ingest_plan`: publish tuned node-side feed knobs
    (currently ``publish_blocks``) to one node's manager KV. ``seq``
    must be monotonically increasing per node — the consumer adopts a
    publication exactly once and ignores stale republishes, so a
    controller's revert is just the next publication."""
    mgr.set(
        FEED_KNOBS_KEY,
        wire.encode("kv.feed_knobs", seq=int(seq), knobs=dict(knobs)),
    )


def fetch_feed_knobs(
    mgr: tf_manager.ManagerHandle,
) -> dict[str, Any] | None:
    """Node side of the feed-knob wire: one non-blocking KV read —
    ``{"seq", "knobs"}`` or None when the driver never tuned anything.
    Unlike :func:`fetch_ingest_plan` this never probes: knobs are an
    optimization, not a dependency, so a feed with no publication just
    keeps its constructor values."""
    raw = mgr.get(FEED_KNOBS_KEY)
    if raw is None:
        return None
    pub = wire.decode("kv.feed_knobs", raw)
    return {
        "seq": int(pub["seq"]),
        "knobs": dict(pub["knobs"]),
    }


def publish_ingest_cursor(
    client: reservation.Client, executor_id: int, payload: dict[str, Any]
) -> None:
    """Node side of the handover protocol's cursor wire, beside
    :func:`publish_ingest_plan`: ship one consumer's replay cursor to
    the DRIVER-side table (``reservation.Server`` ``ICURSOR``) — the
    one store that survives this node being SIGKILLed, which is exactly
    what the crash-handover path seeds a redistribution from. Payload:
    ``{"epoch", "final", "cursor", "records_per_chunk",
    "frame_blocks"}`` (see ``IngestFeed._publish_cursor``)."""
    if failpoint("ingest.cursor_publish") == "drop":
        # chaos: a lost publication — the driver falls back to the
        # previous cursor; duplicates widen by the staleness, zero-gap
        # is untouched (the documented degradation)
        return
    client.publish_cursor(executor_id, payload)


def feed_partition(
    mgr: tf_manager.ManagerHandle,
    partition,
    feed_timeout: float = 600.0,
    qname: str = "input",
    chunk: int = FEED_CHUNK,
    node: dict[str, Any] | None = None,
    columnar: bool = True,
    stream: str | None = None,
) -> int | None:
    """Push one data partition into a node's input queue, chunked.

    Pass the node's roster entry via ``node`` to enable the shared-memory
    fast path when the feeder is co-located with the node; otherwise (or
    when native support is missing) chunks go through the TCP manager
    proxy. With ``columnar=True`` (the default) each chunk is columnized
    ONCE here — per-field contiguous buffers, CRC-framed
    (``feed/columnar.py``) — and ships as a single frame: scatter-pushed
    straight from numpy memory on the ring path, one bytes payload on the
    TCP path. Chunks that cannot columnize (ragged/object records) fall
    back to the versioned row-pickle wire, chunk by chunk. Returns the
    number of records fed, or ``None`` if the node is terminating and the
    partition was skipped (distinct from feeding an empty partition,
    which returns 0). Raises TimeoutError if the consumer stopped pulling
    (reference: "Timeout while feeding partition").

    ``stream`` names the columnar stream explicitly (default: a fresh
    random id per call, so independent partitions can never collide in
    the consumer's sequence tracking). An elastic RE-FEED of a
    partition a consumer partially consumed must pass the SAME stream
    id — and the same ``chunk`` size, so the frame boundaries line up —
    as the original feed: the consumer's replay cursor
    (``DataFeed.cursor``/``seed_cursor``) then recognizes the
    already-consumed prefix as duplicates and drops it, giving
    exactly-once consumption through the replay.
    """
    from tensorflowonspark_tpu_torch.feed import columnar as col
    from tensorflowonspark_tpu_torch.obs import spans as obs_spans

    if fetch_node_state(mgr) in ("terminating", "finished", "error"):
        # Early-stop path: consume and discard remaining partitions
        # (reference: the state check at the top of ``_train``; 'finished'
        # and 'error' additionally, since our map_fun may have already
        # returned — feeding a consumer-less queue would only fill it up).
        for _ in partition:
            pass
        return None
    ring = _node_ring(node)
    if ring is not None:

        def put(obj, _cap=ring.capacity):
            payload = pickle.dumps((qname, obj), protocol=pickle.HIGHEST_PROTOCOL)
            if len(payload) + 4 > _cap and isinstance(obj, list) and len(obj) > 1:
                # Chunk pickles bigger than the whole ring (huge records):
                # split recursively so the fast path keeps working. The TCP
                # path has no such limit, but mixing paths mid-partition
                # would break record ordering.
                mid = len(obj) // 2
                put(obj[:mid], _cap)
                put(obj[mid:], _cap)
                return
            ring.push(payload, timeout=feed_timeout)

    else:
        q = mgr.get_queue(qname)
        put = lambda obj: q.put(obj, timeout=feed_timeout)  # noqa: E731

    seq = 0
    if not columnar:
        stream = None
    elif stream is None:
        stream = os.urandom(8).hex()

    def put_columnar(ck, buf) -> None:
        """Ship one columnar chunk as frame ``seq`` of this partition's
        stream; recurses into halves when a frame outgrows a QUARTER of
        the ring. The quarter cap is a liveness requirement, not tuning:
        consumers hold zero-copy views of frame N while blocking for
        frame N+1, so a frame sized near the whole ring deadlocks the
        plane (producer waits on space only the consumer's next pull
        would free). At cap/4 several frames coexist in flight."""
        nonlocal seq
        if ring is not None:
            # crc=False: same-host shm — the ring's length framing +
            # always-verified header CRC cover truncation, and skipping
            # the payload checksum keeps both sides single-pass
            parts = col.encode_parts(
                ck, qname=qname, stream=stream, seq=seq, crc=False
            )
            if col.parts_nbytes(parts) + 4 > ring.capacity // 4 and len(buf) > 1:
                mid = len(buf) // 2
                put_columnar(ck.view(0, mid), buf[:mid])
                put_columnar(ck.view(mid, len(buf)), buf[mid:])
                return
            # stream/seq args mirror the frame header: the consumer's
            # feed.queue_get span carries the same pair, so
            # tools/trace_merge.py links producer->consumer per frame
            with obs_spans.span(
                "feed.send", stream=stream, seq=seq, path="shm"
            ):
                ring.push_parts(parts, timeout=feed_timeout)
        else:
            with obs_spans.span(
                "feed.send", stream=stream, seq=seq, path="tcp"
            ):
                put(
                    col.ColumnarFrame(
                        col.frame_bytes(
                            ck, qname=qname, stream=stream, seq=seq
                        )
                    )
                )
        seq += 1

    def send(buf: list) -> None:
        if columnar:
            with obs_spans.span(
                "feed.columnize", records=len(buf), stream=stream
            ):
                ck = col.columnize_records(buf)
            if ck is not None:
                put_columnar(ck, buf)
                return
            col.metrics()["fallback"].inc(reason="not_columnizable")
        put(buf)

    count = 0
    buf: list[Any] = []
    try:
        for item in partition:
            buf.append(item)
            if len(buf) >= chunk:
                send(buf)
                count += len(buf)
                buf = []
        if buf:
            send(buf)
            count += len(buf)
        put(EndPartition())
    except (_queue.Full, TimeoutError):
        raise TimeoutError(
            f"timeout while feeding partition (feed_timeout={feed_timeout}s); "
            "consumer appears to have stopped pulling"
        ) from None
    return count


def collect_results(
    mgr: tf_manager.ManagerHandle,
    count: int,
    timeout: float = 600.0,
    qname: str = "output",
) -> list[Any]:
    """Pull exactly ``count`` results off a node's output queue.

    Results arrive as chunks (lists) — the equal-count contract of the
    reference's ``_inference`` (one result per input record, in order).
    """
    out: list[Any] = []
    deadline = time.monotonic() + timeout
    q = mgr.get_queue(qname)
    while len(out) < count:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(
                f"timeout collecting inference results ({len(out)}/{count})"
            )
        try:
            item = q.get(block=True, timeout=min(remaining, 5.0))
        except _queue.Empty:
            # Fail fast if the consumer crashed instead of blocking for the
            # whole feed_timeout; the driver will surface its traceback
            # from the error queue.
            if fetch_node_state(mgr) == "error":
                raise RuntimeError(
                    "node entered error state while collecting results"
                ) from None
            continue
        q.task_done()
        if isinstance(item, list):
            out.extend(item)
        else:
            out.append(item)
    if len(out) > count:
        raise RuntimeError(
            f"inference produced {len(out)} results for {count} inputs; "
            "map_fun must emit exactly one result per record"
        )
    return out


def _push_end_of_feed(
    node: dict[str, Any],
    qnames,
    timeout: float,
    must_deliver: bool,
) -> None:
    """Push EndOfFeed markers behind any in-flight data (via the shm ring
    when this driver fed through it — the marker must not overtake records
    still in the ring), then close the ring's write side.

    ``must_deliver=True`` raises on a push timeout: a dropped marker means
    the consumer never sees end-of-stream and blocks forever.
    """
    with _ring_cache_lock:
        ring = _ring_cache.get(node.get("shm_ring") or "")
    for qname in qnames:
        try:
            if failpoint("node.close_feed") == "drop":
                # Chaos: simulate a lost end-of-feed marker — the
                # must_deliver contract below is exactly what a real
                # drop would violate, so surface it as the timeout.
                raise TimeoutError("failpoint dropped EndOfFeed")
            if ring is not None:
                ring.push(
                    pickle.dumps(
                        (qname, EndOfFeed()), protocol=pickle.HIGHEST_PROTOCOL
                    ),
                    timeout=timeout,
                )
            else:
                mgr = connect_manager(node)
                mgr.get_queue(qname).put(EndOfFeed(), timeout=timeout)
        except (_queue.Full, TimeoutError):
            if must_deliver:
                raise TimeoutError(
                    f"could not deliver EndOfFeed to node "
                    f"{node['executor_id']} queue {qname!r} within "
                    f"{timeout}s (consumer stopped pulling?)"
                ) from None
            logger.warning(
                "could not push EndOfFeed to node %s queue %s (full)",
                node["executor_id"],
                qname,
            )
    if ring is not None:
        ring.close_write()
        # Drop the producer handle: keeping it mapped would pin the (now
        # unlinked) segment's pages for the driver's whole lifetime.
        with _ring_cache_lock:
            _ring_cache.pop(node.get("shm_ring"), None)
        ring.close()


def close_feed(
    node: dict[str, Any], qname: str = "input", timeout: float = 600.0
) -> None:
    """Mark a node's feed complete: EndOfFeed behind any in-flight data,
    leaving the node *running* so it finishes consuming. Unlike
    :func:`shutdown_node` the state is untouched — the training loop sees
    a clean end-of-stream, not early termination. After this no more data
    may be fed to ``qname`` (the shm ring's write side is closed).

    This is what lets multi-controller SPARK-mode workers use
    ``DataFeed.synchronized_batch_stream``: feeds must actually END for
    the all-hosts exhaustion agreement to trigger (a merely-quiet feed
    blocks in the queue, never reaching the agreement). Raises
    TimeoutError if the marker cannot be delivered — a silently dropped
    marker would hang every process in that agreement.
    """
    _push_end_of_feed(node, (qname,), timeout=timeout, must_deliver=True)


def shutdown_node(node: dict[str, Any], queues=("input",)) -> None:
    """Signal one node to finish: EndOfFeed on data queues, STOP on control.

    Reference: ``TFSparkNode._shutdown`` (set state, push terminal markers).
    """
    mgr = connect_manager(node)
    state = fetch_node_state(mgr)
    if state == "running":
        publish_node_state(mgr, "terminating")
    # Best-effort markers: the 'terminating' state already makes the node
    # drain, so a full queue here is a warning, not a hang.
    _push_end_of_feed(node, queues, timeout=30, must_deliver=False)
    mgr.get_queue("control").put(STOP)


def drain_errors(node: dict[str, Any]) -> list[dict[str, Any]]:
    """Non-blocking read of a node's error queue (exception ferry)."""
    mgr = connect_manager(node)
    errors = []
    q = mgr.get_queue("error")
    while True:
        try:
            errors.append(q.get_nowait())
            q.task_done()
        except _queue.Empty:
            return errors


def _hostname() -> str:  # pragma: no cover - trivial
    return socket.gethostname()
