"""The port's node runtime against the JAX package's.

- Every module the port copies from the JAX package equals its original
  once the import prefix is rewritten (and the comment phrases that name
  the JAX package's change history are reworded, ``HISTORY``); the copies
  that change where the JAX package uses JAX differ only in the listed
  hunks.
- The port's ``wire`` decodes every file of ``tools/wirecheck_corpus/``.
- The JAX package's jax-free map_funs (``tests/cluster_fns.py``) run
  through the port's ``tfcluster.run`` (``train``, ``train_stream``,
  ``inference``, TENSORFLOW mode, the error ferry, a node crash) with the
  outputs that ``tests/test_tfcluster.py`` asserts for the JAX package's.
- A spawned port node loads neither jax nor the JAX package, and
  advertises no profiler server (not ported).
- The manager, ``DataFeed`` and ``DevicePrefetcher`` cases of
  ``tests/test_manager_datafeed.py`` and ``tests/test_prefetch.py`` hold
  for the port (the prefetcher on ``device="cpu"``), and
  ``synchronized_batch_stream`` stops two gloo nodes together when one is
  a batch short.

Everything is exact: sums, orders, counts and bytes (tolerance 0).
"""

import difflib
import json
import os
import pickle
import re
import secrets
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.cluster import manager, tfcluster, wire
from tensorflowonspark_tpu_torch.cluster.marker import EndOfFeed, EndPartition
from tensorflowonspark_tpu_torch.cluster.tfcluster import InputMode
from tensorflowonspark_tpu_torch.feed.columnar import decode_frame
from tensorflowonspark_tpu_torch.feed.datafeed import DataFeed
from tensorflowonspark_tpu_torch.feed.prefetch import DevicePrefetcher
from tensorflowonspark_tpu_torch.utils.util import cpu_only_env

from tests import cluster_fns, torch_cluster_fns

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "tensorflowonspark_tpu", ROOT / "tensorflowonspark_tpu_torch"
# CPU nodes share the host: one intra-op thread each, or the nodes' thread
# pools fight over the cores (a tiny step goes from ~0.1 s to seconds)
NODE_ENV = {**cpu_only_env(), "OMP_NUM_THREADS": "1"}

# copied with nothing but the import prefix (and HISTORY below) changed
VERBATIM = [
    "utils/util.py", "utils/failpoints.py", "utils/retry.py", "utils/batching.py",
    "utils/metrics.py", "obs/registry.py", "obs/flightrec.py", "obs/cluster.py",
    "cluster/wire.py", "cluster/marker.py", "feed/columnar.py",
    "cluster/reservation.py", "cluster/reservation_client.py", "cluster/launchers.py",
    "launcher.py", "cluster/node_main.py", "obs/reqtrace.py",
]
# copies changed where the JAX package uses JAX or reaches a module the
# port does not have: the (first, last) lines of the original that each
# differing hunk replaces (last = first - 1 for an insertion); every
# other line is the original's
PATCHED = {
    "obs/spans.py": [(39, 38), (72, 71), (76, 76), (78, 79)],
    "cluster/node.py": [(14, 13), (33, 33), (232, 231), (244, 243), (489, 493), (495, 513)],
    "cluster/tfcluster.py": [(16, 15), (37, 36), (335, 344), (864, 864), (934, 934), (986, 986),
                             (1066, 1066), (1193, 1196)],
    "feed/datafeed.py": [(13, 12), (585, 584), (586, 586), (589, 589), (596, 596), (614, 618)],
    # a stopped server's accepter parked instead of spinning on its closed
    # listener (test_stopped_manager_does_not_spin)
    "cluster/manager.py": [(97, 96), (98, 98), (101, 100)],
}


# comment phrases of the JAX package that name its own change history,
# reworded in the copies (each matches once over all the copied modules)
HISTORY = [
    (r"PR \d+ gave every process", "The obs package gave every process"),
    (r"PR \d+ made node death", "Heartbeats made node death"),
    (r"the glue the round-\d+ verdict", "the glue an earlier review"),
    (r"the PR-\d+ stable assignment", "the static stable assignment"),
    (r" forever \(PR-\d+\)\.", " forever."),
    (r"\(PR \d+'s plane was invisible to", "(the liveness plane was invisible to"),
    (r"PR-\d+ fallback", "stable-shard fallback"),
    (r"restart \(the PR-\d+ path\)", "restart (run_with_restarts)"),
    (r"falls back to PR-\d+ stable", "falls back to stable"),
    (r"\(the PR-\d+ pattern, applied to the", "(lint, gate and runtime checks, applied to the"),
    (r"the PR-\d+-era plane", "the earlier plane"),
    (r"was the round-\d+ trap", "was an early trap"),
    (r"trace proof \([A-Z]+ \d+\) gates", "trace proof gates"),
]


def _rewritten(module: str) -> str:
    source = (REF / module).read_text()
    for pattern, replacement in HISTORY:
        source = re.sub(pattern, replacement, source)
    return re.sub(r"\btensorflowonspark_tpu\.", "tensorflowonspark_tpu_torch.", source)


def test_history_phrases_each_match_once():
    sources = [(REF / m).read_text() for m in VERBATIM + list(PATCHED)]
    for pattern, _ in HISTORY:
        assert sum(len(re.findall(pattern, s)) for s in sources) == 1, pattern


@pytest.mark.parametrize("module", VERBATIM + list(PATCHED))
def test_copy_matches_reference(module):
    ref = _rewritten(module).splitlines(keepends=True)
    port = (PORT / module).read_text().splitlines(keepends=True)
    hunks = [(i1 + 1, i2) for tag, i1, i2, _, _ in
             difflib.SequenceMatcher(a=ref, b=port, autojunk=False).get_opcodes()
             if tag != "equal"]
    assert hunks == PATCHED.get(module, [])


CORPUS = sorted((ROOT / "tools" / "wirecheck_corpus").glob("*.bin"))


def test_corpus_is_there():
    assert len(CORPUS) >= 40


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.name)
def test_port_wire_decodes_the_corpus(path):
    """The port's codecs read every committed corpus file (the decode
    half of ``tools/wirecheck.py:decode_corpus``, on the port's wire)."""
    name = path.name.split("@")[0]
    blob = path.read_bytes()
    sc = wire.schema(name)
    if sc.get("transport") == "frame":
        assert decode_frame(blob).n > 0
        return
    if sc.get("transport") in ("pointer", "http"):
        instances = [json.loads(line) for line in blob.decode().splitlines() if line]
    else:
        instances = pickle.loads(blob)
    assert instances
    for inst in instances:
        wire.decode(name, inst)


# -- the JAX package's cluster cases, through the port's tfcluster.run --------


def _run(fn, args, n, mode=InputMode.SPARK, **kw):
    return tfcluster.run(fn, args, num_executors=n, input_mode=mode, reservation_timeout=120,
                         env=NODE_ENV, **kw)


def test_spark_mode_train_sum(tmp_path):
    cluster = _run(cluster_fns.sum_fn, {"out_dir": str(tmp_path)}, 2)
    partitions = [list((i,) for i in range(p * 25, (p + 1) * 25)) for p in range(4)]
    cluster.train(partitions)
    cluster.shutdown(timeout=120)
    pairs = [open(tmp_path / f"node{i}.txt").read().split() for i in range(2)]
    assert sum(int(c) for _, c in pairs) == 100
    assert sum(int(t) for t, _ in pairs) == sum(range(100))


def test_train_stream_micro_batches(tmp_path):
    """train_stream needs no module outside the port: micro-batches are fed
    on arrival, and an empty one is a no-op."""
    cluster = _run(cluster_fns.sum_fn, {"out_dir": str(tmp_path)}, 2)

    def stream():
        for mb in range(5):
            yield []
            yield [[(i,) for i in range(mb * 20, mb * 20 + 10)],
                   [(i,) for i in range(mb * 20 + 10, (mb + 1) * 20)]]

    cluster.train_stream(stream())
    cluster.shutdown(timeout=120)
    pairs = [open(tmp_path / f"node{i}.txt").read().split() for i in range(2)]
    assert sum(int(c) for _, c in pairs) == 100
    assert sum(int(t) for t, _ in pairs) == sum(range(100))


def test_spark_mode_inference_in_order():
    cluster = _run(cluster_fns.square_inference_fn, {}, 2)
    partitions = [[(i,) for i in range(p * 10, (p + 1) * 10)] for p in range(3)]
    results = cluster.inference(partitions)
    cluster.shutdown(timeout=120)
    assert results == [i**2 for i in range(30)]


def test_tensorflow_mode(tmp_path):
    data_file = tmp_path / "data.txt"
    data_file.write_text("\n".join(str(i) for i in range(50)) + "\n")
    cluster = _run(cluster_fns.file_reader_fn,
                   {"data_file": str(data_file), "out_dir": str(tmp_path)}, 2,
                   mode=InputMode.TENSORFLOW)
    with pytest.raises(RuntimeError):
        cluster.train([[1, 2]])  # feeding is a SPARK-mode operation
    cluster.shutdown(timeout=120)
    assert sum(int(open(tmp_path / f"node{i}.txt").read()) for i in range(2)) == sum(range(50))


def test_error_ferry():
    cluster = _run(cluster_fns.failing_fn, {}, 1)
    with pytest.raises(RuntimeError, match="intentional failure"):
        cluster.shutdown(timeout=120)


def test_node_crash_mid_feed():
    cluster = _run(cluster_fns.crashing_consumer_fn, {}, 1, queue_maxsize=2, use_shm_ring=False)
    with pytest.raises((TimeoutError, ConnectionError, EOFError, OSError)):
        cluster.train([[(i,) for i in range(4096)]], feed_timeout=10)
    with pytest.raises(RuntimeError, match="nonzero"):
        cluster.shutdown(timeout=10)


def test_spawned_node_is_jax_free(tmp_path):
    """...and starts no profiler server (not ported), so the roster
    advertises none, as when the JAX package's server is unavailable."""
    cluster = _run(torch_cluster_fns.modules_fn, {"out_dir": str(tmp_path)}, 1,
                   mode=InputMode.TENSORFLOW, profiler=True)
    urls = cluster.profiler_urls()
    cluster.shutdown(timeout=120)
    assert json.loads((tmp_path / "node0.json").read_text())["forbidden"] == []
    assert urls == {}


def test_synchronized_batch_stream_stops_gloo_nodes_together(tmp_path):
    """Node 0 is fed 5 batches, node 1 four: both stop after four."""
    batch = 4
    sizes = [3, 3, 2, 1]  # batches per partition; round robin: node 0 gets 3+2
    partitions, n = [], 0
    for k in sizes:
        partitions.append([(n + i,) for i in range(k * batch)])
        n += k * batch
    cluster = _run(torch_cluster_fns.sync_count_fn,
                   {"out_dir": str(tmp_path), "batch": batch, "device": "cpu"}, 2,
                   distributed=True)
    cluster.train(partitions, close_feed=True)
    cluster.shutdown(timeout=120)
    got = [json.loads((tmp_path / f"node{i}.json").read_text()) for i in range(2)]
    assert [g["batches"] for g in got] == [4, 4]
    assert all(g["backend"] == "gloo" and g["world"] == 2 for g in got)


def test_unported_branches_name_their_roadmap_item():
    # elastic membership is ported (tests/test_torch_elastic.py): run()
    # keeps the JAX package's two refusals of elastic=True
    with pytest.raises(ValueError, match="InputMode.TENSORFLOW"):
        tfcluster.run(cluster_fns.sum_fn, {}, num_executors=1, elastic=True)
    with pytest.raises(ValueError, match="heartbeat_interval"):
        tfcluster.run(cluster_fns.sum_fn, {}, num_executors=1, elastic=True,
                      input_mode=InputMode.TENSORFLOW, heartbeat_interval=0)
    # the device mesh is ported (tests/test_torch_mesh.py): a mesh and a
    # device together are refused
    with pytest.raises(ValueError, match="not both"):
        DevicePrefetcher([], mesh=types.SimpleNamespace(device_type="cpu"), device="cpu")


# -- manager and DataFeed (tests/test_manager_datafeed.py, on the port) -------


@pytest.fixture()
def mgr():
    h = manager.start(secrets.token_bytes(16), mode="local")
    yield h
    h.stop()


def test_stopped_manager_does_not_spin():
    """A connection attempt after stop() used to wake the accepter thread
    into multiprocessing's retry loop on a closed listener, 100 % CPU for
    the life of the process (the GIL it took slowed every later test of
    the process by orders of magnitude). The accepter's own CPU time is
    read from /proc, so other threads of the process do not count."""
    import socket
    import time

    before = set(threading.enumerate())
    h = manager.start(secrets.token_bytes(16), mode="local")
    accepters = [t for t in threading.enumerate()
                 if t not in before and "accepter" in t.name]
    assert len(accepters) == 1
    deadline = time.monotonic() + 5
    while accepters[0].native_id is None and time.monotonic() < deadline:
        time.sleep(0.01)  # the thread has not run yet
    stat = f"/proc/self/task/{accepters[0].native_id}/stat"

    def cpu_ticks():
        fields = open(stat).read().rsplit(")", 1)[1].split()
        return int(fields[11]) + int(fields[12])  # utime + stime

    h.stop()
    time.sleep(0.2)
    try:  # refused, or taken by the socket the blocked accept() still holds
        socket.create_connection(tuple(h.address), timeout=1).close()
    except OSError:
        pass
    time.sleep(0.3)
    t0 = cpu_ticks()
    time.sleep(1.0)
    assert cpu_ticks() - t0 < 10  # clock ticks (100 a second): the thread sleeps


def test_kv_and_queue_local_and_remote(mgr):
    mgr.set("state", "running")
    remote = manager.connect(mgr.address, mgr._authkey)
    assert str(remote.get("state")) == "running"
    remote.set("state", "terminating")
    assert str(mgr.get("state")) == "terminating"
    remote.get_queue("input").put([1, 2, 3])
    assert mgr.get_queue("input").get() == [1, 2, 3]


def test_datafeed_batches(mgr):
    q = mgr.get_queue("input")
    q.put([(i, i * 2) for i in range(10)])
    q.put(EndPartition())
    q.put([(10, 20), (11, 22)])
    q.put(EndOfFeed())
    feed = DataFeed(mgr)
    assert len(feed.next_batch(4)) == 4
    assert len(feed.next_batch(100)) == 6  # rest of the partition
    assert not feed.should_stop()
    assert len(feed.next_batch(100)) == 2
    assert feed.should_stop() and feed.next_batch(4) == []


@pytest.mark.parametrize("records", ["tuples", "dicts"])
def test_datafeed_input_mapping(mgr, records):
    rows = [(np.ones(4), 7), (np.zeros(4), 8)]
    if records == "dicts":
        rows = [{"image": x, "label": y} for x, y in rows]
    mgr.get_queue("input").put(rows)
    mgr.get_queue("input").put(EndOfFeed())
    batch = DataFeed(mgr, input_mapping={"image": "x", "label": "y"}).next_batch(2)
    assert set(batch) == {"x", "y"} and batch["x"].shape == (2, 4)
    assert batch["y"].tolist() == [7, 8]


def test_datafeed_dict_records_missing_field_raises(mgr):
    mgr.get_queue("input").put([{"pixels": np.ones(4), "label": 7}])
    mgr.get_queue("input").put(EndOfFeed())
    with pytest.raises(KeyError, match="image"):
        DataFeed(mgr, input_mapping={"image": "x", "label": "y"}).next_batch(1)


def test_datafeed_results_and_terminate(mgr):
    feed = DataFeed(mgr, train_mode=False)
    feed.batch_results([1, 2, 3])
    assert mgr.get_queue("output").get() == [1, 2, 3]
    q = mgr.get_queue("input")
    for _ in range(5):
        q.put([(0,)] * 10)
    q.put(EndOfFeed())
    feed.terminate()
    assert str(mgr.get("state")) == "terminating"
    assert feed.should_stop() and q.qsize() == 0


def test_producer_consumer_threads(mgr):
    total = 1000

    def produce():
        q = manager.connect(mgr.address, mgr._authkey).get_queue("input")
        for start in range(0, total, 100):
            q.put([(i,) for i in range(start, start + 100)])
        q.put(EndOfFeed())

    t = threading.Thread(target=produce)
    t.start()
    feed, seen = DataFeed(mgr), []
    while not feed.should_stop():
        seen.extend(feed.next_batch(64))
    t.join()
    assert [r[0] for r in seen] == list(range(total))


def test_batch_stream_buffers_across_partitions(mgr):
    q, n = mgr.get_queue("input"), 0
    for size in (7, 5, 6):
        q.put([(n + i,) for i in range(size)])
        n += size
        q.put(EndPartition())
    q.put(EndOfFeed())
    batches = list(DataFeed(mgr).batch_stream(4))
    assert [len(b) for b in batches] == [4, 4, 4, 4, 2]
    assert [r[0] for b in batches for r in b] == list(range(18))


def test_batch_stream_tail_trim_and_mapping(mgr):
    mgr.get_queue("input").put([(i, i * 10) for i in range(11)])
    mgr.get_queue("input").put(EndPartition())
    mgr.get_queue("input").put(EndOfFeed())
    feed = DataFeed(mgr, input_mapping={"a": "x", "b": "y"})
    batches = list(feed.batch_stream(8, multiple_of=4))
    assert len(batches) == 1
    np.testing.assert_array_equal(batches[0]["x"], np.arange(8))
    np.testing.assert_array_equal(batches[0]["y"], np.arange(8) * 10)


def test_synchronized_batch_stream_single_process(mgr):
    """Without a process group it is batch_stream, ``stop_when`` honoured."""
    mgr.get_queue("input").put([(i,) for i in range(12)])
    mgr.get_queue("input").put(EndOfFeed())
    seen = []
    for b in DataFeed(mgr).synchronized_batch_stream(4, stop_when=lambda: len(seen) == 2):
        seen.append(b)
    assert [[r[0] for r in b] for b in seen] == [[0, 1, 2, 3], [4, 5, 6, 7]]


# -- DevicePrefetcher (tests/test_prefetch.py, on device="cpu") ----------------


def test_prefetch_orders_and_moves():
    batches = [{"x": np.full((8, 4), i, np.float32), "y": np.arange(8) + i} for i in range(5)]
    out = list(DevicePrefetcher(iter(batches), depth=2, device="cpu"))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])
        np.testing.assert_array_equal(b["y"].numpy(), batches[i]["y"])


def test_prefetch_transform_override():
    assert list(DevicePrefetcher([1, 2, 3], transform=lambda b: b * 10, depth=1)) == [10, 20, 30]


def test_prefetch_producer_error_reraised():
    def gen():
        yield {"x": np.zeros((8, 2), np.float32)}
        raise TimeoutError("feed died")

    pf = DevicePrefetcher(gen(), device="cpu")
    next(pf)
    with pytest.raises(TimeoutError, match="feed died"):
        next(pf)


def test_prefetch_close_unblocks_producer():
    pf = DevicePrefetcher(({"x": np.zeros((8, 2), np.float32)} for _ in range(1000)), depth=1,
                          device="cpu")
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetch_from_feed_stages_and_copies(mgr):
    """Through the staging pool, every batch the consumer holds is its own
    copy: the slots are rewritten (depth 1, 3 slots) while the consumer
    keeps all ten batches, which still equal the feed's rows. Row-list
    batches pass through untouched, and the stats count both sides."""
    rows = [(np.full(5, i, np.int32), i) for i in range(40)]
    q = mgr.get_queue("input")
    q.put(rows)
    q.put(EndOfFeed())
    feed = DataFeed(mgr, input_mapping={"tok": "tokens", "lab": "label"})
    with DevicePrefetcher.from_feed(feed, 4, depth=1, device="cpu") as pf:
        got = list(pf)
        stats = pf.stats()
    assert len(got) == 10
    for k, b in enumerate(got):
        assert b["tokens"].dtype == torch.int32 and b["tokens"].shape == (4, 5)
        np.testing.assert_array_equal(b["tokens"][:, 0].numpy(), np.arange(4 * k, 4 * k + 4))
        np.testing.assert_array_equal(b["label"].numpy(), np.arange(4 * k, 4 * k + 4))
    assert stats["transferred"] == 10 and stats["delivered"] == 10
    assert stats["data_wait_s"] >= 0 and stats["depth"] == 1

    q.put([(i,) for i in range(6)])
    q.put(EndOfFeed())
    with DevicePrefetcher.from_feed(DataFeed(mgr), 3, device="cpu") as pf:
        assert [[r[0] for r in b] for b in pf] == [[0, 1, 2], [3, 4, 5]]
