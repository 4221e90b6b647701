"""The port's serving fleet (``serving/fleet.py``, ``serving/router.py``)
against the JAX package's.

Both modules are copies, pinned to the originals. The router and
supervisor policies are held to the JAX package's tests of them on
scripted stub engines (placement, affinity, shedding, failover, the health
plane, respawn budgets, the merged metrics). On a tiny fp32 llama carried
over by ``models.convert``, a fleet of two port engines gives exactly the
JAX package's single engine's greedy tokens, with and without the prefix
L2, and ``serve_model --gen-replicas 2 --cachetier-l2`` serves them over
HTTP on the CPU.
"""

import contextlib
import difflib
import json
import re
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu.serving import engine as jengine
from tensorflowonspark_tpu_torch.cachetier import CacheServer, CacheTier
from tensorflowonspark_tpu_torch.compute.checkpoint import save_checkpoint
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models.convert import params_from_jax
from tensorflowonspark_tpu_torch.serving.engine import (
    ContinuousBatcher,
    EngineOverloaded,
    EngineWedged,
)
from tensorflowonspark_tpu_torch.serving.fleet import (
    DEAD,
    READY,
    FleetOverloaded,
    FleetUnavailable,
    ReplicaGone,
    ServingFleet,
)
from tensorflowonspark_tpu_torch.serving.router import FleetRouter
from tensorflowonspark_tpu_torch.tools import serve_model as tserve
from tensorflowonspark_tpu_torch.utils import failpoints

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "tensorflowonspark_tpu", ROOT / "tensorflowonspark_tpu_torch"
# copies whose only change is the import prefix, which also rewrites the
# two ``-m`` targets of the subprocess replicas (``tools.serve_model``) and
# of the cachetier daemon (``cachetier.service``) to the port's modules
COPIES = ["serving/fleet.py", "serving/router.py"]
HISTORY = [(r"\(the PR-\d+$", "(the node")]
WAIT_S = 30.0


def _rewritten(module: str) -> str:
    source = (REF / module).read_text()
    for pattern, replacement in HISTORY:
        source = re.sub(pattern, replacement, source, flags=re.M)
    return re.sub(r"\btensorflowonspark_tpu\.", "tensorflowonspark_tpu_torch.", source)


@pytest.mark.parametrize("module", COPIES)
def test_copy_matches_reference(module):
    ref = _rewritten(module).splitlines(keepends=True)
    port = (PORT / module).read_text().splitlines(keepends=True)
    hunks = [(i1 + 1, i2) for tag, i1, i2, _, _ in
             difflib.SequenceMatcher(a=ref, b=port, autojunk=False).get_opcodes()
             if tag != "equal"]
    assert hunks == []


def test_the_spawn_targets_are_the_ports():
    text = (PORT / "serving/fleet.py").read_text()
    assert '"tensorflowonspark_tpu_torch.tools.serve_model",' in text
    assert '"tensorflowonspark_tpu_torch.cachetier.service",' in text
    for pattern, _ in HISTORY:
        assert len(re.findall(pattern, (REF / "serving/fleet.py").read_text(), re.M)) == 1


@pytest.fixture(autouse=True)
def _no_failpoints():
    yield
    failpoints.disarm_all()


# -- scripted stub engines ----------------------------------------------------


class _StubMetrics:
    def render(self):
        return "# TYPE stub_up gauge\nstub_up 1\n"


class _StubStream:
    """Yields ``tokens``, raising ``error`` after ``error_after`` yields."""

    def __init__(self, tokens, error=None, error_after=0):
        self._tokens, self._error, self._error_after = list(tokens), error, error_after
        self._i = 0
        self.result = self.logprobs = None
        self.closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._error is not None and self._i >= self._error_after:
            raise self._error
        if self._i >= len(self._tokens):
            self.result = list(self._tokens)
            raise StopIteration
        self._i += 1
        return self._tokens[self._i - 1]

    def close(self):
        self.closed = True


class _StubEngine:
    """The router/fleet surface with injectable failures and health."""

    stream_error = None

    def __init__(self):
        self.live = self.ready = True
        self.submit_error = None
        self.stream_script = None
        self.stats_extra = {}
        self.closed = False
        self.calls = []
        self.metrics = _StubMetrics()

    def warmup(self):
        pass

    def health(self):
        return {"live": self.live, "ready": self.ready}

    def stats(self):
        return {"slots": 2, "slots_busy": 0, "queue_depth": 0, "watchdog_fires": 0,
                "admitted": len(self.calls), "completed": len(self.calls), **self.stats_extra}

    def unresolved(self):
        return 0

    def submit_many(self, prompts, max_new_tokens, **kw):
        self.calls.append(list(prompts))
        if self.submit_error is not None:
            raise self.submit_error
        return [[7] * min(int(max_new_tokens), 3) for _ in prompts]

    def stream(self, tokens, max_new_tokens, **kw):
        self.calls.append([list(tokens)])
        if self.stream_error is not None:
            raise self.stream_error
        if self.stream_script is not None:
            return self.stream_script()
        return _StubStream(list(range(min(int(max_new_tokens), 4))))

    def close(self, drain=False, drain_timeout=300.0):
        self.closed = True
        self.live = self.ready = False


def _stub_fleet(n=2, **kw):
    """(fleet, stubs): stubs are every engine built, respawns appended."""
    made = []

    def factory():
        made.append(_StubEngine())
        return made[-1]

    kw.setdefault("probe_interval", 0.1)
    kw.setdefault("warmup", False)
    kw.setdefault("respawn_backoff_s", 0.01)
    kw.setdefault("drain_timeout", 2.0)
    return ServingFleet(factory=factory, replicas=n, **kw), made


def _until(pred, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _wait_states(fleet, want, timeout=WAIT_S):
    assert _until(lambda: fleet.states() == want, timeout), fleet.states()


# -- construction, placement, affinity -----------------------------------------


def test_fleet_requires_exactly_one_replica_kind():
    with pytest.raises(ValueError, match="exactly one"):
        ServingFleet()
    with pytest.raises(ValueError, match="exactly one"):
        ServingFleet(factory=lambda: None, spawn_argv=["x"])
    with pytest.raises(ValueError, match="replicas"):
        ServingFleet(factory=lambda: None, replicas=0)


def test_placement_least_loaded_then_lowest_rid():
    fleet, _ = _stub_fleet(2)
    try:
        router = FleetRouter(fleet)
        assert router._place([1, 2], 0, None, set())["rid"] == 0
        assert router._place([3, 4], 0, None, set())["rid"] == 1  # 0 is loaded now
        router._resolve(0, "ok")
        router._resolve(1, "ok")
    finally:
        fleet.close()


def test_router_requests_route_and_resolve():
    fleet, stubs = _stub_fleet(2)
    try:
        router = FleetRouter(fleet)
        assert router.submit([1, 2, 3], 3) == [7, 7, 7]
        st = router.stats()
        assert st["router"]["outstanding"] == {} and st["fleet"]["ready"] == 2
        assert stubs[0].calls
    finally:
        fleet.close()


def test_prefix_affinity_routes_to_the_warm_replica():
    fleet, stubs = _stub_fleet(2)
    try:
        router = FleetRouter(fleet)
        base = [5, 6, 7, 8]
        router.submit(base, 2)
        warm = 0 if stubs[0].calls else 1
        with router._lock:
            router._outstanding[1 - warm] = 0
            router._outstanding[warm] = router._outstanding.get(warm, 0) + 3
        router.submit(base + [9, 10], 2)
        assert router.stats()["router"]["affinity_hits"] >= 1
        assert len(stubs[warm].calls) == 2 and not stubs[1 - warm].calls
        assert 'router_affinity_total{outcome="hit"}' in router.metrics_text()
    finally:
        fleet.close()


def test_affinity_is_adapter_bucketed():
    fleet, _ = _stub_fleet(2)
    try:
        router = FleetRouter(fleet)
        router.submit([5, 6, 7], 2, adapter=0)
        hits = router.stats()["router"]["affinity_hits"]
        router.submit([5, 6, 7], 2, adapter=0)
        assert router.stats()["router"]["affinity_hits"] == hits + 1
        router.submit([5, 6, 7, 8], 2, adapter=0)
        misses = router.stats()["router"]["affinity_misses"]
        router.submit([5, 6, 7, 8], 2, adapter=3)
        assert router.stats()["router"]["affinity_misses"] == misses + 1
    finally:
        fleet.close()


# -- shedding ---------------------------------------------------------------------


def test_deadline_admission_sheds_with_retry_after(tmp_path):
    from tensorflowonspark_tpu_torch.obs import flightrec

    rec = flightrec.install(str(tmp_path / "rec.json"), process="t")
    fleet, _ = _stub_fleet(2)
    try:
        router = FleetRouter(fleet, service_time_hint_s=10.0)
        with pytest.raises(FleetOverloaded) as ei:
            router.submit([1], 2, deadline_s=5.0)
        assert ei.value.retry_after >= 1.0
        assert router.stats()["router"]["shed"] == {"deadline": 1}
        assert router.submit([1], 2, deadline_s=30.0) == [7, 7]
        assert 'router_shed_total{reason="deadline"}' in router.metrics_text()
        assert "fleet_shed" in [e["kind"] for e in rec.snapshot("t")["events"]]
    finally:
        fleet.close()
        rec.stop()
        with flightrec._install_lock:
            flightrec._recorder = None


def test_deadline_admission_prefers_a_feasible_replica_over_affinity():
    fleet, stubs = _stub_fleet(2)
    try:
        router = FleetRouter(fleet, service_time_hint_s=1.0)
        base = [4, 4, 4]
        router.submit(base, 2)
        with router._lock:
            router._est_req_s.clear()
        stubs[0].stats_extra = {"queue_depth": 50, "slots": 1}
        fleet.probe_now()
        assert router.submit(base + [5], 2, deadline_s=3.0) == [7, 7]
        assert len(stubs[1].calls) == 1
    finally:
        fleet.close()


def test_queue_full_everywhere_sheds_fleet_overloaded():
    fleet, stubs = _stub_fleet(2)
    try:
        router = FleetRouter(fleet)
        for s in stubs:
            s.submit_error = EngineOverloaded("request queue full (1)")
        with pytest.raises(FleetOverloaded, match="queue"):
            router.submit([1], 2)
        assert router.stats()["router"]["shed"].get("queue_full") == 1
        assert fleet.states() == {0: READY, 1: READY}  # overload is not death
    finally:
        fleet.close()


def test_full_fleet_drain_sheds_503_class():
    fleet, _ = _stub_fleet(2)
    try:
        router = FleetRouter(fleet)
        fleet.begin_drain()
        with pytest.raises(FleetUnavailable):
            router.submit([1], 2)
        assert router.stats()["router"]["shed"] == {"drain": 1}
        assert router.health()["ready"] is False and router.health()["live"] is True
    finally:
        fleet.close()


# -- failover ---------------------------------------------------------------------


def test_submit_fails_over_once_from_a_wedged_replica():
    fleet, stubs = _stub_fleet(2)
    try:
        router = FleetRouter(fleet, ewma_alpha=1.0)
        stubs[0].submit_error = EngineWedged("no scheduler progress")
        assert router.submit([1, 2], 3) == [7, 7, 7]
        assert router.stats()["router"]["failovers"] == 1
        assert _until(lambda: len(stubs) == 3)  # a fresh engine behind seat 0
        _wait_states(fleet, {0: READY, 1: READY})
        assert stubs[0].closed
        text = router.metrics_text()
        assert "router_failover_total 1" in text
        assert 'fleet_respawns_total{outcome="ok"} 1' in text
    finally:
        fleet.close()


def test_submit_failover_is_once_then_terminal():
    fleet, stubs = _stub_fleet(2, respawn=False)
    try:
        router = FleetRouter(fleet)
        for s in stubs:
            s.submit_error = EngineWedged("wedged")
        with pytest.raises(EngineWedged):
            router.submit([1], 2)
        assert router.stats()["router"]["failovers"] == 1
    finally:
        fleet.close()


@pytest.mark.parametrize("path", ["submit", "stream"])
def test_dispatch_drop_fails_over_then_loud_terminal(path):
    """A dispatch lost in flight: one drop is absorbed by failover (a
    stream's before its first token too); dropping both attempts is a
    loud ReplicaGone, never a hang."""
    fleet, _ = _stub_fleet(2)
    try:
        router = FleetRouter(fleet)

        def call(p):
            return router.submit(p, 2) if path == "submit" else list(router.stream(p, 2))

        failpoints.arm("fleet.dispatch", "drop", count=1)
        assert call([1]) == ([7, 7] if path == "submit" else [0, 1])
        assert router.stats()["router"]["failovers"] == 1
        _wait_states(fleet, {0: READY, 1: READY})
        failpoints.arm("fleet.dispatch", "drop", count=2)
        with pytest.raises(ReplicaGone, match="dropped"):
            call([2])
    finally:
        fleet.close()


def test_stream_failover_before_the_first_token_and_midstream_terminal():
    fleet, stubs = _stub_fleet(2)
    try:
        router = FleetRouter(fleet)
        stubs[0].stream_script = lambda: _StubStream([], error=ReplicaGone("severed"))
        s = router.stream([1, 2], 3)
        assert list(s) == [0, 1, 2]
        assert router.stats()["router"]["failovers"] == 1
        _wait_states(fleet, {0: READY, 1: READY})
        for stub in stubs:
            if not stub.closed:
                stub.stream_script = lambda: _StubStream([9, 9], error=EngineWedged("wedged"),
                                                         error_after=2)
        got = []
        with pytest.raises(EngineWedged):
            for t in router.stream([3, 4], 5):
                got.append(t)
        assert got == [9, 9]
    finally:
        fleet.close()


def test_stream_close_cancels_and_resolves():
    fleet, _ = _stub_fleet(1)
    try:
        router = FleetRouter(fleet)
        s = router.stream([1], 4)
        next(s)
        s.close()
        assert router.stats()["router"]["outstanding"] == {}
        assert 'outcome="cancelled"' in router.metrics_text()
    finally:
        fleet.close()


def test_stream_open_retries_an_overloaded_replica_then_429_class():
    fleet, stubs = _stub_fleet(2)
    try:
        router = FleetRouter(fleet)
        stubs[0].stream_error = EngineOverloaded("request queue full")
        assert list(router.stream([1, 2], 3)) == [0, 1, 2]
        assert fleet.states() == {0: READY, 1: READY}
        stubs[1].stream_error = EngineOverloaded("request queue full")
        with pytest.raises(FleetOverloaded):
            router.stream([3, 4], 3)
        assert router.stats()["router"]["shed"].get("queue_full") == 1
    finally:
        fleet.close()


def test_stream_terminal_failover_does_not_double_resolve():
    fleet, stubs = _stub_fleet(1, respawn=False)
    try:
        router = FleetRouter(fleet)
        router._place([9, 9], 0, None, set())  # a concurrent request's outstanding
        stubs[0].stream_script = lambda: _StubStream([], error=ReplicaGone("severed"))
        s = router.stream([1, 2], 3)
        with pytest.raises(ReplicaGone):
            next(s)
        s.close()
        with router._lock:
            assert router._outstanding.get(0) == 1
        text = router.metrics_text()
        assert 'outcome="cancelled"' not in text and 'outcome="failover"' in text
    finally:
        fleet.close()


def test_http_stream_torn_line_is_replica_gone():
    from tensorflowonspark_tpu_torch.serving.fleet import _HTTPStream

    class _TornResp:
        def readline(self):
            return b'{"tok'

    class _NullConn:
        def close(self):
            pass

    s = object.__new__(_HTTPStream)
    s._rid, s._yield_logprobs, s._done = 7, False, False
    s.result = s.logprobs = None
    s._resp, s._conn = _TornResp(), _NullConn()
    with pytest.raises(ReplicaGone, match="severed mid-line"):
        next(s)
    assert s._done


# -- the health plane and supervision ---------------------------------------------


def test_probe_misses_flip_draining_and_respawn_gated_on_readiness():
    fleet, stubs = _stub_fleet(2, miss_limit=2)
    try:
        stubs[0].live = False
        fleet.probe_now()
        fleet.probe_now()
        assert _until(lambda: len(stubs) == 3)
        _wait_states(fleet, {0: READY, 1: READY})
        text = fleet.metrics.render()
        assert 'fleet_replica_state{replica="0",state="ready"} 1' in text
        assert 'fleet_probe_misses_total{replica="0"} 2' in text
    finally:
        fleet.close()


def test_watchdog_fire_delta_flips_draining():
    fleet, stubs = _stub_fleet(2)
    try:
        fleet.probe_now()
        stubs[1].stats_extra = {"watchdog_fires": 1}
        fleet.probe_now()
        assert _until(lambda: len(stubs) == 3)
        assert stubs[1].closed
        _wait_states(fleet, {0: READY, 1: READY})
        assert fleet.stats()["seats"]["1"]["respawns"] == 1
    finally:
        fleet.close()


def test_a_not_ready_replica_shows_in_fleet_health():
    fleet, stubs = _stub_fleet(2, miss_limit=100)
    try:
        stubs[0].ready = False
        fleet.probe_now()
        h = fleet.health()
        assert h["replicas"]["0"]["ready"] is False and h["ready"] is True
    finally:
        fleet.close()


def test_spawn_failpoint_exhausts_the_respawn_budget_to_dead():
    fleet, _ = _stub_fleet(2, max_respawns=2)
    try:
        router = FleetRouter(fleet)
        failpoints.arm("fleet.replica_spawn", "raise")
        fleet.report_failure(0, "test kill")
        assert _until(lambda: fleet.states()[0] == DEAD)
        assert fleet.stats()["seats"]["0"]["respawns"] == 2
        assert router.submit([1], 2) == [7, 7]
        text = fleet.metrics.render()
        assert 'fleet_replica_state{replica="0",state="dead"} 1' in text
        assert 'fleet_respawns_total{outcome="failed"}' in text
    finally:
        fleet.close()


def test_respawn_disabled_marks_dead_and_the_survivor_serves():
    fleet, stubs = _stub_fleet(2, respawn=False)
    try:
        router = FleetRouter(fleet)
        fleet.report_failure(0, "gone")
        assert _until(lambda: fleet.states()[0] == DEAD)
        assert router.submit([1], 2) == [7, 7] and len(stubs[1].calls) == 1
        fleet.report_failure(1, "gone too")
        assert _until(lambda: fleet.states()[1] == DEAD)
        with pytest.raises(FleetUnavailable):
            router.submit([2], 2)
    finally:
        fleet.close()


def test_replica_reset_drops_affinity_for_a_respawned_seat():
    fleet, _ = _stub_fleet(2)
    try:
        router = FleetRouter(fleet)
        router.submit([1, 2, 3], 2)
        assert len(router._affinity) == 1
        fleet.report_failure(0, "kill")
        _wait_states(fleet, {0: READY, 1: READY})
        assert _until(lambda: fleet.stats()["seats"]["0"]["respawns"] == 1)
        with router._lock:
            assert router._affinity.lookup([1, 2, 3, 4], 0) is None
    finally:
        fleet.close()


def test_respawn_budget_counts_consecutive_failures_not_successes():
    fleet, _ = _stub_fleet(2, max_respawns=2)
    try:
        for i in range(3):
            fleet.report_failure(0, f"incident {i}")
            assert _until(lambda: fleet.stats()["seats"]["0"]["respawns"] == i + 1)
            _wait_states(fleet, {0: READY, 1: READY})
        seat = fleet.stats()["seats"]["0"]
        assert seat["state"] == READY and seat["respawns"] == 3
    finally:
        fleet.close()


def test_stale_generation_failure_does_not_drain_a_respawned_seat():
    fleet, _ = _stub_fleet(2)
    try:
        fleet.report_failure(0, "first death")
        assert _until(lambda: fleet.stats()["seats"]["0"]["respawns"] == 1)
        _wait_states(fleet, {0: READY, 1: READY})
        fleet.report_failure(0, "stale verdict", generation=0)
        fleet.probe_now()
        assert fleet.states()[0] == READY
        assert fleet.stats()["seats"]["0"]["respawns"] == 1
    finally:
        fleet.close()


@pytest.mark.parametrize("misses", [1, 2])
def test_probe_misses_below_the_limit_neither_flap_health_nor_drain(misses):
    fleet, _ = _stub_fleet(1, miss_limit=3)
    try:
        fleet.probe_now()
        failpoints.arm("fleet.replica_probe", "raise", count=misses)
        for _ in range(misses):
            fleet.probe_now()
        assert fleet.stats()["seats"]["0"]["misses"] == misses
        h = fleet.health()
        assert h["live"] is True and h["ready"] is True
        fleet.probe_now()  # disarmed: a healthy probe resets the count
        assert fleet.stats()["seats"]["0"]["misses"] == 0 and fleet.states()[0] == READY
    finally:
        fleet.close()


def test_cold_start_all_failed_raises_the_root_cause():
    def bad_factory():
        raise RuntimeError("boom at spawn")

    with pytest.raises(RuntimeError, match="boom at spawn"):
        ServingFleet(factory=bad_factory, replicas=2, warmup=False, respawn=False,
                     probe_interval=0.1)


def test_cold_start_partial_failure_enters_respawn_without_wait():
    made = []

    def flaky_factory():
        made.append(_StubEngine())
        if len(made) == 1:
            raise RuntimeError("first spawn fails")
        return made[-1]

    fleet = ServingFleet(factory=flaky_factory, replicas=1, warmup=False, wait_ready=False,
                         probe_interval=0.1, respawn_backoff_s=0.01, drain_timeout=1.0)
    try:
        _wait_states(fleet, {0: READY})
        assert len(made) == 2
    finally:
        fleet.close()


def test_metrics_merge_relabels_per_replica():
    from tensorflowonspark_tpu_torch.obs.cluster import merge_families, parse_prometheus_text

    fleet, _ = _stub_fleet(2)
    try:
        router = FleetRouter(fleet)
        router.submit([1], 2)
        text = router.metrics_text()
        assert "# TYPE fleet_replica_state gauge" in text
        assert 'stub_up{replica="0"} 1' in text and 'stub_up{replica="1"} 1' in text
        parse_prometheus_text(text)
    finally:
        fleet.close()
    merged = merge_families({"0": parse_prometheus_text('# TYPE x gauge\nx{replica="inner"} 5\n')},
                            label="replica")
    assert 'exported_replica="inner"' in merged and 'replica="0"' in merged


# -- real engines on a tiny llama, against the JAX package's engine ----------------

BASE = dict(remat=False, max_seq_len=64)
ENG = dict(slots=2, prompt_widths=(8, 16), prefill_chunk=4, prefix_cache=4)
_rng = np.random.default_rng(5)
PROMPTS = [_rng.integers(1, 256, n).tolist() for n in (3, 7, 12, 5, 16, 9)]
NEW = 6


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(port model, port checkpoint dir, the JAX engine's greedy
    completions of PROMPTS)."""
    jm = jllama.Llama(jllama.LlamaConfig.tiny(**BASE, dtype=jnp.float32, attention_impl="xla"))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    jeng = jengine.ContinuousBatcher(jm, params, **ENG)
    try:
        want = jeng.submit_many(PROMPTS, NEW)
    finally:
        jeng.close()
    host = params_from_jax(jax.tree.map(np.asarray, params))
    m = tllama.Llama(tllama.LlamaConfig.tiny(**BASE, dtype=torch.float32, attention_impl="xla"),
                     device="cpu")
    m.load_state_dict(host)
    ckpt = save_checkpoint(str(tmp_path_factory.mktemp("fleet") / "ckpt"), {"params": host})
    return m, ckpt, want


@pytest.mark.parametrize("prefix_l2", [None, "inproc"])
def test_a_fleet_of_two_matches_the_jax_engine(tiny, prefix_l2):
    """Routing (and the L2) change where a request runs, never its tokens:
    concurrent requests through the router, a stream, and each replica
    called directly give exactly the JAX package's single engine's greedy
    completions."""
    model, _, want = tiny
    fleet = ServingFleet(factory=lambda: ContinuousBatcher(model, **ENG), replicas=2,
                         probe_interval=0.2, warmup=False, drain_timeout=5.0,
                         prefix_l2=prefix_l2)
    router = FleetRouter(fleet)
    try:
        got = {}

        def one(i):
            got[i] = router.submit(PROMPTS[i], NEW)

        ts = [threading.Thread(target=one, args=(i,)) for i in range(len(PROMPTS))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert [got.get(i) for i in range(len(PROMPTS))] == want
        s = router.stream(PROMPTS[1], NEW)
        assert list(s) == s.result == want[1]
        for v in fleet.views():  # each replica on its own, whatever the router chose
            rid = v["rid"]
            assert v["handle"].submit_many([PROMPTS[rid]], NEW) == [want[rid]]
    finally:
        router.close()


def test_the_l2_carries_a_prefix_across_replicas(tiny):
    """A prompt prefilled on replica 0 is an L2 hit on replica 1 for its
    extension, with exactly the JAX engine's tokens."""
    model, _, want = tiny
    fleet = ServingFleet(factory=lambda: ContinuousBatcher(model, **ENG), replicas=2,
                         probe_interval=0.2, warmup=False, drain_timeout=5.0,
                         prefix_l2="inproc")
    try:
        views = fleet.views()
        base = PROMPTS[4][:12]
        views[0]["handle"].submit_many([base], 2)
        assert _until(lambda: fleet.cache_stats()["fills"] >= 3)
        assert views[1]["handle"].submit_many([PROMPTS[4]], NEW) == [want[4]]
        assert views[1]["handle"].stats()["prefix_l2_hits"] == 1
        assert fleet.invalidate_prefix_version("v0") > 0
        assert fleet.cache_stats()["entries"] == 0
    finally:
        fleet.close()


def test_an_idle_engine_does_not_fire_its_watchdog(tiny):
    """Waiting for work is not a stall: an engine idle for longer than
    ``watchdog_s`` serves its next request without a watchdog fire (the
    JAX package's engine aborts it). The idle spell is the scheduler's
    progress stamp set back while it waits; the request's first decode
    dispatch is then held (failpoint) for longer than the watchdog's poll,
    within its limit."""
    model, _, want = tiny
    eng = ContinuousBatcher(model, slots=2, prompt_widths=(8, 16), watchdog_s=5.0)
    try:
        assert eng.submit(PROMPTS[0], NEW) == want[0]
        # the loop is parked on its queue once its stamp stops moving
        assert _until(lambda: time.monotonic() - eng._progress_ts > 0.2)
        eng._progress_ts -= 100.0
        failpoints.arm("engine.dispatch", "delay", delay_s=1.5, count=1)
        assert eng.submit(PROMPTS[2], NEW) == want[2]
        assert eng.stats()["watchdog_fires"] == 0
    finally:
        eng.close()


def _post(url, path, body):
    req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read().decode()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), dict(e.headers)


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@contextlib.contextmanager
def _serving(gen):
    server = tserve.make_server(None, port=0, gen=gen)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


def test_serve_model_with_two_replicas_and_the_cachetier_l2(tiny):
    """``--gen-replicas 2 --cachetier-l2`` in process on the CPU: the
    router answers /generate with the JAX engine's tokens, every engine
    offers to the daemon, /healthz and /readyz split, /metrics is the
    router's merged exposition with replica labels, a deadline it cannot
    meet sheds 429 with Retry-After, and a full drain sheds 503."""
    model, ckpt, want = tiny
    tier = CacheTier(capacity_bytes=1 << 26)
    daemon = CacheServer(tier).start()
    gen = dict(checkpoint=ckpt, model="tiny", config_overrides=json.dumps(
        {"remat": False, "dtype": "float32", "max_seq_len": 64}), device="cpu",
        engine="continuous", widths="8,16", width=16, batch_size=2, slots=2, max_new_tokens=NEW,
        decode_block=4, prefill_chunk=4, prefix_cache=4, replicas=2, probe_interval=0.2,
        cachetier_l2=daemon.address, cachetier_lookup_timeout_s=5.0)
    try:
        with _serving(gen) as (server, url):
            code, out, _ = _post(url, "/generate", {"prompts": PROMPTS[:3]})
            assert code == 200 and out["completions"] == want[:3]
            req = urllib.request.Request(url + "/generate", json.dumps(
                {"prompts": [PROMPTS[3]], "stream": True}).encode(),
                {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                lines = [json.loads(x) for x in r.read().decode().splitlines()]
            assert [x["token"] for x in lines[:-1]] == lines[-1]["completion"] == want[3]
            assert _until(lambda: tier.stats()["fills"] >= 1)
            code, h = _get(url, "/healthz")
            h = json.loads(h)
            assert code == 200 and h["live"] and sorted(h["replicas"]) == ["0", "1"]
            assert _get(url, "/readyz")[0] == 200
            code, text = _get(url, "/metrics")
            assert code == 200 and 'replica="0"' in text and 'replica="1"' in text
            assert "router_requests_total" in text
            assert json.loads(_get(url, "/stats")[1])["mode"] == "fleet"
            router = server.gen_engine
            router._service_time_hint = 60.0
            with router._lock:
                router._est_req_s.clear()
            code, body, hdr = _post(url, "/generate", {"prompts": [[1, 2]], "deadline_s": 1.0})
            assert code == 429 and body["error_type"] == "FleetOverloaded"
            assert int(hdr.get("Retry-After", "0")) >= 1
            router._service_time_hint = None
            router.begin_drain()
            assert _get(url, "/readyz")[0] == 503 and _get(url, "/healthz")[0] == 200
            code, body, _ = _post(url, "/generate", {"prompts": [[1]]})
            assert code == 503 and body["error_type"] == "FleetUnavailable"
    finally:
        daemon.close()


def test_cli_gen_replicas_needs_the_continuous_engine(tiny):
    _, ckpt, _ = tiny
    with pytest.raises(SystemExit):
        tserve.main(["--llama-checkpoint", ckpt, "--device", "cpu", "--gen-replicas", "2"])
