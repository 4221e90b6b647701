"""The port's cache tier (``tensorflowonspark_tpu_torch.cachetier``) against
the JAX package's.

``frames.py``, ``service.py`` and ``__init__.py`` are copies, pinned to the
originals with their hunks listed; ``prefix.py`` is rewritten for torch
tensors (bf16 has no numpy dtype; the filler orders its device→host copy
after an event). The store, the TCP transport and the PrefixL2 facade are
held to the JAX package's tests of the same behaviour. The close race of
the JAX package's ``CacheServer`` is fixed in the port: every lookup after
``close()`` misses, and ``close()`` shuts the server's open connections.
On a tiny fp32 llama carried over by ``models.convert``, an L2 hit gives
exactly the tokens of a miss and of the JAX package's engine.
"""

import difflib
import re
import socket
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu.serving import engine as jengine
from tensorflowonspark_tpu_torch.cachetier import (
    CacheClient,
    CacheServer,
    CacheTier,
    FrameCache,
    LocalClient,
    PrefixL2,
)
from tensorflowonspark_tpu_torch.cachetier.prefix import (
    NS,
    decode_leaves,
    encode_leaves,
    prefix_key,
    version_prefix,
)
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models.convert import params_from_jax
from tensorflowonspark_tpu_torch.serving import ContinuousBatcher, FleetRouter, ServingFleet
from tensorflowonspark_tpu_torch.utils import failpoints

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "tensorflowonspark_tpu", ROOT / "tensorflowonspark_tpu_torch"
# copies whose only change is the import prefix
VERBATIM = ["cachetier/frames.py", "cachetier/__init__.py"]
# the (first, last) lines of the original that each differing hunk
# replaces (last = first - 1 for an insertion); every other line is the
# original's
PATCHED = {
    # the docstring's history phrase and its note of the fixes; the
    # server's set of open connections, registered at accept and dropped
    # when served out, shut down by close() (the close race); a client
    # reconnects once when the server dropped its idle connection
    "cachetier/service.py": [(35, 34), (383, 382), (405, 404), (429, 428), (478, 478),
                             (587, 586), (588, 598)],
}
HISTORY = [(r"PR-\d+ rollout invalidation", "weight rollout invalidation")]
JOIN_S = 60


def _rewritten(module: str) -> str:
    source = (REF / module).read_text()
    for pattern, replacement in HISTORY:
        source = re.sub(pattern, replacement, source)
    return re.sub(r"\btensorflowonspark_tpu\.", "tensorflowonspark_tpu_torch.", source)


@pytest.mark.parametrize("module", VERBATIM + list(PATCHED))
def test_copy_matches_reference(module):
    ref = _rewritten(module).splitlines(keepends=True)
    port = (PORT / module).read_text().splitlines(keepends=True)
    hunks = [(i1 + 1, i2) for tag, i1, i2, _, _ in
             difflib.SequenceMatcher(a=ref, b=port, autojunk=False).get_opcodes()
             if tag != "equal"]
    assert hunks == PATCHED.get(module, [])


def test_history_phrases_each_match_once():
    sources = [(REF / m).read_text() for m in VERBATIM + list(PATCHED)]
    for pattern, _ in HISTORY:
        assert sum(len(re.findall(pattern, s)) for s in sources) == 1, pattern


@pytest.fixture(autouse=True)
def _no_failpoints():
    yield
    failpoints.disarm_all()


def _free_port() -> int:
    """A port with NO listener (bound then released): connection refused."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _until(pred, timeout=JOIN_S):
    """Wait for ``pred`` (a state, not a time); False past ``timeout``."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


# -- the store ----------------------------------------------------------------


def test_tier_exact_keying_and_lru_eviction():
    tier = CacheTier(capacity_bytes=64)
    assert tier.fill("prefix", "a", b"x" * 24)
    assert tier.fill("prefix", "b", b"y" * 24)
    assert tier.lookup("prefix", "a") == b"x" * 24
    assert tier.lookup("frames", "a") is None
    assert tier.fill("prefix", "c", b"z" * 24)  # evicts b (a was refreshed)
    assert tier.lookup("prefix", "b") is None
    assert tier.lookup("prefix", "a") == b"x" * 24
    st = tier.stats()
    assert (st["entries"], st["bytes"], st["evictions"], st["fills"]) == (2, 48, 1, 3)
    assert st["hits"] == 2 and st["misses"] == 2


def test_tier_per_entry_cap_and_capacity_knob():
    tier = CacheTier(capacity_bytes=100)
    assert not tier.fill("frames", "huge", b"x" * 51)  # over half the budget
    assert tier.fill("frames", "a", b"x" * 40)
    assert tier.fill("frames", "b", b"y" * 40)
    tier.set_capacity(50)
    st = tier.stats()
    assert st["capacity_bytes"] == 50 and st["bytes"] <= 50 and st["entries"] == 1
    with pytest.raises(ValueError):
        tier.set_capacity(0)


def test_tier_invalidate_is_prefix_exact():
    tier = CacheTier(capacity_bytes=1 << 20)
    tier.fill("prefix", "v0|a|1,2", b"old")
    tier.fill("prefix", "v0|b|1,2", b"old2")
    tier.fill("prefix", "v1|a|1,2", b"new")
    tier.fill("frames", "v0|decoy", b"frame")
    assert tier.invalidate("prefix", "v0|") == 2
    assert tier.lookup("prefix", "v1|a|1,2") == b"new"
    assert tier.lookup("frames", "v0|decoy") == b"frame"
    assert tier.invalidate("prefix", "v0|") == 0


@pytest.mark.parametrize("site,action", [("cachetier.lookup", "drop"), ("cachetier.fill", "drop")])
def test_tier_failpoints_degrade_never_corrupt(site, action):
    tier = CacheTier(capacity_bytes=20)
    assert tier.fill("x", "k", b"val")
    failpoints.arm(site, action, count=1)
    if site == "cachetier.lookup":
        assert tier.lookup("x", "k") is None  # a dropped lookup IS a miss
        assert tier.lookup("x", "k") == b"val"
    else:
        assert not tier.fill("x", "k2", b"v2")  # a dropped fill is not cached
        assert tier.lookup("x", "k2") is None
        assert tier.fill("x", "k2", b"v2")


def test_tier_get_frame_read_through(tmp_path):
    path = str(tmp_path / "backing.bin")
    payload = bytes(range(256)) * 4
    with open(path, "wb") as f:
        f.write(payload)
    tier = CacheTier(capacity_bytes=1 << 20)
    assert tier.get_frame(path, 16, 64) == payload[16:80]
    assert tier.get_frame(path, 16, 64) == payload[16:80]
    assert tier.stats()["backing_read_bytes"] == 64  # one backing read
    assert tier.get_frame(str(tmp_path / "gone.bin"), 0, 8) is None
    assert tier.get_frame(path, len(payload) - 4, 64) is None  # short read refused


def test_read_frames_via_the_frame_cache_is_identical(tmp_path):
    from tensorflowonspark_tpu_torch.feed import columnar as col

    path = str(tmp_path / "data.colf")
    records = [{"x": np.arange(6, dtype=np.float32) + i, "y": np.int64(i)} for i in range(12)]
    col.write_frames(path, records, records_per_frame=5)
    tier = CacheTier(capacity_bytes=1 << 20)
    fc = FrameCache(LocalClient(tier))
    plain = [r for c in col.read_frames(path) for r in c.rows()]
    cached = [r for c in col.read_frames(path, frame_cache=fc) for r in c.rows()]
    assert len(plain) == len(cached) == 12
    for a, b in zip(plain, cached):
        np.testing.assert_array_equal(a["x"], b["x"])
    payload = sum(span for _, span, n in col.scan_frames(path) if n)
    list(col.read_frames(path, frame_cache=fc))  # served from the tier
    assert tier.stats()["backing_read_bytes"] == payload


# -- TCP transport ---------------------------------------------------------------


def test_cache_server_roundtrip(tmp_path):
    tier = CacheTier(capacity_bytes=1 << 20)
    srv = CacheServer(tier).start()
    cl = CacheClient(srv.address)
    try:
        cl.fill("prefix", "v0||1,2,3", b"blob-bytes")
        assert _until(lambda: tier.stats()["fills"] == 1)
        assert cl.lookup("prefix", "v0||1,2,3", timeout_s=2.0) == b"blob-bytes"
        assert cl.lookup("prefix", "nope", timeout_s=2.0) is None
        path = str(tmp_path / "f.bin")
        with open(path, "wb") as f:
            f.write(b"0123456789")
        assert cl.get_frame(path, 2, 6, timeout_s=2.0) == b"234567"
        st = cl.stats()
        assert st["entries"] == 2 and st["backing_read_bytes"] == 6
        assert cl.invalidate("prefix", "v0|") == 1
        assert cl.lookup("prefix", "v0||1,2,3", timeout_s=2.0) is None
    finally:
        cl.close()
        srv.close()


def test_lookup_miss_on_refused_connection_never_hangs():
    cl = CacheClient(f"127.0.0.1:{_free_port()}")
    try:
        t0 = time.monotonic()
        assert cl.lookup("prefix", "k", timeout_s=0.2) is None
        assert cl.lookup("prefix", "k", timeout_s=0.2) is None  # down-backoff
        assert time.monotonic() - t0 < 30.0  # generous: a refused connect is instant
        cl.fill("prefix", "k", b"v")
        assert cl.stats() is None
    finally:
        cl.close()


def test_lookup_after_close_is_a_miss():
    """The close race, fixed in the port: fill, lookup (a hit on the
    connection the client keeps open), close(), lookup — 50 times. The
    JAX package's server answered some lookups after close() on that open
    connection; every one must miss here."""
    misses = 0
    for r in range(50):
        tier = CacheTier(capacity_bytes=1 << 20)
        srv = CacheServer(tier).start()
        cl = CacheClient(srv.address)
        try:
            cl.fill("prefix", f"k{r}", b"v")
            assert _until(lambda: tier.stats()["fills"] == 1)
            assert cl.lookup("prefix", f"k{r}", timeout_s=5.0) == b"v"
            srv.close()
            misses += cl.lookup("prefix", f"k{r}", timeout_s=0.5) is None
        finally:
            cl.close()
            srv.close()
    assert misses == 50


def test_close_shuts_the_servers_open_connections():
    """An open, idle connection (its server thread waiting for the next
    request) is shut down by close(): the peer reads end-of-stream at
    once, and the server keeps no connection."""
    srv = CacheServer(CacheTier(capacity_bytes=1 << 20)).start()
    raw = socket.create_connection((srv.host, srv.port), timeout=10)
    try:
        assert _until(lambda: len(srv._conns) == 1)
        srv.close()
        assert srv._conns == set()
        raw.settimeout(10)
        assert raw.recv(1) == b""  # closed by the server, not timed out
    finally:
        raw.close()
        srv.close()


def test_client_reconnects_when_the_server_dropped_its_connection():
    """The server closes a connection idle past its read timeout; the
    client's next request reconnects within its bound instead of missing
    and dropping everything in the down window after it."""
    tier = CacheTier(capacity_bytes=1 << 20)
    srv = CacheServer(tier).start()
    cl = CacheClient(srv.address)
    try:
        assert cl.lookup("prefix", "k", timeout_s=5.0) is None  # connects
        assert _until(lambda: len(srv._conns) == 1)
        with srv._conns_lock:  # what the idle timeout does
            (conn,) = srv._conns
        conn.shutdown(socket.SHUT_RDWR)
        assert _until(lambda: not srv._conns)
        for i in range(3):
            cl.fill("prefix", f"k{i}", b"v")
        assert _until(lambda: tier.stats()["fills"] == 3)
        assert cl.lookup("prefix", "k2", timeout_s=5.0) == b"v"
    finally:
        cl.close()
        srv.close()


# -- PrefixL2 -------------------------------------------------------------------


def _leaves():
    g = torch.Generator().manual_seed(0)
    return [torch.randn(2, 3, 4, generator=g).to(torch.bfloat16),
            torch.randn(3, 4, generator=g),
            torch.arange(6, dtype=torch.int32).reshape(2, 3),
            torch.tensor(5, dtype=torch.int32)]


def _wait_fills(tier, n):
    assert _until(lambda: tier.stats()["fills"] >= n)


def test_encoded_leaves_round_trip_bit_for_bit():
    leaves = _leaves()
    got = decode_leaves(encode_leaves(leaves))
    assert [(t.dtype, t.shape) for t in got] == [(t.dtype, t.shape) for t in leaves]
    assert all(torch.equal(a, b) for a, b in zip(got, leaves))
    assert decode_leaves(b"not a blob") is None
    assert decode_leaves(encode_leaves(leaves)[:-1]) is None


def test_prefix_l2_version_and_adapter_isolation():
    tier = CacheTier(capacity_bytes=1 << 20)
    l2 = PrefixL2(LocalClient(tier), chunk=4, lookup_timeout_s=5.0)
    try:
        leaves, toks = _leaves(), list(range(100, 108))
        l2.offer(toks, leaves, None, "v0")
        _wait_fills(tier, 1)
        got, depth = l2.lookup(toks + [1, 2], None, "v0")
        assert depth == 8
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, leaves))
        assert l2.lookup(toks, "lora-a", "v0") is None
        assert l2.lookup(toks, None, "v1") is None
        assert l2.invalidate_version("v0") == 1
        assert l2.lookup(toks, None, "v0") is None
        st = l2.stats()
        assert st["l2_hits"] == 1 and st["l2_offered"] == 1
    finally:
        l2.close()


def test_prefix_l2_probes_the_boundary_ladder():
    tier = CacheTier(capacity_bytes=1 << 20)
    l2 = PrefixL2(LocalClient(tier), chunk=4, lookup_timeout_s=5.0)
    try:
        toks = list(range(16))
        l2.offer(toks[:4], [torch.zeros(2)], None, "v0")
        l2.offer(toks[:8], [torch.ones(2)], None, "v0")
        _wait_fills(tier, 2)
        got, depth = l2.lookup(toks[:13], None, "v0")
        assert depth == 8 and torch.equal(got[0], torch.ones(2))
        assert tier.lookup(NS, prefix_key("v0", None, toks[:8])) is not None
        assert prefix_key("v0", None, [1, 2]).startswith(version_prefix("v0"))
    finally:
        l2.close()


def test_l2_offer_dedup_skips_repeats_and_self_heals():
    tier = CacheTier(capacity_bytes=1 << 20)
    l2 = PrefixL2(LocalClient(tier), chunk=4, lookup_timeout_s=5.0)
    try:
        toks, leaves = [11, 12, 13, 14], [torch.zeros(2)]
        l2.offer(toks, leaves, None, "v0")
        _wait_fills(tier, 1)
        l2.offer(toks, leaves, None, "v0")  # deduplicated before any queueing
        st = l2.stats()
        assert st["l2_offered"] == 1 and st["l2_offer_dedups"] == 1
        assert l2.invalidate_version("v0") == 1
        assert l2.lookup(toks + [9, 9], None, "v0") is None  # the miss re-arms the key
        l2.offer(toks, leaves, None, "v0")
        _wait_fills(tier, 2)
        assert l2.stats()["l2_offered"] == 2
    finally:
        l2.close()


def test_prefix_l2_over_tcp_and_a_dead_service_is_a_miss():
    tier = CacheTier(capacity_bytes=1 << 20)
    srv = CacheServer(tier).start()
    l2 = PrefixL2(CacheClient(srv.address), chunk=4, lookup_timeout_s=5.0, own_client=True)
    try:
        leaves, toks = _leaves(), [3, 1, 4, 1, 5, 9]
        l2.offer(toks, leaves, None, "v0")
        _wait_fills(tier, 1)
        got, depth = l2.lookup(toks, None, "v0")
        assert depth == 6 and all(torch.equal(a, b) for a, b in zip(got, leaves))
        srv.close()
        assert l2.lookup(toks, None, "v0") is None
        assert l2.stats()["l2_misses"] == 1
    finally:
        l2.close()
        srv.close()


def test_l2_spec_normalization():
    from tensorflowonspark_tpu_torch.serving.fleet import _normalize_l2_spec

    assert _normalize_l2_spec(None) is None
    spec = _normalize_l2_spec("inproc")
    assert (spec["mode"], spec["capacity_bytes"], spec["lookup_timeout_s"]) == (
        "inproc", 256 << 20, 0.05)
    spec = _normalize_l2_spec({"mode": "spawn", "capacity_bytes": 1 << 20})
    assert spec["mode"] == "spawn" and spec["capacity_bytes"] == 1 << 20
    for bad, what in (("tcp", "mode"), ({"capacity_bytes": 0}, "capacity"), (17, "prefix_l2")):
        with pytest.raises(ValueError, match=what):
            _normalize_l2_spec(bad)


# -- the router's affinity with and without an L2 (stub engines) -----------------


class _StubMetrics:
    def render(self):
        return "# TYPE stub_up gauge\nstub_up 1\n"


class _StubEngine:
    def __init__(self):
        self.live = self.ready = True
        self.calls = []
        self.metrics = _StubMetrics()

    def warmup(self):
        pass

    def health(self):
        return {"live": self.live, "ready": self.ready}

    def stats(self):
        return {"slots": 2, "slots_busy": 0, "queue_depth": 0, "watchdog_fires": 0,
                "admitted": len(self.calls), "completed": len(self.calls)}

    def unresolved(self):
        return 0

    def submit_many(self, prompts, max_new_tokens, **kw):
        self.calls.append(list(prompts))
        return [[7] * min(int(max_new_tokens), 3) for _ in prompts]

    def close(self, drain=False, drain_timeout=300.0):
        self.live = self.ready = False


@pytest.mark.parametrize("prefix_l2,slack,extra_load,moves", [
    ("inproc", None, 4, True),  # warm replica overloaded: yields to the other
    ("inproc", None, 1, False),  # within the slack: locality still wins
    (None, None, 4, False),  # no L2: the warm replica is the only copy
    ("inproc", 100.0, 4, False),  # a wide slack keeps affinity
], ids=["l2_bypass", "l2_within_slack", "no_l2", "wide_slack"])
def test_affinity_is_a_locality_hint_with_an_l2(prefix_l2, slack, extra_load, moves):
    made = []

    def factory():
        made.append(_StubEngine())
        return made[-1]

    fleet = ServingFleet(factory=factory, replicas=2, probe_interval=5.0, warmup=False,
                         drain_timeout=2.0, prefix_l2=prefix_l2)
    try:
        router = FleetRouter(fleet, **({} if slack is None else {"affinity_load_slack": slack}))
        base = [5, 6, 7, 8]
        router.submit(base, 2)
        warm = 0 if made[0].calls else 1
        with router._lock:
            router._outstanding[1 - warm] = 0
            router._outstanding[warm] = router._outstanding.get(warm, 0) + extra_load
        router.submit(base + [9, 10], 2)
        st = router.stats()["router"]
        assert (len(made[1 - warm].calls) == 1) == moves
        assert (st["affinity_bypasses"] >= 1) == moves
        if moves:
            assert 'router_affinity_total{outcome="bypass"}' in router.metrics_text()
    finally:
        fleet.close()


# -- the engine's L2 on a tiny llama, against the JAX package's engine ----------

BASE = dict(remat=False, max_seq_len=64)
ENG = dict(slots=2, prompt_widths=(16,), prefill_chunk=4, prefix_cache=4)
_rng = np.random.default_rng(3)
PROMPT = _rng.integers(1, 256, 12).tolist()
EXT = PROMPT + _rng.integers(1, 256, 3).tolist()


@pytest.fixture(scope="module")
def tiny():
    """(port model, the JAX engine's greedy completion of EXT)."""
    jm = jllama.Llama(jllama.LlamaConfig.tiny(**BASE, dtype=jnp.float32, attention_impl="xla"))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    jeng = jengine.ContinuousBatcher(jm, params, **ENG)
    try:
        want = jeng.submit(EXT, 6)
    finally:
        jeng.close()
    m = tllama.Llama(tllama.LlamaConfig.tiny(**BASE, dtype=torch.float32, attention_impl="xla"),
                     device="cpu")
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return m, want


def test_l2_hit_equals_a_miss_and_the_jax_engine(tiny):
    """A prefix prefilled by one engine is an L2 hit on another (resumed
    at the offered depth, inserted into its L1), and the tokens equal a
    cold engine's and the JAX package's engine's exactly."""
    model, want = tiny
    tier = CacheTier(capacity_bytes=32 << 20)
    a = ContinuousBatcher(model, **ENG)
    b = ContinuousBatcher(model, **ENG)
    cold = ContinuousBatcher(model, **ENG)
    try:
        a.attach_prefix_l2(PrefixL2(LocalClient(tier), chunk=4, lookup_timeout_s=5.0))
        b.attach_prefix_l2(PrefixL2(LocalClient(tier), chunk=4, lookup_timeout_s=5.0))
        a.submit(PROMPT, 2)
        _wait_fills(tier, 3)  # boundaries 4 and 8, then the whole prompt
        hit = b.submit(EXT, 6)
        st = b.stats()
        assert st["prefix_l2_hits"] == 1 and st["prefix_cache_entries"] >= 1
        assert hit == cold.submit(EXT, 6) == want
        # the payload an engine offers reconstructs; another config's is a miss
        _wait_fills(tier, 5)  # b's own offers: depth 12 and the whole of EXT
        found = b._prefix_l2.lookup(EXT, None, b.weights_version)
        assert found is not None and found[1] == len(EXT)
        rebuilt = b._l2_reconstruct(found[0])
        assert rebuilt is not None and len(rebuilt) == model.cfg.num_layers
        assert b._l2_reconstruct(found[0][:-1]) is None
        assert b._l2_reconstruct([t.to(torch.float64) if t.is_floating_point() else t
                                  for t in found[0]]) is None
    finally:
        for e in (a, b, cold):
            e.close()


def test_l2_offers_wait_for_warmup_and_the_key_holds_the_version(tiny):
    model, _ = tiny
    tier = CacheTier(capacity_bytes=32 << 20)
    eng = ContinuousBatcher(model, weights_version="w7", **ENG)
    try:
        eng.attach_prefix_l2(PrefixL2(LocalClient(tier), chunk=4, lookup_timeout_s=5.0))
        eng.warmup()
        assert eng.stats()["prefix_l2_offered"] == 0  # warmup's prompts stay local
        eng.submit(PROMPT, 2)
        _wait_fills(tier, 3)
        assert tier.lookup(NS, prefix_key("w7", None, PROMPT)) is not None
        assert tier.lookup(NS, prefix_key("v0", None, PROMPT)) is None
    finally:
        eng.close()
    assert eng._prefix_l2._closed  # closed with the engine's loop


def test_prefix_l2_needs_the_l1(tiny):
    model, _ = tiny
    l2 = PrefixL2(LocalClient(CacheTier()), chunk=4)
    try:
        with pytest.raises(ValueError, match="prefix_l2 requires prefix_cache"):
            ContinuousBatcher(model, slots=1, prompt_widths=(8,), prefix_l2=l2)
        eng = ContinuousBatcher(model, slots=1, prompt_widths=(8,))
        try:
            with pytest.raises(ValueError, match="prefix_l2 requires prefix_cache"):
                eng.attach_prefix_l2(l2)
        finally:
            eng.close()
    finally:
        l2.close()
