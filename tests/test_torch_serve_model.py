"""The port's ``tools/serve_model`` against the JAX package's.

Both servers run in process on port 0 over the same tiny fp32 weights
(max_seq_len 64): the JAX one over an orbax checkpoint of JAX-drawn
params, the port's on the CPU over a ``save_checkpoint`` of those params
moved by ``params_from_jax``. ``/generate`` (the fixed path and the
continuous engine, plain and streamed), ``/v1/completions`` and ``/score``
must return the same token ids, and logprobs and scores within 1e-4.
``/healthz``, ``/readyz``, ``/metrics`` and ``/stats`` answer. A draft
model serves the fixed path speculatively. Every
option the port's server does not have yet raises
``NotImplementedError`` at startup naming its ROADMAP item, and its
request paths answer 501 with the same message (the fleet and the prefix
L2 are held in ``tests/test_torch_fleet.py``, ``/admin/reload`` and the
rollout channel in ``tests/test_torch_rollout_serve.py``).
"""

import contextlib
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu.tools import serve_model as jserve
from tensorflowonspark_tpu_torch.compute.checkpoint import save_checkpoint
from tensorflowonspark_tpu_torch.models.convert import params_from_jax
from tensorflowonspark_tpu_torch.tools import serve_model as tserve

TOL = 1e-4
OVERRIDES = json.dumps({"remat": False, "dtype": "float32", "max_seq_len": 64})
PROMPTS = [[5, 9, 2], [17, 3, 8, 8, 1, 40, 2], [99]]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    from tensorflowonspark_tpu.compute.checkpoint import CheckpointManager

    root = tmp_path_factory.mktemp("serve")
    cfg = jllama.LlamaConfig.tiny(remat=False, dtype=jnp.float32, max_seq_len=64)
    params = jllama.Llama(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    jdir = str(root / "jax")
    with CheckpointManager(jdir, async_save=False) as mgr:
        mgr.save(0, {"params": params}, force=True)
    tdir = save_checkpoint(str(root / "port"),
                           {"params": params_from_jax(jax.tree.map(np.asarray, params))})
    return jdir, tdir


def _gen(ckpt, engine, **kw):
    return dict(checkpoint=ckpt, model="tiny", config_overrides=OVERRIDES, widths="8,16",
                width=16, batch_size=3, max_new_tokens=8, engine=engine, decode_block=4, **kw)


@contextlib.contextmanager
def _serving(make_server, gen):
    server = make_server(None, port=0, gen=gen)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


def _post(url, path, body):
    req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _drive(url, continuous):
    """The answers both servers must agree on."""
    out = {}
    code, body = _post(url, "/generate", {"prompts": PROMPTS})
    assert code == 200, body
    out["generate"] = json.loads(body)["completions"]
    code, body = _post(url, "/score", {"sequences": [p + [3, 4] for p in PROMPTS]})
    assert code == 200, body
    out["score"] = json.loads(body)["logprobs"]
    if continuous:
        code, body = _post(url, "/generate", {"prompts": PROMPTS[:2], "logprobs": True,
                                              "max_new_tokens": 6, "stop": [[PROMPTS[0][0]]]})
        assert code == 200, body
        out["logprobs"] = json.loads(body)
        code, body = _post(url, "/v1/completions", {"prompt": PROMPTS[1], "max_tokens": 5,
                                                    "temperature": 0, "logprobs": 1})
        assert code == 200, body
        v1 = json.loads(body)
        out["v1"] = [(c["tokens"], c["logprobs"]["token_logprobs"], c["finish_reason"])
                     for c in v1["choices"]]
        code, body = _post(url, "/generate", {"prompts": [PROMPTS[1]], "stream": True})
        assert code == 200, body
        lines = [json.loads(x) for x in body.splitlines()]
        assert lines[-1]["done"] and [x["token"] for x in lines[:-1]] == lines[-1]["completion"]
        out["stream"] = lines[-1]["completion"]
    return out


def _agree(got, want):
    assert got["generate"] == want["generate"]
    for g, w in zip(got["score"], want["score"]):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    if "v1" in want:
        assert got["logprobs"]["completions"] == want["logprobs"]["completions"]
        for g, w in zip(got["logprobs"]["logprobs"], want["logprobs"]["logprobs"]):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
        assert [(t, f) for t, _, f in got["v1"]] == [(t, f) for t, _, f in want["v1"]]
        np.testing.assert_allclose(got["v1"][0][1], want["v1"][0][1], atol=TOL, rtol=0)
        assert got["stream"] == want["stream"] == want["generate"][1]


@pytest.mark.parametrize("engine", ["continuous", "fixed"])
def test_server_answers_as_the_jax_server_does(engine, checkpoints):
    jdir, tdir = checkpoints
    continuous = engine == "continuous"
    with _serving(jserve.make_server, _gen(jdir, engine)) as url:
        want = _drive(url, continuous)
    with _serving(tserve.make_server, _gen(tdir, engine, device="cpu", warmup=continuous)) as url:
        got = _drive(url, continuous)
        for path in ("/healthz", "/readyz", "/v1/models", "/debugz/traces"):
            assert _get(url, path)[0] == 200, path
        code, text = _get(url, "/metrics")
        assert code == 200 and "reqtrace_" in text
        stats = json.loads(_get(url, "/stats")[1])
        assert stats["mode"] == engine
        if continuous:
            assert "engine_inflight_depth" in text and "engine_ttft_seconds" in text
            assert stats["completed"] >= 7 and stats["watchdog_fires"] == 0
            assert set(stats["phase_ms"]) >= {"queue", "prefill", "dispatch", "fetch", "sweep"}
    _agree(got, want)


REFUSED = {
    "mesh": (dict(mesh="model=2"), "A9b, mesh/TP decode"),
    "slo_ttft_s": (dict(slo_ttft_s=2.5), "A12"),
    "obs_window_s": (dict(obs_window_s=5.0), "A12"),
    "slo_error_budget": (dict(slo_error_budget=0.01), "A12"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_unported_options_raise_naming_their_roadmap_item(name, checkpoints):
    extra, item = REFUSED[name]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tserve.make_server(None, port=0, gen=_gen(checkpoints[1], "continuous", device="cpu",
                                                  **extra))


DRAFTS = {
    "draft_checkpoint": {},
    "spec_k": dict(spec_k=2),
    "draft_model": dict(draft_model="tiny", eos_id=8),
}


@pytest.mark.parametrize("name", list(DRAFTS))
def test_fixed_path_serves_through_a_draft(name, checkpoints):
    """The speculative options (once refused) on the fixed-batch path: the
    target as its own draft, so every proposal is accepted, and
    ``/generate`` equals the same server without a draft."""
    tdir = checkpoints[1]
    extra = DRAFTS[name]
    plain = {k: v for k, v in extra.items() if k == "eos_id"}
    with _serving(tserve.make_server, _gen(tdir, "fixed", device="cpu", **plain)) as url:
        want = _post(url, "/generate", {"prompts": PROMPTS})
    with _serving(tserve.make_server, _gen(tdir, "fixed", device="cpu", draft_checkpoint=tdir,
                                           draft_config_overrides=OVERRIDES, **extra)) as url:
        got = _post(url, "/generate", {"prompts": PROMPTS})
    assert got[0] == want[0] == 200, got
    assert json.loads(got[1])["completions"] == json.loads(want[1])["completions"]


def test_draft_options_are_checked_at_startup(checkpoints):
    """As the JAX package's server: the continuous engine refuses a draft,
    and the verify window must fit both models' caches."""
    tdir = checkpoints[1]
    with pytest.raises(ValueError, match="does not compose with --draft-checkpoint"):
        tserve.make_server(None, port=0, gen=_gen(tdir, "continuous", device="cpu",
                                                  draft_checkpoint=tdir))
    with pytest.raises(ValueError, match=r"--spec-k \(41\) exceeds --model's max_seq_len"):
        tserve.make_server(None, port=0, gen=_gen(tdir, "fixed", device="cpu",
                                                  draft_checkpoint=tdir, spec_k=41,
                                                  draft_config_overrides=OVERRIDES))
    with pytest.raises(ValueError, match="--top-k/--top-p/--min-p"):
        tserve.make_server(None, port=0, gen=_gen(tdir, "fixed", device="cpu",
                                                  draft_checkpoint=tdir, temperature=0.5,
                                                  top_k=4))


def test_export_dir_and_cli_flags_are_refused(checkpoints):
    with pytest.raises(NotImplementedError, match="ROADMAP A12, api/export"):
        tserve.make_server("/nonexistent", port=0)
    with pytest.raises(NotImplementedError, match="ROADMAP A9b, mesh/TP decode"):
        tserve.main(["--llama-checkpoint", checkpoints[1], "--device", "cpu",
                     "--gen-mesh", "model=2"])
    with pytest.raises(ValueError, match="does not compose with --draft-checkpoint"):
        tserve.main(["--llama-checkpoint", checkpoints[1], "--device", "cpu",
                     "--gen-engine", "continuous", "--draft-checkpoint", checkpoints[1]])
    with pytest.raises(NotImplementedError, match="ROADMAP A12, api/export"):
        tserve.main(["--llama-checkpoint", checkpoints[1], "--device", "cpu",
                     "--batch-size", "32"])


@pytest.mark.parametrize("bucket,new,ctx,want", [
    (512, 256, 2048, 769), (512, 257, 2048, 769), (512, 258, 2048, 897), (128, 64, 2048, 257),
    (16, 8, 64, 64), (1000, 1000, 2048, 2048), (64, 64, 129, 129),
])
def test_score_width_covers_generate_and_meets_the_flash_gate(bucket, new, ctx, want):
    """/score's width covers the largest bucket plus the budget, rounded
    up to 128·n + 1 (the forward's 128·n positions meet the flash gate),
    capped at the model's context."""
    assert tserve.score_width(bucket, new, ctx) == want


def test_unported_paths_answer_501(checkpoints):
    gen = _gen(checkpoints[1], "continuous", device="cpu")
    with _serving(tserve.make_server, gen) as url:
        code, body = _post(url, "/predict", {})
        assert code == 501 and "ROADMAP A12, api/export" in body
        code, body = _get(url, "/statusz")
        assert code == 501 and "ROADMAP A12" in body
        # adapters are served from a LoRA bank: this checkpoint has none
        code, body = _post(url, "/generate", {"prompts": [[1, 2]], "adapter": 1})
        assert code == 400 and "MultiLoraTensor bank" in body
        code, body = _post(url, "/generate", {"prompts": [[1] * 17]})
        assert code == 400 and "prompt width" in body


@pytest.mark.parametrize("row", [
    {"a": np.arange(3), "b": {"c": np.float32(1.5), "d": [1, 2]}},
    np.ones((2, 2), np.int64), np.int16(7), "text", [np.float64(2.0)],
], ids=["nested", "array", "scalar", "str", "list"])
def test_to_jsonable_matches_reference(row):
    """The port's copy of run_model._to_jsonable converts as the JAX
    package's does."""
    from tensorflowonspark_tpu.tools.run_model import _to_jsonable as ref
    from tensorflowonspark_tpu_torch.tools.run_model import _to_jsonable

    got, want = _to_jsonable(row), ref(row)
    assert json.dumps(got, default=repr) == json.dumps(want, default=repr)
    assert type(got) is type(want)
