"""The port's rollout on real engines and through its server, against the
JAX package's.

A 2-layer tiny Llama in fp32 (max_seq_len 64) serves v0 and v1, each drawn
from a numpy seed in the JAX package's tree and carried into the port's
by ``models.convert.params_from_jax``, so both packages serve the same
numbers.

- **Engines.** A JAX engine under the JAX controller and a port engine
  under the port's take the same roll to v1 and the same rejected update
  (a leaf's shape cut): the completions after the roll agree token for
  token with logprobs within ``TOL`` (fp32, summation order only), and
  the rejected update leaves both serving v1's completions.
- **The three traps** of a literal port (see ``serving/rollout.py``): the
  loader writes no tensor of ``current_weights()``; a rollback gives the
  swapped seat its prior back exactly; a published payload is not
  reached by in-place edits of the caller's tensors afterwards, and a
  seat respawned later re-syncs to exactly the published weights.
- **The loader.** An fp32 ``TrainState`` saved by ``CheckpointManager``
  loads into a bf16 engine; a tree that is not a Llama's, a missing leaf
  or a cut shape is ``WeightsIncompatible``; a truncated ``state.pt`` is
  a load error and a rollback.
- **The server.** ``/admin/reload``'s 403/400/200/409/501 on one engine
  and 202 on a fleet, the rollout channel watched by a fleet server, and
  ``--admin-token-file`` read as a file with ``TFOS_ADMIN_TOKEN`` as the
  fallback.
"""

import contextlib
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu.serving import engine as jengine
from tensorflowonspark_tpu.serving import rollout as j_rollout
from tensorflowonspark_tpu_torch.compute import TrainState, adamw
from tensorflowonspark_tpu_torch.compute.checkpoint import CheckpointManager, save_checkpoint
from tensorflowonspark_tpu_torch.models.convert import params_from_jax
from tensorflowonspark_tpu_torch.models.llama import LlamaConfig
from tensorflowonspark_tpu_torch.serving import ContinuousBatcher, ServingFleet
from tensorflowonspark_tpu_torch.serving import rollout as t_rollout
from tensorflowonspark_tpu_torch.serving.engine import WeightsIncompatible
from tensorflowonspark_tpu_torch.tools import serve_model as tserve
from tensorflowonspark_tpu_torch.tools.generate_text import load_model
from tensorflowonspark_tpu_torch.utils import failpoints

TOL = 1e-4  # fp32 logprobs, port against the JAX package: summation order only
PROMPTS = [[5, 9, 2], [17, 3, 8, 8, 1, 40, 2], [99]]
NEW = 6


@pytest.fixture(autouse=True)
def _no_failpoints():
    yield
    failpoints.disarm_all()


def _draw(template, seed):
    """A tree shaped as ``template`` drawn from a numpy seed, each leaf at its
    template's own mean and spread (norm scales stay ones)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (rng.standard_normal(x.shape) * float(np.std(x))
                                   + float(np.mean(x))).astype(np.float32), template)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    cfg = jllama.LlamaConfig.tiny(remat=False, dtype=jnp.float32, max_seq_len=64, num_layers=2)
    jmodel = jllama.Llama(cfg)
    template = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 8), jnp.int32))["params"])
    jp0, jp1 = _draw(template, 10), _draw(template, 11)
    tcfg = LlamaConfig.tiny(remat=False, dtype=torch.float32, max_seq_len=64, num_layers=2)
    p0, p1 = params_from_jax(jp0), params_from_jax(jp1)
    root = tmp_path_factory.mktemp("rollout")
    ck0 = save_checkpoint(str(root / "v0"), {"params": p0})
    ck1 = save_checkpoint(str(root / "v1"), {"params": p1})
    return dict(cfg=tcfg, jmodel=jmodel, jp0=jp0, jp1=jp1, p0=p0, p1=p1, ck0=ck0, ck1=ck1,
                root=root)


def _engine(tiny, params, **kw):
    model = load_model(tiny["cfg"], tiny["p0"], device="cpu")
    return ContinuousBatcher(model, params, slots=2, prompt_widths=(8,), **kw)


def _serve(eng):
    toks, lps, vers = eng.submit_many(PROMPTS, NEW, return_logprobs=True, return_versions=True)
    return toks, lps, vers


@pytest.fixture(scope="module")
def reference(tiny):
    """The JAX engine under the JAX controller: v0, the roll to v1, a rejected
    update (one leaf's shape cut)."""
    eng = jengine.ContinuousBatcher(tiny["jmodel"], tiny["jp0"], slots=2, prompt_widths=(8,))
    ctl = j_rollout.RolloutController(eng, verify_timeout=60.0)
    try:
        out = {"v0": _serve(eng), "roll": ctl.publish(tiny["jp1"], version="v1")}
        out["v1"] = _serve(eng)
        bad = dict(tiny["jp1"])
        bad["embed"] = bad["embed"][:-1]
        out["bad"] = ctl.publish(bad, version="v2")
        out["kept"] = _serve(eng)
        out["last_error"] = ctl.last_error["type"]
    finally:
        eng.close()
    return out


def _score(tiny, params, rows):
    """Fresh scoring of ``rows`` under ``params`` (the server's width and rows)."""
    from tensorflowonspark_tpu_torch.tools.generate_text import build_score_fn

    model = load_model(tiny["cfg"], params, device="cpu")
    width = tserve.score_width(8, NEW, tiny["cfg"].max_seq_len)
    return build_score_fn(model, width=width, bsz=2)(rows)


def _close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.allclose(a, b, atol=TOL, rtol=0), (a, b)


def _agree(got, want):
    assert got[0] == want[0] and got[2] == want[2]
    for a, b in zip(got[1], want[1]):
        assert np.allclose(a, b, atol=TOL, rtol=0), (a, b)


def test_roll_and_rejected_update_match_the_reference(tiny, reference):
    """Port engine + port controller against the JAX engine + JAX controller:
    the same completions under v0 and after the roll, and a rejected update
    (a cut shape) that leaves v1 serving."""
    eng = _engine(tiny, tiny["p0"])
    ctl = t_rollout.RolloutController(eng, verify_timeout=60.0)
    try:
        _agree(_serve(eng), reference["v0"])
        assert ctl.publish(tiny["p1"], version="v1") == reference["roll"] == "completed"
        _agree(_serve(eng), reference["v1"])
        bad = dict(tiny["p1"], embed=tiny["p1"]["embed"][:-1])
        assert ctl.publish(bad, version="v2") == reference["bad"] == "rolled_back"
        assert ctl.last_error["type"] == reference["last_error"] == "WeightsIncompatible"
        _agree(_serve(eng), reference["kept"])
        assert eng.stats()["weights_swaps"] == 1  # the rejected update touched nothing
    finally:
        eng.close()


def test_loader_never_writes_the_running_weights(tiny):
    """checkpoint_loader restores into tensors of its own: the running set it
    was given is left as it was, and what it returns shares no storage with
    it."""
    eng = _engine(tiny, tiny["p0"])
    try:
        _, live = eng.current_weights()
        before = {k: v.clone() for k, v in live.items()}
        got = t_rollout.checkpoint_loader(live)(t_rollout.WeightsUpdate(version="v1",
                                                                        path=tiny["ck1"]))
        for k, v in live.items():
            assert torch.equal(v, before[k]), k
            assert got[k].untyped_storage().data_ptr() != v.untyped_storage().data_ptr()
            assert torch.equal(got[k], tiny["p1"][k]), k
    finally:
        eng.close()


def _fleet(tiny, params):
    def factory():
        return _engine(tiny, params)

    return ServingFleet(factory=factory, replicas=2, probe_interval=5.0, warmup=False,
                        drain_timeout=10.0, respawn_backoff_s=0.01)


def _seats(fleet):
    return [v["handle"].engine for v in sorted(fleet.views(), key=lambda v: v["rid"])]


def test_rollback_gives_the_swapped_seat_its_exact_prior(tiny):
    """Both seats at v1; a path-published v0 swaps seat 0 (loaded against
    seat 0's running tensors), then seat 1's verification raises: seat 0
    serves exactly v1's completions again, as does seat 1."""
    fleet = _fleet(tiny, tiny["p0"])
    ctl = t_rollout.RolloutController(fleet, drain_timeout=10.0, verify_timeout=60.0)
    ref = _engine(tiny, tiny["p1"])
    try:
        assert ctl.publish(tiny["p1"], version="v1") == "completed"
        want = _serve(ref)
        seat0 = _seats(fleet)[0]
        ctl._loader = t_rollout.checkpoint_loader(seat0.current_weights()[1])
        release = fleet.release_seat

        def arm_after_seat0(rid):
            release(rid)
            if rid == 0:
                failpoints.arm("rollout.verify", "raise", count=1)

        fleet.release_seat = arm_after_seat0
        upd = t_rollout.WeightsUpdate(version="v0-again", path=tiny["ck0"])
        assert ctl.roll(upd) == "rolled_back"
        fleet.release_seat = release
        assert ctl.last_error["stage"] == "verify"
        for seat in _seats(fleet):
            toks, lps, vers = _serve(seat)
            assert (toks, lps) == want[:2] and vers == ["v1"] * len(PROMPTS)
    finally:
        ref.close()
        fleet.close()


def test_published_snapshot_survives_the_trainers_next_step_and_a_respawn(tiny):
    """publish(params) of tensors the caller then writes in place (a trainer's
    next step): both seats serve the published weights, and a seat
    respawned afterwards re-syncs to exactly them."""
    fleet = _fleet(tiny, tiny["p0"])
    ctl = t_rollout.RolloutController(fleet, drain_timeout=10.0, verify_timeout=60.0)
    try:
        live = {k: v.clone() for k, v in tiny["p1"].items()}
        assert ctl.publish(live, version="v1") == "completed"
        with torch.no_grad():
            for t in live.values():
                t.add_(1.0)
        fleet.force_respawn(0, "test respawn")
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
                fleet.states() == {0: "ready", 1: "ready"}
                and fleet.stats()["seats"]["0"]["respawns"] == 1):
            time.sleep(0.05)
        seats = _seats(fleet)
        assert fleet.stats()["seats"]["0"]["respawns"] == 1
        for seat in seats:
            ver, params = seat.current_weights()
            assert ver == "v1"
            for k, v in params.items():
                assert torch.equal(v, tiny["p1"][k]), k
    finally:
        fleet.close()


def test_trainers_fp32_checkpoint_rolls_into_a_bf16_engine(tiny, tmp_path):
    """A TrainState (fp32 params, bf16 moments) saved by an async
    CheckpointManager, published through the channel, rolls into a bf16
    engine: each weight is the fp32 one cast to bf16 once."""
    state = TrainState.create({k: v.clone() for k, v in tiny["p1"].items()},
                              adamw(1e-3, moment_dtype=torch.bfloat16))
    mgr = CheckpointManager(str(tmp_path / "train"))
    mgr.save(5, state)
    mgr.wait()
    ch = str(tmp_path / "chan")
    t_rollout.publish_checkpoint(ch, version="step-5", path=mgr.step_path(5), step=5)
    upd = t_rollout.read_latest(ch)
    assert (upd.version, upd.step) == ("step-5", 5)
    cfg = LlamaConfig.tiny(remat=False, dtype=torch.bfloat16, max_seq_len=64, num_layers=2)
    bf = {k: v.to(torch.bfloat16) for k, v in tiny["p0"].items()}
    eng = ContinuousBatcher(load_model(cfg, bf, device="cpu"), slots=2, prompt_widths=(8,))
    ctl = t_rollout.RolloutController(eng, loader=t_rollout.checkpoint_loader(
        eng.current_weights()[1]), verify_timeout=60.0)
    try:
        assert ctl.roll(upd) == "completed"
        ver, params = eng.current_weights()
        assert ver == "step-5"
        for k, v in params.items():
            assert v.dtype == torch.bfloat16 and torch.equal(v, tiny["p1"][k].to(torch.bfloat16))
    finally:
        eng.close()


def _cut(params):
    return {**params, "embed": params["embed"][:-1]}


def _drop(params):
    return {k: v for k, v in params.items() if k != "embed"}


def _truncate(path):
    with open(os.path.join(path, "state.pt"), "r+b") as f:
        f.truncate(4096)


LOADER_CASES = {  # name -> (what is saved, how it is damaged, the error)
    "not_a_llama": (lambda p: {"weights": p["embed"]}, None, WeightsIncompatible),
    "leaf_missing": (lambda p: {"params": _drop(p)}, None, WeightsIncompatible),
    "shape_cut": (lambda p: {"params": _cut(p)}, None, WeightsIncompatible),
    "state_truncated": (lambda p: {"params": p}, _truncate, RuntimeError),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_a_bad_checkpoint_is_refused_and_rolled_back(case, tiny, tmp_path):
    """The loader refuses each bad checkpoint with its error, and the
    controller rolls back with the engine still serving v0, untouched."""
    tree, damage, error = LOADER_CASES[case]
    path = save_checkpoint(str(tmp_path / case), tree(tiny["p1"]))
    if damage is not None:
        damage(path)
    eng = _engine(tiny, tiny["p0"])
    live = eng.current_weights()[1]
    upd = t_rollout.WeightsUpdate(version="bad", path=path)
    try:
        with pytest.raises(error):
            t_rollout.checkpoint_loader(live)(upd)
        ctl = t_rollout.RolloutController(eng, loader=t_rollout.checkpoint_loader(live),
                                          verify_timeout=60.0)
        assert ctl.roll(upd) == "rolled_back"
        assert eng.weights_version == "v0" and eng.stats()["weights_swaps"] == 0
    finally:
        eng.close()


# -- the server ---------------------------------------------------------------


@contextlib.contextmanager
def _serving(gen):
    server = tserve.make_server(None, port=0, gen=gen)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


def _gen(ckpt, **kw):
    return {**dict(checkpoint=ckpt, model="tiny",
                   config_overrides=json.dumps({"remat": False, "dtype": "float32",
                                                "max_seq_len": 64, "num_layers": 2}),
                   device="cpu", widths="8", width=8, batch_size=2, max_new_tokens=NEW,
                   engine="continuous"), **kw}


def _post(url, path, body, headers=None):
    req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _stats(url):
    with urllib.request.urlopen(url + "/stats", timeout=60) as r:
        return json.loads(r.read().decode())


BEARER = {"Authorization": "Bearer sekrit"}


def test_admin_reload_status_codes_on_one_engine(tiny, reference):
    """One engine: 403 without a token, with a wrong one and with the
    token's file path; 400 on a bad body; 200 with the token (Bearer or
    X-Admin-Token) and v1's completions stamped with the version; 409 on a
    cut shape; 501 on a LoRA reload; /stats carries the rollout."""
    bad = save_checkpoint(str(tiny["root"] / "bad"), {"params": _cut(tiny["p1"])})
    with _serving(_gen(tiny["ck0"], admin_token="sekrit")) as url:
        body = {"version": "v1", "path": tiny["ck1"]}
        assert _post(url, "/admin/reload", body)[0] == 403
        assert _post(url, "/admin/reload", body, {"Authorization": "Bearer nope"})[0] == 403
        assert _post(url, "/admin/reload", {"path": tiny["ck1"]}, BEARER)[0] == 400
        assert _post(url, "/admin/reload", dict(body, kind="lora"), BEARER)[0] == 501
        code, out = _post(url, "/admin/reload", body, {"X-Admin-Token": "sekrit"})
        assert code == 200 and out["status"] == "completed" and out["version"] == "v1", out
        code, out = _post(url, "/generate", {"prompts": PROMPTS, "versions": True,
                                             "logprobs": True})
        assert code == 200
        _agree((out["completions"], out["logprobs"], out["weights_versions"]), reference["v1"])
        rows = [p + [3, 4] for p in PROMPTS[:2]]
        code, out = _post(url, "/score", {"sequences": rows})
        assert code == 200
        _close(out["logprobs"], _score(tiny, tiny["p1"], rows))
        code, out = _post(url, "/admin/reload", {"version": "bad", "path": bad}, BEARER)
        assert code == 409 and out["error_type"] == "WeightsIncompatible", out
        st = _stats(url)["rollout"]
        assert st["target_version"] == "v1" and st["outcomes"] == {"completed": 1,
                                                                   "rolled_back": 1}
        code, out = _post(url, "/generate", {"prompts": PROMPTS, "versions": True})
        assert out["weights_versions"] == ["v1"] * len(PROMPTS)


def test_admin_reload_is_refused_without_a_token_or_an_engine(tiny):
    """No token configured: 403 whatever is sent. The fixed path: 400."""
    with _serving(_gen(tiny["ck0"])) as url:
        code, out = _post(url, "/admin/reload", {"version": "v1", "path": tiny["ck1"]}, BEARER)
        assert code == 403 and "disabled" in out["error"]
    with _serving(_gen(tiny["ck0"], admin_token="sekrit", engine="fixed")) as url:
        assert _post(url, "/admin/reload", {"version": "v1", "path": tiny["ck1"]},
                     BEARER)[0] == 400


def test_fleet_server_rolls_from_the_channel_and_answers_202(tiny, reference, tmp_path):
    """Two replicas: a publication on the watched channel rolls both to v1;
    /admin/reload answers 202 and rolls in the background."""
    ch = str(tmp_path / "chan")
    gen = _gen(tiny["ck0"], admin_token="sekrit", replicas=2, probe_interval=5.0,
               rollout_channel=ch, rollout_poll=0.05)
    with _serving(gen) as url:
        t_rollout.publish_checkpoint(ch, version="step-1", path=tiny["ck1"], step=1)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and _stats(url)["rollout"]["target_version"] is None:
            time.sleep(0.05)
        st = _stats(url)["rollout"]
        assert st["target_version"] == "step-1" and st["applied"] == {"0": "step-1",
                                                                      "1": "step-1"}
        code, out = _post(url, "/generate", {"prompts": PROMPTS, "versions": True,
                                             "logprobs": True})
        assert code == 200 and out["weights_versions"] == ["step-1"] * len(PROMPTS)
        _agree((out["completions"], out["logprobs"], reference["v1"][2]), reference["v1"])
        rows = [p + [3, 4] for p in PROMPTS[:2]]
        code, out = _post(url, "/score", {"sequences": rows})
        assert code == 200
        _close(out["logprobs"], _score(tiny, tiny["p1"], rows))
        code, out = _post(url, "/admin/reload", {"version": "back", "path": tiny["ck0"]}, BEARER)
        assert code == 202 and out["status"] == "rolling"
        while time.monotonic() < deadline and _stats(url)["rollout"]["target_version"] != "back":
            time.sleep(0.05)
        code, out = _post(url, "/generate", {"prompts": PROMPTS, "versions": True,
                                             "logprobs": True})
        _agree((out["completions"], out["logprobs"], reference["v0"][2]), reference["v0"])
        assert out["weights_versions"] == ["back"] * len(PROMPTS)


def test_admin_token_is_the_files_contents(tiny, tmp_path, monkeypatch):
    """--admin-token-file is read as a file (not its path), stripped;
    TFOS_ADMIN_TOKEN is the fallback; --rollout-channel needs the
    continuous engine."""
    monkeypatch.setenv("TFOS_ADMIN_TOKEN", "from-env")
    token_file = tmp_path / "token"
    token_file.write_text("  sekrit\n")
    assert tserve.read_admin_token(str(token_file)) == "sekrit"
    assert tserve.read_admin_token(None) == "from-env"
    (tmp_path / "empty").write_text("\n")
    assert tserve.read_admin_token(str(tmp_path / "empty")) == "from-env"
    with pytest.raises(SystemExit):
        tserve.main(["--llama-checkpoint", tiny["ck0"], "--rollout-channel", str(tmp_path)])
    with pytest.raises(ValueError, match="continuous"):
        tserve.make_server(None, port=0, gen=_gen(tiny["ck0"], engine="fixed",
                                                  rollout_channel=str(tmp_path)))
    port_file = tmp_path / "port"
    g = _gen(tiny["ck0"])
    argv = ["--llama-checkpoint", tiny["ck0"], "--model", "tiny", "--config-overrides",
            g["config_overrides"], "--device", "cpu", "--gen-engine", "continuous",
            "--gen-widths", "8", "--max-new-tokens", str(NEW), "--port", "0",
            "--port-file", str(port_file), "--admin-token-file", str(token_file)]
    thread = threading.Thread(target=tserve.main, args=(argv,), daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while not port_file.exists() and time.monotonic() < deadline:
        time.sleep(0.05)
    url = f"http://127.0.0.1:{int(port_file.read_text())}"
    try:
        body = {"version": "v1", "path": tiny["ck1"]}
        assert _post(url, "/admin/reload", body, {"X-Admin-Token": str(token_file)})[0] == 403
        assert _post(url, "/admin/reload", body, {"X-Admin-Token": "from-env"})[0] == 403
        assert _post(url, "/admin/reload", body, {"X-Admin-Token": "sekrit"})[0] == 200
    finally:
        tserve._last_server.shutdown()
        tserve._last_server.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()
