"""Serving LoRA banks and int8 weights in the port: the engine, the
adapter-only swap and rollout, the server, the decode CLI.

A 2-layer tiny Llama in fp32 (max_seq_len 64) with a bank of two trained
adapters over its seed-0 weights (``multi_lora_bank``: slot 0 the zero
adapter, slots 1 and 2 the adapters, ``b`` drawn from numpy seeds so both
factors matter), all greedy:

- **The engine with a bank.** Mixed-adapter requests decoding together
  against each adapter's ``generate`` alone (a model holding
  ``select_adapter(bank, k)``), token for token; slot 0 against the base
  model; the adapter range errors; the same prompt under two adapters a
  prefix-cache miss, under the same adapter a hit that decodes the miss's
  tokens.
- **The adapter-only swap.** ``rollout.lora_state`` of a second bank
  against the JAX package's ``lora_state`` of the same bank (factor by
  factor through ``models.convert.jax_leaf``); ``swap_weights(kind='lora')``
  keeps every base tensor and decodes as a fresh engine of the new bank;
  ``RolloutController.publish(kind='lora')`` and a channel-published
  lora checkpoint through ``checkpoint_loader`` do the same.
- **int8.** An engine built on an int8 weight set decodes as ``generate``
  on a model holding it, and takes an int8 swap; ``generate_text`` over an
  int8 checkpoint decodes the same.
- **The server** over a bank checkpoint: ``adapter`` 2 equal to the
  engine's, 9 a 400, ``/admin/reload`` of kind lora 200, ``/score`` the
  bank's slot 0; and ``generate_text --lora-scale`` against ``generate``.
"""

import contextlib
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.ops import lora as jlora
from tensorflowonspark_tpu.serving import rollout as j_rollout
from tensorflowonspark_tpu_torch.compute.checkpoint import save_checkpoint
from tensorflowonspark_tpu_torch.models import llama as tllama
from tensorflowonspark_tpu_torch.models.convert import jax_leaf, params_to_jax
from tensorflowonspark_tpu_torch.ops import lora as tlora
from tensorflowonspark_tpu_torch.ops import quant as tquant
from tensorflowonspark_tpu_torch.serving import ContinuousBatcher
from tensorflowonspark_tpu_torch.serving import rollout as t_rollout
from tensorflowonspark_tpu_torch.tools import generate_text as tgen
from tensorflowonspark_tpu_torch.tools import serve_model as tserve

CFG = tllama.LlamaConfig.tiny(remat=False, dtype=torch.float32, max_seq_len=64,
                              attention_impl="xla")
OVERRIDES = json.dumps({"remat": False, "dtype": "float32", "max_seq_len": 64})
RANK, NEW = 4, 6
PROMPTS = [[5, 9, 2], [17, 3, 8, 8, 1, 40, 2], [99, 4], [7] * 9]


def _adapter(base, seed):
    """One trained adapter over ``base``: factors from ``add_lora`` with a
    seeded generator, ``b`` seeded normals."""
    out = tlora.add_lora(base, RANK, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for name in tlora.lora_names(out):
        b = out[name + tlora.B]
        out[name + tlora.B] = torch.tensor(rng.normal(0, 0.2, tuple(b.shape)), dtype=torch.float32)
    return out


@pytest.fixture(scope="module")
def weights():
    base = dict(tllama.Llama(CFG, device="cpu", seed=0).named_parameters())
    base = {n: t.detach() for n, t in base.items()}
    bank = tlora.multi_lora_bank([_adapter(base, 1), _adapter(base, 2)])
    bank2 = tlora.multi_lora_bank([_adapter(base, 3), _adapter(base, 4)])
    return base, bank, bank2


def _model(params):
    model = tllama.Llama(CFG, device="cpu")
    tllama.adopt_params(model, params)
    return model


def _alone(params, prompt, k=None):
    """``generate`` of one prompt on a model holding ``params`` (adapter k of
    a bank as a single adapter)."""
    if k is not None:
        params = tlora.select_adapter(params, k)
    out = tllama.generate(_model(params), torch.tensor([prompt]), NEW)
    return out[0].tolist()


def _engine(params, **kw):
    return ContinuousBatcher(_model(params), slots=3, prompt_widths=(16,), **kw)


def _submit_all(eng, reqs):
    """Every (prompt, adapter) at once from its own thread."""
    got = [None] * len(reqs)

    def one(i):
        got[i] = eng.submit(reqs[i][0], NEW, adapter=reqs[i][1])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return got


def test_bank_engine_rows_decode_as_each_adapter_alone(weights):
    base, bank, _ = weights
    reqs = [(p, k) for k in (0, 1, 2) for p in PROMPTS[:3]]
    eng = _engine(bank)
    try:
        assert eng.stats()["adapters"] == 3
        got = _submit_all(eng, reqs)
        for (prompt, k), toks in zip(reqs, got):
            assert toks == _alone(bank, prompt, k), (prompt, k)
            if k == 0:  # slot 0 is the base model
                assert toks == _alone(base, prompt)
        for bad in (3, -1, 9):
            with pytest.raises(ValueError, match="out of range"):
                eng.submit(PROMPTS[0], NEW, adapter=bad)
    finally:
        eng.close()
    plain = _engine(base)
    try:
        with pytest.raises(ValueError, match="no MultiLoraTensor bank"):
            plain.submit(PROMPTS[0], NEW, adapter=1)
        assert "adapters" not in plain.stats()
    finally:
        plain.close()


def test_prefix_cache_is_keyed_by_adapter(weights):
    _, bank, _ = weights
    eng = _engine(bank, prefill_chunk=4, prefix_cache=4)
    prompt = PROMPTS[3]
    try:
        first = eng.submit(prompt, NEW, adapter=1)
        miss = eng.stats()["prefix_misses"]
        other = eng.submit(prompt, NEW, adapter=2)  # another adapter: a miss
        s = eng.stats()
        assert s["prefix_misses"] == miss + 1 and s["prefix_hits"] == 0
        again = eng.submit(prompt, NEW, adapter=1)  # the same adapter: a hit
        assert eng.stats()["prefix_hits"] == 1
        assert again == first == _alone(bank, prompt, 1)
        assert other == _alone(bank, prompt, 2) != first
    finally:
        eng.close()


def test_lora_state_matches_the_jax_payload(weights):
    _, _, bank2 = weights
    got = t_rollout.lora_state(bank2)
    assert sorted(got) == sorted(n + s for n in tlora.lora_names(bank2) for s in (tlora.A, tlora.B))
    # the JAX package's payload of the same bank: {"a", "b"} per kernel
    jbank = jlora.rewrap_lora(params_to_jax(bank2), 1.0)
    ref = j_rollout.lora_state(jbank)
    n_leaves = 0
    for name, t in got.items():
        path, _, perm = jax_leaf(name, tuple(t.shape))
        node = ref
        for key in path.split("/"):
            node = node[key]
        np.testing.assert_array_equal(np.transpose(node, perm), t.numpy(), err_msg=name)
        n_leaves += 1
    assert n_leaves == 2 * 7 * CFG.num_layers


def test_lora_swap_keeps_the_bases_and_decodes_as_a_fresh_engine(weights, tmp_path):
    _, bank, bank2 = weights
    reqs = [(p, k) for k in (0, 1, 2) for p in PROMPTS[:2]]
    fresh = _engine(bank2)
    try:
        want = _submit_all(fresh, reqs)
    finally:
        fresh.close()
    eng = _engine(bank)
    try:
        before = _submit_all(eng, reqs)
        _, old = eng.current_weights()
        eng.swap_weights(t_rollout.lora_state(bank2), version="v1", kind="lora")
        _, new = eng.current_weights()
        assert eng.weights_version == "v1"
        for name in tlora.lora_names(bank):
            assert new[name] is old[name]  # the base: the running tensor itself
            assert new[name + tlora.A] is not old[name + tlora.A]
        assert _submit_all(eng, reqs) == want != before
        with pytest.raises(t_rollout.WeightsIncompatible, match="both"):
            eng.swap_weights({"layers.0.attn.q_proj.weight_lora_a":
                              bank2["layers.0.attn.q_proj.weight_lora_a"]}, version="v2",
                             kind="lora")
        with pytest.raises(t_rollout.WeightsIncompatible, match="shape"):
            cut = {n: t[:, :1] for n, t in t_rollout.lora_state(bank2).items()}
            eng.swap_weights(cut, version="v2", kind="lora")
        # the controller: an in-process publish of kind lora, and a channel
        # publication read back through the loader
        ctl = t_rollout.RolloutController(eng, loader=t_rollout.checkpoint_loader(new))
        assert ctl.publish(t_rollout.lora_state(bank), version="v2", kind="lora") == "completed"
        assert _submit_all(eng, reqs) == before
        ch = str(tmp_path / "chan")
        upd = t_rollout.publish_params(ch, t_rollout.lora_state(bank2), version="v3",
                                       kind="lora")
        latest = t_rollout.read_latest(ch)
        assert (latest.kind, latest.path) == ("lora", upd.path)
        assert ctl.roll(latest) == "completed" and eng.weights_version == "v3"
        assert _submit_all(eng, reqs) == want
        assert eng.current_weights()[1]["embed"] is old["embed"]
    finally:
        eng.close()


def test_int8_engine_decodes_as_generate(weights, tmp_path):
    base, _, _ = weights
    q = tquant.quantize_tree(base, min_size=1 << 14)
    assert len(tquant.quantized_names(q)) == 2 + 5 * CFG.num_layers
    # the decode CLI over an int8 checkpoint
    ckpt = save_checkpoint(str(tmp_path / "int8"), {"params": q})
    (tmp_path / "p.jsonl").write_text(json.dumps({"tokens": PROMPTS[1]}) + "\n")
    assert tgen.main(["--checkpoint", ckpt, "--config-overrides", OVERRIDES, "--prompts",
                      str(tmp_path / "p.jsonl"), "--output", str(tmp_path / "o.jsonl"),
                      "--max-new-tokens", str(NEW), "--device", "cpu"]) == 0
    assert json.loads((tmp_path / "o.jsonl").read_text())["tokens"] == _alone(q, PROMPTS[1])
    eng = _engine(q)
    try:
        got = _submit_all(eng, [(p, None) for p in PROMPTS[:3]])
        assert got == [_alone(q, p) for p in PROMPTS[:3]]
        q2 = tquant.quantize_tree({n: t * 1.5 for n, t in base.items()}, min_size=1 << 14)
        eng.swap_weights(q2, version="int8-v1")
        assert eng.submit(PROMPTS[0], NEW) == _alone(q2, PROMPTS[0])
    finally:
        eng.close()


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


def _post(url, path, body, headers=None):
    req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_server_serves_a_bank_and_reloads_adapters(weights, tmp_path):
    _, bank, bank2 = weights
    ckpt = save_checkpoint(str(tmp_path / "bank"), {"params": bank})
    gen = dict(checkpoint=ckpt, model="tiny", config_overrides=OVERRIDES, device="cpu",
               widths="16", batch_size=2, max_new_tokens=NEW, engine="continuous", slots=2,
               lora_scale=1.0, admin_token="sekrit")
    lora_ckpt = save_checkpoint(str(tmp_path / "adapters"), t_rollout.lora_state(bank2))
    with _serving(gen) as url:
        code, body = _post(url, "/generate", {"prompts": [PROMPTS[1]], "adapter": 2})
        assert code == 200 and body["completions"][0] == _alone(bank, PROMPTS[1], 2)
        code, body = _post(url, "/generate", {"prompts": [PROMPTS[1]], "adapter": 9})
        assert code == 400 and "out of range" in body["error"]
        # /score runs the bank's slot 0: the base model
        code, body = _post(url, "/score", {"sequences": [PROMPTS[1]]})
        assert code == 200
        with torch.no_grad():
            logits = _model(tlora.select_adapter(bank, 0))(torch.tensor([PROMPTS[1]]))
        want = torch.log_softmax(logits[0, :-1], -1).gather(
            -1, torch.tensor(PROMPTS[1][1:])[:, None])[:, 0]
        np.testing.assert_allclose(body["logprobs"][0], want.numpy(), rtol=1e-4, atol=1e-4)
        code, body = _post(url, "/admin/reload",
                           {"version": "adapters-v1", "path": lora_ckpt, "kind": "lora"},
                           {"Authorization": "Bearer sekrit"})
        assert code in (200, 202), body
        code, body = _post(url, "/generate", {"prompts": [PROMPTS[1]], "adapter": 2,
                                              "versions": True})
        assert code == 200 and body["completions"][0] == _alone(bank2, PROMPTS[1], 2)


def test_generate_text_rewraps_with_lora_scale(weights, tmp_path):
    base, _, _ = weights
    one = _adapter(base, 5)
    ckpt = save_checkpoint(str(tmp_path / "one"), {"params": one})
    (tmp_path / "p.jsonl").write_text(json.dumps({"tokens": PROMPTS[1]}) + "\n")
    for scale in (None, 0.5, 0.0):
        out = tmp_path / f"out{scale}.jsonl"
        flags = [] if scale is None else ["--lora-scale", str(scale)]
        assert tgen.main(["--checkpoint", ckpt, "--config-overrides", OVERRIDES,
                          "--prompts", str(tmp_path / "p.jsonl"), "--output", str(out),
                          "--max-new-tokens", str(NEW), "--device", "cpu", *flags]) == 0
        got = json.loads(out.read_text())["tokens"]
        want = tlora.rewrap_lora(one, 1.0 if scale is None else scale)
        assert got == _alone(want if scale != 0.0 else base, PROMPTS[1])
    params = tgen._load_params(ckpt, CFG, 0.5)
    assert float(params["layers.0.mlp.up_proj.weight_lora_scale"]) == 0.5


@pytest.mark.parametrize("stored", [True, False])
def test_a_stored_lora_scale_survives_save_and_load(weights, tmp_path, stored):
    """An adapter fine-tuned at alpha = 2·rank keeps its scale 2.0 through a
    checkpoint: ``generate_text`` and ``serve_model`` decode it at the stored
    scale when no flag is given. A set that stores no scale (the JAX
    package's checkpoint form) gets 1.0."""
    base, _, _ = weights
    one = _adapter(base, 6)
    for name in tlora.lora_names(one):
        one[name + tlora.S] = torch.tensor(2.0)
    saved = one if stored else {n: t for n, t in one.items() if not n.endswith(tlora.S)}
    ckpt = save_checkpoint(str(tmp_path / "one"), {"params": saved})
    want_scale = 2.0 if stored else 1.0
    params = tgen._load_params(ckpt, CFG)
    scales = {float(params[n + tlora.S]) for n in tlora.lora_names(params)}
    assert scales == {want_scale}
    want = _alone(tlora.rewrap_lora(one, want_scale), PROMPTS[1])
    assert want != _alone(tlora.rewrap_lora(one, 3.0 - want_scale), PROMPTS[1])
    (tmp_path / "p.jsonl").write_text(json.dumps({"tokens": PROMPTS[1]}) + "\n")
    out = tmp_path / "out.jsonl"
    assert tgen.main(["--checkpoint", ckpt, "--config-overrides", OVERRIDES,
                      "--prompts", str(tmp_path / "p.jsonl"), "--output", str(out),
                      "--max-new-tokens", str(NEW), "--device", "cpu"]) == 0
    assert json.loads(out.read_text())["tokens"] == want
    _, _, load = tserve._load_model(dict(checkpoint=ckpt, model="tiny",
                                         config_overrides=OVERRIDES, device="cpu"))
    got = tllama.generate(load(), torch.tensor([PROMPTS[1]]), NEW)[0].tolist()
    assert got == want


@pytest.mark.parametrize("case", ["fp32_base", "bf16", "bf16_fp32_scales"])
def test_engine_construction_holds_leaves_to_the_model_dtype(weights, case):
    """A weight set given at construction is held to the model's dtype: an
    fp32 set on a bf16 engine is refused (it would hold twice the memory and
    every bf16 swap after it would be refused); int8 codes and fp32 scales
    are accepted as they are."""
    from tensorflowonspark_tpu_torch.serving import WeightsIncompatible

    base, _, _ = weights
    cfg16 = tllama.LlamaConfig.tiny(remat=False, dtype=torch.bfloat16, max_seq_len=64,
                                    attention_impl="xla")
    model = tllama.Llama(cfg16, device="cpu")
    q = tquant.quantize_tree(base, min_size=1 << 14)
    if case == "fp32_base":
        with pytest.raises(WeightsIncompatible, match="float32"):
            ContinuousBatcher(model, params=base, slots=1, prompt_widths=(8,))
        return
    params = {n: t.to(torch.bfloat16) if t.is_floating_point() and not (
        case == "bf16_fp32_scales" and n.endswith(tquant.SCALE)) else t for n, t in q.items()}
    eng = ContinuousBatcher(model, params=params, slots=1, prompt_widths=(8,))
    try:
        held = eng._params
        assert {n: t.dtype for n, t in held.items()} == {n: t.dtype for n, t in params.items()}
        eng.swap_weights(params, version="v1")
        assert eng.weights_version == "v1"
    finally:
        eng.close()
