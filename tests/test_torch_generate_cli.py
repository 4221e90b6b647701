"""The port's ``tools/generate_text.py`` against the JAX package's, and the
example's ``--generate``.

The JAX package's tiny fp32 Llama (vocab 256, hidden 128, 2 layers, max_seq_len
128) writes its initial weights through ``params_from_jax`` into a checkpoint
of the port's ``compute/checkpoint.py``; the port's CLI decodes and scores
from it on the CPU (``--device cpu``) and JAX's ``decode_batches`` /
``build_score_fn`` run on the same weights. Greedy completions (trimmed at
eos) must be identical; ``--score`` logprobs agree to 1e-4 absolute (fp32,
two attention implementations summing in other orders).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import llama as jllama
from tensorflowonspark_tpu.tools import generate_text as jgen
from tensorflowonspark_tpu_torch.compute import TrainState, adamw
from tensorflowonspark_tpu_torch.compute.checkpoint import CheckpointManager, save_checkpoint
from tensorflowonspark_tpu_torch.models.convert import params_from_jax
from tensorflowonspark_tpu_torch.tools import generate_text as tgen

ROOT = Path(__file__).resolve().parent.parent
SCORE_ATOL = 1e-4
OVERRIDES = '{"dtype": "float32"}'
PROMPTS = [[5, 9, 3, 7, 1, 2], [200, 4], [17, 18, 19, 20], [250]]
NEW = 10


@pytest.fixture(scope="module")
def weights():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, attention_impl="xla")
    model = jllama.Llama(jcfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params, params_from_jax(jax.tree.map(np.asarray, params))


def _write_jsonl(path, rows):
    path.write_text("".join(json.dumps({"tokens": r}) + "\n" for r in rows))


def _read_jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _checkpoint(tmp_path, port_params, kind="params"):
    if kind == "manager":
        state = TrainState.create(port_params, adamw(1e-3))
        with CheckpointManager(str(tmp_path / "ckpt"), async_save=False) as mgr:
            mgr.save(3, state)
        return tmp_path / "ckpt"
    tree = {"params": port_params} if kind == "params" else port_params
    return Path(save_checkpoint(str(tmp_path / "ckpt"), tree))


def _cli(tmp_path, ckpt, *flags, prompts=PROMPTS):
    _write_jsonl(tmp_path / "prompts.jsonl", prompts)
    out = tmp_path / "out.jsonl"
    argv = ["--checkpoint", str(ckpt), "--model", "tiny", "--config-overrides", OVERRIDES,
            "--prompts", str(tmp_path / "prompts.jsonl"), "--output", str(out),
            "--device", "cpu", *flags]
    assert tgen.main(argv) == 0
    return _read_jsonl(out)


def _jax_decode(weights, prompts, eos_id=None, batch_size=8):
    model, params, _ = weights
    width = max(len(p) for p in prompts)
    out, _ = jgen.decode_batches(model, params, prompts, batch_size=batch_size, width=width,
                                 max_new_tokens=NEW, rng=jax.random.PRNGKey(0), eos_id=eos_id)
    return out


@pytest.mark.parametrize("kind", ["params", "manager", "bare"])
def test_cli_decodes_as_jax_decode_batches(tmp_path, weights, kind):
    """Mixed-length prompts in chunks of 3 (the last chunk padded by
    repetition), greedy, from each checkpoint layout the tool reads."""
    ckpt = _checkpoint(tmp_path, weights[2], kind)
    got = _cli(tmp_path, ckpt, "--max-new-tokens", str(NEW), "--batch-size", "3")
    assert [r["tokens"] for r in got] == _jax_decode(weights, PROMPTS, batch_size=3)


def test_cli_eos_completions_match_jax(tmp_path, weights):
    """With ``--eos-id`` each completion is trimmed after its first eos, as
    the JAX package's."""
    plain = _jax_decode(weights, PROMPTS)
    eos = plain[0][3]
    want = _jax_decode(weights, PROMPTS, eos_id=eos)
    assert len(want[0]) == plain[0].index(eos) + 1 < NEW and want != plain
    got = _cli(tmp_path, _checkpoint(tmp_path, weights[2]), "--max-new-tokens", str(NEW),
               "--eos-id", str(eos))
    assert [r["tokens"] for r in got] == want


def test_cli_score_matches_jax_build_score_fn(tmp_path, weights):
    model, params, port = weights
    seqs = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1], [8, 2, 8, 1, 8]]
    got = _cli(tmp_path, _checkpoint(tmp_path, port), "--score", "--batch-size", "2",
               prompts=seqs)
    score = jgen.build_score_fn(model, params, width=8, bsz=2)
    want = score(seqs[:2]) + score(seqs[2:])
    assert len(got) == 3
    for row, ref in zip(got, want):
        np.testing.assert_allclose(row["logprobs"], ref, rtol=0, atol=SCORE_ATOL)
        assert row["total"] == pytest.approx(sum(row["logprobs"]))


def test_cli_runs_as_a_module(tmp_path, weights):
    """``python -m tensorflowonspark_tpu_torch.tools.generate_text`` in a
    fresh process on the CPU gives the in-process completions."""
    ckpt = _checkpoint(tmp_path, weights[2])
    want = _cli(tmp_path, ckpt, "--max-new-tokens", "4")
    out = tmp_path / "sub.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "tensorflowonspark_tpu_torch.tools.generate_text",
         "--checkpoint", str(ckpt), "--config-overrides", OVERRIDES, "--prompts",
         str(tmp_path / "prompts.jsonl"), "--output", str(out), "--max-new-tokens", "4",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert _read_jsonl(out) == want


UNPORTED = [
    (["--mesh", "data=2"], "ROADMAP A9b"),
    (["--draft-checkpoint", "draft/"], "ROADMAP A10"),
    (["--draft-model", "tiny"], "ROADMAP A10"),
    (["--draft-config-overrides", "{}"], "ROADMAP A10"),
    (["--spec-k", "4"], "ROADMAP A10"),
]


@pytest.mark.parametrize("flags,item", UNPORTED, ids=[f[0] for f, _ in UNPORTED])
def test_unported_flags_raise(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        tgen.main(["--checkpoint", str(tmp_path), "--prompts", "p", "--output", "o", *flags])


@pytest.mark.parametrize("leaf,what", [({"q": torch.zeros(2, dtype=torch.int8),
                                         "scale": torch.ones(2)}, "int8 weights"),
                                        ({"base": torch.zeros(2, 2), "a": torch.zeros(2, 1),
                                          "b": torch.zeros(1, 2)}, "LoRA adapters")],
                         ids=["int8", "lora"])
def test_int8_and_lora_checkpoints_raise(tmp_path, weights, leaf, what):
    """int8 and LoRA weights load in the port's own form (flat entries
    beside the weight, ``tests/test_torch_lora_serving.py``); the JAX
    package's node dicts nested under a weight's name are no port weight
    set and raise, naming the leaf."""
    port = dict(weights[2])
    port["layers.0.attn.q_proj.weight"] = leaf
    ckpt = _checkpoint(tmp_path, port)
    cfg = tgen._load_config(tgen.build_parser().parse_args(
        ["--checkpoint", "x", "--prompts", "p", "--output", "o"]))
    with pytest.raises(ValueError, match="q_proj.weight is not a tensor"):
        tgen._load_params(str(ckpt), cfg)


def test_params_cast_once_to_the_compute_dtype(tmp_path, weights):
    """The restored fp32 weights come back in cfg.dtype (bf16 here) and the
    model holds them so: no per-call cast from fp32 in the projections."""
    ckpt = _checkpoint(tmp_path, weights[2], "manager")
    cfg = tgen._load_config(tgen.build_parser().parse_args(
        ["--checkpoint", "x", "--prompts", "p", "--output", "o"]))
    assert cfg.dtype == torch.bfloat16
    params = tgen._load_params(str(ckpt), cfg)
    assert {t.dtype for t in params.values()} == {torch.bfloat16}
    model = tgen.load_model(cfg, params, "cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    for name, p in model.named_parameters():
        assert torch.equal(p, weights[2][name].to(torch.bfloat16)), name


def test_cli_defaults_to_cuda(tmp_path, weights, monkeypatch):
    ckpt = _checkpoint(tmp_path, weights[2])
    _write_jsonl(tmp_path / "p.jsonl", PROMPTS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main(["--checkpoint", str(ckpt), "--prompts", str(tmp_path / "p.jsonl"),
                   "--output", str(tmp_path / "o.jsonl")])


@pytest.mark.parametrize("rows,match", [([], "no prompts given"), ([[1], []], r"rows \[1\]"),
                                        ([[1] * 9], "exceed the decode width")])
def test_decode_prompt_errors(weights, rows, match):
    cfg = tgen._load_config(tgen.build_parser().parse_args(
        ["--checkpoint", "x", "--prompts", "p", "--output", "o", "--config-overrides",
         OVERRIDES]))
    model = tgen.load_model(cfg, weights[2], "cpu")
    with pytest.raises(tgen.PromptError, match=match):
        tgen.decode_batches(model, rows, batch_size=2, width=8, max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A9b"):
        tgen.decode_batches(model, [[1]], batch_size=2, width=8, max_new_tokens=2,
                            mesh=object())


@pytest.mark.parametrize("rows,match", [([], "non-empty"), ([[1, 2]] * 3, "at most 2"),
                                        ([[1]], ">= 2 tokens"), ([[1] * 9], "exceeds"),
                                        ([[1, 300]], "outside the vocabulary")])
def test_score_errors(weights, rows, match):
    cfg = dataclasses.replace(tgen._load_config(tgen.build_parser().parse_args(
        ["--checkpoint", "x", "--prompts", "p", "--output", "o"])), dtype=torch.float32)
    score = tgen.build_score_fn(tgen.load_model(cfg, weights[2], "cpu"), width=8, bsz=2)
    with pytest.raises(tgen.PromptError, match=match):
        score(rows)


def test_example_generates_after_training(capfd):
    """The example's ``--generate``: one CPU node trains a step, then the
    chief decodes after the seeded (2, 8) prompt and prints the JAX
    example's line."""
    from tensorflowonspark_tpu_torch.cluster import tfcluster
    from tensorflowonspark_tpu_torch.cluster.tfcluster import InputMode
    from tensorflowonspark_tpu_torch.examples import llama_fsdp
    from tensorflowonspark_tpu_torch.utils.util import cpu_only_env

    args = llama_fsdp.parse_args(["--cpu", "--steps", "1", "--seq", "16", "--batch-size", "2",
                                  "--generate", "6"])
    cluster = tfcluster.run(llama_fsdp.main_fun, args, num_executors=1,
                            input_mode=InputMode.TENSORFLOW, distributed=True,
                            reservation_timeout=120,
                            env={**cpu_only_env(), "OMP_NUM_THREADS": "1"})
    cluster.shutdown(timeout=300)
    out = capfd.readouterr().out
    assert "generated 6.0 tokens/seq (KV-cache decode)" in out


def test_example_refuses_generate_on_a_wider_mesh():
    from tensorflowonspark_tpu_torch.examples import llama_fsdp

    args = llama_fsdp.parse_args(["--cpu", "--generate", "4"])
    llama_fsdp._refuse_unported(args, world=1)
    with pytest.raises(NotImplementedError, match="ROADMAP A9b"):
        llama_fsdp._refuse_unported(args, world=2)
    # --quantize-decode and --lora-rank are ported: nothing refuses them
    for flags in (["--quantize-decode"], ["--lora-rank", "4"]):
        llama_fsdp._refuse_unported(llama_fsdp.parse_args(["--cpu", "--generate", "4", *flags]))
