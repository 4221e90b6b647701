"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, calls no finished attention or BatchNorm kernel, and its entry
points run on CUDA unless told otherwise."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "tensorflowonspark_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tensorflowonspark_tpu")


def _port_files():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 5
    return files


def _forbidden(module: str) -> bool:
    # exact name or a submodule: "tensorflowonspark_tpu_torch" is not a match
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_rule_matches_exact_names():
    assert _forbidden("jax.numpy") and _forbidden("tensorflowonspark_tpu.ops")
    assert _forbidden("tensorflowonspark_tpu")
    assert not _forbidden("tensorflowonspark_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import tensorflowonspark_tpu_torch, tensorflowonspark_tpu_torch.models.llama\n"
        "import tensorflowonspark_tpu_torch.compute.train, tensorflowonspark_tpu_torch.ops.attention\n"
        "import tensorflowonspark_tpu_torch.models.convert\n"
        "import tensorflowonspark_tpu_torch.models.resnet, tensorflowonspark_tpu_torch.models.vgg\n"
        "import tensorflowonspark_tpu_torch.models.inception, tensorflowonspark_tpu_torch.models.conv\n"
        "import tensorflowonspark_tpu_torch.ops.batch_norm, tensorflowonspark_tpu_torch.ops.bn_kernels\n"
        "import tensorflowonspark_tpu_torch.compute.optim\n"
        "import tensorflowonspark_tpu_torch.compute.mesh, tensorflowonspark_tpu_torch.compute.layout\n"
        "import tensorflowonspark_tpu_torch.parallel, tensorflowonspark_tpu_torch.compute.checkpoint\n"
        "import tensorflowonspark_tpu_torch.feed.prefetch, tensorflowonspark_tpu_torch.cluster.context\n"
        "import tensorflowonspark_tpu_torch.tools.generate_text\n"
        "import tensorflowonspark_tpu_torch.serving.engine, tensorflowonspark_tpu_torch.serving\n"
        "import tensorflowonspark_tpu_torch.tools.serve_model\n"
        "import tensorflowonspark_tpu_torch.serving.fleet, tensorflowonspark_tpu_torch.serving.router\n"
        "import tensorflowonspark_tpu_torch.cachetier, tensorflowonspark_tpu_torch.cachetier.prefix\n"
        "import tensorflowonspark_tpu_torch.cachetier.service, tensorflowonspark_tpu_torch.cachetier.frames\n"
        "import tensorflowonspark_tpu_torch.models.zoo, tensorflowonspark_tpu_torch.models.vit\n"
        "import tensorflowonspark_tpu_torch.models.bert, tensorflowonspark_tpu_torch.models.unet\n"
        "import tensorflowonspark_tpu_torch.models.mnist\n"
        "import tensorflowonspark_tpu_torch.examples.resnet_imagenet\n"
        "import tensorflowonspark_tpu_torch.examples.mnist_spark\n"
        "import tensorflowonspark_tpu_torch.examples.unet_segmentation\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("word", ["scaled_dot_product_attention", "torch.compile", "cudnn",
                                  "flash_attn", "F.batch_norm", "functional.batch_norm",
                                  "torch.batch_norm", "BatchNorm2d", "native_batch_norm",
                                  "batch_norm_backward_reduce"])
def test_no_finished_kernels(word):
    for path in PACKAGE.rglob("*"):
        if path.suffix in (".py", ".cu", ".cuh") and "build" not in path.parts:
            assert word not in path.read_text(), f"{path} names {word}"


def test_entry_points_default_to_cuda(monkeypatch):
    """With no CUDA device and no ``device``, the entry points raise; with
    ``device='cpu'`` they run there."""
    from tensorflowonspark_tpu_torch import resolve_device
    from tensorflowonspark_tpu_torch.compute import (
        adamw,
        build_bn_train_step,
        build_eval_step,
        build_train_step,
        sgd,
    )
    from tensorflowonspark_tpu_torch.models.inception import InceptionConfig, InceptionV3
    from tensorflowonspark_tpu_torch.models.llama import Llama, LlamaConfig
    from tensorflowonspark_tpu_torch.models.resnet import ResNet, ResNetConfig
    from tensorflowonspark_tpu_torch.models.vgg import VGG, VGGConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny(num_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Llama(cfg)
    for build, conf in ((ResNet, ResNetConfig.tiny()), (VGG, VGGConfig.tiny()),
                        (InceptionV3, InceptionConfig.tiny())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(conf)
        assert next(build(conf, device="cpu").parameters()).device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(lambda p, b: None, adamw())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_bn_train_step(lambda p, s, b: None, sgd(0.1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_eval_step(lambda p, b: None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert Llama(cfg, device="cpu").device == torch.device("cpu")
    # the server resolves its device before it reads the checkpoint
    from tensorflowonspark_tpu_torch.serving import ContinuousBatcher
    from tensorflowonspark_tpu_torch.tools import serve_model

    for engine in ("fixed", "continuous"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_model.make_server(None, port=0, gen={"checkpoint": "/nonexistent",
                                                       "model": "tiny", "engine": engine})
    eng = ContinuousBatcher(Llama(cfg, device="cpu"), slots=1, prompt_widths=(4,))
    try:
        assert eng.submit([1, 2], 2) and eng._state.tok.device == torch.device("cpu")
    finally:
        eng.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")


def test_kernel_build_is_lazy_and_keyed_on_source():
    """Importing the ops builds nothing; the library name follows the
    source's content, so an edited source never loads a stale build."""
    from tensorflowonspark_tpu_torch.ops import _build

    for name in ("flash_attention", "bn_stats"):
        path = _build.library_path(name)
        assert path.parent == PACKAGE / "csrc" / "build"
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == ["bn_stats.cu", "flash_attention.cu"]
    gitignore = (ROOT / ".gitignore").read_text().split()
    assert "tensorflowonspark_tpu_torch/csrc/build/" in gitignore


def test_kernel_build_is_keyed_on_headers(monkeypatch, tmp_path):
    """An edit to a csrc/*.cuh header changes the library's path, so a
    source that includes it never loads a build of the old header."""
    from tensorflowonspark_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "a.cuh"\n')
    (csrc / "a.cuh").write_text("// one\n")
    (csrc / "b.cuh").write_text("// two\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", csrc / "build")
    first = _build.library_path("k")
    assert first.parent == csrc / "build" and _build.library_path("k") == first
    (csrc / "a.cuh").write_text("// one, edited\n")
    second = _build.library_path("k")
    assert second != first
    (csrc / "b.cuh").write_text("// two, edited\n")
    assert _build.library_path("k") not in (first, second)
    (csrc / "c.cuh").write_text("")
    assert _build.library_path("k") not in (first, second)


def test_profile_kinds_name_every_kernel():
    """chip_smoke's profile puts every kernel of the port's CUDA sources
    under its own kind, by the name the profiler prints for it."""
    smoke = _import_root_module("chip_smoke")
    names = []
    for path in sorted((PACKAGE / "csrc").glob("*.cu")):
        names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                            path.read_text())
    assert {"fwd_wgmma_kernel", "dq_wgmma_kernel", "dkv_wgmma_kernel", "fwd_kernel", "dq_kernel",
            "dkv_kernel", "stats_partial_kernel", "stats_finalize_kernel"} <= set(names)
    for name in names:
        printed = f"void (anonymous namespace)::{name}<128>((anonymous namespace)::Args)"
        want = "bn_stats" if name.startswith("stats_") else "flash"
        assert smoke.kind_of_kernel(printed) == want, name


def _body(source: str, signature: str) -> str:
    """The brace-delimited body that follows the first match of ``signature``."""
    start = source.index("{", re.search(signature, source).end())
    depth = 0
    for i in range(start, len(source)):
        depth += {"{": 1, "}": -1}.get(source[i], 0)
        if depth == 0:
            return source[start:i + 1]
    raise AssertionError(f"unbalanced body after {signature}")


def test_bf16_dispatch_runs_only_hopper_kernels():
    """Static guard of the bf16 flash dispatch, whose kernels run only on
    the card: dQ goes to the wgmma kernel, no mma.sync instruction is left,
    and every kernel the bf16 dispatch reaches is launched with the
    producer/consumer block of HOPPER_THREADS."""
    source = (PACKAGE / "csrc" / "flash_attention.cu").read_text()
    dispatch = _body(source, r"int dispatch_bf16\(")
    cases = dict(re.findall(r"case (\w+): return (\w+)<D>\(", dispatch))
    assert cases == {"FWD": "launch_fwd_wgmma", "DQ": "launch_dq_wgmma",
                     "DKV": "launch_dkv_wgmma"}
    assert "mma.sync" not in source and "dq_mma_kernel" not in source
    launch_hopper = _body(source, r"int launch_hopper\(")
    assert "<<<grid, HOPPER_THREADS, smem," in launch_hopper
    for launcher in cases.values():
        body = _body(source, rf"int {launcher}\(")
        kernels = re.findall(r"return launch_hopper\((\w+)<D>,", body)
        assert len(kernels) == 1, launcher
        assert re.search(rf"__global__ void __launch_bounds__\(HOPPER_THREADS, 1\)\s+"
                         rf"{kernels[0]}\(", source), kernels[0]
    assert source.count("<<<") == 2  # launch_hopper's and the fp32 kernels' launch


@pytest.mark.parametrize("rc, message", [(-1, "unsupported dtype or head dim"),
                                         (-2, "TMA tensor map could not be encoded"),
                                         (700, "CUDA error 700")])
def test_refused_launch_raises(monkeypatch, rc, message):
    """A launch the C entry point refuses raises with its reason: there is
    no fallback to the plain version."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(fa, "_kernels", lambda: {"tfos_flash_fwd": lambda *args: rc})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("S", (), {"cuda_stream": 0}))
    with pytest.raises(RuntimeError, match=f"tfos_flash_fwd failed to launch: {message}"):
        fa._launch("tfos_flash_fwd", 0, 0)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from tensorflowonspark_tpu_torch.ops import _build

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.touch()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    assert _build.nvcc_path() == str(fake)


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """chip_smoke.py alone, with no CUDA device, exits non-zero and prints
    no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _import_root_module(name):
    sys.path.insert(0, str(ROOT))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(ROOT))


def test_chip_smoke_conv_helpers_rehearse_on_cpu(monkeypatch):
    """chip_smoke's batch-norm and conv helpers run on the CPU at small
    sizes: its table of ResNet-50's BatchNorm shapes and the MAC count come
    out of the model, a statistics check passes on the plain versions, and
    a tiny ResNet trains and resets to the same trajectory."""
    from tensorflowonspark_tpu_torch.models.resnet import ResNet, ResNetConfig, loss_fn
    from tensorflowonspark_tpu_torch.ops import bn_kernels

    smoke = _import_root_module("chip_smoke")
    monkeypatch.setattr(smoke, "DEVICE", "cpu")
    shapes, macs = smoke.conv_shapes(ResNet(ResNetConfig.resnet50(dtype=torch.float32),
                                            device="cpu"), 224)
    counts = {}
    for rows, c in shapes:
        counts[(rows * 256, c)] = counts.get((rows * 256, c), 0) + 1
    assert sorted((r, c, n) for (r, c), n in counts.items()) == sorted(smoke.RESNET50_BN)
    assert macs == 4_089_184_256
    x, dy = smoke.bn_inputs(1000, 64, torch.bfloat16, seed=0, offset=1, tail=8)
    assert x.data_ptr() % 16 and smoke.check_bn_case(bn_kernels, "cpu", x, dy) == 0.0
    model = ResNet(ResNetConfig.tiny(), device="cpu")
    run = smoke.ConvRun(model, loss_fn(model), smoke.image_batch(4, 32, 10))
    losses, _ = run.steps(3)
    run.reset()
    again, _ = run.steps(3)
    assert losses == again and losses[-1] < losses[0]


def test_chip_smoke_cluster_phase_rehearses_on_cpu(capsys):
    """chip_smoke's phase cluster runs on the CPU at a tiny size (a tiny
    fp32 Llama, a gloo group of one, the prefetcher on the CPU): every
    batch matches its checksum, the restored state equals the saved one
    bit for bit, and the next-step losses agree exactly."""
    smoke = _import_root_module("chip_smoke")
    smoke.phase_cluster(rehearse={"device": "cpu", "tiny": True, "sizes": {
        "batch": 2, "seq": 32, "vocab": 256, "stress": 4, "steps": 2, "depth": 2, "lr": 1e-2}})
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    check = lines[-1]
    assert check["case"] == "cluster_checks" and check["ok"]
    assert check["err"]["bad_batches"] == 0 and check["err"]["batches_checked"] == 12
    assert lines[-2]["backend"] == "gloo" and lines[-2]["checkpoint"]["n_unequal"] == 0


def test_chip_smoke_mesh_phase_rehearses_on_cpu(capsys):
    """chip_smoke's phase mesh runs on the CPU at a tiny size (a gloo group
    of one, the wrappers' plain versions): the mesh routes are taken, and
    the node's sharded checkpoint restores bit for bit."""
    from tensorflowonspark_tpu_torch.ops import bn_kernels
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    smoke = _import_root_module("chip_smoke")
    smoke.phase_mesh(fa, bn_kernels, rehearse={"device": "cpu", "sizes": {
        "batch": 2, "seq": 32, "vocab": 256, "steps": 2, "conv_batch": 4, "conv_steps": 2,
        "lr": 1e-2, "depth": 2, "update_calls": 2}})
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    checks = {x["case"]: x for x in lines if "case" in x}
    assert sorted(checks) == ["llama_mesh_step", "mesh_node", "resnet_mesh_step"]
    assert all(x["ok"] for x in checks.values())
    assert checks["llama_mesh_step"]["err"]["attention_routes"] == 8
    assert checks["mesh_node"]["err"]["restored_unequal"] == 0
    assert not torch.distributed.is_initialized()


def test_chip_smoke_elastic_phase_rehearses_on_cpu(capsys):
    """chip_smoke's phase elastic runs on the CPU at a tiny size: a node is
    SIGKILLed, the survivor reshards, a replacement hydrates from it, the
    survivor's checkpoint fallback rewinds, and both end bit-equal to the
    uninterrupted run."""
    smoke = _import_root_module("chip_smoke")
    flash, bn = smoke.phase_elastic(rehearse={"device": "cpu", "tiny": True, "sizes": {
        "batch": 2, "seq": 32, "vocab": 256, "lr": 1e-2, "wait_s": 60.0, "grace": 3.0}})
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    check = lines[-1]
    assert check["case"] == "elastic_checks" and check["ok"]
    assert check["err"]["unequal"] == {"0": 0, "1": 0}
    assert check["err"]["joiner"]["hydrate"] == "peer_hydrate"
    assert flash == {"fwd": 0, "dq": 0, "dkv": 0} and bn == {"pair": 0, "cross": 0}


def test_chip_smoke_decode_phase_rehearses_on_cpu(capsys):
    """chip_smoke's phase decode runs on the CPU at a tiny size (bf16, the
    wrappers' plain versions): every check of (attn) and (a)-(g) passes, the
    CLI runs as two subprocesses on the CPU, and no kernel is launched."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    smoke = _import_root_module("chip_smoke")
    launches = smoke.phase_decode(fa, layers=2, rehearse={"device": "cpu", "tiny": True, "sizes": {
        "batch": 4, "width": 16, "min_len": 4, "new": 32, "int8_steps": 4, "roll_batch": 2,
        "roll_window": 8, "roll_cache": 16, "roll_prompt": 8, "roll_new": 12,
        "score_width": 17}})
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    check = lines[-1]
    assert check["case"] == "decode_checks" and check["ok"]
    assert sorted(check["checks"]) == ["attention", "cli", "eos", "int8", "mixed", "rolling",
                                       "score"]
    assert check["err"]["mixed"]["capture_equals_generate"]
    assert check["err"]["eos"]["steps_run"] < check["err"]["eos"]["max_steps"]
    assert check["err"]["cli"]["completion_mismatches"] == 0
    assert check["err"]["int8"]["cache_bytes_int8"] < check["err"]["int8"]["cache_bytes_bf16"]
    assert launches == {"fwd": 0, "dq": 0, "dkv": 0, "pair": 0, "cross": 0}


def test_chip_smoke_serve_phase_rehearses_on_cpu(capsys):
    """chip_smoke's phase serve runs on the CPU at a tiny size: every
    check of the sampler and (a)-(e) passes — the engine against
    generate() alone and a teacher-forced forward, its replays token for
    token, chunked prefill with prefix hits, the server in process and as
    a process on the CPU — and no kernel is launched."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    smoke = _import_root_module("chip_smoke")
    launches = smoke.phase_serve(fa, layers=2, rehearse={"device": "cpu", "tiny": True, "sizes": {
        "requests": 5, "sampled": 2, "threads": 3, "min_len": 4, "max_len": 30, "min_new": 4,
        "max_new": 12, "sampled_new": (4, 8), "widths": (8, 16, 32), "slots": 3, "block": 4,
        "stagger": 0.01, "alone": 2, "alone_new": 24, "chunk": 8, "prefix": 4, "system": 16,
        "chunk_new": 6, "timing_prompt": 8, "timing_new": 9, "profile_new": 9, "fixed_new": 6,
        "port_wait_s": 120.0, "budget": 24}})
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    check = lines[-1]
    assert check["case"] == "serve_checks" and check["ok"]
    assert sorted(check["checks"]) == ["chunked", "http", "identity", "process", "sampler",
                                       "staggered"]
    assert check["err"]["staggered"]["stops_hit"] >= 1
    assert check["err"]["chunked"]["prefix"]["prefix_hits"] >= 2
    assert lines[-2]["part"] == "numbers" and lines[-2]["sync_warnings"] == 0
    assert launches == {"fwd": 0, "dq": 0, "dkv": 0, "pair": 0, "cross": 0}


def test_chip_smoke_fleet_phase_rehearses_on_cpu(capsys):
    """chip_smoke's phase fleet runs on the CPU at a tiny size: every check
    of (a)-(e) passes — the in-process fleet against one engine, the L2
    across replicas, the filler's ordering and the cache server's close
    race, a dropped dispatch and a wedged replica under traffic, the
    subprocess fleet with its daemon (a child and the daemon SIGKILLed and
    respawned) and the server with two replicas and the daemon L2 — and no
    kernel is launched."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    smoke = _import_root_module("chip_smoke")
    launches = smoke.phase_fleet(fa, layers=2, rehearse={"device": "cpu", "tiny": True, "sizes": {
        "requests": 5, "sampled": 2, "threads": 3, "min_len": 4, "max_len": 30, "min_new": 4,
        "max_new": 12, "sampled_new": (4, 8), "widths": (8, 16, 32), "slots": 3, "block": 4,
        "stagger": 0.01, "alone": 2, "alone_new": 24, "chunk": 8, "prefix": 4,
        "budget": 24, "l2_prompt": 24, "l2_tail": 4,
        "l2_new": 6, "wedge_s": 5.0, "watchdog_s": 2.0, "probe_s": 0.2, "drain_s": 20.0,
        "spawn_wait_s": 120.0, "ready_wait_s": 120.0, "server_requests": 2, "post_kill": 2}})
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    check = lines[-1]
    assert check["case"] == "fleet_checks" and check["ok"]
    assert sorted(check["checks"]) == ["a_inproc", "b_l2", "c_failover", "close_race", "d_spawn",
                                       "e_server", "l2_filler_ordering", "l2_syncs"]
    assert check["err"]["b_l2"]["replica1_l2_hits"] >= 1
    assert check["err"]["d_spawn"]["daemon"]["respawns"] >= 1
    assert lines[-2]["part"] == "numbers"
    assert launches == {"fwd": 0, "dq": 0, "dkv": 0, "pair": 0, "cross": 0}


def test_chip_smoke_lora_phase_rehearses_on_cpu(capsys):
    """chip_smoke's phase lora runs on the CPU at a tiny size: every check
    of (a)-(e) passes — the adapters' fine-tune with its frozen base, the
    merged int8 decode against bf16 and the example through tfcluster.run,
    the bank's routing and serving and its prefix isolation, the
    adapters-only swap and the lora rollout across a fleet, the server over
    a bank checkpoint — and no kernel is launched."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    smoke = _import_root_module("chip_smoke")
    launches = smoke.phase_lora(fa, layers=2, rehearse={"device": "cpu", "tiny": True, "sizes": {
        "rank": 4, "batch": 2, "seq": 64, "steps": 4, "dec_batch": 2, "dec_min": 8,
        "dec_width": 32, "dec_new": 8, "time_prompt": 8, "time_steps": 2,
        "example_args": ["--steps", "2", "--seq", "32", "--batch-size", "2", "--lora-rank", "4",
                         "--generate", "4", "--quantize-decode"],
        "requests": 8, "threads": 4, "min_len": 4, "max_len": 30, "min_new": 4, "max_new": 8,
        "widths": (16, 32), "slots": 4, "block": 2, "chunk": 8, "prefix": 4, "prefix_prompt": 20,
        "route_rows": 4, "route_len": 16, "roll_requests": 4, "roll_threads": 2, "roll_new": 6,
        "budget": 16, "score_rows": 2, "quant_min": 1 << 12}})
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    check = lines[-1]
    assert check["case"] == "lora_checks" and check["ok"], check
    assert sorted(check["checks"]) == ["a_train", "b_example", "b_int8", "c_bank_rows", "c_prefix",
                                       "c_serve", "d_fleet", "d_prior_intact", "d_swap",
                                       "e_server"]
    assert check["err"]["a_train"]["frozen_no_grad"]
    assert check["err"]["c_prefix"]["same_adapter_hits"] >= 1
    assert lines[-2]["part"] == "numbers"
    assert launches == {"fwd": 0, "dq": 0, "dkv": 0, "pair": 0, "cross": 0}


def test_chip_smoke_moe_phase_rehearses_on_cpu(capsys):
    """chip_smoke's phase moe runs on the CPU at a tiny size: every check of
    (a)-(d) passes — the MoE train step and its loss against the CPU, one
    block against the plain version at both capacities, decode against a
    teacher-forced forward with the drops counted, the engine — and no
    kernel is launched."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    smoke = _import_root_module("chip_smoke")
    launches = smoke.phase_moe(fa, layers=2, dec_layers=2, eng_layers=2, rehearse={
        "device": "cpu", "tiny": True, "sizes": {
            "batch": 2, "seq": 32, "steps": 2, "block_batch": 1, "block_seq": 32,
            "dec_batch": 3, "dec_width": 24, "dec_min": 8, "dec_new": 6, "eng_widths": (16, 32),
            "eng_requests": 3, "eng_threads": 2, "eng_min": 4, "eng_max": 30, "eng_new": 6,
            "alone_len": 16}})
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    check = lines[-1]
    assert check["case"] == "moe_checks" and check["ok"], check
    assert sorted(check["checks"]) == ["a_loss_cpu", "a_loss_parts", "a_train", "b_block",
                                       "b_block_low_cf", "c_decode", "d_alone", "d_engine"]
    assert check["err"]["b_block_low_cf"]["dropped_share"] > 0
    assert check["err"]["a_loss_cpu"]["aux_sum"] > 100 * check["tol"]["loss_cpu"]
    assert launches == {"fwd": 0, "dq": 0, "dkv": 0, "pair": 0, "cross": 0}


def test_chip_smoke_spec_phase_rehearses_on_cpu(capsys):
    """chip_smoke's phase spec runs on the CPU at a tiny size: greedy
    speculative decoding through the three drafts against plain greedy in
    fp32 and bf16 (the target itself accepting every draft in fp32), the
    rejection rule's distribution, a sampled decode, and serve_model's
    fixed path with a saved draft against the CLI."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    smoke = _import_root_module("chip_smoke")
    smoke.phase_spec(fa, layers=2, rehearse={"device": "cpu", "tiny": True, "sizes": {
        "batch": 3, "width": 24, "min_len": 8, "new": 8, "early_layers": 1, "draft_layers": 1,
        "time_prompt": 8, "time_new": 8, "server_rows": 3}})
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    check = lines[-1]
    assert check["case"] == "spec_checks" and check["ok"], check
    assert sorted(check["checks"]) == ["a_greedy_bf16", "a_greedy_fp32", "b_accept",
                                       "b_sampled", "c_server"]
    assert check["err"]["a_greedy_fp32"]["self"]["accepted_per_verify"] == check["k"]
    assert check["err"]["c_server"]["equal_to_cli"]


FAULTS = ["fwd_no_rescale", "fwd_frontier_unmasked", "dq_drop_last_k_tile", "dq_bulk_3pct",
          "dq_frontier_unmasked", "dk_drop_last_q_tile", "dv_drop_first_q_tile",
          "dkv_frontier_unmasked", "bn_ragged_unmasked", "bn_drop_first_split", "bn_cross_dy_dy",
          "prefetch_no_fence", "ckpt_no_snapshot", "mesh_attention_plain",
          "mesh_restore_skips_opt_state", "mesh_bn_plain", "reshard_drops_opt_state",
          "snapshot_casts_bf16", "hydrate_stale_step", "fallback_no_rewind",
          "heartbeat_ignores_epoch", "elastic_plain_attention", "decode_slot_mask_strict",
          "rolling_pos_init_zero", "int8_drop_v_scale", "first_token_padded_position",
          "eos_not_sticky", "qk_logits_bf16", "admit_wrong_slot", "decode_row0_pos_frozen",
          "block_surplus_emitted", "penalty_after_temperature", "sample_counter_is_step",
          "router_no_failover_before_first_token", "l2_key_without_version",
          "l2_filler_before_event", "cache_close_leaves_conns_open",
          "loader_writes_running_tensors", "publish_keeps_reference", "rollback_skips_restore",
          "latest_crc_unchecked", "bank_gather_off_by_one", "int8_scale_on_input_axis",
          "lora_swap_writes_in_place", "moe_priority_choices_major", "moe_aux_loss_dropped",
          "spec_accepts_past_mismatch"]


@pytest.mark.parametrize("fault", FAULTS)
def test_chip_faults_plants_each_fault_in_the_kernel_source(fault):
    """Each fault of chip_faults.py changes exactly one statement of the
    current source of its kernel, so the fault check keeps up with the
    kernels; each source has a check that chip_smoke.py defines."""
    chip_faults = _import_root_module("chip_faults")
    chip_smoke = _import_root_module("chip_smoke")
    assert sorted(chip_faults.FAULTS) == sorted(FAULTS)
    path = chip_faults.FAULTS[fault][0]
    assert hasattr(chip_smoke, chip_faults.check_of(fault).split("(")[0])
    source = (ROOT / path).read_text()
    faulty = chip_faults.planted(source, fault)
    assert faulty != source
    assert len(faulty.splitlines()) == len(source.splitlines())
    assert chip_faults.planted(source, "none") == source
