"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, calls no finished attention or BatchNorm kernel, and its entry
points run on CUDA unless told otherwise."""

import ast
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


FAULTS = ["fwd_no_rescale", "fwd_frontier_unmasked", "dq_drop_last_k_tile", "dq_bulk_3pct",
          "dq_frontier_unmasked", "dk_drop_last_q_tile", "dv_drop_first_q_tile",
          "dkv_frontier_unmasked", "bn_ragged_unmasked", "bn_drop_first_split", "bn_cross_dy_dy"]


@pytest.mark.parametrize("fault", FAULTS)
def test_chip_faults_plants_each_fault_in_the_kernel_source(fault):
    """Each fault of chip_faults.py changes exactly one statement of the
    current source of its kernel, so the fault check keeps up with the
    kernels; each source has a check that chip_smoke.py defines."""
    chip_faults = _import_root_module("chip_faults")
    chip_smoke = _import_root_module("chip_smoke")
    assert sorted(chip_faults.FAULTS) == sorted(FAULTS)
    path = chip_faults.FAULTS[fault][0]
    assert hasattr(chip_smoke, chip_faults.CHECKS[path].split("(")[0])
    source = (ROOT / path).read_text()
    faulty = chip_faults.planted(source, fault)
    assert faulty != source
    assert len(faulty.splitlines()) == len(source.splitlines())
    assert chip_faults.planted(source, "none") == source
