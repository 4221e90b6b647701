"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, calls no finished attention kernel, and its entry points run on
CUDA unless told otherwise."""

import ast
import os
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
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("word", ["scaled_dot_product_attention", "torch.compile", "cudnn",
                                  "flash_attn"])
def test_no_finished_kernels(word):
    for path in PACKAGE.rglob("*"):
        if path.suffix in (".py", ".cu", ".cuh") and "build" not in path.parts:
            assert word not in path.read_text(), f"{path} names {word}"


def test_entry_points_default_to_cuda(monkeypatch):
    """With no CUDA device and no ``device``, the entry points raise; with
    ``device='cpu'`` they run there."""
    from tensorflowonspark_tpu_torch import resolve_device
    from tensorflowonspark_tpu_torch.compute import adamw, build_eval_step, build_train_step
    from tensorflowonspark_tpu_torch.models.llama import Llama, LlamaConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny(num_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Llama(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(lambda p, b: None, adamw())
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

    path = _build.library_path("flash_attention")
    assert path.parent == PACKAGE / "csrc" / "build"
    assert path.name.startswith("libflash_attention-") and path.suffix == ".so"
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert [p.name for p in _build.CSRC.glob("*.cu")] == ["flash_attention.cu"]
    gitignore = (ROOT / ".gitignore").read_text().split()
    assert "tensorflowonspark_tpu_torch/csrc/build/" in gitignore


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


@pytest.mark.parametrize("fault", ["fwd_no_rescale", "dq_drop_last_k_tile", "dq_bulk_3pct",
                                   "dk_drop_last_q_tile", "dv_drop_first_q_tile"])
def test_chip_faults_plants_each_fault_in_the_kernel_source(fault):
    """Each fault of chip_faults.py changes exactly one statement of the
    current kernel source, so the fault check keeps up with the kernels."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_faults
    finally:
        sys.path.remove(str(ROOT))
    source = (ROOT / chip_faults.SOURCE).read_text()
    assert sorted(chip_faults.FAULTS) == sorted(
        ["fwd_no_rescale", "dq_drop_last_k_tile", "dq_bulk_3pct", "dk_drop_last_q_tile",
         "dv_drop_first_q_tile"])
    faulty = chip_faults.planted(source, fault)
    assert faulty != source
    assert len(faulty.splitlines()) == len(source.splitlines())
    assert chip_faults.planted(source, "none") == source
