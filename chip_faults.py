"""Plant known faults in a copy of the port's CUDA kernels and show that the
kernel checks of ``chip_smoke.py`` refuse each one.

    python3 chip_faults.py        # on a machine with one NVIDIA GPU

For the unchanged sources and for each fault below, the port's package and
``chip_smoke.py`` are copied into a temporary directory, one statement of a
kernel source is changed there, and a child process builds that copy and
runs the check of that source: ``chip_smoke.check_slice`` for
``csrc/flash_attention.cu`` (the three kernels against their plain
versions at the llama_1b training shape, bf16, causal; every flash fault
is in a bf16 kernel, the ones that shape runs: the wgmma forward, dQ and
dK/dV kernels) and
``chip_smoke.check_bn_edges`` for ``csrc/bn_stats.cu`` (both statistics
kernels at the stem shape and the edge cases: ragged rows with poison past
the end, fp32, narrow and misaligned C). The unchanged copy runs both. The
children run at once. Each prints its check lines; this script prints one
JSON line per fault with the readings of the last, and exits non-zero
unless the checks pass the unchanged sources and refuse every fault.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLASH = Path("tensorflowonspark_tpu_torch/csrc/flash_attention.cu")
BN = Path("tensorflowonspark_tpu_torch/csrc/bn_stats.cu")
CHECKS = {FLASH: "check_slice(fa)", BN: "check_bn_edges(bn)"}

# name -> (source, statement as in the source, the faulty statement)
FAULTS = {
    # forward: the O accumulator is not rescaled when the row max grows
    "fwd_no_rescale": (
        FLASH,
        "for (int e = 0; e < NO; ++e) o[e] *= alpha[(e >> 1) & 1];",
        "for (int e = 0; e < NO; ++e) o[e] *= 1.f;",
    ),
    # forward: the tile on the causal frontier takes the unmasked path
    "fwd_frontier_unmasked": (
        FLASH,
        "const bool full_tile = tile_plain(a, qw0, 64, k0, BN) && below_frontier(a, qw0, k0 + BN - 1);",
        "const bool full_tile = tile_plain(a, qw0, 64, k0, BN);",
    ),
    # dQ: the last key tile of each query tile (the causal diagonal of its
    # last 64 rows) is lost
    "dq_drop_last_k_tile": (
        FLASH,
        "for (int kk = 0; kk < NK / 16; ++kk) wgmma_rs(dq, dsf[kk], mn_desc(sK, NK, kk));  // dQ += dS K",
        "if (k0 + NK < k_hi) for (int kk = 0; kk < NK / 16; ++kk) wgmma_rs(dq, dsf[kk], mn_desc(sK, NK, kk));",
    ),
    # dQ: every query tile but the first comes out 3% too large, an error
    # confined to the bulk of the rows, below their largest values
    "dq_bulk_3pct": (
        FLASH,
        "pack_f2(dq[4 * j + 2 * i] * a.scale, dq[4 * j + 2 * i + 1] * a.scale);",
        "pack_f2(dq[4 * j + 2 * i] * a.scale * (q0 >= NQ ? 1.03f : 1.f),"
        " dq[4 * j + 2 * i + 1] * a.scale * (q0 >= NQ ? 1.03f : 1.f));",
    ),
    # dQ: the tile on the causal frontier takes the unmasked path
    "dq_frontier_unmasked": (
        FLASH,
        "const bool full_tile = tile_plain(a, qw0, 64, k0, NK) && below_frontier(a, qw0, k0 + NK - 1);",
        "const bool full_tile = tile_plain(a, qw0, 64, k0, NK);",
    ),
    # dK: the last query tile of each key tile is lost
    "dk_drop_last_q_tile": (
        FLASH,
        "for (int kk = 0; kk < NQ / 16; ++kk) wgmma_rs(dk, dsf[kk], mn_desc(sQ, NQ, kk));  // dK += dS^T Q",
        "if (q0 + NQ < q_hi) for (int kk = 0; kk < NQ / 16; ++kk) wgmma_rs(dk, dsf[kk], mn_desc(sQ, NQ, kk));",
    ),
    # dV: the first query tile of each key tile (the causal diagonal) is lost
    "dv_drop_first_q_tile": (
        FLASH,
        "for (int kk = 0; kk < NQ / 16; ++kk) wgmma_rs(dv, pf[kk], mn_desc(sdO, NQ, kk));  // dV += P^T dO",
        "if (q0 != q_lo) for (int kk = 0; kk < NQ / 16; ++kk) wgmma_rs(dv, pf[kk], mn_desc(sdO, NQ, kk));",
    ),
    # dK/dV: the tile on the causal frontier takes the unmasked path
    "dkv_frontier_unmasked": (
        FLASH,
        "const bool full_tile = tile_plain(a, q0, NQ, wk0, 64) && below_frontier(a, q0, wk0 + 63);",
        "const bool full_tile = tile_plain(a, q0, NQ, wk0, 64);",
    ),
    # both bn kernels: the ragged end of a split is read (rows past the end
    # of the tensor, poison in the check, join the sums)
    "bn_ragged_unmasked": (
        BN,
        "live[u] = live_c && r < r_end;  // the ragged end of the split is masked",
        "live[u] = live_c;",
    ),
    # both bn kernels: the first row split's partial sums are dropped
    "bn_drop_first_split": (
        BN,
        "for (int s = ty; s < splits; s += kFinalY) {  // every split's partial, in a fixed order",
        "for (int s = ty; s < splits; s += kFinalY) { if (s == 0) continue;",
    ),
    # B5: accumulates dy*dy instead of dy*x
    "bn_cross_dy_dy": (
        BN,
        "q[v] += fa[v] * fb[v];",
        "q[v] += fa[v] * fa[v];",
    ),
}

CHILD = """
import os, chip_smoke
from tensorflowonspark_tpu_torch.ops import bn_kernels as bn
from tensorflowonspark_tpu_torch.ops import flash_attention as fa
assert fa.__file__.startswith(os.getcwd()), fa.__file__
"""


def planted(source: str, name: str) -> str:
    """The kernel source with fault ``name`` in it (unchanged for "none")."""
    if name == "none":
        return source
    _, old, new = FAULTS[name]
    if source.count(old) != 1:
        raise ValueError(f"{name}: the statement to change is not in the source once")
    return source.replace(old, new)


def start(name: str, workdir: Path) -> subprocess.Popen:
    copy = workdir / name
    shutil.copytree(ROOT / "tensorflowonspark_tpu_torch", copy / "tensorflowonspark_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", copy)
    sources = list(CHECKS) if name == "none" else [FAULTS[name][0]]
    for source in sources:
        (copy / source).write_text(planted((ROOT / source).read_text(), name))
    code = CHILD + "".join(f"chip_smoke.{CHECKS[source]}\n" for source in sources)
    return subprocess.Popen([sys.executable, "-c", code], cwd=copy, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def check_line(output: str) -> dict | None:
    for line in reversed(output.splitlines()):
        if line.startswith("{") and '"case"' in line:
            return json.loads(line)
    return None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_faults: no CUDA device", file=sys.stderr)
        return 1
    names = ["none", *FAULTS]
    good = True
    with tempfile.TemporaryDirectory() as tmp:
        procs = {n: start(n, Path(tmp)) for n in names}
        for name, proc in procs.items():
            out, _ = proc.communicate(timeout=900)
            line = check_line(out)
            if line is None:
                print(out, file=sys.stderr)
                good = False
                continue
            passed = bool(line["ok"]) and proc.returncode == 0
            good &= passed if name == "none" else not passed
            print(json.dumps({"fault": name, "passed_check": passed, "case": line["case"],
                              "err": line["err"], "lse_err": line.get("lse_err"),
                              "tol": line["tol"]}), flush=True)
    print(json.dumps({"ok": good}))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
