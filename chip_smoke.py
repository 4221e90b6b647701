"""Drive the PyTorch port on one NVIDIA GPU: build, check and time its kernels,
then train llama_1b for a few steps through them.

    python3 chip_smoke.py

Phases (one JSON line each; any failure exits non-zero):

1. device — the card, its power limit, torch/CUDA versions, the kernel build.
2. kernels — each flash-attention kernel (forward, dQ, dK/dV) against its
   plain PyTorch version on the card, element by element and in Frobenius
   norm (limits in ``TOL``), at the llama_1b training shape (B=8, S=1024,
   H=16, D=128, bf16, causal) and at small GQA, sq != sk, dead-row, window
   and segment cases; times of kernel, plain version and
   ``scaled_dot_product_attention`` (a yardstick only: the port never calls
   it), and the bound of each kernel on an H100.
3. train — ``LlamaConfig.llama_1b(remat=False)`` at full depth, batch 8,
   seq 1024, fp32 params, ``adamw(moment_dtype=bf16)``, attention ``auto``:
   one warm-up step, then 5 timed steps on one fixed batch, with the kernel
   launch counts of those 5 steps; and a small model whose logits through
   the kernels must match the plain attention path.
4. profile — two more llama_1b steps under ``torch.profiler``: device busy
   and idle share, device time by kind of kernel and of the weight update,
   and the heaviest kernels.

The last lines are the ``kernels`` summary, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3
SLICE = dict(b=8, s=1024, h=16, d=128)
KERNEL_SOURCE = "tensorflowonspark_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "fwd": "tensorflowonspark_tpu/ops/flash_attention.py:134",
    "dq": "tensorflowonspark_tpu/ops/flash_attention.py:343",
    "dkv": "tensorflowonspark_tpu/ops/flash_attention.py:400",
}
# Each kernel output a against its plain version b, element by element,
# |a - b| <= atol + rtol*|b| with atol = atol_rms * rms(b) (the tensor's own
# scale), and as a whole, rms(a - b) <= frob * rms(b) (the Frobenius-
# relative error). bf16: both sides round the output to bf16 once, which
# leaves them one bf16 step apart (rtol = 2^-7) wherever the values before
# rounding agree to better than a step; the tensor-core kernels also round
# P and dS to bf16 before their products, an error that does not shrink
# with |b| where the sum cancels (atol). fp32 differs only by summation
# order. The limits sit 2.5-5x above the largest readings of the unchanged
# kernels and far below those of the faults that chip_faults.py plants
# (PERF.md, Findings). With inputs of rms 1, a tensor of rms under
# RMS_FLOOR is zero up to rounding (window 1 makes dQ and dK exactly 0),
# and is held at that scale instead of its own.
TOL = {
    torch.bfloat16: dict(rtol=2**-7, atol_rms=1.5e-1, frob=1e-2),
    torch.float32: dict(rtol=1e-5, atol_rms=3e-5, frob=3e-6),
}
RMS_FLOOR = 1e-3
LSE_TOL = 1e-3  # LSE is fp32 on both sides; bf16 inputs only shift the order


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(a, b, rtol) -> dict:
    """How far a is from b, in units of b's rms (at least RMS_FLOOR): the
    least atol_rms that passes at this rtol, and the Frobenius-relative
    error; and max |a - b| and max |b|."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    scale = (b.norm() / math.sqrt(b.numel())).clamp_min(RMS_FLOOR)
    return {
        "atol_rms": ((diff - rtol * b.abs()).max() / scale).clamp_min(0).item(),
        "frob": (diff.norm() / math.sqrt(b.numel()) / scale).item(),
        "max_abs": diff.max().item(),
        "plain_max": b.abs().max().item(),
    }


def phase_device(fa_build):
    t0 = time.perf_counter()
    fa_build.load("flash_attention")  # compiles csrc/flash_attention.cu unless built
    build_s = time.perf_counter() - t0
    log = fa_build.library_path("flash_attention").with_suffix(".log")
    ptxas = [
        line.strip() for line in (log.read_text() if log.exists() else "").splitlines()
        if "registers" in line or "spill" in line
    ]
    emit({
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi(),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_s": build_s,
        "ptxas": ptxas,
    })


def make_case(b, sq, sk, hq, hk, d, dtype, seed, segments=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda s, h: torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)  # noqa: E731
    q, k, v, do = mk(sq, hq), mk(sk, hk), mk(sk, hk), mk(sq, hq)
    seg = None
    if segments:
        # three documents per row, boundaries differing by row
        pos = torch.arange(sq, device="cuda")[None, :]
        cut = torch.tensor([[sq // 3 + 7 * r, 2 * sq // 3 + 5 * r] for r in range(b)], device="cuda")
        seg = (pos >= cut[:, :1]).int() + (pos >= cut[:, 1:]).int() + 1
    return q, k, v, do, seg


def check_case(fa, name, case, causal, window=None):
    """Every kernel against its plain version on one input; returns errors."""
    q, k, v, do, seg = case
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    out, lse = fa.flash_forward(q, k, v, causal, None, window, seg)
    out_p, lse_p = fa.attention_plain(q, k, v, causal, None, window, seg)
    live = lse_p > fa.NEG_INF / 2
    delta = fa.row_delta(out_p, do)
    dq = fa.flash_dq(q, k, v, do, lse_p, delta, causal, None, window, seg)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_p, delta, causal, None, window, seg)
    dq_p = fa.dq_plain(q, k, v, do, lse_p, delta, causal, None, window, seg)
    dk_p, dv_p = fa.dkv_plain(q, k, v, do, lse_p, delta, causal, None, window, seg)
    torch.cuda.synchronize()
    tol = TOL[q.dtype]
    lse_ok = torch.equal(lse <= fa.NEG_INF / 2, ~live)
    lse_err = (lse[live] - lse_p[live]).abs().max().item() if live.any() else 0.0
    errs = {
        n: compare(x, y, tol["rtol"])
        for n, (x, y) in {"fwd": (out, out_p), "dq": (dq, dq_p),
                          "dk": (dk, dk_p), "dv": (dv, dv_p)}.items()
    }
    ok = (
        lse_ok
        and lse_err <= LSE_TOL
        and all(e["atol_rms"] <= tol["atol_rms"] and e["frob"] <= tol["frob"]
                for e in errs.values())
    )
    emit({"phase": "kernels", "case": name, "dtype": str(q.dtype), "causal": causal,
          "window": window, "segments": seg is not None, "err": errs, "lse_err": lse_err,
          "tol": tol, "lse_tol": LSE_TOL, "dead_rows_match": lse_ok, "ok": ok})
    if not ok:
        raise SystemExit(f"kernel check failed: {name}")
    return {"fwd": errs["fwd"]["max_abs"], "dq": errs["dq"]["max_abs"],
            "dkv": max(errs["dk"]["max_abs"], errs["dv"]["max_abs"])}


def bound(kind, b, sq, sk, hq, hk, d, n_live, elem):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and the
    products' FLOPs over the bf16 tensor-core peak, for these inputs."""
    qo = b * sq * hq * d * elem
    kv = b * sk * hk * d * elem
    rows = b * hq * sq * 4  # one fp32 per row (LSE or delta)
    matmuls = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2 * matmuls * n_live * d
    nbytes = {
        "fwd": qo + 2 * kv + qo + rows,  # q, k, v in; o, lse out
        "dq": 2 * qo + 2 * kv + 2 * rows + qo,  # q, do, k, v, lse, delta in; dq out
        "dkv": 2 * qo + 2 * kv + 2 * rows + 2 * kv,  # ... in; dk, dv out
    }[kind]
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# (name, shape, options) of the small cases, run in bf16 and in fp32
SMALL_CASES = [
    ("gqa_8_2", dict(b=2, sq=256, sk=256, hq=8, hk=2, d=128), dict(causal=True)),
    ("multibatch_6_3_d64", dict(b=3, sq=128, sk=128, hq=6, hk=3, d=64), dict(causal=False)),
    ("cross_sq128_sk256", dict(b=2, sq=128, sk=256, hq=4, hk=4, d=64), dict(causal=True)),
    ("dead_rows_sq256_sk128", dict(b=2, sq=256, sk=128, hq=4, hk=2, d=64), dict(causal=True)),
    ("window_100", dict(b=2, sq=384, sk=384, hq=4, hk=2, d=128), dict(causal=True, window=100)),
    ("window_1", dict(b=1, sq=128, sk=128, hq=2, hk=2, d=64), dict(causal=True, window=1)),
    ("ragged_sq200", dict(b=1, sq=200, sk=200, hq=2, hk=1, d=64), dict(causal=True)),
]


def check_slice(fa):
    """The three kernels against their plain versions at the llama_1b
    training shape (bf16, causal); returns the case and each max |error|."""
    b, s, h, d = SLICE["b"], SLICE["s"], SLICE["h"], SLICE["d"]
    case = make_case(b, s, s, h, h, d, torch.bfloat16, seed=99)
    return case, check_case(fa, "llama_1b_slice", case, causal=True)


def phase_kernels(fa):
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, shape, opts) in enumerate(SMALL_CASES):
            check_case(fa, name, make_case(**shape, dtype=dtype, seed=i), **opts)
        seg_shape = dict(b=2, sq=256, sk=256, hq=4, hk=2, d=128)
        check_case(fa, "segments", make_case(**seg_shape, dtype=dtype, seed=10, segments=True),
                   causal=True)
        check_case(fa, "segments_window", make_case(**seg_shape, dtype=dtype, seed=11,
                                                    segments=True), causal=True, window=50)

    case, abs_errs = check_slice(fa)
    b, s, h, d = SLICE["b"], SLICE["s"], SLICE["h"], SLICE["d"]
    q, k, v, do, _ = case
    out_p, lse_p = fa.attention_plain(q, k, v, True)
    delta = fa.row_delta(out_p, do)
    n_live = b * h * s * (s + 1) // 2
    times = {
        "fwd": (lambda: fa.flash_forward(q, k, v, True),
                lambda: fa.attention_plain(q, k, v, True)),
        "dq": (lambda: fa.flash_dq(q, k, v, do, lse_p, delta, True),
               lambda: fa.dq_plain(q, k, v, do, lse_p, delta, True)),
        "dkv": (lambda: fa.flash_dkv(q, k, v, do, lse_p, delta, True),
                lambda: fa.dkv_plain(q, k, v, do, lse_p, delta, True)),
    }
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(qt, kt, vt, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dot)

    library = {"fwd": time_ms(sdpa_fwd), "dq": time_ms(sdpa_fwd_bwd)}
    library["dkv"] = library["dq"]
    rows = {}
    for kind, (kern, plain) in times.items():
        k_ms, p_ms = time_ms(kern), time_ms(plain, iters=3, warmup=1)
        b_ms, by = bound(kind, b, s, s, h, h, d, n_live, 2)
        rows[kind] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                          library_ms=library[kind], max_abs_err=abs_errs[kind])
        emit({"phase": "kernels", "kernel": kind, "shape": SLICE, "dtype": "bfloat16",
              "causal": True, "kernel_ms": k_ms, "plain_ms": p_ms, "bound_us": b_ms * 1e3,
              "bound_by": by, "library_ms": library[kind],
              "library": "scaled_dot_product_attention " + ("fwd" if kind == "fwd" else "fwd+bwd")})
    return rows


def kind_of_kernel(name: str) -> str:
    if "mma_kernel" in name or name.startswith(("fwd_kernel", "dq_kernel", "dkv_kernel")):
        return "flash"
    if any(w in name.lower() for w in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
        return "gemm"
    return "other"


def profile_steps(step, state, batch, n=2):
    """Device time of ``n`` train steps under torch.profiler, by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from tensorflowonspark_tpu_torch.compute.train import WEIGHT_UPDATE_SCOPE

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds, kernels, update_ms = {}, [], 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0) or 0
        if evt.key == WEIGHT_UPDATE_SCOPE:
            update_ms = (getattr(evt, "device_time_total", 0) or 0) / 1e3 / n
        elif dev_us > 0 and "CUDA" in str(evt.device_type):
            kind = kind_of_kernel(evt.key)
            kinds[kind] = kinds.get(kind, 0.0) + dev_us / 1e3 / n
            kernels.append((dev_us / 1e3 / n, evt.count // n, kind, evt.key[:90]))
    busy = sum(kinds.values())
    kernels.sort(reverse=True)
    emit({"phase": "profile", "steps": n, "wall_ms_per_step": wall_ms / n,
          "device_busy_ms_per_step": busy, "device_idle_share": 1 - busy * n / wall_ms,
          "device_ms_by_kind": kinds, "weight_update_device_ms": update_ms,
          "top_kernels": [dict(ms=k[0], launches=k[1], kind=k[2], name=k[3])
                          for k in kernels[:15]]})
    return state


def phase_train(fa):
    from tensorflowonspark_tpu_torch.compute import TrainState, adamw, build_train_step
    from tensorflowonspark_tpu_torch.models.llama import Llama, LlamaConfig, llama_loss_fn

    # small model: logits through the kernels against the plain attention path
    small = LlamaConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2, remat=False,
                             dtype=torch.float32, attention_impl="flash")
    m_flash = Llama(small, seed=1)
    m_xla = Llama(dataclasses.replace(small, attention_impl="xla"), seed=1)
    toks = torch.randint(0, small.vocab_size, (2, 256), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.no_grad():
        lf, lx = m_flash(toks), m_xla(toks)
    small_err = (lf - lx).abs().max().item()
    small_ok = bool(torch.isfinite(lf).all()) and lf.shape == (2, 256, small.vocab_size) \
        and small_err <= 1e-3
    emit({"phase": "train", "check": "tiny_logits_flash_vs_xla", "max_abs_err": small_err,
          "tol": 1e-3, "ok": small_ok})
    if not small_ok:
        raise SystemExit("small-model logits through the kernels disagree")
    del m_flash, m_xla

    b, seq, steps = 8, 1024, 5
    cfg = LlamaConfig.llama_1b(max_seq_len=seq, remat=False, attention_impl="auto")
    model = Llama(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    tx = adamw(1e-4, moment_dtype=torch.bfloat16)
    state = TrainState.create(dict(model.named_parameters()), tx)
    loss_fn = llama_loss_fn(model)
    step = build_train_step(lambda p, bt: loss_fn(p, bt["tokens"]), tx)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, seq + 1), device="cuda",
                                     generator=gen)}
    state, loss0 = step(state, batch)  # warm-up
    torch.cuda.synchronize()
    fa.reset_launches()
    losses = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    losses = [loss0.item()] + [x.item() for x in losses]
    step_s = dt / steps
    tokens = b * seq
    ok = (
        all(math.isfinite(x) for x in losses)
        and losses[-1] < losses[0]
        and all(n == cfg.num_layers * steps for n in launches.values())
    )
    emit({"phase": "train", "config": "llama_1b", "layers": cfg.num_layers,
          "hidden": cfg.hidden_size, "batch": b, "seq": seq, "n_params": n_params,
          "steps": steps, "losses": losses, "step_ms": step_s * 1e3,
          "tokens_per_s": tokens / step_s,
          "model_tflops_per_s": 6 * n_params * tokens / step_s / 1e12,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "expected_launches": cfg.num_layers * steps, "ok": ok})
    if not ok:
        raise SystemExit("train phase failed")
    profile_steps(step, state, batch)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    phase_device(_build)
    rows = phase_kernels(fa)
    launches = phase_train(fa)
    emit({"kernels": [
        {"name": f"flash_{kind}", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[kind], "launches": launches[kind], **rows[kind]}
        for kind in ("fwd", "dq", "dkv")
    ]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
