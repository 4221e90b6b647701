"""Drive the PyTorch port on one NVIDIA GPU: build, check and time its kernels,
then train llama_1b and the BatchNorm conv nets for a few steps through them.

    python3 chip_smoke.py

Phases (one JSON line each, or more; any failure exits non-zero):

1. device — the card, its power limit, torch/CUDA versions, the kernel
   builds (one nvcc per source, all started at once) and ptxas' registers
   and spills of each kernel, by its demangled name (the bf16 flash kernels
   are ``fwd_wgmma_kernel<64|128>``, ``dq_wgmma_kernel<64|128>`` and
   ``dkv_wgmma_kernel<64|128>``).
2. kernels — each flash-attention kernel (forward, dQ, dK/dV) against its
   plain PyTorch version on the card, element by element and in Frobenius
   norm (limits in ``TOL``), at the llama_1b training shape (B=8, S=1024,
   H=16, D=128, bf16, causal) and at small GQA, sq != sk, dead-row, window
   and segment cases; times of kernel, plain version and
   ``scaled_dot_product_attention`` (a yardstick only: the port never calls
   it; forward for B1; for B2 and B3, which it computes in one call, the
   backward alone on a kept forward, as device time under the profiler), and
   the bound of each kernel on an H100 with the kernel's share of it.
3. train — ``LlamaConfig.llama_1b(remat=False)`` at full depth, batch 8,
   seq 1024, fp32 params, ``adamw(moment_dtype=bf16)``, attention ``auto``:
   one warm-up step, then 5 timed steps on one fixed batch, with the kernel
   launch counts of those 5 steps; and a small model whose logits through
   the kernels must match the plain attention path. Then two more steps
   under ``torch.profiler`` (phase ``profile``): device busy and idle
   share, device time by kind of kernel and of the weight update, and the
   heaviest kernels.
4. bn_kernels — the batch-norm statistics kernels (``pair_stats`` B4,
   ``cross_stats`` B5) against their plain versions on the card, each
   per-channel sum held to ``|a − b| ≤ rtol·Σ|terms| + atol`` (Σ|terms| in
   fp64; limits in ``BN_TOL``), at the 12 (rows, C) shapes of ResNet-50's
   BatchNorm layers at batch 256, 224x224, bf16, and at edge cases (fp32,
   ragged rows with poison past the end, C = 4, 65, 600, a base pointer
   off 16 bytes). Per shape: kernel, plain and library time
   (``torch.batch_norm_stats`` / ``torch.batch_norm_backward_reduce``,
   yardsticks the port never calls) and the byte bound.
5. bn_layer — ``fused_batch_norm`` forward and backward, ``kernel`` route
   against ``xla`` route, at the stem and a stage-4 shape, bf16.
6. conv_train — ResNet-50 (``ResNetConfig.resnet50()``), batch 256,
   224x224, bf16 compute, fp32 params, ``sgd(0.1, momentum=0.9)``, random
   weights and one fixed batch from seed 0, BatchNorm ``auto`` (→ the
   kernels): one warm-up step, 5 timed steps with the launch counts of
   those steps (53 of each kernel per step), then the same with ``xla``
   statistics as the A/B of the dispatch, two steps under the profiler,
   and one step each of Inception-v3 (299x299, batch 32, aux head on) and
   VGG-16 (224x224, batch 32) through the kernels.

The last lines are the ``kernels`` summary (the bn kernels' ``ms``,
``plain_ms``, ``bound_ms`` and ``library_ms`` are per ResNet-50 step: the
sum over its 53 BatchNorm layers), the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
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
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, same data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3
SLICE = dict(b=8, s=1024, h=16, d=128)
KERNEL_SOURCE = "tensorflowonspark_tpu_torch/csrc/flash_attention.cu"
BN_SOURCE = "tensorflowonspark_tpu_torch/csrc/bn_stats.cu"
REPLACES = {
    "fwd": "tensorflowonspark_tpu/ops/flash_attention.py:134",
    "dq": "tensorflowonspark_tpu/ops/flash_attention.py:343",
    "dkv": "tensorflowonspark_tpu/ops/flash_attention.py:400",
    "pair": "tensorflowonspark_tpu/ops/bn_kernels.py:101",
    "cross": "tensorflowonspark_tpu/ops/bn_kernels.py:109",
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


def device_ms(fn, iters=10, warmup=2) -> float:
    """Device time of one call of ``fn``: the kernels' own time under
    torch.profiler, summed and averaged over ``iters`` calls. Unlike
    time_ms it leaves out the gaps where the card waits for the host, which
    set the event time of a call whose host side is nearly as long as its
    kernels (the library's backward)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in prof.key_averages()
                   if "CUDA" in str(e.device_type))
    return total_us / 1e3 / iters


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


def demangle(text: str) -> str:
    """``text`` with its C++ symbols demangled by ``c++filt``, where the
    machine has it; else as it is."""
    try:
        return subprocess.run(["c++filt"], input=text, capture_output=True, text=True,
                              timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return text


def phase_device(build):
    t0 = time.perf_counter()
    build.build(["flash_attention", "bn_stats"])  # compiles what is not built, in parallel
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in ("flash_attention", "bn_stats"):
        log = build.library_path(name).with_suffix(".log")
        ptxas[name] = [
            line.strip() for line in demangle(log.read_text() if log.exists() else "").splitlines()
            if any(w in line for w in ("entry function", "registers", "spill", "warning"))
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

    kept = sdpa(qt, kt, vt, is_causal=True)  # the backward alone runs on a kept forward

    def sdpa_bwd():
        torch.autograd.grad(kept, (qt, kt, vt), dot, retain_graph=True)

    # the library's backward computes dQ, dK and dV in one call: the
    # yardstick of B2 + B3 together, given to each of the two, as device
    # time (its host side takes ~0.2 ms a call, near its kernels' time)
    bwd_ms = device_ms(sdpa_bwd)
    library = {"fwd": time_ms(sdpa_fwd), "dq": bwd_ms, "dkv": bwd_ms}
    bwd_event_ms, fwd_bwd_ms = time_ms(sdpa_bwd), time_ms(sdpa_fwd_bwd)
    rows = {}
    for kind, (kern, plain) in times.items():
        k_ms, p_ms = time_ms(kern), time_ms(plain, iters=3, warmup=1)
        b_ms, by = bound(kind, b, s, s, h, h, d, n_live, 2)
        rows[kind] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                          library_ms=library[kind], max_abs_err=abs_errs[kind])
        emit({"phase": "kernels", "kernel": kind, "shape": SLICE, "dtype": "bfloat16",
              "causal": True, "kernel_ms": k_ms, "plain_ms": p_ms, "bound_us": b_ms * 1e3,
              "bound_by": by, "share_of_bound": b_ms / k_ms, "library_ms": library[kind],
              "library": "scaled_dot_product_attention "
                         + ("fwd" if kind == "fwd" else "bwd (device time)")})
    emit({"phase": "kernels", "kernel": "dq+dkv", "kernel_ms": rows["dq"]["ms"] + rows["dkv"]["ms"],
          "library_bwd_device_ms": bwd_ms, "library_bwd_event_ms": bwd_event_ms,
          "library_fwd_bwd_event_ms": fwd_bwd_ms,
          "bound_ms": rows["dq"]["bound_ms"] + rows["dkv"]["bound_ms"]})
    return rows


KINDS = (  # (kind, substrings of the kernel's name), first match wins
    ("flash", ("fwd_wgmma_kernel", "dq_wgmma_kernel", "dkv_wgmma_kernel", "::fwd_kernel",
               "::dq_kernel", "::dkv_kernel")),
    ("bn_stats", ("stats_partial_kernel", "stats_finalize_kernel")),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "implicit", "cudnn")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce_kernel",)),
    ("pool", ("pool",)),
)


def kind_of_kernel(name: str) -> str:
    lower = name.lower()
    for kind, marks in KINDS:
        if any(m.lower() in lower for m in marks):
            return kind
    return "other"


def profile_steps(run_step, n=2, model=None):
    """Device time of ``n`` calls of ``run_step()`` (one train step each)
    under torch.profiler, by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from tensorflowonspark_tpu_torch.compute.train import WEIGHT_UPDATE_SCOPE

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run_step()
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
    emit({"phase": "profile", "model": model, "steps": n, "wall_ms_per_step": wall_ms / n,
          "device_busy_ms_per_step": busy, "device_idle_share": 1 - busy * n / wall_ms,
          "device_ms_by_kind": kinds, "weight_update_device_ms": update_ms,
          "top_kernels": [dict(ms=k[0], launches=k[1], kind=k[2], name=k[3])
                          for k in kernels[:15]],
          "port_kernels": [dict(ms=k[0], launches=k[1], name=k[3]) for k in kernels
                           if k[2] in ("flash", "bn_stats")]})


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

    def run_step():
        nonlocal state
        state, _ = step(state, batch)

    profile_steps(run_step, model="llama_1b")
    return launches


# where the bn and conv phases run (a CPU rehearsal at tiny sizes sets "cpu")
DEVICE = "cuda"


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# (rows, C, layers) of ResNet-50's BatchNorm inputs at batch 256, 224x224;
# phase conv_train checks it against the model
RESNET50_BN = [
    (3211264, 64, 1), (802816, 64, 6), (802816, 128, 1), (802816, 256, 4),
    (200704, 128, 7), (200704, 256, 1), (200704, 512, 5), (50176, 256, 11),
    (50176, 512, 1), (50176, 1024, 7), (12544, 512, 5), (12544, 2048, 4),
]
# Each per-channel sum of a bn kernel against its plain version:
# |a - b| <= rtol * sum|terms| + atol, sum|terms| in fp64 (the scale of a
# sum that may cancel). Both sides read the same values and sum in fp32 in
# different orders (the kernel's last pass over its row splits in fp64).
# The unchanged kernels read at most 3.7e-7 of sum|terms| (PERF.md, Findings);
# the limit sits 5x above, far below what a lost row split costs (1/splits).
BN_TOL = dict(rtol=2e-6, atol=1e-6)
# rows past the end of a ragged input hold this: a kernel that reads them
# is off by far more than BN_TOL allows
POISON = 100.0
# name, rows, C, dtype, elements the view starts into its buffer, poisoned rows after it
BN_EDGE_CASES = [
    ("stem_bf16", 3211264, 64, torch.bfloat16, 0, 0),
    ("ragged_bf16", 100003, 64, torch.bfloat16, 0, 2048),
    ("ragged_fp32", 100003, 256, torch.float32, 0, 2048),
    ("c4_scalar", 50001, 4, torch.bfloat16, 0, 2048),
    ("c65_scalar", 30011, 65, torch.bfloat16, 0, 2048),
    ("c600_bf16", 20011, 600, torch.bfloat16, 0, 2048),
    ("c600_fp32", 20011, 600, torch.float32, 0, 2048),
    ("misaligned_bf16", 100003, 64, torch.bfloat16, 1, 2048),
    ("stage4_fp32", 12544, 2048, torch.float32, 0, 0),
]
# fused_batch_norm, kernel route against xla route (bf16): compare() limits.
# The two routes share every rounding but the order of the fp32 sums and
# the derivation of sum(dy*xhat); readings: y exact, dx frob <= 1.3e-8,
# dgamma/dbeta frob <= 3.7e-7 (PERF.md, Findings).
BN_LAYER_TOL = dict(rtol=2**-7, atol_rms=1e-3, frob=1e-5)


def bn_inputs(rows, c, dtype, seed, offset=0, tail=0):
    """x ~ normal(0.5, 2) and dy ~ normal(0, 1), (rows, c) views on the card
    that start ``offset`` elements into their buffers and are followed by
    ``tail`` rows of POISON."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def make(mean, std):
        buf = torch.full(((rows + tail) * c + offset,), POISON, dtype=dtype, device=DEVICE)
        body = buf[offset:offset + rows * c]
        body.copy_(torch.randn(rows * c, generator=g, device=DEVICE).mul_(std).add_(mean))
        return body.view(rows, c)

    return make(0.5, 2.0), make(0.0, 1.0)


def check_bn_case(bn, name, x, dy):
    """Both statistics kernels against their plain versions on (x, dy);
    returns the largest |kernel - plain|."""
    got = dict(zip(("sum_x", "sum_xx"), bn.pair_stats(x)))
    got.update(zip(("sum_dy", "sum_dyx"), bn.cross_stats(dy, x)))
    want = dict(zip(("sum_x", "sum_xx"), bn.pair_stats_plain(x)))
    want.update(zip(("sum_dy", "sum_dyx"), bn.cross_stats_plain(dy, x)))
    x64, dy64 = x.double(), dy.double()
    scale = {"sum_x": x64.abs().sum(0), "sum_xx": (x64 * x64).sum(0),
             "sum_dy": dy64.abs().sum(0), "sum_dyx": (dy64 * x64).abs().sum(0)}
    del x64, dy64
    errs, ok = {}, True
    for k in got:
        diff = (got[k].double() - want[k].double()).abs()
        limit = BN_TOL["rtol"] * scale[k] + BN_TOL["atol"]
        errs[k] = {"rel": (diff / scale[k].clamp_min(1e-30)).max().item(),
                   "max_abs": diff.max().item(), "worst_over_limit": (diff / limit).max().item()}
        ok &= bool(torch.isfinite(got[k]).all()) and bool((diff <= limit).all())
    rows, c = x.shape
    vec = bn.vector_width((dy, x), c)
    tx, splits, per = bn.launch_geometry(rows, c, vec)
    emit({"phase": "bn_kernels", "case": name, "rows": rows, "C": c, "dtype": str(x.dtype),
          "vec": vec, "tx": tx, "splits": splits, "rows_per_split": per, "err": errs,
          "tol": BN_TOL, "ok": ok})
    if not ok:
        raise SystemExit(f"bn kernel check failed: {name}")
    return max(e["max_abs"] for e in errs.values())


def check_bn_edges(bn):
    """The statistics kernels at the edge cases (the check chip_faults.py runs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    for i, (name, rows, c, dtype, offset, tail) in enumerate(BN_EDGE_CASES):
        x, dy = bn_inputs(rows, c, dtype, seed=100 + i, offset=offset, tail=tail)
        worst = max(worst, check_bn_case(bn, name, x, dy))
        del x, dy
    return worst


def bn_bound(kind, rows, c, elem):
    """(bound_ms, bound_by): bytes (inputs once, two fp32 (C,) outputs) over
    HBM rate against 3 fp32 operations an element over the fp32 peak."""
    streams = 1 if kind == "pair" else 2
    t_bytes = (streams * rows * c * elem + 2 * c * 4) / H100_BYTES_PER_S
    t_ops = 3 * rows * c / H100_FP32_FLOPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def phase_bn_kernels(bn):
    """Edge cases, then the 12 ResNet-50 shapes in bf16: check and time
    each kernel; returns the per-step rows of the kernels line."""
    worst = check_bn_edges(bn)
    tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=worst)
           for k in ("pair", "cross")}
    for i, (rows, c, layers) in enumerate(RESNET50_BN):
        x, dy = bn_inputs(rows, c, torch.bfloat16, seed=i)
        err = check_bn_case(bn, f"resnet50_{rows}x{c}", x, dy)
        var, mean = torch.var_mean(x.float(), 0, correction=0)
        invstd = torch.rsqrt(var + 1e-5)
        fns = {
            "pair": (lambda: bn.pair_stats(x), lambda: bn.pair_stats_plain(x),
                     lambda: torch.batch_norm_stats(x, 1e-5)),
            "cross": (lambda: bn.cross_stats(dy, x), lambda: bn.cross_stats_plain(dy, x),
                      lambda: torch.batch_norm_backward_reduce(dy, x, mean, invstd, None,
                                                               True, False, False)),
        }
        line = {"phase": "bn_kernels", "shape": [rows, c], "layers": layers, "dtype": "bfloat16"}
        for kind, (kern, plain, lib) in fns.items():
            k_ms, p_ms, l_ms = time_ms(kern), time_ms(plain, iters=3, warmup=1), time_ms(lib)
            b_ms, by = bn_bound(kind, rows, c, 2)
            line[kind] = dict(kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                              bound_us=b_ms * 1e3, bound_by=by, share_of_bound=b_ms / k_ms)
            t = tot[kind]
            t["ms"] += layers * k_ms
            t["plain_ms"] += layers * p_ms
            t["library_ms"] += layers * l_ms
            t["bound_ms"] += layers * b_ms
            t["bound_by"] = by
            t["max_abs_err"] = max(t["max_abs_err"], err)
        emit(line)
        del x, dy
    emit({"phase": "bn_kernels", "per_resnet50_step": tot,
          "library": "torch.batch_norm_stats / torch.batch_norm_backward_reduce"})
    return tot


def phase_bn_layer():
    """fused_batch_norm, kernel route against xla route, forward and backward."""
    from tensorflowonspark_tpu_torch.ops.batch_norm import fused_batch_norm

    for name, shape in (("stem", (256, 112, 112, 64)), ("stage4", (256, 7, 7, 2048))):
        g = torch.Generator(device=DEVICE).manual_seed(7)
        c = shape[-1]
        x = (torch.randn(shape, generator=g, device=DEVICE) * 2 + 0.5).bfloat16()
        gamma = torch.randn(c, generator=g, device=DEVICE) * 0.3 + 1
        beta = torch.randn(c, generator=g, device=DEVICE)
        t = torch.randn(shape, generator=g, device=DEVICE).bfloat16()
        outs = {}
        for impl in ("kernel", "xla"):
            xi, gi, bi = (v.clone().requires_grad_() for v in (x, gamma, beta))
            y = fused_batch_norm(xi, gi, bi, 1e-5, impl=impl)
            y.backward(t)
            outs[impl] = {"y": y.detach(), "dx": xi.grad, "dgamma": gi.grad, "dbeta": bi.grad}
        sync()
        errs = {k: compare(outs["kernel"][k], outs["xla"][k], BN_LAYER_TOL["rtol"])
                for k in outs["kernel"]}
        ok = all(e["atol_rms"] <= BN_LAYER_TOL["atol_rms"] and e["frob"] <= BN_LAYER_TOL["frob"]
                 for e in errs.values())
        emit({"phase": "bn_layer", "case": name, "shape": list(shape), "dtype": "bfloat16",
              "err": errs, "tol": BN_LAYER_TOL, "ok": ok})
        if not ok:
            raise SystemExit(f"bn layer check failed: {name}")
        del outs, x, t


def conv_shapes(model, size):
    """(BatchNorm (rows per image, C) in call order, forward MACs per image)
    from one no-grad forward of one image, read off the model's layers."""
    from tensorflowonspark_tpu_torch.models.conv import Conv, Dense
    from tensorflowonspark_tpu_torch.ops.batch_norm import FusedBatchNorm

    bn_shapes, macs, hooks = [], [0], []

    def on_conv(mod, inp, out):
        macs[0] += out[0].numel() * mod.weight[0].numel()

    def on_dense(mod, inp, out):
        macs[0] += mod.weight.numel()

    def on_bn(mod, inp, out):
        bn_shapes.append((inp[0].numel() // inp[0].shape[-1], inp[0].shape[-1]))

    for mod in model.modules():
        hook = {Conv: on_conv, Dense: on_dense, FusedBatchNorm: on_bn}.get(type(mod))
        if hook is not None:
            hooks.append(mod.register_forward_hook(hook))
    with torch.no_grad():
        model(torch.zeros(1, size, size, 3, device=DEVICE), train=True)
    for h in hooks:
        h.remove()
    from tensorflowonspark_tpu_torch.ops.batch_norm import pop_batch_stats

    pop_batch_stats(model)
    return bn_shapes, macs[0]


def image_batch(n, size, classes, seed=0):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return {"image": torch.randn(n, size, size, 3, generator=g, device=DEVICE),
            "label": torch.randint(0, classes, (n,), generator=g, device=DEVICE)}


class ConvRun:
    """One conv net, its SGD state and batch: ``steps(n)`` runs n train steps."""

    def __init__(self, model, loss_fn, batch):
        from tensorflowonspark_tpu_torch.compute import TrainState, build_bn_train_step, sgd

        self.model, self.batch = model, batch
        self.tx = sgd(0.1, momentum=0.9)
        self.step = build_bn_train_step(loss_fn, self.tx, device=DEVICE)
        self.init = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.stats0 = {n: b.clone() for n, b in model.named_buffers()}
        self._make_state = lambda: TrainState.create(model.named_parameters(), self.tx)
        self.reset()

    def reset(self):
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(self.init[n])
        self.state = self._make_state()
        self.stats = {n: b.clone() for n, b in self.stats0.items()}

    def advance(self):
        self.state, self.stats, loss = self.step(self.state, self.stats, self.batch)
        return loss

    def steps(self, n):
        """Losses and wall ms per step of n steps ending in a synchronize."""
        sync()
        t0 = time.perf_counter()
        losses = [self.advance() for _ in range(n)]
        sync()
        return [x.item() for x in losses], (time.perf_counter() - t0) * 1e3 / n


def phase_conv_train(bn):
    from tensorflowonspark_tpu_torch.models import inception, resnet, vgg
    from tensorflowonspark_tpu_torch.ops.batch_norm import FusedBatchNorm, set_impl

    b, size, steps = 256, 224, 5
    cfg = resnet.ResNetConfig.resnet50()
    model = resnet.ResNet(cfg, device=DEVICE, seed=0)
    shapes, macs = conv_shapes(model, size)
    distinct = {}
    for rows, c in shapes:
        distinct[(rows * b, c)] = distinct.get((rows * b, c), 0) + 1
    shapes_ok = sorted((r, c, n) for (r, c), n in distinct.items()) == sorted(RESNET50_BN)
    run = ConvRun(model, resnet.loss_fn(model), image_batch(b, size, cfg.num_classes))
    n_params = sum(p.numel() for p in model.parameters())
    flop_per_step = 2 * 3 * macs * b  # 2 FLOP per MAC; backward twice the forward

    # the main path: BatchNorm 'auto', i.e. the kernels
    loss0, _ = run.steps(1)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    bn.reset_launches()
    losses, step_ms = run.steps(steps)
    launches = dict(bn.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = loss0 + losses
    # the A/B: the same steps from the same weights with 'xla' statistics,
    # then in turns (kernel, xla, xla, kernel)
    set_impl(model, "xla")
    run.reset()
    x_loss0, _ = run.steps(1)
    x_losses, x_ms = run.steps(steps)
    x_losses = x_loss0 + x_losses
    _, x_ms2 = run.steps(steps)
    set_impl(model, "auto")
    _, k_ms2 = run.steps(steps)
    want = [steps * len(shapes)] * 2
    ok = (shapes_ok and all(math.isfinite(v) for v in losses + x_losses)
          and losses[-1] < losses[0] and [launches["pair"], launches["cross"]] == want
          and abs(losses[0] - x_losses[0]) <= 1e-2 * abs(x_losses[0]))
    emit({"phase": "conv_train", "config": "resnet50", "batch": b, "image": size,
          "n_params": n_params, "bn_layers": len(shapes), "bn_shapes_match": shapes_ok,
          "gmac_per_image": macs / 1e9, "steps": steps, "losses": losses,
          "step_ms": step_ms, "images_per_s": b / step_ms * 1e3,
          "model_tflops_per_s": flop_per_step / step_ms / 1e9,
          "peak_mem_gb": peak_gb, "launches": launches, "expected_launches": want[0],
          "ab": {"kernel_step_ms": [step_ms, k_ms2], "xla_step_ms": [x_ms, x_ms2],
                 "xla_losses": x_losses,
                 "max_rel_loss_gap": max(abs(a - c) / abs(c) for a, c in zip(losses, x_losses))},
          "ok": ok})
    if not ok:
        raise SystemExit("conv_train failed: resnet50")
    main_launches = launches
    profile_steps(run.advance, model="resnet50")
    del run, model
    torch.cuda.empty_cache()

    for name, build, size, make_loss in (
        ("inception_v3", lambda: inception.InceptionV3(inception.InceptionConfig.v3(), DEVICE, seed=0),
         299, inception.loss_fn),
        ("vgg16", lambda: vgg.VGG(vgg.VGGConfig.vgg16(), DEVICE, seed=0), 224, vgg.loss_fn),
    ):
        model = build()
        n_bn = sum(isinstance(m, FusedBatchNorm) for m in model.modules())
        run = ConvRun(model, make_loss(model), image_batch(32, size, 1000, seed=1))
        loss0, _ = run.steps(1)
        bn.reset_launches()
        loss1, ms = run.steps(1)
        launches = dict(bn.LAUNCHES)
        ok = (all(math.isfinite(v) for v in loss0 + loss1)
              and [launches["pair"], launches["cross"]] == [n_bn, n_bn])
        emit({"phase": "conv_train", "config": name, "batch": 32, "image": size,
              "losses": loss0 + loss1, "step_ms": ms, "images_per_s": 32 / ms * 1e3,
              "bn_layers": n_bn, "launches": launches, "ok": ok})
        if not ok:
            raise SystemExit(f"conv_train failed: {name}")
        del run, model
        torch.cuda.empty_cache()
    return main_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops import bn_kernels as bn
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    phase_device(_build)
    rows = phase_kernels(fa)
    launches = phase_train(fa)
    torch.cuda.empty_cache()
    bn_rows = phase_bn_kernels(bn)
    phase_bn_layer()
    bn_launches = phase_conv_train(bn)
    emit({"kernels": [
        {"name": f"flash_{kind}", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[kind], "launches": launches[kind], **rows[kind]}
        for kind in ("fwd", "dq", "dkv")
    ] + [
        {"name": f"bn_{kind}_stats", "route": "cuda", "source": BN_SOURCE,
         "replaces": REPLACES[kind], "launches": bn_launches[kind], **bn_rows[kind]}
        for kind in ("pair", "cross")
    ]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
