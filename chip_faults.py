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
the end, fp32, narrow and misaligned C), and ``chip_smoke.phase_cluster``
at 4 layers for ``feed/prefetch.py`` and ``compute/checkpoint.py`` (the
node runtime: every device batch against its host checksum, with the
prefetcher's copy stream held back so that a staging slot is reused while
its copy may still be pending, and a restored checkpoint against the
state saved before the step that followed the async save), and
``chip_smoke.phase_mesh`` at 4 layers and ResNet-50 at batch 32 for the
mesh routes of ``ops/attention.py``, ``ops/bn_kernels.py`` and the sharded
restore of ``compute/checkpoint.py`` (the kernels' launches and the mesh
routes' counts per step, and a sharded checkpoint restored bit for bit),
and ``chip_smoke.phase_elastic`` at 2 layers, batch 2, sequence 256 for
``compute/elastic.py``, ``cluster/node.py``'s heartbeat and the elastic
nodes' attention (a SIGKILLed node, a reconfigure in memory, a
replacement hydrated from its peer, a checkpoint fallback with its rewind;
the outcomes, the replacement's start step, every loss and the final
state against an uninterrupted run bit for bit, the state's dtypes and
bytes after each reconfigure, and the kernels' launches), and
``chip_smoke.phase_decode`` at 4 layers for ``models/llama.py``'s decode
(the cached attention against fp64 with large logits, a mixed-length
greedy decode against a teacher-forced forward, the eos early exit, the
int8 and rolling caches, scoring and the CLI), and ``chip_smoke.phase_serve``
at 4 layers for ``serving/engine.py`` (the sampler against its plain
version, staggered traffic against generate() alone and a teacher-forced
forward, the same traffic at other decode blocks, depths and arrival
orders token for token, chunked prefill with the prefix cache, and the
HTTP server in process and as a process), and ``chip_smoke.phase_fleet`` at
4 layers, parts b and c, for ``serving/router.py``, ``cachetier/prefix.py``
and ``cachetier/service.py`` (an L2 hit across replicas equal to a miss, a
lookup under another weights version a miss, an entry offered while the
device is stalled equal to what was written, 50 lookups after
``CacheServer.close()`` all misses with no connection left open, and a
dropped dispatch and a wedged replica under traffic: every request
resolved once, failovers, respawns), and ``chip_smoke.phase_moe`` at 2
layers, parts a and b, for ``parallel/moe.py`` and the MoE aux loss in
``models/llama.py`` (a tiny MoE Llama's loss against cross entropy plus
aux losses on the CPU, one MoE block at full width against a plain
version at capacity factor 0.25, where the priority order decides the
drops), and ``chip_smoke.phase_spec`` at 4 layers, part a, for
``models/speculative.py`` (greedy speculative decoding against plain
greedy, token for token in fp32).
Faults that show only across ranks (a dropped ``all_reduce``, a rank's
rows lost from an uneven split) cannot show on one card; the CPU tests
plant those at 2 ranks (``tests/test_torch_mesh.py``). The unchanged
copy runs every check once. The children run at once, then those of the
decode check (a llama_1b of 4 layers each, and two CLI processes) at once,
then those of the serve check (a llama_1b of 4 layers and a server process
each) at once, then those of the fleet check (a llama_1b of 4 layers and
three engines each) at once,
then those of the elastic check (the unchanged copy's and the elastic
faults', two or three node processes each) three at a time. Each prints its check lines; this script prints one
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
PREFETCH = Path("tensorflowonspark_tpu_torch/feed/prefetch.py")
CKPT = Path("tensorflowonspark_tpu_torch/compute/checkpoint.py")
ATTENTION = Path("tensorflowonspark_tpu_torch/ops/attention.py")
BN_ROUTE = Path("tensorflowonspark_tpu_torch/ops/bn_kernels.py")
ELASTIC = Path("tensorflowonspark_tpu_torch/compute/elastic.py")
NODE = Path("tensorflowonspark_tpu_torch/cluster/node.py")
LLAMA = Path("tensorflowonspark_tpu_torch/models/llama.py")
ENGINE = Path("tensorflowonspark_tpu_torch/serving/engine.py")
ROUTER = Path("tensorflowonspark_tpu_torch/serving/router.py")
PREFIX_L2 = Path("tensorflowonspark_tpu_torch/cachetier/prefix.py")
CACHE_SERVICE = Path("tensorflowonspark_tpu_torch/cachetier/service.py")
ROLLOUT = Path("tensorflowonspark_tpu_torch/serving/rollout.py")
LORA = Path("tensorflowonspark_tpu_torch/ops/lora.py")
QUANT = Path("tensorflowonspark_tpu_torch/ops/quant.py")
MOE = Path("tensorflowonspark_tpu_torch/parallel/moe.py")
SPECULATIVE = Path("tensorflowonspark_tpu_torch/models/speculative.py")
CLUSTER_CHECK = "phase_cluster(layers=4)"
MESH_CHECK = "phase_mesh(fa, bn, layers=4, conv_batch=32)"
ELASTIC_CHECK = 'phase_elastic(layers=2, rehearse={"sizes": {"batch": 2, "seq": 256, "wait_s": 120.0}})'
DECODE_CHECK = "phase_decode(fa, layers=4)"
SERVE_CHECK = "phase_serve(fa, layers=4)"
FLEET_CHECK = 'phase_fleet(fa, layers=4, parts="bc")'
ROLLOUT_CHECK = 'phase_rollout(fa, layers=4, parts="ab")'
LORA_CHECK = 'phase_lora(fa, layers=4, parts="abcd")'
MOE_CHECK = 'phase_moe(fa, layers=2, parts="ab")'
SPEC_CHECK = 'phase_spec(fa, layers=4, parts="a")'
CHECKS = {FLASH: "check_slice(fa)", BN: "check_bn_edges(bn)", PREFETCH: CLUSTER_CHECK,
          CKPT: CLUSTER_CHECK, ATTENTION: MESH_CHECK, BN_ROUTE: MESH_CHECK,
          ELASTIC: ELASTIC_CHECK, NODE: ELASTIC_CHECK, LLAMA: DECODE_CHECK, ENGINE: SERVE_CHECK,
          ROUTER: FLEET_CHECK, PREFIX_L2: FLEET_CHECK, CACHE_SERVICE: FLEET_CHECK,
          ROLLOUT: ROLLOUT_CHECK, LORA: LORA_CHECK, QUANT: LORA_CHECK, MOE: MOE_CHECK,
          SPECULATIVE: SPEC_CHECK}
# faults whose check is not their source's
FAULT_CHECKS = {"mesh_restore_skips_opt_state": MESH_CHECK,
                "elastic_plain_attention": ELASTIC_CHECK,
                "lora_swap_writes_in_place": LORA_CHECK,
                "moe_aux_loss_dropped": MOE_CHECK}

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
    # prefetcher: a staging slot is rewritten without waiting for the
    # event of its previous H2D copy
    "prefetch_no_fence": (
        PREFETCH,
        "prev.synchronize()  # the slot's last H2D copy has read it",
        "pass  # the slot's last H2D copy has read it",
    ),
    # checkpoint: the async save hands the live tensors to the writer
    # thread without the host snapshot
    "ckpt_no_snapshot": (
        CKPT,
        "host = _host_copy(flat, self._pinned)",
        "host = flat",
    ),
    # attention's mesh route runs the plain attention on each shard
    # instead of the flash kernels
    "mesh_attention_plain": (
        ATTENTION,
        "return flash_attention(q, k, v, causal, scale, window, seg)",
        "return _xla_attention(q, k, v, causal=causal, scale=scale, segment_ids=seg, window=window)",
    ),
    # the sharded restore reads the params but leaves the optimizer state
    "mesh_restore_skips_opt_state": (
        CKPT,
        "dcp.load(want, checkpoint_id=path)",
        'dcp.load({k: v for k, v in want.items() if "opt_state" not in k}, checkpoint_id=path)',
    ),
    # the batch-norm mesh route sums each rank's rows with the plain
    # versions instead of the kernels
    "mesh_bn_plain": (
        BN_ROUTE,
        "s, q = stats_fn(*local)",
        's, q = (pair_stats_plain if kind == "pair" else cross_stats_plain)(*map(as_2d, local))',
    ),
    # the reconfigure commits fresh (zero) optimizer state instead of the
    # snapshot's
    "reshard_drops_opt_state": (
        ELASTIC,
        "state = reshard_state(snapshot, shardings)",
        "state = reshard_state(dataclasses.replace(snapshot, opt_state=_tree_map("
        "torch.zeros_like, snapshot.opt_state)), shardings)",
    ),
    # the snapshot goes through numpy, which has no bf16: the bf16 moments
    # come back as fp32
    "snapshot_casts_bf16": (
        ELASTIC,
        'return _tree_map(lambda _x: next(it).to("cpu", copy=True), state)',
        'return _tree_map(lambda _x: torch.from_numpy(next(it).cpu().float().numpy()) '
        'if _x.dtype == torch.bfloat16 else next(it).to("cpu", copy=True), state)',
    ),
    # a peer's manager keeps serving its first (oldest) snapshot, so the
    # joiner hydrates from it instead of the freshest
    "hydrate_stale_step": (
        ELASTIC,
        "mgr.set(self._state_key, blob)",
        "mgr.set(self._state_key, mgr.get(self._state_key) or blob)",
    ),
    # after a checkpoint fallback the loop is not told to rewind
    "fallback_no_rewind": (
        ELASTIC,
        "self.resume_step = restored_step",
        "self.resume_step = None",
    ),
    # the heartbeat swallows the membership epoch (the port's earlier stub)
    "heartbeat_ignores_epoch": (
        NODE,
        'elastic.notify_membership(info["epoch"], info["roster"])',
        'raise NotImplementedError("elastic membership is not ported yet")',
    ),
    # attention 'auto' takes the plain attention on CUDA too: the elastic
    # nodes' llama launches no kernel
    "elastic_plain_attention": (
        ATTENTION,
        'return "flash" if on_cuda and _flash_shapes_ok(q, k, segment_ids) else "xla"',
        'return "xla"',
    ),
    # decode: a query no longer sees its own slot
    "decode_slot_mask_strict": (
        LLAMA,
        "mask = key_pos[None, None, None, None, :] <= slot_q[:, None, None, :, None]",
        "mask = key_pos[None, None, None, None, :] < slot_q[:, None, None, :, None]",
    ),
    # a rolling cache's position plane starts at 0, so unwritten slots pass
    # for position 0
    "rolling_pos_init_zero": (
        LLAMA,
        "torch.full((batch, c), -1 if rolling else 0, dtype=torch.int32,",
        "torch.full((batch, c), 0, dtype=torch.int32,",
    ),
    # int8 decode: the V scale is not applied to the probabilities
    "int8_drop_v_scale": (
        LLAMA,
        'probs = probs * cache["v_scale"][:, :, None, None, :]',
        "probs = probs",
    ),
    # padded prefill: each row's first token comes from the padded last
    # position, not its true last one
    "first_token_padded_position": (
        LLAMA,
        "last = logits[torch.arange(b, device=prompt.device), lengths - 1]",
        "last = logits[:, -1]",
    ),
    # eos: a finished row goes on emitting what it decodes
    "eos_not_sticky": (
        LLAMA,
        "nxt = torch.where(done, eos_id, nxt)  # eos stays in finished rows",
        "nxt = nxt  # eos stays in finished rows",
    ),
    # the QK^T logits of a bf16 cache are rounded to bf16 before the softmax
    "qk_logits_bf16": (
        LLAMA,
        "return torch.bmm(q, k.transpose(1, 2), out_dtype=torch.float32)",
        "return torch.bmm(q, k.transpose(1, 2)).float()",
    ),
    # the engine copies an admitted row's cache into slot r+1
    "admit_wrong_slot": (
        ENGINE,
        "leaf[row].copy_(layer_1[name][0])",
        "leaf[(row + 1) % leaf.shape[0]].copy_(layer_1[name][0])",
    ),
    # slot 0's position is not advanced by a decode step
    "decode_row0_pos_frozen": (
        ENGINE,
        "st.pos = torch.clamp(st.pos + 1, max=max_pos)",
        "st.pos = torch.cat([st.pos[:1], torch.clamp(st.pos[1:] + 1, max=max_pos)])",
    ),
    # a block's rows retire only at its last step: tokens past a row's
    # stop or budget are emitted
    "block_surplus_emitted": (
        ENGINE,
        "if self._finished(p, out, t):",
        "if self._finished(p, out, t) and j == k - 1:",
    ),
    # the penalties are applied after the temperature
    "penalty_after_temperature": (
        ENGINE,
        "logits = logits - pens[:, :1] * counts - pens[:, 1:] * (counts > 0)",
        "logits = logits - (pens[:, :1] * counts + pens[:, 1:] * (counts > 0))"
        " * temps.clamp_min(1e-6)[:, None]",
    ),
    # the sampling counter is the engine's step count, not the position
    "sample_counter_is_step": (
        ENGINE,
        "counter = st.pos + 1",
        "counter = torch.full_like(st.pos, self.steps)",
    ),
    # a stream whose dispatch fails before its first token is not failed over
    "router_no_failover_before_first_token": (
        ROUTER,
        "                if not self._failed_over:",
        "                if False:",
    ),
    # the prefix L2's key leaves out the weights version
    "l2_key_without_version": (
        PREFIX_L2,
        "return f\"{version}|{adapter or ''}|{toks}\"",
        "return f\"|{adapter or ''}|{toks}\"",
    ),
    # the filler copies an offered entry without waiting for its event
    "l2_filler_before_event": (
        PREFIX_L2,
        "side.wait_event(ready)  # the entry is written before it is read",
        "pass  # the entry is written before it is read",
    ),
    # CacheServer.close() closes the listener but leaves connections open
    "cache_close_leaves_conns_open": (
        CACHE_SERVICE,
        "conns, self._conns = list(self._conns), set()",
        "conns, self._conns = [], self._conns",
    ),
    # the checkpoint loader writes the restored weights into the running
    # tensors it was given (a target restore in place)
    "loader_writes_running_tensors": (
        ROLLOUT,
        "out[name] = got.to(want.dtype) if got.is_floating_point() else got",
        "out[name] = want.detach().copy_(got) if got.is_floating_point() else got",
    ),
    # publish keeps the caller's params by reference, no snapshot
    "publish_keeps_reference": (
        ROLLOUT,
        "params = _ByReference(_snapshot(params, self._serving_dtype()))",
        "params = _ByReference(params)",
    ),
    # a rollback releases a swapped seat without re-installing its prior
    "rollback_skips_restore": (
        ROLLOUT,
        'self._apply(view["handle"], prior)',
        "pass",
    ),
    # read_latest takes a pointer whose CRC does not match its manifest
    "latest_crc_unchecked": (
        ROLLOUT,
        'if int(doc["crc"]) != zlib.crc32(_manifest_body(raw_manifest)):',
        "if False:",
    ),
    # the bank's gather is off by one slot: each row runs the next adapter
    "bank_gather_off_by_one": (
        LORA,
        "    a_sel = w.a[adapter_ids].to(x.dtype)\n    b_sel = w.b[adapter_ids].to(x.dtype)",
        "    a_sel = w.a[(adapter_ids + 1) % w.n_adapters].to(x.dtype)\n"
        "    b_sel = w.b[(adapter_ids + 1) % w.n_adapters].to(x.dtype)",
    ),
    # the int8 scales are broadcast on the weight's input axis of the square
    # weights (q_proj, o_proj), where the shapes alone let it pass: each
    # column takes another row's scale
    "int8_scale_on_input_axis": (
        QUANT,
        "    return (acc * w.scale.float().reshape(-1)).to(x.dtype)",
        "    return (torch.matmul(x.float(), (w.q.float() * w.scale.float().reshape(1, -1)).t())"
        " if w.q.shape[0] == w.q.shape[1] else acc * w.scale.float().reshape(-1)).to(x.dtype)",
    ),
    # a lora swap writes the new factors into the running weight set's own
    # tensors in place, under the requests decoding and the retained prior
    "lora_swap_writes_in_place": (
        ENGINE,
        "placed[name] = self._place_leaf(old[name], t, name)",
        "placed[name] = old[name].copy_(t)",
    ),
    # MoE routing priority flattened choices-major (every token's first
    # choice before any second one), where the reference's is token-major
    "moe_priority_choices_major": (
        MOE,
        "    order = expert.reshape(t * k)\n    onehot = F.one_hot(order, e)  # (T*k, E)\n"
        "    before = torch.cumsum(onehot, dim=0) - onehot\n"
        "    slot = before.gather(1, order[:, None]).reshape(t, k)",
        "    order = expert.t().reshape(t * k)\n    onehot = F.one_hot(order, e)  # (T*k, E)\n"
        "    before = torch.cumsum(onehot, dim=0) - onehot\n"
        "    slot = before.gather(1, order[:, None]).reshape(k, t).t()",
    ),
    # llama_loss_fn leaves the MoE layers' aux losses out of the loss
    "moe_aux_loss_dropped": (
        LLAMA,
        "        loss = loss + aux.loss",
        "        loss = loss",
    ),
    # speculative greedy accepts one draft past the first mismatch
    "spec_accepts_past_mismatch": (
        SPECULATIVE,
        "            accepted = torch.cumprod((emit[:, :k] == drafts).long(), dim=1).sum(1)",
        "            accepted = (torch.cumprod((emit[:, :k] == drafts).long(), dim=1).sum(1)"
        " + 1).clamp(max=k)",
    ),
}
# the check of phase rollout that must refuse each of its faults (its JSON
# line names every check it failed)
NAMED_CHECKS = {"loader_writes_running_tensors": "b3_verify_seat1",
                "publish_keeps_reference": "b5_publish_snapshot",
                "rollback_skips_restore": "b3_verify_seat1",
                "latest_crc_unchecked": "b4_torn_latest",
                "bank_gather_off_by_one": "c_bank_rows",
                "int8_scale_on_input_axis": "b_int8",
                "lora_swap_writes_in_place": "d_prior_intact",
                "moe_priority_choices_major": "b_block_low_cf",
                "moe_aux_loss_dropped": "a_loss_cpu",
                "spec_accepts_past_mismatch": "a_greedy_fp32"}


def check_of(name: str) -> str:
    """The chip_smoke check that must refuse fault ``name``."""
    return FAULT_CHECKS.get(name) or CHECKS[FAULTS[name][0]]

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


def start(label: str, name: str, checks: list, workdir: Path) -> subprocess.Popen:
    """A child that runs ``checks`` on a copy with fault ``name`` planted
    (every source unchanged for "none"), in ``workdir / label``."""
    copy = workdir / label
    shutil.copytree(ROOT / "tensorflowonspark_tpu_torch", copy / "tensorflowonspark_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", copy)
    sources = list(CHECKS) if name == "none" else [FAULTS[name][0]]
    for source in sources:
        (copy / source).write_text(planted((ROOT / source).read_text(), name))
    code = CHILD + "".join(f"chip_smoke.{check}\n" for check in checks)
    with open(copy / "output.log", "w") as log:  # a file: no pipe to fill while others run
        return subprocess.Popen([sys.executable, "-c", code], cwd=copy, text=True,
                                stdout=log, stderr=subprocess.STDOUT)


# checks whose children run after the others, in this order: check ->
# (label, how many children at once)
LATER = {DECODE_CHECK: ("decode", 7), SERVE_CHECK: ("serve", 6), FLEET_CHECK: ("fleet", 5),
         ROLLOUT_CHECK: ("rollout", 3), LORA_CHECK: ("lora", 4), MOE_CHECK: ("moe", 3),
         SPEC_CHECK: ("spec", 2), ELASTIC_CHECK: ("elastic", 3)}


def jobs(only: list[str] | None = None) -> list[tuple[list, int]]:
    """Stages of (label, fault, checks) children, each with how many run at
    once: every check but those of LATER at once, then each of LATER's.
    ``only`` (fault names) keeps those faults and the unchanged copy's runs
    of their checks."""
    names = list(FAULTS) if only is None else list(only)
    needed = {check_of(n) for n in names} if only is not None else None
    every = [c for c in dict.fromkeys([*CHECKS.values(), *FAULT_CHECKS.values()])
             if needed is None or c in needed]
    first = [("none", "none", [c for c in every if c not in LATER])]
    later = {check: [(f"none:{label}", "none", [check])] for check, (label, _) in LATER.items()
             if check in every}
    for name in names:
        check = check_of(name)
        (later[check] if check in LATER else first).append((name, name, [check]))
    if not first[0][2]:
        first = first[1:]
    stages = [(first, len(first))] if first else []
    return stages + [(later[c], n) for c, (_, n) in LATER.items() if c in later]


def run_all(workdir: Path, only: list[str] | None = None) -> dict:
    """Every child's (return code, output), by label."""
    done = {}
    for stage, at_once in jobs(only):
        for i in range(0, len(stage), at_once):
            procs = [(label, start(label, name, checks, workdir))
                     for label, name, checks in stage[i:i + at_once]]
            for label, proc in procs:
                proc.wait(timeout=900)
                done[label] = (proc.returncode, (workdir / label / "output.log").read_text())
    return done


def check_line(output: str) -> dict | None:
    for line in reversed(output.splitlines()):
        if line.startswith("{") and '"case"' in line:
            return json.loads(line)
    return None


def main(argv: list[str]) -> int:
    """``argv``: fault names to plant (every fault when empty)."""
    import torch

    unknown = [name for name in argv if name not in FAULTS]
    if unknown:
        print(f"chip_faults: unknown faults {unknown}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_faults: no CUDA device", file=sys.stderr)
        return 1
    good = True
    with tempfile.TemporaryDirectory() as tmp:
        results = run_all(Path(tmp), argv or None)
    for label, (rc, out) in results.items():
        line = check_line(out)
        unchanged = label.startswith("none")
        passed = line is not None and bool(line["ok"]) and rc == 0
        if line is None or (unchanged and not passed):
            print(out[-20000:], file=sys.stderr)
        if line is None:
            good = False
            continue
        failed = sorted(k for k, v in line.get("checks", {}).items() if not v)
        named = NAMED_CHECKS.get(label)
        good &= passed if unchanged else not passed and (named is None or named in failed)
        err = (line["err"] if named is None else
               line["err"].get(named, line["err"].get("b_rollback", {}).get(named)))
        print(json.dumps({"fault": label, "passed_check": passed, "case": line["case"],
                          "failed_checks": failed, "named_check": named, "err": err,
                          "lse_err": line.get("lse_err"), "tol": line["tol"]}), flush=True)
    print(json.dumps({"ok": good}))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
