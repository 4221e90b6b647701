"""HTTP server over a Llama checkpoint of the port: the counterpart of the
JAX package's ``tools/serve_model.py`` on one device, with one engine or a
fleet of them (``--gen-replicas N``: N in-process engines behind the
health-routing ``FleetRouter``, each with its own caches and scheduler
over one shared model).

stdlib-only (``http.server``), threaded, one model shared across requests.
The model runs on CUDA unless ``--device`` (``gen["device"]``) names
another device (``--device cpu``).

Endpoints::

    GET  /healthz            -> liveness (200 iff the scheduler runs;
                                in fleet mode the body carries the
                                per-replica split)
    GET  /readyz             -> readiness (200 iff live and not warming
                                or draining)
    GET  /v1/models          -> single-model list (``--served-model-name``)
    GET  /metrics            -> Prometheus text-format metrics (the
                                process registry + the continuous
                                engine's counters/gauges/histograms; in
                                fleet mode the router's merged
                                exposition, labelled by replica)
    GET  /stats              -> scheduler JSON incl. per-phase request
                                latency percentiles (queue/prefill/
                                dispatch/fetch/sweep)
    GET  /debugz/traces      -> tail-sampled request-trace ring stats
                                + retained trace ids
    GET  /debugz/trace/<id>  -> one retained request timeline as a
                                Chrome trace. Requests adopt an
                                ``X-TFOS-Trace`` header (or mint an id);
                                every JSON reply echoes ``trace``
    POST /generate           -> body {"prompts": [[token ids], ...]}
                                -> {"completions": [[token ids], ...]}
                                (``--gen-engine fixed``, the default:
                                decode params are fixed at startup and
                                each request decodes through
                                ``decode_batches``; ``--gen-engine
                                continuous``: the ``ContinuousBatcher``
                                with per-request sampling knobs,
                                ``deadline_s`` (504 on expiry), ``stream``
                                (NDJSON), ``n``, ``logprobs``)
    POST /score              -> body {"sequences": [[token ids], ...]}
                                -> {"logprobs": [[float, ...], ...]}
                                (per-token next-token logprobs through
                                the flash forward; see score_width),
                                under the weights the continuous engine
                                serves now (a rollout moves them; the
                                JAX package's keeps the boot weights)
    POST /v1/completions     -> OpenAI-completions-shaped alias over the
                                continuous engine (token ids only)
    POST /admin/reload       -> authenticated weight hot-swap (token from
                                --admin-token-file or TFOS_ADMIN_TOKEN,
                                as ``Authorization: Bearer`` or
                                ``X-Admin-Token``; 403 without one): body
                                {"version", "path", "step"?} loads a
                                committed checkpoint and swaps it into the
                                live engine(s) between decode blocks —
                                synchronous for a single engine (200, 409
                                on a shape mismatch, 500 otherwise), 202
                                and a rolling update in fleet mode

Usage::

    python -m tensorflowonspark_tpu_torch.tools.serve_model \\
        --llama-checkpoint ckpt/ --model 1b [--gen-engine continuous] \\
        [--gen-widths 128,256,512] [--max-new-tokens 64] [--port 8500] \\
        [--device cpu] [--gen-replicas 2] [--cachetier-l2 HOST:PORT] \\
        [--admin-token-file F] [--rollout-channel DIR [--rollout-poll S]]

Speculative decoding (``models.speculative``): ``--draft-checkpoint``
loads a draft (``--draft-model``, ``--draft-config-overrides``) that
proposes ``--spec-k`` tokens per verify forward on the fixed-batch path;
``width + max_new + spec_k`` must fit both models' ``max_seq_len``, and
``--gen-engine continuous`` refuses a draft (a ``ValueError`` at startup).

``--cachetier-l2`` attaches a fleet-global prefix L2 (``cachetier.
PrefixL2`` over a ``CacheClient``) to every engine; it needs
``--gen-prefix-cache``, and a failure to attach leaves the engine on its
L1 only. ``--cachetier-lookup-timeout`` bounds each lookup (the JAX
package's 0.05 s by default).

Weight rollout (``serving/rollout.py``): a ``RolloutController`` fronts the
continuous engine(s), one replica at a time with rollback; ``/admin/reload``
drives it, and ``--rollout-channel DIR`` also watches a publication
channel (a ``LATEST`` pointer at committed checkpoint directories, polled
every ``--rollout-poll`` seconds). ``/stats`` carries its state under
``rollout``.

LoRA banks and int8 weights: a checkpoint of a bank (``ops.lora.
multi_lora_bank``) serves each request's ``adapter`` (0 = the base model;
out of range: 400, as the engine raises) at the scale its checkpoint
stores (``--gen-lora-scale`` overrides it; a set that stores none gets
1.0), ``/admin/reload`` of ``"kind": "lora"``
rolls adapter factors alone (a ``rollout.lora_state`` checkpoint), and
``/score`` runs the bank's slot 0; an int8 checkpoint
(``ops.quant.quantize_tree``) serves as it is.

Not ported yet; each raises ``NotImplementedError`` at startup naming its
ROADMAP item: ``--export-dir``, ``--batch-size`` and ``/predict`` (A12,
``api/export``), ``--gen-mesh`` (A9b, mesh/TP decode), and the SLO/history plane with ``/statusz`` (``--slo-*``,
``--obs-window-s``; A12). A request to ``/predict`` or ``/statusz`` answers
501 with the same message.
"""

from __future__ import annotations

import argparse
import hmac
import json
import logging
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from tensorflowonspark_tpu_torch.cluster import wire
from tensorflowonspark_tpu_torch.obs import reqtrace
from tensorflowonspark_tpu_torch.tools.run_model import _to_jsonable

logger = logging.getLogger(__name__)

# The server most recently started by main() — lets tooling and tests
# reach a CLI-started server (e.g. its ephemeral port under --port 0).
_last_server = None

# what each refused surface is, and the ROADMAP item that ports it
_PREDICT = ("--export-dir and /predict (serving an api/export artifact)", "A12, api/export")
_STATUSZ = ("the SLO and history plane and /statusz", "A12")


def _not_ported(what: str, item: str) -> str:
    return f"{what} is not ported yet: ROADMAP {item}"


def _refuse_unported(gen: dict | None, export_dir: str | None = None) -> None:
    """Raise NotImplementedError for every option the port's server does
    not have yet — never accept one and then ignore it."""
    gen = gen or {}
    refused = [
        (export_dir is not None, *_PREDICT),
        (gen.get("mesh"), "--gen-mesh (decode on a device mesh)", "A9b, mesh/TP decode"),
        (any(gen.get(k) is not None for k in ("slo_ttft_s", "slo_latency_s", "slo_error_budget",
                                               "obs_window_s")), *_STATUSZ),
    ]
    for hit, what, item in refused:
        if hit:
            raise NotImplementedError(_not_ported(what, item))


class _Handler(BaseHTTPRequestHandler):
    # set by make_server():
    gen_fn: Any = None  # prompts -> completions (--gen-engine fixed)
    gen_batcher: Any = None  # _GenBatcher when --gen-batch-window > 0
    gen_engine: Any = None  # ContinuousBatcher, or a FleetRouter with --gen-replicas > 1
    gen_max_new: int = 64  # per-request decode budget in engine mode
    score_fn: Any = None  # sequences -> per-token logprobs (/score)
    model_name: str = "default"  # /v1/models id + completion envelopes
    # the RolloutController fronting the continuous engine(s), and the
    # shared secret gating POST /admin/reload (None = endpoint disabled:
    # hot-swapping weights is an operator-only surface)
    rollout_ctl: Any = None
    admin_token: str | None = None
    # the CURRENT request's trace id (adopted from X-TFOS-Trace or
    # minted at ingress); _reply stamps it into every JSON body so
    # error answers — 503/504 included — are trace-attributable
    _trace: str | None = None
    _last_code: int = 200
    # per-server lock (set in make_server): serializes the fixed path's
    # decode and /score on one model while the HTTP layer stays threaded
    predict_lock: threading.Lock

    def log_message(self, fmt, *fargs):  # route to logging, not stderr
        logger.info("%s " + fmt, self.client_address[0], *fargs)

    def _read_json_body(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def _reply(self, code: int, payload: dict, headers: dict | None = None) -> None:
        if self._trace is not None and "trace" not in payload:
            payload = {**payload, "trace": self._trace}
        self._reply_text(code, json.dumps(_to_jsonable(payload)), "application/json", headers)

    def _reply_text(self, code: int, text: str, content_type: str,
                    headers: dict | None = None) -> None:
        self._last_code = code
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        self._trace = None
        if self.path in ("/healthz", "/readyz"):
            # Liveness vs readiness, SPLIT: /healthz answers 200 iff
            # live, /readyz 200 iff ready (false during warmup and drain)
            h = {"live": True, "ready": True}
            if self.gen_engine is not None:
                try:
                    h = self.gen_engine.health()
                except Exception:  # noqa: BLE001 - a dead engine is a
                    # health verdict, not a 500
                    h = {"live": False, "ready": False}
            ok = h.get("live") if self.path == "/healthz" else h.get("ready")
            self._reply(200 if ok else 503,
                        {"status": "ok" if h.get("live") else "dead", "export_dir": "", **h})
        elif self.path == "/v1/models":
            # the OpenAI SDK's client.models.list() handshake
            self._reply(200, {"object": "list", "data": [
                {"id": self.model_name, "object": "model", "created": 0,
                 "owned_by": "tensorflowonspark_tpu"}]})
        elif self.path == "/metrics":
            # Prometheus text exposition: the process-global registry plus
            # the engine's per-instance registry when one is serving
            from tensorflowonspark_tpu_torch.obs import registry as obs_reg

            text = obs_reg.default_registry().render()
            if self.gen_engine is not None:
                text += self.gen_engine.metrics.render()
            self._reply_text(200, text, obs_reg.CONTENT_TYPE)
        elif self.path == "/stats":
            stats: dict = {"mode": ""}
            if self.gen_engine is not None:
                stats.update(self.gen_engine.stats(), mode=(
                    "fleet" if getattr(self.gen_engine, "IS_FLEET", False) else "continuous"))
                if self.rollout_ctl is not None:
                    stats["rollout"] = self.rollout_ctl.stats()
            elif self.gen_batcher is not None:
                stats.update(mode="coalesced", decode_calls=self.gen_batcher.decode_calls)
            elif self.gen_fn is not None:
                stats["mode"] = "fixed"
            self._reply(200, stats)
        elif self.path == "/statusz":
            self._reply(501, {"error": _not_ported(*_STATUSZ)})
        elif self.path == "/debugz/traces":
            ring = reqtrace.get_ring()
            self._reply(200, {**ring.stats(), "trace_ids": ring.ids()})
        elif self.path.startswith("/debugz/trace/"):
            tid = self.path.rsplit("/", 1)[1]
            data = reqtrace.to_chrome(tid)
            if data is None:
                self._reply(404, {"error": f"no retained trace {tid!r} (unknown, evicted, or "
                                           "not tail-sampled)"})
            else:
                self._reply(200, data)
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        self._trace = None
        if self.path == "/generate":
            self._do_generate()
        elif self.path == "/v1/completions":
            self._do_v1_completions()
        elif self.path == "/score":
            self._do_score()
        elif self.path == "/predict":
            self._reply(501, {"error": _not_ported(*_PREDICT)})
        elif self.path == "/admin/reload":
            self._do_admin_reload()
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def _do_admin_reload(self) -> None:
        """Authenticated hot weight swap. Body: ``{"version": ..., "path":
        <committed checkpoint dir>, "kind": "full", "step": N?}``.

        Single-engine mode answers SYNCHRONOUSLY once the swap, the warm-up
        probe and verification finished (the surface a fleet supervisor's
        ``SubprocessReplica.reload`` drives): 200 on ``completed``, 409 on
        a shape/name mismatch (``WeightsIncompatible`` — the caller rolls
        back), 500 otherwise. Fleet mode starts a rolling update in the
        background and answers 202: rolling N replicas under drain takes
        longer than an HTTP round trip."""
        if self.admin_token is None:
            self._reply(403, {"error": "admin endpoint disabled (no admin token configured: set "
                                       "TFOS_ADMIN_TOKEN or --admin-token-file)"})
            return
        auth = self.headers.get("Authorization", "")
        token = (auth[len("Bearer "):] if auth.startswith("Bearer ")
                 else self.headers.get("X-Admin-Token", ""))
        if not hmac.compare_digest(token.encode(), self.admin_token.encode()):
            self._reply(403, {"error": "invalid admin token"})
            return
        if self.rollout_ctl is None:
            self._reply(400, {"error": "/admin/reload requires --gen-engine continuous"})
            return
        from tensorflowonspark_tpu_torch.serving.rollout import WeightsUpdate

        try:
            payload = self._read_json_body()
            update = WeightsUpdate(
                version=str(payload["version"]), kind=str(payload.get("kind") or "full"),
                path=str(payload["path"]),
                step=None if payload.get("step") is None else int(payload["step"]),
            )
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        # stamp the rollout onto every in-flight request's timeline: a trace
        # spanning the swap shows WHICH weights served it
        reqtrace.mark("admin.reload", version=update.version)
        ctl = self.rollout_ctl
        if getattr(self.gen_engine, "IS_FLEET", False):
            threading.Thread(target=ctl.roll, args=(update,), daemon=True,
                             name="admin-rollout").start()
            self._reply(202, wire.encode("serve.reload", status="rolling",
                                         version=update.version))
            return
        t0 = time.monotonic()
        try:
            outcome = ctl.roll(update)
        except Exception as e:  # noqa: BLE001 - ferried to the caller
            logger.exception("admin reload crashed")
            self._reply(500, wire.encode("serve.error", error=f"{type(e).__name__}: {e}",
                                         error_type=type(e).__name__))
            return
        if outcome == "completed":
            self._reply(200, wire.encode("serve.reload", status="completed",
                                         version=update.version,
                                         swap_seconds=round(time.monotonic() - t0, 3)))
            return
        err = ctl.last_error or {}
        etype = err.get("type", "RolloutFailed")
        self._reply(409 if etype == "WeightsIncompatible" else 500,
                    wire.encode("serve.error",
                                error=f"rollout {outcome}: {err.get('error', 'unknown failure')}",
                                error_type=etype, outcome=outcome))

    def _do_score(self) -> None:
        if self.score_fn is None:
            self._reply(400, {"error": "server was not started with --llama-checkpoint; "
                                       "/score unavailable"})
            return
        from tensorflowonspark_tpu_torch.tools.generate_text import PromptError

        try:
            payload = self._read_json_body()
            seqs = payload["sequences"]
            if not isinstance(seqs, list):
                raise ValueError("'sequences' must be a list")
            seqs = [[int(t) for t in s] for s in seqs]
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        try:
            with self.predict_lock:
                logprobs = self.score_fn(seqs)
        except PromptError as e:
            self._reply(400, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 - server-side; log + 500
            logger.exception("scoring failed")
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, {"logprobs": logprobs})

    def _do_v1_completions(self) -> None:
        """OpenAI /v1/completions alias: translate the request into the
        native /generate schema and run the shared path, then wrap the
        result in the text_completion envelope."""
        try:
            raw = self._read_json_body()
            payload, meta = _openai_to_generate(raw, self.gen_max_new)
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        self._do_generate(payload=payload, v1_meta=meta)

    def _do_generate(self, payload=None, v1_meta=None) -> None:
        """Trace-owning ingress shell around :meth:`_generate_inner`:
        adopt the caller's ``X-TFOS-Trace`` id or mint a fresh one, then
        stamp the terminal ``http.generate`` segment and finish the record
        with the HTTP outcome."""
        hdr = self.headers.get(reqtrace.HEADER)
        tid, owned = reqtrace.ensure(hdr, route="http.generate")
        if tid is not None and hdr:
            reqtrace.flag(tid, propagated=True)
        self._trace = tid
        self._last_code = 200
        t0 = time.monotonic()
        try:
            self._generate_inner(payload, v1_meta, tid)
        except BaseException as e:
            reqtrace.flag(tid, error=type(e).__name__)
            if owned:
                reqtrace.finish(tid, outcome="error", error=type(e).__name__)
            raise
        code = self._last_code
        reqtrace.segment(tid, "http.generate", time.monotonic() - t0)
        if code >= 400:
            reqtrace.flag(tid, http_error=code)
        if owned:
            reqtrace.finish(tid, outcome="ok" if code < 400 else "error", http_status=code)

    def _generate_inner(self, payload=None, v1_meta=None, trace=None) -> None:
        if self.gen_fn is None and self.gen_engine is None:
            self._reply(400, {"error": "server was not started with --llama-checkpoint; "
                                       "/generate unavailable"})
            return
        try:
            if payload is None:
                payload = self._read_json_body()
            prompts = payload["prompts"]
            if not isinstance(prompts, list) or not prompts:
                raise ValueError("'prompts' must be a non-empty list")
            prompts = [[int(t) for t in p] for p in prompts]
            if any(not p for p in prompts):
                raise ValueError("prompts must be non-empty token lists")
            temperature = payload.get("temperature")
            max_new = payload.get("max_new_tokens")
            eos_id = payload.get("eos_id")
            adapter = payload.get("adapter")
            stop = payload.get("stop")
            n_samples = payload.get("n")
            req_top_k = payload.get("top_k")
            req_top_p = payload.get("top_p")
            req_seed = payload.get("seed")
            req_min_p = payload.get("min_p")
            req_fpen = payload.get("frequency_penalty")
            req_ppen = payload.get("presence_penalty")
            req_bias = payload.get("logit_bias")
            req_deadline = payload.get("deadline_s")
            want_logprobs = bool(payload.get("logprobs"))
            # stamp each completion with the weights version it resolved
            # under (continuous engine only)
            want_versions = bool(payload.get("versions"))
            if (
                temperature is not None or max_new is not None or eos_id is not None
                or adapter is not None or stop is not None or n_samples is not None
                or req_top_k is not None or req_top_p is not None or req_seed is not None
                or req_min_p is not None or req_fpen is not None or req_ppen is not None
                or req_bias is not None or req_deadline is not None or want_logprobs
                or want_versions
            ) and self.gen_engine is None:
                raise ValueError(
                    "per-request temperature/max_new_tokens/eos_id/"
                    "adapter/stop/n/top_k/top_p/min_p/seed/penalties/"
                    "logprobs/deadline_s require --gen-engine "
                    "continuous (the fixed path bakes decode params "
                    "at startup)"
                )
            if temperature is not None:
                temperature = float(temperature)
            if max_new is not None:
                max_new = int(max_new)
                if not 1 <= max_new <= self.gen_max_new:
                    raise ValueError(
                        f"max_new_tokens must be in [1, {self.gen_max_new}] (the server's "
                        f"configured budget), got {max_new}"
                    )
            if eos_id is not None:
                eos_id = int(eos_id)
            if adapter is not None:
                adapter = int(adapter)
            if stop is not None:
                stop = [[int(t) for t in seq] for seq in stop]
            if req_top_k is not None:
                req_top_k = int(req_top_k)
            if req_top_p is not None:
                req_top_p = float(req_top_p)
            if req_seed is not None:
                req_seed = int(req_seed)
            if req_min_p is not None:
                req_min_p = float(req_min_p)
            if req_fpen is not None:
                req_fpen = float(req_fpen)
            if req_ppen is not None:
                req_ppen = float(req_ppen)
            if req_bias is not None:
                # OpenAI wire format: JSON object keys are strings
                req_bias = {int(t): float(v) for t, v in dict(req_bias).items()}
            if req_deadline is not None:
                req_deadline = float(req_deadline)
            if n_samples is not None:
                n_samples = int(n_samples)
                if not 1 <= n_samples <= 16:
                    raise ValueError(f"n must be in [1, 16], got {n_samples}")
                # EFFECTIVE temperature: the request value, else the
                # engine-wide default; greedy would return n identical rows
                eff_temp = (temperature if temperature is not None
                            else getattr(self.gen_engine, "_temperature", 0.0))
                if n_samples > 1 and eff_temp <= 0:
                    raise ValueError(
                        "n > 1 with greedy decoding (effective temperature <= 0) would "
                        "return n identical completions; set a temperature"
                    )
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        from tensorflowonspark_tpu_torch.tools.generate_text import PromptError

        stream = bool(payload.get("stream"))
        if stream and self.gen_engine is None:
            self._reply(400, {"error": "streaming requires --gen-engine continuous"})
            return
        if stream and len(prompts) != 1:
            self._reply(400, {"error": "streaming supports exactly one prompt"})
            return
        if stream and (n_samples or 1) > 1:
            self._reply(400, {"error": "streaming supports exactly one completion (n must be 1)"})
            return
        if stream:
            self._engine_stream(
                prompts[0], temperature, max_new, eos_id, want_logprobs, adapter, stop,
                req_top_k, req_top_p, req_seed, req_min_p, req_fpen, req_ppen, req_bias,
                req_deadline, trace=trace,
            )
            return
        from tensorflowonspark_tpu_torch.serving import (
            DeadlineExceeded,
            EngineOverloaded,
            EngineWedged,
            FleetOverloaded,
            FleetUnavailable,
            ReplicaGone,
        )

        logprobs = None
        versions = None
        try:
            if self.gen_engine is not None:
                try:
                    n = n_samples or 1
                    fan = [p for p in prompts for _ in range(n)]
                    completions = self._engine_generate(
                        fan, temperature, max_new, eos_id, want_logprobs, adapter, stop,
                        req_top_k, req_top_p, req_seed, req_min_p, req_fpen, req_ppen,
                        req_bias, req_deadline, want_versions, trace=trace,
                    )
                    versions = None
                    if want_versions:
                        *rest, versions = completions
                        completions = rest[0] if len(rest) == 1 else tuple(rest)
                    if want_logprobs:
                        completions, logprobs = completions
                    if n > 1 and v1_meta is None:
                        # regroup: completions[i] becomes the LIST of n
                        # samples for prompt i (the OpenAI envelope keeps
                        # the flat order)
                        completions = [completions[i * n:(i + 1) * n]
                                       for i in range(len(prompts))]
                        if logprobs is not None:
                            logprobs = [logprobs[i * n:(i + 1) * n] for i in range(len(prompts))]
                        if versions is not None:
                            versions = [versions[i * n:(i + 1) * n] for i in range(len(prompts))]
                except FleetOverloaded as e:
                    # router admission shed: the deadline cannot be met
                    # from queue-depth estimates (or every queue is full)
                    # — tell the client when to come back, and that the
                    # number is the router's estimate
                    self._reply(429, wire.encode("serve.error", error=str(e),
                                                 error_type="FleetOverloaded",
                                                 retry_after_src="router_estimate"),
                                {"Retry-After": str(int(math.ceil(e.retry_after)))})
                    return
                except FleetUnavailable as e:
                    # full-fleet drain / no ready replica
                    self._reply(503, wire.encode("serve.error", error=str(e),
                                                 error_type="FleetUnavailable",
                                                 retry_after_src="static"),
                                {"Retry-After": "2"})
                    return
                except EngineOverloaded as e:
                    self._reply(503, wire.encode("serve.error", error=str(e),
                                                 error_type="EngineOverloaded",
                                                 retry_after_src="static"),
                                {"Retry-After": "1"})
                    return
                except DeadlineExceeded as e:
                    # an expired per-request budget is a gateway-timeout
                    # class outcome, not a server defect
                    self._reply(504, wire.encode("serve.error", error=str(e),
                                                 error_type="DeadlineExceeded"))
                    return
                except (EngineWedged, ReplicaGone) as e:
                    # the watchdog aborted in-flight work (or the replica
                    # died and failover was already spent) and the
                    # engine or fleet keeps serving — a retryable
                    # unavailability
                    self._reply(503, wire.encode("serve.error", error=str(e),
                                                 error_type=type(e).__name__,
                                                 retry_after_src="static"),
                                {"Retry-After": "1"})
                    return
                except ValueError as e:
                    # the engine's submit-side prompt validation — client
                    # fault, like PromptError below
                    self._reply(400, {"error": str(e)})
                    return
            elif self.gen_batcher is not None:
                # coalesced path: the batcher's worker serializes the
                # decode (and takes predict_lock itself)
                completions = self.gen_batcher.submit(prompts)
            else:
                with self.predict_lock:
                    completions = self.gen_fn(prompts)
        except PromptError as e:  # the caller's prompts are at fault
            self._reply(400, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 - server-side; log + 500
            logger.exception("generation failed")
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if v1_meta is not None:
            eff_max = max_new if max_new is not None else self.gen_max_new
            choices = []
            for i, comp in enumerate(completions):
                ch = {
                    "index": i,
                    # token-id server: no tokenizer to render text with;
                    # the ids ride in "tokens" (clients detokenize)
                    "text": "",
                    "tokens": comp,
                    "logprobs": None,
                    "finish_reason": "stop" if len(comp) < eff_max else "length",
                }
                if logprobs is not None:
                    ch["logprobs"] = {"tokens": comp, "token_logprobs": logprobs[i],
                                      "top_logprobs": None, "text_offset": None}
                choices.append(ch)
            import uuid

            n_prompt = sum(len(p) for p in prompts)
            n_comp = sum(len(c) for c in completions)
            self._reply(200, {
                "id": f"cmpl-{uuid.uuid4().hex}",
                "object": "text_completion",
                "created": int(time.time()),
                "model": v1_meta["model"] or self.model_name,
                "choices": choices,
                "usage": {"prompt_tokens": n_prompt, "completion_tokens": n_comp,
                          "total_tokens": n_prompt + n_comp},
            })
            return
        kw: dict[str, Any] = {"completions": completions}
        if logprobs is not None:
            kw["logprobs"] = logprobs
        if versions is not None:
            kw["weights_versions"] = versions
        self._reply(200, wire.encode("serve.completion", **kw))

    def _engine_stream(self, prompt, temperature=None, max_new=None, eos_id=None,
                       want_logprobs=False, adapter=None, stop=None, top_k=None, top_p=None,
                       seed=None, min_p=None, frequency_penalty=None, presence_penalty=None,
                       logit_bias=None, deadline_s=None, trace=None) -> None:
        """Stream one completion as newline-delimited JSON: a ``{"token":
        t}`` line per decoded token, then a ``{"done": true, "completion":
        [...]}`` trailer. The response is close-delimited (no
        Content-Length); a mid-stream failure surfaces as an ``{"error":
        ...}`` line since the 200 status is already on the wire."""
        from tensorflowonspark_tpu_torch.serving import (
            EngineOverloaded,
            FleetOverloaded,
            FleetUnavailable,
            ReplicaGone,
        )

        try:
            gen = self.gen_engine.stream(
                prompt, max_new or self.gen_max_new, temperature=temperature, eos_id=eos_id,
                yield_logprobs=want_logprobs, adapter=adapter, stop=stop, top_k=top_k,
                top_p=top_p, seed=seed, min_p=min_p, frequency_penalty=frequency_penalty,
                presence_penalty=presence_penalty, logit_bias=logit_bias,
                deadline_s=deadline_s, trace=trace,
            )
        except FleetOverloaded as e:
            self._reply(429, wire.encode("serve.error", error=str(e),
                                         error_type="FleetOverloaded",
                                         retry_after_src="router_estimate"),
                        {"Retry-After": str(int(math.ceil(e.retry_after)))})
            return
        except (FleetUnavailable, ReplicaGone) as e:
            self._reply(503, wire.encode("serve.error", error=str(e),
                                         error_type=type(e).__name__,
                                         retry_after_src="static"),
                        {"Retry-After": "2"})
            return
        except EngineOverloaded as e:
            self._reply(503, wire.encode("serve.error", error=str(e),
                                         error_type="EngineOverloaded",
                                         retry_after_src="static"),
                        {"Retry-After": "1"})
            return
        except ValueError as e:  # submit-side prompt validation
            self._reply(400, {"error": str(e)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Connection", "close")
        self.end_headers()
        out: list = []
        lps: list = []
        try:
            for item in gen:
                if want_logprobs:
                    t, lp = item
                    lps.append(lp)
                    line = wire.encode("serve.stream_chunk", token=t, logprob=lp)
                else:
                    t = item
                    line = wire.encode("serve.stream_chunk", token=t)
                out.append(t)
                self.wfile.write(json.dumps(line).encode() + b"\n")
                self.wfile.flush()
            # the engine's result is the stop-TRIMMED completion; fall
            # back to the raw tokens if the iterator wasn't exhausted
            final = gen.result if gen.result is not None else out
            tkw: dict[str, Any] = {"done": True, "completion": final}
            if trace is not None:
                tkw["trace"] = trace
            if want_logprobs:
                tkw["logprobs"] = gen.logprobs if gen.result is not None else lps
            wv = getattr(gen, "weights_version", None)
            if wv is not None:
                tkw["weights_version"] = wv
            trailer = wire.encode("serve.stream_trailer", **tkw)
            self.wfile.write(json.dumps(trailer).encode() + b"\n")
        except (BrokenPipeError, ConnectionResetError):
            logger.info("stream client disconnected")
        except Exception as e:  # noqa: BLE001 - status already sent
            logger.exception("stream failed mid-decode")
            reqtrace.flag(trace, error=type(e).__name__)
            try:
                ekw: dict[str, Any] = {"error": f"{type(e).__name__}: {e}",
                                       "error_type": type(e).__name__}
                if trace is not None:
                    ekw["trace"] = trace
                err_line = wire.encode("serve.stream_error", **ekw)
                self.wfile.write(json.dumps(err_line).encode() + b"\n")
            except OSError:
                pass
        finally:
            # Deterministic cancel on client disconnect — don't lean on
            # refcount GC of `gen` to free the slot for a dead consumer.
            gen.close()

    def _engine_generate(self, prompts, temperature=None, max_new=None, eos_id=None,
                         want_logprobs=False, adapter=None, stop=None, top_k=None, top_p=None,
                         seed=None, min_p=None, frequency_penalty=None, presence_penalty=None,
                         logit_bias=None, deadline_s=None, want_versions=False, trace=None):
        """Continuous-batching path: the request's rows are admitted
        ATOMICALLY (all accepted, or a 400/503 before any decodes), then
        decode concurrently, interleaved with other requests' rows."""
        return self.gen_engine.submit_many(
            prompts, max_new or self.gen_max_new, temperature=temperature, eos_id=eos_id,
            return_logprobs=want_logprobs, adapter=adapter, stop=stop, top_k=top_k,
            top_p=top_p, seed=seed, min_p=min_p, frequency_penalty=frequency_penalty,
            presence_penalty=presence_penalty, logit_bias=logit_bias, deadline_s=deadline_s,
            return_versions=want_versions, trace=trace,
        )


def _openai_to_generate(raw: Any, budget: int) -> tuple[dict, dict]:
    """Translate an OpenAI /v1/completions body into the native
    /generate schema (+ envelope metadata). Raises ValueError on
    malformed or unsupported fields; the caller replies 400.

    Token ids only: ``prompt`` is [ids] or [[ids], ...] and ``stop`` is
    [ids] or [[ids], ...]. ``max_tokens`` defaults to the OpenAI 16
    clamped to the server's decode ``budget``; ``temperature`` defaults to
    the OpenAI 1.0. ``logprobs: N`` maps to the sampled token's logprob
    for any non-null N including 0. ``echo``, ``suffix``, ``best_of``
    (beyond n) and ``stream`` are unsupported.
    """
    if not isinstance(raw, dict):
        raise ValueError("body must be a JSON object")
    if raw.get("echo"):
        raise ValueError("'echo' is not supported; POST /score for prompt logprobs")
    if raw.get("suffix"):
        raise ValueError("'suffix' (insertion) is not supported")
    if raw.get("stream"):
        raise ValueError("'stream' is not supported on /v1/completions; "
                         "POST /generate with stream=true instead")
    n = raw.get("n")
    best_of = raw.get("best_of")
    if best_of is not None and best_of != (n or 1):
        raise ValueError("'best_of' beyond 'n' is not supported")

    def _token_rows(value, what):
        if isinstance(value, str) or (isinstance(value, list)
                                      and any(isinstance(v, str) for v in value)):
            raise ValueError(
                f"text {what} need a tokenizer, which is corpus-specific and out of "
                f"framework scope; send token ids ([[int, ...]]) and detokenize client-side"
            )
        if not isinstance(value, list) or not value:
            raise ValueError(f"'{what}' must be a non-empty token-id list or a list of them")
        return [list(r) for r in value] if isinstance(value[0], list) else [list(value)]

    payload: dict = {"prompts": _token_rows(raw.get("prompt"), "prompts")}
    max_tokens = raw.get("max_tokens")
    payload["max_new_tokens"] = min(16, budget) if max_tokens is None else int(max_tokens)
    temp = raw.get("temperature")
    payload["temperature"] = 1.0 if temp is None else float(temp)
    for key in ("top_p", "seed", "frequency_penalty", "presence_penalty", "logit_bias", "n",
                # extensions shared with /generate
                "eos_id", "adapter", "top_k", "min_p"):
        if raw.get(key) is not None:
            payload[key] = raw[key]
    if raw.get("stop") is not None:
        payload["stop"] = _token_rows(raw["stop"], "stop sequences")
    if raw.get("logprobs") is not None:  # 0 is valid: sampled-token lp
        payload["logprobs"] = True
    return payload, {"model": raw.get("model")}


class _GenBatcher:
    """Coalesce concurrent /generate requests into shared decode calls.

    The worker thread takes the first queued request, lingers up to
    ``window`` seconds collecting more (up to ``max_rows`` prompt rows),
    runs ONE decode for all of them, and distributes per-request slices. A
    failing batch retries each request individually so one bad prompt
    cannot poison its co-batched neighbors.
    """

    _STOP = object()

    def __init__(self, gen_fn, lock, window: float, max_rows: int):
        import queue as _q

        self._gen_fn = gen_fn
        self._lock = lock
        self._window = float(window)
        self._max_rows = int(max_rows)
        self._queue: "_q.Queue" = _q.Queue()
        self._closed = False
        # Orders submit()'s closed-check-then-put against close()'s
        # set-flag-then-put-STOP.
        self._submit_lock = threading.Lock()
        self.decode_calls = 0  # observability (asserted in tests)
        threading.Thread(target=self._worker, daemon=True, name="gen-batcher").start()

    def submit(self, prompts: list[list[int]]) -> list[list[int]]:
        slot: dict = {"event": threading.Event()}
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("server shutting down")
            self._queue.put((prompts, slot))
        slot["event"].wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def close(self) -> None:
        """Release the worker thread; requests racing the shutdown are
        failed, not left hanging."""
        with self._submit_lock:
            self._closed = True
            self._queue.put(self._STOP)

    def _fail_pending(self) -> None:
        import queue as _q

        while True:
            try:
                item = self._queue.get_nowait()
            except _q.Empty:
                return
            if item is self._STOP:
                continue
            _, slot = item
            slot["error"] = RuntimeError("server shutting down")
            slot["event"].set()

    def _decode(self, prompts):
        self.decode_calls += 1
        with self._lock:
            return self._gen_fn(prompts)

    def _worker(self) -> None:
        import queue as _q

        pending = None
        while True:
            first = pending if pending is not None else self._queue.get()
            pending = None
            if first is self._STOP:
                self._fail_pending()
                return
            batch = [first]
            rows = len(first[0])
            deadline = time.monotonic() + self._window
            while rows < self._max_rows:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except _q.Empty:
                    break
                if item is self._STOP or rows + len(item[0]) > self._max_rows:
                    # capacity (or shutdown): carry into the next round
                    pending = item
                    break
                batch.append(item)
                rows += len(item[0])
            flat = [p for req, _ in batch for p in req]
            try:
                results = self._decode(flat)
            except Exception as e:  # noqa: BLE001
                from tensorflowonspark_tpu_torch.tools.generate_text import PromptError

                if len(batch) > 1 and isinstance(e, PromptError):
                    # isolate the guilty request(s)
                    for req, slot in batch:
                        try:
                            slot["result"] = self._decode(req)
                        except Exception as e_one:  # noqa: BLE001
                            slot["error"] = e_one
                        slot["event"].set()
                else:
                    for _, slot in batch:
                        slot["error"] = e
                        slot["event"].set()
                continue
            i = 0
            for req, slot in batch:
                slot["result"] = results[i:i + len(req)]
                i += len(req)
                slot["event"].set()


def _load_model(gen: dict):
    """The Llama of ``gen`` (``model``, ``config_overrides``) with the
    checkpoint's weights, on ``gen["device"]`` (CUDA unless named)."""
    from tensorflowonspark_tpu_torch import resolve_device
    from tensorflowonspark_tpu_torch.tools.generate_text import (
        _load_config,
        _load_params,
        load_model,
    )

    device = resolve_device(gen.get("device"))
    cfg = _load_config(argparse.Namespace(model=gen["model"],
                                          config_overrides=gen.get("config_overrides")))
    return cfg, device, lambda: load_model(
        cfg, _load_params(gen["checkpoint"], cfg, gen.get("lora_scale")), device)


def _build_engine(gen: dict):
    """Build the continuous-batching engine for ``--gen-engine
    continuous``: one persistent slot-based decode loop instead of the
    fixed-batch gen_fn, or with ``replicas`` > 1 a ``ServingFleet`` of
    such engines behind a ``FleetRouter`` (returned in the engine's
    place: it has the engine's surface). Incompatible with the
    coalescing window — reject at startup, not on the first request."""
    from tensorflowonspark_tpu_torch.serving import ContinuousBatcher

    for bad, flag in (("batch_window", "--gen-batch-window"),
                      ("draft_checkpoint", "--draft-checkpoint")):
        if gen.get(bad):
            raise ValueError(
                f"--gen-engine continuous does not compose with {flag} (the engine "
                "schedules per token; those options belong to the fixed-batch path)"
            )
    cfg, _, load = _load_model(gen)
    max_new = int(gen.get("max_new_tokens", 64))
    raw_widths = gen.get("widths")
    if raw_widths:
        # --gen-widths replaces --gen-width entirely
        try:
            widths = tuple(int(w) for w in str(raw_widths).split(","))
        except ValueError:
            raise ValueError(f"--gen-widths must be a CSV of integers, got {raw_widths!r}") from None
        if not widths or any(w < 1 for w in widths):
            raise ValueError(f"--gen-widths buckets must be >= 1, got {raw_widths!r}")
    else:
        widths = (int(gen.get("width", 128)),)
    if max(widths) + max_new > cfg.max_seq_len:
        raise ValueError(
            f"largest prompt-width bucket ({max(widths)}) + --max-new-tokens ({max_new}) "
            f"exceeds max_seq_len ({cfg.max_seq_len})"
        )
    max_queue = gen.get("max_queue")
    if max_queue is not None and int(max_queue) < 1:
        raise ValueError(f"--gen-max-queue must be >= 1, got {max_queue}")
    # Cheap shape validation above happens BEFORE the checkpoint restore.
    model = load()

    engine_kw = dict(
        slots=int(gen.get("slots") or gen.get("batch_size", 8)),
        prompt_widths=widths,
        temperature=float(gen.get("temperature", 0.0)),
        top_k=gen.get("top_k"),
        top_p=gen.get("top_p"),
        min_p=gen.get("min_p"),
        eos_id=gen.get("eos_id"),
        seed=int(gen.get("seed", 0)),
        max_queue=gen.get("max_queue"),
        prefill_chunk=gen.get("prefill_chunk"),
        prefix_cache=gen.get("prefix_cache"),
        # only None (unset) takes the default; explicit values pass
        # through to the engine's own max(1, ...) clamp
        decode_block=8 if gen.get("decode_block") is None else int(gen["decode_block"]),
        pipeline_depth=2 if gen.get("pipeline_depth") is None else int(gen["pipeline_depth"]),
        watchdog_s=None if gen.get("watchdog_s") is None else float(gen["watchdog_s"]),
    )

    def _new_prefix_l2():
        # Fresh per engine (each facade owns a filler thread + client);
        # any construction failure degrades to L1-only — the cache tier
        # must never keep a replica from serving.
        addr = gen.get("cachetier_l2")
        if not addr:
            return None
        if not gen.get("prefix_cache"):
            logger.warning("--cachetier-l2 needs --gen-prefix-cache; serving without the L2")
            return None
        try:
            from tensorflowonspark_tpu_torch.cachetier import CacheClient, PrefixL2

            return PrefixL2(CacheClient(addr), chunk=int(gen.get("prefill_chunk") or 1),
                            lookup_timeout_s=float(gen.get("cachetier_lookup_timeout_s", 0.05)),
                            own_client=True)
        except Exception:  # noqa: BLE001 - L2 is optional
            logger.warning("cachetier L2 attach failed", exc_info=True)
            return None

    def factory():
        # One engine per call: the fleet path respawns replicas through
        # this, so everything scheduler-stateful is built fresh here;
        # the model (its weights) is shared read-only.
        return ContinuousBatcher(model, **engine_kw, prefix_l2=_new_prefix_l2())

    n_replicas = int(gen.get("replicas") or 1)
    if n_replicas > 1:
        # The fleet plane: N in-process replicas (each with its own
        # scheduler + watchdog) behind the health-routing FleetRouter —
        # the handler talks to the router exactly as to one engine.
        from tensorflowonspark_tpu_torch.serving.fleet import ServingFleet
        from tensorflowonspark_tpu_torch.serving.router import FleetRouter

        t0 = time.monotonic()
        fleet = ServingFleet(factory=factory, replicas=n_replicas,
                             probe_interval=float(gen.get("probe_interval") or 1.0),
                             warmup=bool(gen.get("warmup")))
        router = FleetRouter(fleet, default_temperature=float(gen.get("temperature", 0.0)))
        logger.info("serving fleet of %d replicas ready in %.1fs", n_replicas,
                    time.monotonic() - t0)
        return router, max_new, model
    engine = factory()
    if gen.get("warmup"):
        t0 = time.monotonic()
        engine.warmup()
        logger.info("engine warmup ran every program in %.1fs", time.monotonic() - t0)
    return engine, max_new, model


def _build_gen_fn(gen: dict):
    """Build ``prompts -> completions`` over a Llama checkpoint at one
    (gen_batch_size, gen_width) decode shape through the port's
    ``decode_batches``; sampled decodes draw from one generator seeded
    ``gen["seed"]`` on the model's device, continued across requests. With
    ``draft_checkpoint`` the decode is speculative: a draft of
    ``draft_model`` / ``draft_config_overrides`` proposes ``spec_k`` tokens
    a verify. Returns ``(gen_fn, batch_size, model)``."""
    import torch

    from tensorflowonspark_tpu_torch.tools.generate_text import (
        _load_config,
        _load_params,
        decode_batches,
        load_model,
    )

    if float(gen.get("temperature", 0.0)) == 0.0 and any(
        gen.get(k) is not None for k in ("top_k", "top_p", "min_p")
    ):
        # generate() raises the same error per call; surface it at
        # startup, BEFORE the checkpoint restore
        raise ValueError(
            "--top-k/--top-p/--min-p require --temperature > 0 (temperature 0 is greedy "
            "argmax, which would silently ignore them)"
        )
    cfg, device, load = _load_model(gen)
    width = int(gen.get("width", 128))
    bsz = int(gen.get("batch_size", 8))
    max_new = int(gen.get("max_new_tokens", 64))
    if bsz < 1:
        raise ValueError(f"--gen-batch-size must be >= 1, got {bsz}")
    if width + max_new > cfg.max_seq_len:
        raise ValueError(
            f"--gen-width ({width}) + --max-new-tokens ({max_new}) exceeds max_seq_len "
            f"({cfg.max_seq_len})"
        )
    spec_k = 4 if gen.get("spec_k") is None else int(gen["spec_k"])
    draft_load = None
    if gen.get("draft_checkpoint"):
        # fail at startup, before either checkpoint's restore
        if spec_k < 1:
            raise ValueError(f"--spec-k must be >= 1, got {spec_k}")
        if any(gen.get(k) is not None for k in ("top_k", "top_p", "min_p")):
            raise ValueError(
                "--draft-checkpoint supports greedy and plain-temperature sampling; drop "
                "--top-k/--top-p/--min-p (truncation would change the distribution the "
                "rejection rule preserves)"
            )
        dcfg = _load_config(argparse.Namespace(
            model=gen.get("draft_model") or "tiny",
            config_overrides=gen.get("draft_config_overrides")))
        # the verify window needs spec_k slots of headroom in both caches
        for nm, c in (("--model", cfg), ("--draft-model", dcfg)):
            if width + max_new + spec_k > c.max_seq_len:
                raise ValueError(
                    f"--gen-width ({width}) + --max-new-tokens ({max_new}) + --spec-k "
                    f"({spec_k}) exceeds {nm}'s max_seq_len ({c.max_seq_len})"
                )
        draft_load = lambda: load_model(  # noqa: E731
            dcfg, _load_params(gen["draft_checkpoint"], dcfg), device)
    model = load()
    draft = None if draft_load is None else draft_load()
    gen_box = [torch.Generator(device=device).manual_seed(int(gen.get("seed", 0)))]

    def gen_fn(prompts: list[list[int]]) -> list[list[int]]:
        out, gen_box[0] = decode_batches(
            model, prompts, batch_size=bsz, width=width, max_new_tokens=max_new,
            # server mode: one (gen_batch_size, width) shape for every request
            pad_to_batch=True,
            generator=gen_box[0], temperature=float(gen.get("temperature", 0.0)),
            top_k=gen.get("top_k"), top_p=gen.get("top_p"), min_p=gen.get("min_p"),
            eos_id=gen.get("eos_id"), draft=draft, spec_k=spec_k,
        )
        return out

    return gen_fn, bsz, model


def score_width(max_bucket: int, max_new: int, max_seq_len: int) -> int:
    """The ``/score`` width: it covers anything ``/generate`` can emit (the
    largest prompt bucket plus the decode budget), rounded up to 128·n + 1
    so that the forward's 128·n positions meet the flash gate (multiples
    of 128), capped at the model's context. Rows are right-padded, and
    causal attention keeps the padded tail out of every real position."""
    need = min(max_bucket + max_new, max_seq_len)
    return min(-(-(need - 1) // 128) * 128 + 1, max_seq_len)


def _scoring_module(engine, lm):
    """The module ``/score`` runs beside the continuous engine: the one the
    engine serves now, or in fleet mode the one of the lowest-numbered ready
    replica (``lm`` when none is ready). Mid-rollout a fleet serves two
    versions, and ``/score`` takes that replica's."""
    if getattr(engine, "IS_FLEET", False):
        for v in sorted(engine.fleet.ready_views(), key=lambda v: v["rid"]):
            eng = getattr(v["handle"], "engine", None)
            if eng is not None:
                return eng.serving_module()
        return lm
    return engine.serving_module()


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer that also releases the request batcher's
    worker thread and closes the engine on shutdown."""

    gen_batcher = None
    gen_engine = None
    rollout_ctl = None
    drain_on_shutdown = False

    def shutdown(self) -> None:
        super().shutdown()
        if self.rollout_ctl is not None:
            # stop watching the channel BEFORE the engines go away: a
            # rollout racing teardown would hold seats of a closing fleet
            self.rollout_ctl.stop()
        if self.gen_batcher is not None:
            self.gen_batcher.close()
        if self.gen_engine is not None:
            # drain: accepted requests finish before the engine stops
            # (--gen-drain-on-shutdown); default remains abrupt
            self.gen_engine.close(drain=self.drain_on_shutdown)


def make_server(export_dir: str | None, port: int = 8500, host: str = "127.0.0.1",
                gen: dict | None = None) -> ThreadingHTTPServer:
    """Load the ``gen`` Llama checkpoint config and return a ready
    (unstarted) HTTP server; callers drive ``serve_forever``/``shutdown``
    (tests bind port 0). Binds localhost by default — the endpoint is
    unauthenticated. ``export_dir`` (an api/export artifact) is not
    ported yet and must be None."""
    _refuse_unported(gen, export_dir)
    if gen is not None and gen.get("rollout_channel") and gen.get("engine") != "continuous":
        raise ValueError("a rollout channel requires the continuous engine (only it hot-swaps "
                         "weights)")
    gen_fn, gen_bsz = (None, 0)
    engine, engine_max_new = (None, 64)
    score_fn = None
    if gen is not None and gen.get("engine") == "continuous":
        engine, engine_max_new, lm = _build_engine(gen)
    elif gen is not None:
        gen_fn, gen_bsz, lm = _build_gen_fn(gen)
    if gen is not None:
        from tensorflowonspark_tpu_torch.tools.generate_text import build_score_fn

        if gen.get("engine") == "continuous" and gen.get("widths"):
            max_bucket = max(int(w) for w in str(gen["widths"]).split(","))
        else:
            max_bucket = int(gen.get("width", 128))
        width = score_width(max_bucket, int(gen.get("max_new_tokens", 64)), lm.cfg.max_seq_len)
        bsz = int(gen.get("batch_size", 8))
        if engine is None:
            score_fn = build_score_fn(lm, width=width, bsz=bsz)
        else:
            def score_fn(seqs):
                # /score follows a rollout: it runs the weights served now
                return build_score_fn(_scoring_module(engine, lm), width=width, bsz=bsz)(seqs)
    lock = threading.Lock()  # per-server, not shared
    batcher = None
    window = float(gen.get("batch_window", 0.0) or 0.0) if gen else 0.0
    if gen_fn is not None and window > 0:
        batcher = _GenBatcher(gen_fn, lock, window, gen_bsz)
    rollout_ctl = None
    if engine is not None:
        # a controller always fronts the continuous engine(s): /admin/reload
        # drives it, and --rollout-channel also starts the channel watcher
        # (no thread until start()). The loader reads the running weights'
        # names, shapes and dtypes, and restores into tensors of its own.
        from tensorflowonspark_tpu_torch.serving.rollout import (
            RolloutController,
            checkpoint_loader,
        )

        rollout_ctl = RolloutController(
            engine.fleet if getattr(engine, "IS_FLEET", False) else engine,
            channel_dir=gen.get("rollout_channel"),
            loader=checkpoint_loader(dict(lm.named_parameters())),
            poll_interval=float(gen.get("rollout_poll") or 2.0),
        )
        if gen.get("rollout_channel"):
            rollout_ctl.start()
    handler = type(
        "_BoundHandler",
        (_Handler,),
        {
            # staticmethod: a bare function class attribute would bind as a
            # method and receive the handler as its first argument
            "gen_fn": staticmethod(gen_fn) if gen_fn is not None else None,
            "gen_batcher": batcher,
            "gen_engine": engine,
            "gen_max_new": engine_max_new,
            "score_fn": staticmethod(score_fn) if score_fn is not None else None,
            "model_name": str(gen.get("served_model_name") or "default") if gen else "default",
            "rollout_ctl": rollout_ctl,
            "admin_token": gen.get("admin_token") if gen else None,
            "predict_lock": lock,
        },
    )
    server = _Server((host, port), handler)
    server.gen_batcher = batcher
    server.gen_engine = engine
    server.rollout_ctl = rollout_ctl
    server.drain_on_shutdown = bool(gen.get("drain_on_shutdown") if gen else False)
    return server


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="serve_model",
        description="HTTP serving of a Llama checkpoint of the PyTorch port (/generate, "
        "/v1/completions, /score)",
    )
    p.add_argument("--export-dir", default=None,
                   help="serve an api/export artifact (not ported: ROADMAP A12)")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--batch-size", type=int, default=None,
                   help="the /predict batch of an api/export artifact (not ported: ROADMAP A12)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (unauthenticated endpoint: exposing beyond localhost is "
                   "an explicit choice)")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: CUDA; 'cpu' to run there)")
    p.add_argument("--llama-checkpoint", default=None)
    p.add_argument("--model", choices=("tiny", "1b", "7b"), default="tiny")
    p.add_argument("--config-overrides", default=None)
    p.add_argument("--gen-width", type=int, default=128)
    p.add_argument("--gen-batch-size", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--min-p", type=float, default=None)
    p.add_argument("--eos-id", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--draft-checkpoint", default=None,
                   help="speculative decoding for /generate (--gen-engine fixed): a checkpoint "
                   "of a draft model proposing --spec-k tokens per verify forward of the "
                   "target; greedy output equals the plain greedy decode")
    p.add_argument("--draft-model", choices=("tiny", "1b", "7b"), default="tiny")
    p.add_argument("--draft-config-overrides", default=None,
                   help="JSON LlamaConfig overrides of the draft model")
    p.add_argument("--spec-k", type=int, default=4)
    p.add_argument("--gen-batch-window", type=float, default=0.0,
                   help="coalesce concurrent /generate requests: linger this many seconds "
                   "collecting requests into one shared decode batch (up to --gen-batch-size "
                   "rows); 0 = decode per request")
    p.add_argument("--gen-mesh", default=None,
                   help="shard decoding over a device mesh (not ported: ROADMAP A9b)")
    p.add_argument("--gen-engine", choices=("fixed", "continuous"), default="fixed",
                   help="'continuous' = slot-based continuous batching: requests join/leave a "
                   "persistent decode loop at token granularity; does not compose with "
                   "--gen-batch-window")
    p.add_argument("--gen-slots", type=int, default=None,
                   help="continuous engine KV-cache slots (default: --gen-batch-size)")
    p.add_argument("--gen-widths", default=None,
                   help="continuous engine prompt-width buckets as a CSV (e.g. '32,128'): each "
                   "prompt prefills at the smallest bucket that fits (default: one bucket of "
                   "--gen-width)")
    p.add_argument("--gen-max-queue", type=int, default=None,
                   help="continuous engine: shed load with HTTP 503 once this many requests "
                   "are waiting for a slot (default: unbounded)")
    p.add_argument("--gen-drain-on-shutdown", action="store_true",
                   help="continuous engine: on server shutdown, finish accepted requests "
                   "before stopping instead of failing them")
    p.add_argument("--served-model-name", default="default",
                   help="model id reported by GET /v1/models and echoed in /v1/completions "
                   "envelopes")
    p.add_argument("--gen-lora-scale", type=float, default=None,
                   help="override the LoRA adapters' scale alpha/rank (default: the scale "
                   "the checkpoint stores, else 1.0, add_lora's default alpha=rank)")
    p.add_argument("--gen-warmup", action="store_true",
                   help="continuous engine: run every decode/prefill program once at startup "
                   "so the first real request pays neither the first kernel launches nor the "
                   "slot cache's allocation")
    p.add_argument("--gen-prefix-cache", type=int, default=None,
                   help="continuous engine: keep an LRU of this many prompt-prefix KV caches so "
                   "requests sharing a prefix resume prefill instead of recomputing it; each "
                   "entry holds one full-length single-row KV cache in device memory. "
                   "Requires --gen-prefill-chunk")
    p.add_argument("--cachetier-l2", default=None, metavar="HOST:PORT",
                   help="continuous engine: attach the fleet-global prefix L2 at this cachetier "
                   "daemon address (a ServingFleet in spawn mode injects it); requires "
                   "--gen-prefix-cache. Unreachable = L1-only")
    p.add_argument("--cachetier-lookup-timeout", type=float, default=0.05,
                   help="bound on one prefix-L2 lookup over all its depth probes, in seconds; a "
                   "lookup past it is a miss")
    p.add_argument("--gen-decode-block", type=int, default=8,
                   help="continuous engine: decode this many tokens per host scheduling "
                   "iteration (one fetch per block); 1 = per-token scheduling")
    p.add_argument("--gen-pipeline-depth", type=int, default=2,
                   help="continuous engine: keep this many decode blocks in flight so the "
                   "host sweep overlaps device work; 1 = the strictly serial "
                   "dispatch->fetch->sweep loop (identical tokens either way)")
    p.add_argument("--gen-prefill-chunk", type=int, default=None,
                   help="continuous engine: prefill prompts in chunks of this many tokens "
                   "interleaved with decode steps (default: whole-bucket prefill)")
    p.add_argument("--gen-replicas", type=int, default=1,
                   help="continuous engine: run this many engine replicas (each with its own "
                   "scheduler/watchdog) behind a health-routing fleet router — prefix-aware "
                   "placement, failover, draining, deadline-based load shedding (429/503). 1 = "
                   "the single engine, no router")
    p.add_argument("--gen-probe-interval", type=float, default=1.0,
                   help="fleet mode: replica health-probe cadence in seconds; an unhealthy "
                   "replica flips to draining within miss_limit probes and is respawned")
    p.add_argument("--port-file", default=None,
                   help="write the actually-bound port (useful with --port 0) to this file once "
                   "the server is ready to accept requests")
    p.add_argument("--admin-token-file", default=None,
                   help="enable the authenticated POST /admin/reload weight hot-swap endpoint "
                   "with the token read from this file (else from TFOS_ADMIN_TOKEN, which a "
                   "fleet supervisor injects into its subprocess replicas); without a token "
                   "the endpoint answers 403")
    p.add_argument("--rollout-channel", default=None,
                   help="continuous engine: watch this checkpoint publication channel (an "
                   "atomically written LATEST pointer at committed checkpoint directories; see "
                   "serving/rollout.py) and hot-swap each newly published version into the live "
                   "engine(s) — one replica at a time under router health with --gen-replicas, "
                   "with automatic rollback on failure")
    p.add_argument("--rollout-poll", type=float, default=2.0,
                   help="rollout channel poll interval in seconds")
    for flag in ("--slo-ttft-s", "--slo-latency-s", "--slo-error-budget", "--obs-window-s"):
        p.add_argument(flag, type=float, default=None,
                       help="the SLO and history plane (not ported: ROADMAP A12)")
    p.add_argument("--gen-watchdog", type=float, default=None,
                   help="continuous engine: abort in-flight requests (terminal EngineWedged) "
                   "and keep serving when the scheduler makes no progress for this many "
                   "seconds with work in flight. Default: disabled")
    return p


def read_admin_token(path: str | None) -> str | None:
    """The /admin/reload secret: the contents of ``path`` (stripped), else
    ``TFOS_ADMIN_TOKEN``; None (the endpoint answers 403) when neither
    holds one."""
    token = None
    if path:
        with open(path, encoding="utf-8") as f:
            token = f.read().strip() or None
    return token or os.environ.get("TFOS_ADMIN_TOKEN") or None


def main(argv: list[str] | None = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.export_dir is None and args.llama_checkpoint is None:
        p.error("need --llama-checkpoint")
    if args.gen_replicas > 1 and args.gen_engine != "continuous":
        p.error("--gen-replicas > 1 requires --gen-engine continuous (the fleet router fronts "
                "continuous engines)")
    if args.gen_replicas < 1:
        p.error(f"--gen-replicas must be >= 1, got {args.gen_replicas}")
    if args.rollout_channel and args.gen_engine != "continuous":
        p.error("--rollout-channel requires --gen-engine continuous (only the continuous "
                "engine hot-swaps weights)")
    if args.batch_size is not None:
        raise NotImplementedError(_not_ported("--batch-size (the /predict batch)",
                                              _PREDICT[1]))
    logging.basicConfig(level=logging.INFO)
    admin_token = read_admin_token(args.admin_token_file)
    gen = None
    if args.llama_checkpoint is not None:
        gen = dict(
            checkpoint=args.llama_checkpoint,
            model=args.model,
            config_overrides=args.config_overrides,
            device=args.device,
            width=args.gen_width,
            batch_size=args.gen_batch_size,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            top_k=args.top_k,
            top_p=args.top_p,
            min_p=args.min_p,
            eos_id=args.eos_id,
            seed=args.seed,
            mesh=args.gen_mesh,
            batch_window=args.gen_batch_window,
            draft_checkpoint=args.draft_checkpoint,
            draft_model=args.draft_model,
            draft_config_overrides=args.draft_config_overrides,
            spec_k=args.spec_k,
            engine=args.gen_engine,
            slots=args.gen_slots,
            widths=args.gen_widths,
            max_queue=args.gen_max_queue,
            prefill_chunk=args.gen_prefill_chunk,
            prefix_cache=args.gen_prefix_cache,
            cachetier_l2=args.cachetier_l2,
            cachetier_lookup_timeout_s=args.cachetier_lookup_timeout,
            decode_block=args.gen_decode_block,
            pipeline_depth=args.gen_pipeline_depth,
            watchdog_s=args.gen_watchdog,
            warmup=args.gen_warmup,
            lora_scale=args.gen_lora_scale,
            drain_on_shutdown=args.gen_drain_on_shutdown,
            served_model_name=args.served_model_name,
            replicas=args.gen_replicas,
            probe_interval=args.gen_probe_interval,
            admin_token=admin_token,
            rollout_channel=args.rollout_channel,
            rollout_poll=args.rollout_poll,
            slo_ttft_s=args.slo_ttft_s,
            slo_latency_s=args.slo_latency_s,
            slo_error_budget=args.slo_error_budget,
            obs_window_s=args.obs_window_s,
        )
    server = make_server(args.export_dir, args.port, host=args.host, gen=gen)
    global _last_server  # drive/inspect a CLI-started server (tests,
    _last_server = server  # operator tooling; the bound port for --port 0)
    logger.info("serving %s on :%d", args.llama_checkpoint, server.server_address[1])
    if args.port_file:
        # atomic (tmp + rename): a poller must never read a torn port.
        # Written AFTER make_server returns — the engine is built (and
        # warmed, with --gen-warmup).
        tmp = f"{args.port_file}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(str(server.server_address[1]))
        os.replace(tmp, args.port_file)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
