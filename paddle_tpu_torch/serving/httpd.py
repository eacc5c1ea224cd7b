"""Thin stdlib HTTP endpoint for smoke-serving an Engine (a copy of
``paddle_tpu/serving/httpd.py``; ``main`` builds the port's model and
engine, on the CUDA card unless ``--device`` says otherwise).

Not a production frontend — it exists so the engine can be driven and
scraped end-to-end with nothing but ``curl`` (and so tests exercise the
full submit -> queue -> slot -> result path over a real socket):

  POST /generate   {"prompt": [1,2,3], "max_new_tokens": 8,
                    "eos_token_id": null, "timeout": null,
                    "temperature": 1.0, "top_k": 0, "top_p": 1.0,
                    "priority": 0, "tenant": null,
                    "adapter": null, "stream": false}
                -> {"ids": [...], "generated": [...], "ttft_ms": ...}
                   overload: 503 QueueFull / DeadlineShed, 429
                   RateLimited — each with a COMPUTED Retry-After
                   (queue backlog over the measured drain rate /
                   token-bucket refill time), not a fixed constant.
                   "adapter" routes through a loaded LoRA lane (404
                   {"reason": "unknown_adapter"} otherwise).
                   "stream": true switches the response to SSE
                   (text/event-stream, no buffering): one "token"
                   event per generated token the tick it lands,
                   ":hb" comment frames on idle gaps, and a terminal
                   "done" event carrying the full /generate payload
                   — or a terminal "error" event with the reason and
                   retry_after when the stream is shed or dies
                   mid-response (the client never sees a silently
                   truncated body)
  GET  /metrics    Prometheus text exposition (monitor registry)
  GET  /healthz    {"slots_free": n, "queue_depth": n,
                    "kv_blocks_free": n|null, ...} — always carries
                   the router-tier load signals (queue depth, free
                   slots, free KV blocks) plus the LIVENESS vs
                   READINESS split: "live" (process up), "ready"
                   (accepting new work), "state" distinguishing
                   "draining" (finishing up — stop routing, let it
                   land its streams) from "watchdog_fired" (wedged
                   tick — possibly dying) from "ok"
  GET  /livez      200 while the process serves (liveness probe)
  GET  /readyz     200 {"ready": true} when accepting new work;
                   503 with a machine-readable "reason"
                   ("draining" | "watchdog_fired") when not — a
                   router (or k8s-style prober) distinguishes
                   "dying" from "finishing up" without parsing prose
  GET  /debug/trace     current trace ring as chrome-trace JSON
                        (open in chrome://tracing / Perfetto, or feed
                        tools/trace_view.py)
  GET  /debug/requests  in-flight slot/request states (prefill
                        progress, spec lanes, KV blocks) + the queue
                        + the recent migration log
  POST /migrate/export  KV block migration, source side.  Three body
                        shapes: {"request_id": n} exports a LIVE
                        stream; {"prompt": [...], ...generate params,
                        "min_tokens": 1} submits, decodes to
                        min_tokens, then exports (the disaggregated
                        PREFILL replica's path); {"prefix_only":
                        true, "tokens": [...]} exports the longest
                        cached prefix from the trie (cross-replica
                        prefix warming).  -> {"completed": bool,
                        "generated": [...], "payload": {...}|null}
                        with the payload in JSON wire form
                        (kvcache.payload_to_json)
  POST /migrate/import  destination side: body is a wire payload.  A
                        stream payload is adopted block-for-block and
                        DECODED TO COMPLETION here — the response is
                        /generate-shaped (the disaggregated DECODE
                        replica's path); a prefix payload ("request"
                        null) warms the trie -> {"blocks": n,
                        "tokens": n}.  Failure leaves the destination
                        owning nothing (503 "migrate_failed" /
                        "queue_full"; 400 on geometry mismatch)

Every 4xx/5xx body is JSON with a machine-readable ``reason``
(``bad_request`` / ``queue_full`` / ``rate_limited`` /
``deadline_shed`` / ``draining`` / ``result_timeout`` / ``internal``
/ ``not_found`` / ``http_<code>`` for stdlib-generated errors) and a
``Content-Type`` header — the router tier's retry classifier keys on
``reason``, never on prose.

Handlers run on ThreadingHTTPServer worker threads and block on
``Request.result()`` while the engine's own thread decodes — the
continuous-batching point: N concurrent POSTs share slot ticks.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import monitor
from .kvcache import KVDtypeMismatch, payload_to_json
from .lora import UnknownAdapter
from .request import (DeadlineShed, RateLimited, Rejected,
                      RequestTimeout)
from .stream import TokenStream, sse_format


def _retry_after_header(e):
    """Retry-After header dict from a Rejected exception's computed
    hint (HTTP wants integer delta-seconds; round up, floor 1).
    ``retry_after=None`` means the engine has NO honest backoff —
    e.g. an over-burst request that can never pass its rate limit —
    so no header is sent rather than a made-up constant that would
    put a compliant client on a retry treadmill."""
    ra = getattr(e, "retry_after", None)
    if ra is None:
        return {}
    return {"Retry-After": str(max(int(-(-float(ra) // 1)), 1))}


def _hist_mean(h):
    """Mean of a monitor Histogram as a rounded float, 0.0 when
    missing or empty (the /healthz JSON must never carry a NaN)."""
    return 0.0 if h is None else round(h.mean(), 3)


def _shed_reason(e, draining=False):
    """Machine-readable reason code for a Rejected exception — the
    router's retry classifier keys on this, not on the message."""
    if isinstance(e, RateLimited):
        return "rate_limited"
    if isinstance(e, DeadlineShed):
        return "deadline_shed"
    # QueueFull covers both a full queue and a draining engine; the
    # distinction matters to a router (draining = stop routing here
    # entirely; queue_full = back off and retry here) — the caller
    # passes the engine's actual drain flag, never message prose
    if draining:
        return "draining"
    return "queue_full"


def _readiness(eng):
    """(ready, state) for the liveness/readiness split: an engine that
    is DRAINING is finishing up (in-flight streams complete, no new
    work), one whose WATCHDOG fired is wedged mid-tick (possibly
    dying) — a prober must treat the two differently, and neither is
    the same as dead."""
    if getattr(eng, "_watchdog_fired", False):
        return False, "watchdog_fired"
    if getattr(eng, "_draining", False):
        return False, "draining"
    return True, "ok"


class JsonHandler(BaseHTTPRequestHandler):
    """Shared JSON-HTTP plumbing for the serving tier's handlers
    (engine httpd AND routerd): quiet logging, Content-Length'd
    sends, and the JSON-with-``reason`` error contract — including
    stdlib-generated errors (malformed request line, unsupported
    method), which would otherwise emit an HTML body.  The contract
    lives HERE, once: a router client never parses prose."""

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code, body, ctype="application/json", headers=None):
        data = body if isinstance(body, bytes) else body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code, obj, headers=None):
        self._send(code, json.dumps(obj), headers=headers)

    def send_error(self, code, message=None, explain=None):
        # stdlib send_error closes the connection — keep that: a
        # stdlib-generated error (unsupported method, malformed
        # request line) can leave an unread request body on the
        # socket, and a keep-alive client would desync parsing those
        # bytes as the next request line
        self.close_connection = True
        body = json.dumps({"error": message or f"HTTP {code}",
                           "reason": f"http_{code}"}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Connection", "close")
        self.end_headers()
        # stdlib suppresses the body for HEAD and bodyless statuses
        if self.command != "HEAD" and code >= 200 \
                and code not in (204, 304):
            self.wfile.write(body)


class _Handler(JsonHandler):
    engine = None          # bound per-server via the factory below
    result_timeout = 120.0
    engine_server = None   # owning EngineServer (drain relay; the
    #   name "server" is taken — BaseHTTPRequestHandler binds it)
    incarnation = 0        # supervisor restart generation (/healthz)
    role = "mixed"         # disaggregation role advertised on
    #   /healthz: "prefill" / "decode" / "mixed" — purely a routing
    #   signal (every endpoint works on every role; the router's
    #   phase filter is what specializes the replicas)

    def _validate_prompt(self, prompt, max_new_tokens):
        """Reject malformed / over-capacity prompts AT THE EDGE with a
        clear 400 body, instead of letting them surface as an
        engine-side failure or a silently-clamped embedding gather.
        Returns an error string, or None when the request is
        admissible."""
        eng = self.engine
        if not isinstance(prompt, (list, tuple)) or not prompt:
            return "prompt must be a non-empty list of token ids"
        if not all(isinstance(t, int) and not isinstance(t, bool)
                   for t in prompt):
            return "prompt must contain integer token ids only"
        if max_new_tokens < 1:
            return f"max_new_tokens must be >= 1, got {max_new_tokens}"
        # mirrors Engine.submit's capacity rule (kept in sync with it):
        # checking here too means a clear 400 with zero engine-side
        # effects, not an error minted halfway into submit
        total = len(prompt) + max_new_tokens
        if total > eng.max_seq_len:
            return (f"prompt ({len(prompt)} tokens) + max_new_tokens "
                    f"({max_new_tokens}) = {total} exceeds the engine's "
                    f"slot capacity ({eng.max_seq_len})")
        vocab = getattr(eng, "vocab_size", None)
        if vocab:
            bad = next((t for t in prompt if not 0 <= t < vocab), None)
            if bad is not None:
                return (f"token id {bad} outside the model vocabulary "
                        f"[0, {vocab}) — it would silently clamp to a "
                        "different token")
        return None

    def do_GET(self):
        eng = self.engine
        if self.path == "/metrics":
            # the full exposition content type: scrapers negotiate on
            # the version/charset params, not just text/plain
            self._send(200, monitor.render_prometheus(eng.registry),
                       ctype="text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/healthz":
            # queue_depth / slots_free / kv_blocks_free are ALWAYS
            # present: they are the per-engine load signals a router
            # tier balances on (kv_blocks_free is null in contiguous
            # mode — capacity there is slots, not blocks)
            ready, state = _readiness(eng)
            info = {
                "status": "ok",
                # liveness vs readiness: answering at all = live;
                # ready only when accepting new work; state carries
                # WHY not ("draining" vs "watchdog_fired")
                "live": True,
                "ready": ready,
                "state": state,
                "watchdog_fired": bool(
                    getattr(eng, "_watchdog_fired", False)),
                "slots_total": eng.num_slots,
                "slots_free": eng.scheduler.free_count(),
                "queue_depth": eng.queue.depth(),
                "kv_blocks_free": (
                    eng.block_pool.free_count()
                    if getattr(eng, "_paged", False) else None),
                # the router's prefix-affinity hash aligns on this
                "kv_block_size": (eng._bs if getattr(eng, "_paged",
                                                     False) else None),
                "sample_mode": getattr(eng, "sample_mode", "host"),
                # disaggregated serving: which phase this replica
                # volunteers for (the router's pick() filters on it)
                "role": self.role,
                # which attention implementation serves the paged
                # dispatches: "ragged" = the streaming ragged paged
                # attention kernel (one kernel for decode / spec /
                # chunk windows), "ragged_gather" = the gather-the-row
                # A/B body, "xla" = the plain torch windows of the
                # reference's XLA programs; the router copies this
                # into its registry signals like kv_dtype
                "attn_impl": getattr(eng, "attn_impl", "xla"),
                # long-context exposure: max context length (prompt +
                # decoded) any request has reached on this replica
                "max_context_len": getattr(
                    eng, "_max_context_len", 0),
                # mesh surface: the router registry carries these so
                # a fleet view (and timeline.py --router) can label
                # sharded replicas with the full (mp, dp) shape; kv
                # blocks are head-sliced UNIFORMLY across mp shards
                # (same logical free count on each), while dp shards
                # own DISJOINT slot/block ranges and can drain
                # independently — so the free list enumerates each dp
                # shard's own count, repeated per mp shard
                "mesh_shape": getattr(eng, "mesh_axes", None),
                "mp": getattr(eng, "mp", 1),
                "dp": getattr(eng, "dp", 1),
                "kv_blocks_free_per_shard": (
                    [eng.block_pool.free_count(d)
                     for d in range(getattr(eng, "dp", 1))]
                    * getattr(eng, "mp", 1)
                    if getattr(eng, "_paged", False) else None),
                "kv_block_bytes_per_shard": getattr(
                    eng, "_kv_block_bytes_per_shard", None),
                # quantized serving (serving/quant.py): dtype labels
                # plus the code/scale byte split, so the capacity
                # accounting adds up (code + scale = block bytes) and
                # a migration source can refuse a kv_dtype-mismatched
                # peer BEFORE shipping blocks it would reject
                "weight_dtype": getattr(eng, "_weight_dtype_str",
                                        None),
                "kv_dtype": getattr(eng, "_kv_dtype_str", None),
                "kv_block_bytes": getattr(
                    eng, "_kv_code_bytes_per_shard", None),
                "kv_scale_bytes": getattr(
                    eng, "_kv_scale_bytes_per_shard", None),
                # async-loop signals, next to the router-tier load
                # signals: pipeline depth plus the mean overlapped
                # host time and mean blocking d2h wait per tick —
                # overlap >> wait means the loop is hiding its host
                # work behind device compute
                "async_depth": getattr(eng, "async_depth", 1),
                "tick_overlap_ms": _hist_mean(
                    getattr(eng, "_m_overlap", None)),
                "d2h_wait_ms": _hist_mean(
                    getattr(eng, "_m_d2h_wait", None)),
                # multi-adapter serving: the loaded inventory is a
                # ROUTING signal — the router's pick() filters
                # replicas on it for model= requests
                "adapters": (
                    eng.adapters.names()
                    if getattr(eng, "adapters", None) is not None
                    else []),
                "adapters_loaded": (
                    len(eng.adapters)
                    if getattr(eng, "adapters", None) is not None
                    else 0),
                "streams_active": (
                    eng.streams_active()
                    if hasattr(eng, "streams_active") else 0),
            }
            # overload-protection signals: preemption / shed counts,
            # the measured drain rate behind Retry-After estimates,
            # and the graceful-drain / watchdog state
            def _cnt(name):
                m = getattr(eng, name, None)
                return 0 if m is None else int(m.value)
            # ONE drain_rate() read: the staleness horizon means a
            # second call can flip to None between two reads
            rate = getattr(eng, "drain_rate", lambda: None)()
            info.update({
                "preemptions_total": _cnt("_m_preempt"),
                "resumed_total": _cnt("_m_resumed"),
                "shed_deadline_total": _cnt("_m_shed_deadline"),
                "shed_rate_limited_total": _cnt("_m_shed_rate"),
                "shed_queue_full_total": _cnt("_m_shed_queue"),
                "watchdog_fires": _cnt("_m_watchdog"),
                "drain_rate_tps": (None if rate is None
                                   else round(rate, 1)),
                "draining": bool(getattr(eng, "_draining", False)),
                # restart generation stamped by the supervisor tier:
                # the router registry resets a replica's breaker and
                # health history when this advances, and DISCARDS any
                # probe carrying a lower value (a stale read from the
                # dead predecessor on the same URL)
                "incarnation": int(getattr(self, "incarnation", 0)),
            })
            srv = getattr(self, "engine_server", None)
            if srv is not None:
                info["drain_migrations_total"] = int(
                    srv._m_drain_migrations.value)
                info["drain_fallbacks_total"] = int(
                    srv._m_drain_fallbacks.value)
            if getattr(eng, "_paged", False):
                info["kv_blocks_cached"] = (
                    eng.prefix_cache.cached_blocks()
                    if eng.prefix_cache is not None else 0)
            store = getattr(eng, "host_store", None)
            if store is not None:
                # host-RAM offload tier: warmth the router's
                # prefix_warm can prefer over a peer's recompute
                st = store.stats()
                info["kv_host_blocks"] = st["blocks"]
                info["kv_host_bytes"] = st["bytes"]
                info["kv_host_capacity_mb"] = st["capacity_mb"]
                info["offload_demotes_total"] = _cnt(
                    "_m_offload_demotes")
                info["offload_promotes_total"] = _cnt(
                    "_m_offload_promotes")
                info["offload_hit_tokens_total"] = _cnt(
                    "_m_offload_hit_tokens")
            if getattr(eng, "_spec_k", None):
                info["spec_k"] = eng._spec_k
                info["spec_acceptance_rate"] = round(
                    eng._m_spec_rate.value, 4)
                info["spec_tokens_per_tick"] = round(
                    eng._m_spec_tpt.value, 4)
            self._send_json(200, info)
        elif self.path == "/livez":
            # liveness only: the process is up and answering — a
            # draining or wedged engine is still LIVE (restarting it
            # would kill the streams it is trying to land)
            self._send_json(200, {"status": "ok", "live": True})
        elif self.path == "/readyz":
            ready, state = _readiness(eng)
            if ready:
                self._send_json(200, {"status": "ok", "ready": True,
                                      "state": state})
            else:
                # 503 so a dumb prober can act on the status code
                # alone; "reason" so a smart one can distinguish
                # draining (finishing up) from watchdog_fired (dying)
                self._send_json(503, {"status": "unavailable",
                                      "ready": False, "state": state,
                                      "reason": state})
        elif self.path == "/debug/trace":
            # the live trace ring as a downloadable chrome-trace file
            self._send(
                200, json.dumps(eng.chrome_trace()),
                headers={"Content-Disposition":
                         'attachment; filename="trace.json"'})
        elif self.path == "/debug/requests":
            self._send_json(200, eng.debug_requests())
        else:
            self._send_json(404, {"error": f"no route {self.path}",
                                  "reason": "not_found"})

    def do_POST(self):
        if self.path == "/migrate/export":
            self._migrate_export()
            return
        if self.path == "/migrate/import":
            self._migrate_import()
            return
        if self.path != "/generate":
            self._send_json(404, {"error": f"no route {self.path}",
                                  "reason": "not_found"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            prompt = body["prompt"]
            max_new = int(body.get("max_new_tokens", 16))
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad request: {e}",
                                  "reason": "bad_request"})
            return
        err = self._validate_prompt(prompt, max_new)
        if err is not None:
            self._send_json(400, {"error": err,
                                  "reason": "bad_request"})
            return
        try:
            req = self.engine.submit(
                prompt,
                max_new_tokens=max_new,
                eos_token_id=body.get("eos_token_id"),
                timeout=body.get("timeout"),
                temperature=float(body.get("temperature", 1.0)),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 1.0)),
                seed=body.get("seed"),
                priority=int(body.get("priority", 0)),
                tenant=body.get("tenant"),
                adapter=body.get("adapter"))
        except UnknownAdapter as e:
            # 404, not 400: the request is well-formed — THIS replica
            # lacks the adapter.  The router retries elsewhere on it.
            self._send_json(404, {"error": str(e),
                                  "reason": "unknown_adapter"})
            return
        except Rejected as e:
            # every shed (QueueFull / DeadlineShed 503, RateLimited
            # 429) carries the engine's COMPUTED backoff: queue
            # backlog over the measured drain rate, or the token
            # bucket's refill time — an honest hint, not a constant
            code = 429 if isinstance(e, RateLimited) else 503
            self._send_json(
                code,
                {"error": str(e),
                 "reason": _shed_reason(e, draining=bool(
                     getattr(self.engine, "_draining", False)))},
                headers=_retry_after_header(e))
            return
        except (TypeError, ValueError) as e:
            # TypeError covers JSON nulls / non-numeric fields hitting
            # the int()/float() coercions — still a 400, not a dropped
            # connection
            self._send_json(400, {"error": str(e),
                                  "reason": "bad_request"})
            return
        if body.get("stream"):
            self._stream_response(req)
            return
        try:
            ids = req.result(timeout=self.result_timeout)
        except RequestTimeout as e:
            self._send_json(504, {"error": str(e),
                                  "reason": "result_timeout"})
            return
        except (TimeoutError, RuntimeError) as e:
            srv = getattr(self, "engine_server", None)
            if srv is not None:
                # lazy: only engine-ful processes reach this branch
                from .engine import Migrated
                if isinstance(e, Migrated):
                    # a SIGTERM drain exported this stream mid-decode:
                    # the drain thread is landing it on a peer and
                    # relays the peer's COMPLETE response back here —
                    # the client never learns its stream moved hosts
                    found, resp = srv.await_relay(
                        req.id, timeout=self.result_timeout)
                    if found and resp is not None:
                        out = dict(resp)
                        out["migrated"] = True
                        self._send_json(200, out)
                        return
                    if found:
                        # the drain tried and no peer accepted:
                        # retryable — the router re-dispatches from
                        # the prompt (greedy resume, token-identical)
                        self._send_json(
                            503, {"error": str(e),
                                  "reason": "drain_failed"})
                        return
            self._send_json(500, {"error": str(e),
                                  "reason": "internal"})
            return
        ttft = None
        if req.first_token_at is not None:
            ttft = round((req.first_token_at - req.submitted_at) * 1e3, 3)
        self._send_json(200, {
            "id": req.id,
            "ids": [int(x) for x in ids],
            "generated": [int(x) for x in req.generated],
            "ttft_ms": ttft,
        })

    # -- SSE streaming (POST /generate {"stream": true}) ---------------
    def _stream_response(self, req):
        """Server half of token streaming: headers out immediately
        (text/event-stream, no Content-Length, proxy buffering off),
        then one ``token`` event per generated token the tick the
        engine emits it — the handler thread drains the request's
        TokenStream sink while the engine thread decodes.  Idle gaps
        emit ``:hb`` comment frames (keep-alive + dead-client
        detection).  The stream ALWAYS ends with a terminal event:
        ``done`` carrying the full /generate payload, or ``error``
        with the machine-readable reason and retry_after — a shed or
        preempt-timeout mid-stream is an honest terminal frame, never
        a silently truncated body.  A SIGTERM-drain migration is
        SPLICED: the peer's relayed tokens beyond what was already
        streamed continue the same SSE stream seamlessly."""
        stream = TokenStream(req, heartbeat_s=0.25)
        self.close_connection = True  # the frame has no length; it
        #   ends when the connection does
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("X-Accel-Buffering", "no")
        self.send_header("Connection", "close")
        self.end_headers()
        deadline = time.monotonic() + self.result_timeout
        sent = 0
        try:
            for ev in stream:
                if ev.kind == "token":
                    self.wfile.write(sse_format(
                        {"token": int(ev.token),
                         "index": int(ev.index)}, event="token"))
                    sent += 1
                elif ev.kind == "heartbeat":
                    if time.monotonic() > deadline:
                        self.wfile.write(sse_format(
                            {"error": "no terminal event before "
                             "result_timeout",
                             "reason": "result_timeout",
                             "retry_after": None}, event="error"))
                        return
                    self.wfile.write(sse_format(comment="hb"))
                elif ev.kind == "done":
                    ttft = None
                    if req.first_token_at is not None:
                        ttft = round((req.first_token_at
                                      - req.submitted_at) * 1e3, 3)
                    self.wfile.write(sse_format({
                        "id": req.id,
                        "ids": [int(t) for t in req.prompt]
                        + [int(t) for t in req.generated],
                        "generated": [int(t) for t in req.generated],
                        "ttft_ms": ttft, "streamed": sent,
                    }, event="done"))
                    return
                else:
                    self._stream_error(req, ev.error, sent)
                    return
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # the client vanished mid-stream: nothing to answer; the
            # engine lands the request and this sink dies with the
            # handler thread
            pass

    def _stream_error(self, req, err, sent):
        """Terminal frame for a stream that did not finish cleanly.
        Migrated + a draining EngineServer is the one recoverable
        case: await the drain relay and SPLICE the peer's completion
        into the live stream (tokens beyond ``sent`` — the ones this
        socket has not yet delivered — then ``done``)."""
        from .engine import Migrated
        srv = getattr(self, "engine_server", None)
        if isinstance(err, Migrated) and srv is not None:
            found, resp = srv.await_relay(req.id,
                                          timeout=self.result_timeout)
            if found and resp is not None:
                gen = [int(t) for t in resp.get("generated", [])]
                for j in range(sent, len(gen)):
                    self.wfile.write(sse_format(
                        {"token": gen[j], "index": j}, event="token"))
                out = dict(resp)
                out["migrated"] = True
                out["streamed"] = sent + max(len(gen) - sent, 0)
                self.wfile.write(sse_format(out, event="done"))
                return
            self.wfile.write(sse_format(
                {"error": str(err),
                 "reason": "drain_failed" if found else "internal",
                 "retry_after": None}, event="error"))
            return
        if isinstance(err, RequestTimeout):
            reason = "result_timeout"
        elif isinstance(err, Rejected):
            reason = _shed_reason(err, draining=bool(
                getattr(self.engine, "_draining", False)))
        else:
            reason = "internal"
        self.wfile.write(sse_format(
            {"error": str(err), "reason": reason,
             "retry_after": getattr(err, "retry_after", None)},
            event="error"))

    def _read_body(self):
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n) or b"{}")

    def _migrate_export(self):
        """Source side of a migration.  The disaggregated-prefill
        shape submits here, lets the engine decode to ``min_tokens``
        (so the destination resumes a DECODING stream through the
        proven preemption-resume binding), then exports."""
        eng = self.engine
        try:
            body = self._read_body()
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad request: {e}",
                                  "reason": "bad_request"})
            return
        try:
            if body.get("prefix_only"):
                payload = eng.export_prefix(
                    body.get("tokens") or [],
                    timeout=self.result_timeout)
                self._send_json(200, {
                    "completed": False, "generated": [],
                    "payload": (None if payload is None
                                else payload_to_json(payload))})
                return
            if "request_id" in body:
                res = eng.migrate_out(
                    request_id=int(body["request_id"]),
                    min_tokens=int(body.get("min_tokens", 1)),
                    deliver="return", timeout=self.result_timeout)
            else:
                prompt = body.get("prompt")
                max_new = int(body.get("max_new_tokens", 16))
                err = self._validate_prompt(prompt, max_new)
                if err is not None:
                    self._send_json(400, {"error": err,
                                          "reason": "bad_request"})
                    return
                req = eng.submit(
                    prompt, max_new_tokens=max_new,
                    eos_token_id=body.get("eos_token_id"),
                    timeout=body.get("timeout"),
                    temperature=float(body.get("temperature", 1.0)),
                    top_k=int(body.get("top_k", 0)),
                    top_p=float(body.get("top_p", 1.0)),
                    seed=body.get("seed"),
                    priority=int(body.get("priority", 0)),
                    tenant=body.get("tenant"))
                res = eng.migrate_out(
                    request_id=req.id,
                    min_tokens=int(body.get("min_tokens", 1)),
                    deliver="return", timeout=self.result_timeout)
        except Rejected as e:
            code = 429 if isinstance(e, RateLimited) else 503
            self._send_json(
                code,
                {"error": str(e),
                 "reason": _shed_reason(e, draining=bool(
                     getattr(eng, "_draining", False)))},
                headers=_retry_after_header(e))
            return
        except KeyError as e:
            self._send_json(404, {"error": str(e),
                                  "reason": "not_found"})
            return
        except TimeoutError as e:
            self._send_json(504, {"error": str(e),
                                  "reason": "result_timeout"})
            return
        except (TypeError, ValueError) as e:
            self._send_json(400, {"error": str(e),
                                  "reason": "bad_request"})
            return
        except Exception as e:  # injected export fault: the stream
            #   (if any) keeps running HERE — a retryable decline
            self._send_json(503, {"error": str(e),
                                  "reason": "migrate_declined"})
            return
        payload = res.get("payload")
        self._send_json(200, {
            "completed": bool(res.get("completed")),
            "generated": [int(t) for t in res.get("generated") or []],
            "payload": (None if payload is None
                        else payload_to_json(payload))})

    def _migrate_import(self):
        """Destination side.  A stream payload is adopted and decoded
        to completion — the response is /generate-shaped, with the
        pre-migration tokens included, so the caller (router) streams
        one complete answer.  A prefix payload only warms the trie.
        Every failure path leaves this replica owning nothing."""
        eng = self.engine
        try:
            body = self._read_body()
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad request: {e}",
                                  "reason": "bad_request"})
            return
        try:
            if body.get("request") is None:
                res = eng.import_prefix(body,
                                        timeout=self.result_timeout)
                self._send_json(200, {"blocks": res["blocks"],
                                      "tokens": res["tokens"]})
                return
            res = eng.migrate_in(body, timeout=self.result_timeout)
        except Rejected as e:
            code = 429 if isinstance(e, RateLimited) else 503
            self._send_json(
                code,
                {"error": str(e),
                 "reason": _shed_reason(e, draining=bool(
                     getattr(eng, "_draining", False)))},
                headers=_retry_after_header(e))
            return
        except TimeoutError as e:
            self._send_json(504, {"error": str(e),
                                  "reason": "result_timeout"})
            return
        except KVDtypeMismatch as e:
            # quantized/fp peers disagree on the wire kv dtype: the
            # payload is fine, THIS pairing is wrong — a distinct
            # machine-readable reason so the sender can filter peers
            # by the /healthz kv_dtype signal instead of retrying
            self._send_json(400, {"error": str(e),
                                  "reason": "kv_dtype_mismatch"})
            return
        except (TypeError, ValueError) as e:
            # malformed payload / geometry mismatch: re-sending the
            # same bytes here cannot succeed — non-retryable 400
            self._send_json(400, {"error": str(e),
                                  "reason": "bad_request"})
            return
        except Exception as e:  # injected import fault / pool
            #   exhaustion: this replica adopted NOTHING, the payload
            #   holder may import elsewhere — retryable 503
            self._send_json(503, {"error": str(e),
                                  "reason": "migrate_failed"})
            return
        req = res["request"]
        try:
            ids = req.result(timeout=self.result_timeout)
        except RequestTimeout as e:
            self._send_json(504, {"error": str(e),
                                  "reason": "result_timeout"})
            return
        except (TimeoutError, RuntimeError) as e:
            self._send_json(500, {"error": str(e),
                                  "reason": "internal"})
            return
        ttft = None
        if req.first_token_at is not None:
            ttft = round((req.first_token_at - req.submitted_at) * 1e3,
                         3)
        self._send_json(200, {
            "id": req.id,
            "ids": [int(x) for x in ids],
            "generated": [int(x) for x in req.generated],
            "ttft_ms": ttft,
            "migrated_blocks": res["blocks"],
        })


class EngineServer:
    """Engine tick loop + ThreadingHTTPServer, each on its own daemon
    thread.  ``with EngineServer(engine) as srv: ... srv.port``.

    ``incarnation`` is this process's restart generation, stamped by
    the supervisor tier (``serving.supervisor``) and advertised on
    ``/healthz`` — the router registry keys its breaker/health reset
    on it so a dead process's stale probes never poison its successor.
    ``peers`` are sibling replica base URLs: on SIGTERM (or an
    explicit ``drain_to_peers()``), the server flips ``/readyz`` to
    draining and migrates every live decoding stream to the first
    healthy peer over the ``/migrate/import`` wire, relaying the
    peer's completed response back to the stream's still-blocked
    ``/generate`` waiter — a supervised rolling restart loses zero
    tokens.  When no peer accepts, the waiter gets a retryable 503
    ``drain_failed`` and the router's greedy resume covers it."""

    def __init__(self, engine, host="127.0.0.1", port=0,
                 result_timeout=120.0, role="mixed", incarnation=0,
                 peers=(), drain_grace_s=30.0):
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"role must be 'mixed', 'prefill' or "
                             f"'decode', got {role!r}")
        self.engine = engine
        self.role = role
        self.incarnation = int(incarnation)
        self.peers = [str(u).rstrip("/") for u in (peers or ())]
        self.drain_grace_s = float(drain_grace_s)
        # drain relay: request id -> the peer's completed /generate
        # response (None = no peer accepted); the /generate handler
        # that caught Migrated consumes its entry
        self._relay = {}
        self._relay_cv = threading.Condition()
        self._drain_active = False
        self._m_drain_migrations = engine.registry.counter(
            "supervisor.drain_migrations",
            "live streams migrated to a peer during a SIGTERM drain")
        self._m_drain_fallbacks = engine.registry.counter(
            "supervisor.drain_fallbacks",
            "drain streams no peer accepted (router greedy resume)")
        handler = type("BoundHandler", (_Handler,),
                       {"engine": engine,
                        "result_timeout": float(result_timeout),
                        "role": role,
                        "incarnation": self.incarnation})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        # bound AFTER construction: the handler type must exist before
        # the server, the server before self is complete (the name
        # "server" is taken — BaseHTTPRequestHandler binds it to the
        # ThreadingHTTPServer per request)
        handler.engine_server = self
        self.host, self.port = self.httpd.server_address[:2]
        self._http_thread = None

    @property
    def address(self):
        return f"http://{self.host}:{self.port}"

    # -- SIGTERM drain -------------------------------------------------
    def _post_relay(self, rid, resp):
        with self._relay_cv:
            self._relay[rid] = resp
            self._relay_cv.notify_all()

    def await_relay(self, rid, timeout=30.0):
        """Called by a ``/generate`` handler whose request ended in
        ``Migrated``: wait for the drain thread to finish shipping the
        stream and return ``(found, resp)``.  ``found`` False means no
        drain owns this request (a non-drain migration — the caller
        keeps its legacy 500 path); resp None means the drain tried
        and no peer accepted."""
        deadline = time.monotonic() + float(timeout)
        with self._relay_cv:
            while rid not in self._relay:
                if not self._drain_active:
                    return False, None
                left = deadline - time.monotonic()
                if left <= 0:
                    return False, None
                self._relay_cv.wait(min(left, 0.1))
            resp = self._relay.pop(rid)
            self._relay_cv.notify_all()   # the drain's consumed-wait
            return True, resp

    def _peer_ready(self, url, timeout=2.0):
        import urllib.request
        try:
            with urllib.request.urlopen(url + "/readyz",
                                        timeout=timeout):
                return True
        except Exception:
            return False

    def _post_json(self, url, obj, timeout=60.0):
        import urllib.request
        data = json.dumps(obj).encode()
        req = urllib.request.Request(
            url, data=data,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())

    def drain_to_peers(self, peers=None, grace_s=None):
        """Graceful recycling: flip readiness to draining, export
        every live decoding stream and land it on a healthy peer via
        the KV-migration wire, relay each peer's completed response
        to the stream's blocked ``/generate`` waiter, and return the
        accounting ``{"migrated", "fallback", "lost_tokens",
        "peers"}``.  ``lost_tokens`` counts tokens already emitted on
        streams NO peer accepted (those wait-listed for the router's
        greedy re-decode) — a drain with healthy peers reports 0.
        The engine keeps ticking throughout (mid-prefill streams
        become exportable a few ticks in); whatever is still live at
        ``grace_s`` falls to the engine's own graceful stop."""
        eng = self.engine
        urls = [str(u).rstrip("/") for u in
                (self.peers if peers is None else peers)]
        grace = (self.drain_grace_s if grace_s is None
                 else float(grace_s))
        with self._relay_cv:
            self._drain_active = True
        eng._draining = True      # /readyz -> 503 draining; submit
        #   sheds; the queue admits nothing more
        healthy = [u for u in urls if self._peer_ready(u)]
        migrated = fallback = lost = 0
        deadline = time.monotonic() + grace
        try:
            while time.monotonic() < deadline:
                live = eng.live_request_ids()
                if not live:
                    break
                rid = live[0]
                try:
                    res = eng.migrate_out(
                        request_id=rid, min_tokens=1,
                        deliver="return",
                        timeout=min(5.0, max(
                            0.1, deadline - time.monotonic())))
                except TimeoutError:
                    continue   # not decoding yet — tick on
                except KeyError:
                    continue   # finished between snapshot and export
                except Exception:
                    continue   # export declined: the stream keeps
                    #   running and the engine's stop drain lands it
                if res.get("completed") or res.get("payload") is None:
                    continue   # finished during export — the waiter
                    #   already has its complete result
                gen = [int(t) for t in res.get("generated") or []]
                resp = None
                with eng.tracer.span("drain.migrate", cat="serving",
                                     request=rid, tokens=len(gen)):
                    wire = payload_to_json(res["payload"])
                    for u in healthy:
                        try:
                            resp = self._post_json(
                                u + "/migrate/import", wire)
                            break
                        except Exception:
                            continue
                if resp is not None:
                    migrated += 1
                    self._m_drain_migrations.inc()
                    self._post_relay(rid, resp)
                else:
                    fallback += 1
                    lost += len(gen)
                    self._m_drain_fallbacks.inc()
                    self._post_relay(rid, None)
            # let the blocked waiters consume their relays before the
            # server goes down (handler threads are daemons: nothing
            # else waits for them)
            waited = time.monotonic() + 5.0
            with self._relay_cv:
                while self._relay and time.monotonic() < waited:
                    self._relay_cv.wait(0.1)
        finally:
            with self._relay_cv:
                self._drain_active = False
                self._relay_cv.notify_all()
        return {"migrated": migrated, "fallback": fallback,
                "lost_tokens": lost, "peers": healthy}

    def start(self):
        self.engine.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="paddle_tpu_torch-serving-http")
        self._http_thread.start()
        return self

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=5.0)
            self._http_thread = None
        self.engine.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False


def serve(engine, host="127.0.0.1", port=8000, result_timeout=120.0):
    """Blocking convenience: start the engine and serve HTTP until
    KeyboardInterrupt."""
    srv = EngineServer(engine, host=host, port=port,
                       result_timeout=result_timeout).start()
    try:
        srv._http_thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()


def main(argv=None):
    """Standalone replica process: build a GPT config on ``--device``
    (the CUDA card by default), optionally shard it over an ``(mp,
    dp)`` serving mesh, and serve — what
    ``distributed.launch.spawn_serving_fleet`` spawns N of.

        python -m paddle_tpu_torch.serving.httpd --config gpt2-medium \\
            --port 8000 --max-seq-len 1024 --kv-block-size 16 \\
            --prefill-chunk 64

    ``--seed`` makes every replica of a fleet draw IDENTICAL weights,
    so greedy failover across replicas is token-identical.  Without
    ``--kv-block-size`` the engine serves contiguous slot rows through
    ``attn_impl="xla"`` (the reference engine's default); with it, the
    ragged kernel path.  On the CPU a mesh maps every rank onto the
    CPU."""
    import argparse

    p = argparse.ArgumentParser("paddle_tpu_torch.serving.httpd")
    p.add_argument("--config", default="tiny",
                   help="GPT_CONFIGS name (models/gpt.py)")
    p.add_argument("--num-layers", type=int, default=None,
                   help="the config's depth cut to this many layers "
                        "(its widths stay)")
    p.add_argument("--device", default="cuda",
                   help="where the model and engine live (cuda, "
                        "cuda:N or cpu)")
    p.add_argument("--mp", type=int, default=1,
                   help="tensor-parallel degree: shard the model + KV"
                        " pools over a mesh of this many ranks")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel degree: shard batch slots (and"
                        " their KV block ranges) over this many mesh"
                        " rows — total ranks = mp * dp")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--seed", type=int, default=0,
                   help="weight-init seed (same seed across a fleet "
                        "= token-identical replicas)")
    p.add_argument("--num-slots", type=int, default=4)
    p.add_argument("--max-seq-len", type=int, default=64)
    p.add_argument("--kv-block-size", type=int, default=None)
    p.add_argument("--kv-blocks", type=int, default=None)
    p.add_argument("--kv-budget-mb", type=float, default=None)
    p.add_argument("--prefill-chunk", type=int, default=None)
    p.add_argument("--spec-k", type=int, default=None)
    p.add_argument("--result-timeout", type=float, default=120.0)
    p.add_argument("--role", default="mixed",
                   choices=("mixed", "prefill", "decode"),
                   help="disaggregation role advertised on /healthz: "
                        "the router routes new prompts to prefill "
                        "replicas and migrated streams to decode "
                        "replicas (every endpoint still works on "
                        "every role)")
    p.add_argument("--incarnation", type=int, default=0,
                   help="restart generation stamped by the "
                        "supervisor: advertised on /healthz so the "
                        "router can reset breaker/health state and "
                        "discard stale probes from the predecessor")
    p.add_argument("--peer", action="append", default=[],
                   metavar="URL",
                   help="sibling replica base URL (repeatable): the "
                        "SIGTERM drain migrates live streams to the "
                        "first healthy peer")
    p.add_argument("--drain-grace", type=float, default=30.0,
                   help="seconds the SIGTERM drain may spend "
                        "migrating live streams before exiting")
    p.add_argument("--fail-boot-below", type=int, default=None,
                   metavar="N",
                   help="chaos: exit(23) at boot while incarnation "
                        "< N — the proc_crashloop fault site; the "
                        "supervisor's crash-loop breaker quarantines "
                        "the replica")
    args = p.parse_args(argv)

    if (args.fail_boot_below is not None
            and args.incarnation < args.fail_boot_below):
        # the proc_crashloop site: die BEFORE torch and the model
        # import so the crash loop is fast enough to trip the
        # supervisor's window, exactly like a bad binary rollout would
        import sys
        print(f"crashloop: incarnation {args.incarnation} < "
              f"{args.fail_boot_below}, failing boot", flush=True)
        sys.exit(23)

    import signal as _signal

    import torch

    from ..distributed.mesh import ServingMesh
    from ..models.gpt import GPTModel
    from .engine import Engine

    dev = torch.device(args.device)
    depth = {} if args.num_layers is None else {
        "num_layers": args.num_layers}
    model = GPTModel.from_config(args.config, device=dev, seed=args.seed,
                                 dropout=0.0, **depth)
    model.eval()
    mesh = None
    if args.mp > 1 or args.dp > 1:
        if args.mp > 1:
            model = model.to_tensor_parallel()
        n = args.mp * args.dp
        if dev.type == "cuda":
            mesh = (args.mp, args.dp)
        else:
            mesh = ServingMesh(args.mp, args.dp, devices=[dev] * n)
    # the ragged kernel path over block pools, the XLA path (the
    # reference engine's default) over contiguous rows
    attn_impl = "ragged" if args.kv_block_size else "xla"
    engine = Engine(model, num_slots=args.num_slots,
                    max_seq_len=args.max_seq_len,
                    kv_block_size=args.kv_block_size,
                    kv_blocks=args.kv_blocks,
                    kv_budget_mb=args.kv_budget_mb,
                    prefill_chunk=args.prefill_chunk,
                    spec_k=args.spec_k, mesh=mesh, attn_impl=attn_impl,
                    device=None if mesh is not None else dev)
    # graceful recycling: SIGTERM sets a flag the main thread acts on
    # (the handler itself must stay trivial — it can interrupt a tick)
    stop_evt = threading.Event()
    try:
        _signal.signal(_signal.SIGTERM, lambda s, f: stop_evt.set())
    except ValueError:
        pass   # not the main thread (embedded use): no drain hook
    # the port line is the launcher's readiness handshake: printed
    # AFTER the socket is bound, flushed so a pipe reader sees it
    srv = EngineServer(engine, host=args.host, port=args.port,
                       result_timeout=args.result_timeout,
                       role=args.role, incarnation=args.incarnation,
                       peers=args.peer,
                       drain_grace_s=args.drain_grace).start()
    print(f"serving {args.config} on {dev} mp={args.mp} dp={args.dp} "
          f"on {srv.address}", flush=True)
    try:
        while not stop_evt.wait(0.2):
            if not srv._http_thread.is_alive():
                break
    except KeyboardInterrupt:
        pass
    try:
        if stop_evt.is_set():
            acct = srv.drain_to_peers()
            # the supervisor/smoke parse this accounting line from
            # the replica log: a rolling restart must report 0 lost
            print("drain: migrated={migrated} fallback={fallback} "
                  "lost_tokens={lost_tokens}".format(**acct),
                  flush=True)
    finally:
        srv.close()


if __name__ == "__main__":
    main()
