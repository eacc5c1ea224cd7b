"""HTTP front door for the multi-replica Router (serving.router; a
copy of ``paddle_tpu/serving/routerd.py``).

The router-tier twin of ``serving.httpd``: handler threads block on
``Router.generate`` (which retries / hedges / fails over across the
replica fleet) the same way engine handlers block on
``Request.result()``.

  POST /generate    same body as the engine endpoint; the response
                    additionally carries ``replica`` (who served it)
                    and ``attempts``.  ``model`` (or ``adapter``)
                    routes to replicas advertising that LoRA adapter
                    — 404 ``unknown_adapter`` when none does.
                    ``stream: true`` answers as SSE (token / done /
                    error frames, exactly like httpd's) fed by the
                    router's live ``on_token`` stream — a replica
                    dying mid-response fails over and the resumed
                    tokens continue the SAME stream seamlessly.
                    Buffered errors are JSON with a machine-readable
                    ``reason``: 503 ``no_replicas`` / 502
                    ``request_failed`` (the classified replica cause
                    is included), 400 ``bad_request``.
  POST /rebalance   operator preempt-and-migrate: body
                    ``{"source": NAME, "request_id"?, "min_tokens"?}``
                    exports one live stream off the named replica;
                    the router re-lands it on a peer (in-process
                    replica fleets — see ``Router.rebalance``).
  GET  /healthz     router liveness + the replica table summary
                    (counts by health state, breaker states)
  GET  /livez       200 while the process serves
  GET  /readyz      200 when at least one replica is routable,
                    503 ``no_replicas`` otherwise
  GET  /replicas    full registry view: per-replica state, breaker,
                    probed load signals, supervisor incarnation,
                    address — the surface tools/timeline.py uses to
                    pull every replica's /debug/trace next to the
                    router's own
  GET  /metrics     Prometheus exposition of the router's registry
  GET  /debug/trace the router's span ring (route.pick/route.retry/
                    route.hedge/probe) as chrome-trace JSON

``main()`` runs a standalone routerd over a static replica list:

  python -m paddle_tpu_torch.serving.routerd \
      --replica http://host1:8000 --replica http://host2:8000

(each ``--replica`` may be ``name=url`` or a bare url).  For a
spawned local fleet — N engine processes on one host — use
``distributed/launch.py`` to start the engines and pass their ports
here, or build the fleet in-process with ``InProcessReplica`` (see
``examples/serving_router.py``).
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import ThreadingHTTPServer

from .. import monitor
from .httpd import JsonHandler
from .router import (HttpReplicaClient, NoReplicasAvailable,
                     RequestFailed, Router, RouterPolicy,
                     UnknownModel)
from .stream import sse_format

# states a /readyz considers routable
_ROUTABLE = ("healthy", "degraded")


class _Handler(JsonHandler):
    # the JSON-with-reason plumbing (incl. the send_error override)
    # is shared with the engine's httpd handler via JsonHandler
    router = None   # bound per-server by the factory below

    def _replica_summary(self):
        rows = self.router.replicas()
        by_state = {}
        for r in rows:
            by_state[r["state"]] = by_state.get(r["state"], 0) + 1
        return rows, by_state

    def _rebalance(self, body):
        source = body.get("source")
        if not source:
            raise ValueError("source (a replica name) is required")
        return self.router.rebalance(
            source, request_id=body.get("request_id"),
            min_tokens=int(body.get("min_tokens", 1)),
            timeout=float(body.get("timeout", 10.0)))

    def do_GET(self):
        rt = self.router
        if self.path == "/metrics":
            self._send(200, monitor.render_prometheus(rt.registry),
                       ctype="text/plain; version=0.0.4; "
                             "charset=utf-8")
        elif self.path == "/healthz":
            rows, by_state = self._replica_summary()
            by_role = {}
            for r in rows:
                by_role[r["role"]] = by_role.get(r["role"], 0) + 1
            self._send_json(200, {
                "status": "ok", "live": True,
                "ready": any(r["state"] in _ROUTABLE for r in rows),
                "replicas_total": len(rows),
                "replicas_by_state": by_state,
                "replicas_by_role": by_role,
                "breakers_open": sum(
                    1 for r in rows if r["breaker"] != "closed"),
            })
        elif self.path == "/livez":
            self._send_json(200, {"status": "ok", "live": True})
        elif self.path == "/readyz":
            rows, by_state = self._replica_summary()
            if any(r["state"] in _ROUTABLE for r in rows):
                self._send_json(200, {"status": "ok", "ready": True,
                                      "replicas_by_state": by_state})
            else:
                self._send_json(503, {
                    "status": "unavailable", "ready": False,
                    "reason": "no_replicas",
                    "replicas_by_state": by_state})
        elif self.path == "/replicas":
            self._send_json(200, {"replicas": self.router.replicas()})
        elif self.path == "/debug/trace":
            self._send(200, json.dumps(rt.chrome_trace()),
                       headers={"Content-Disposition":
                                'attachment; filename="router-trace'
                                '.json"'})
        else:
            self._send_json(404, {"error": f"no route {self.path}",
                                  "reason": "not_found"})

    def do_POST(self):
        if self.path == "/rebalance":
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                out = self._rebalance(body)
            except KeyError as e:
                self._send_json(404, {"error": str(e),
                                      "reason": "not_found"})
            except (TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._send_json(400, {"error": f"bad request: {e}",
                                      "reason": "bad_request"})
            except Exception as e:
                self._send_json(503, {"error": str(e),
                                      "reason": "migrate_declined"})
            else:
                self._send_json(200, {
                    "completed": bool(out.get("completed")),
                    "generated": len(out.get("generated") or [])})
            return
        if self.path != "/generate":
            self._send_json(404, {"error": f"no route {self.path}",
                                  "reason": "not_found"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            prompt = body["prompt"]
            if not isinstance(prompt, (list, tuple)) or not prompt:
                raise ValueError(
                    "prompt must be a non-empty list of token ids")
            kwargs = dict(
                max_new_tokens=int(body.get("max_new_tokens", 16)),
                eos_token_id=body.get("eos_token_id"),
                temperature=float(body.get("temperature", 1.0)),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 1.0)),
                seed=body.get("seed"),
                priority=int(body.get("priority", 0)),
                tenant=body.get("tenant"),
                timeout=body.get("timeout"),
                model=body.get("model", body.get("adapter")))
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad request: {e}",
                                  "reason": "bad_request"})
            return
        if body.get("stream"):
            self._stream_generate(prompt, kwargs)
            return
        try:
            out = self.router.generate(prompt, **kwargs)
        except NoReplicasAvailable as e:
            self._send_json(503, {"error": str(e),
                                  "reason": "no_replicas"})
            return
        except UnknownModel as e:
            self._send_json(404, {"error": str(e),
                                  "reason": "unknown_adapter"})
            return
        except RequestFailed as e:
            cause = e.cause
            self._send_json(502, {
                "error": str(e), "reason": "request_failed",
                "cause": (type(cause).__name__ if cause is not None
                          else None)})
            return
        except (TypeError, ValueError) as e:
            self._send_json(400, {"error": str(e),
                                  "reason": "bad_request"})
            return
        self._send_json(200, out)

    def _stream_generate(self, prompt, kwargs):
        """SSE out over the router's live token stream.  The router
        call runs on a worker thread feeding a queue; this handler
        thread writes frames as they land (``:hb`` comments when
        quiet).  The FIRST queue item decides the response shape: a
        fast failure (unknown adapter, empty fleet) still gets its
        proper HTTP status, because no SSE header has been committed
        yet.  A failover mid-stream is invisible here — the router
        splices the resumed tokens into the same ``on_token`` feed,
        so the client sees one uninterrupted stream."""
        import queue as _queue
        q = _queue.Queue()
        res = {}

        def run():
            try:
                res["out"] = self.router.generate(
                    prompt, on_token=lambda t: q.put(("tok", t)),
                    **kwargs)
            except Exception as e:
                res["err"] = e
            q.put(("end", None))

        threading.Thread(target=run, daemon=True,
                         name="paddle_tpu_torch-routerd-stream").start()
        kind, val = q.get()
        if kind == "end" and "err" in res:
            e = res["err"]
            if isinstance(e, UnknownModel):
                self._send_json(404, {"error": str(e),
                                      "reason": "unknown_adapter"})
            elif isinstance(e, NoReplicasAvailable):
                self._send_json(503, {"error": str(e),
                                      "reason": "no_replicas"})
            elif isinstance(e, RequestFailed):
                cause = e.cause
                self._send_json(502, {
                    "error": str(e), "reason": "request_failed",
                    "cause": (type(cause).__name__
                              if cause is not None else None)})
            else:
                self._send_json(500, {"error": str(e),
                                      "reason": "internal"})
            return
        self.close_connection = True
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("X-Accel-Buffering", "no")
        self.send_header("Connection", "close")
        self.end_headers()
        sent = 0
        try:
            while kind != "end":
                if kind == "tok":
                    self.wfile.write(sse_format(
                        {"token": int(val), "index": sent},
                        event="token"))
                    sent += 1
                else:
                    self.wfile.write(sse_format(comment="hb"))
                self.wfile.flush()
                try:
                    kind, val = q.get(timeout=0.25)
                except _queue.Empty:
                    kind, val = "hb", None
            err = res.get("err")
            if err is None and "out" in res:
                out = dict(res["out"])
                out["streamed"] = sent
                self.wfile.write(sse_format(out, event="done"))
            else:
                self.wfile.write(sse_format(
                    {"error": str(err),
                     "reason": ("no_replicas"
                                if isinstance(err, NoReplicasAvailable)
                                else "request_failed"
                                if isinstance(err, RequestFailed)
                                else "internal"),
                     "retry_after": None}, event="error"))
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # the client vanished mid-stream: the fleet still lands
            # the request; this socket just stops listening
            pass


class RouterServer:
    """Router prober + ThreadingHTTPServer, each on its own daemon
    thread.  ``with RouterServer(router) as srv: ... srv.address``."""

    def __init__(self, router, host="127.0.0.1", port=0):
        self.router = router
        handler = type("BoundRouterHandler", (_Handler,),
                       {"router": router})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._http_thread = None

    @property
    def address(self):
        return f"http://{self.host}:{self.port}"

    def start(self):
        self.router.start()   # background prober
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="paddle_tpu_torch-routerd-http")
        self._http_thread.start()
        return self

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=5.0)
            self._http_thread = None
        self.router.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False


def parse_replica_spec(spec):
    """``NAME=URL`` or a bare URL (name defaults to host:port...).
    Only the text BEFORE the first ``=`` with no ``://`` in it is a
    name — a bare URL whose query string contains ``=`` must not be
    split."""
    name, sep, url = spec.partition("=")
    if not sep or "://" in name:
        return spec.split("//")[-1], spec
    return name, url


def main(argv=None):
    p = argparse.ArgumentParser(
        description="HTTP front door routing over N engine replicas "
                    "(health-probed, prefix-affinity, retry/hedge/"
                    "circuit-break)")
    p.add_argument("--replica", action="append", default=[],
                   metavar="[NAME=]URL", required=False,
                   help="replica endpoint (repeatable); NAME defaults "
                        "to the URL's host:port")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--probe-interval", type=float, default=1.0)
    p.add_argument("--no-affinity", action="store_true",
                   help="route by load only (A/B the affinity gain)")
    p.add_argument("--hedge", action="store_true",
                   help="enable tail-latency hedging for idempotent "
                        "requests")
    p.add_argument("--disaggregate", action="store_true",
                   help="prefill/decode disaggregation: prefill on a "
                        "prefill-role replica, migrate the KV blocks, "
                        "decode on a decode-role replica")
    p.add_argument("--prefix-warm", action="store_true",
                   help="on an affinity miss, warm the chosen "
                        "replica's prefix cache from the affinity "
                        "target before dispatching")
    args = p.parse_args(argv)
    if not args.replica:
        p.error("at least one --replica is required")
    policy = RouterPolicy(probe_interval_s=args.probe_interval,
                          affinity=not args.no_affinity,
                          hedge=args.hedge,
                          disaggregate=args.disaggregate,
                          prefix_warm=args.prefix_warm)
    router = Router(policy=policy)
    for spec in args.replica:
        name, url = parse_replica_spec(spec)
        router.add_replica(name, HttpReplicaClient(url))
    # fail fast on typo'd addresses: an entirely unreachable fleet is
    # a configuration error, not a fleet to keep probing
    router.probe_once()
    unreachable = [r.name for r in router._reps()
                   if r.probe_failures > 0]
    if len(unreachable) == len(router._reps()):
        p.error("no replica answered its first probe: "
                + ", ".join(unreachable))
    for name in unreachable:
        print(f"warning: replica {name} unreachable (kept in the "
              "registry; the prober will retry)", file=sys.stderr)
    srv = RouterServer(router, host=args.host, port=args.port).start()
    print(f"routerd on {srv.address} over "
          f"{len(router.replicas())} replica(s)")
    try:
        srv._http_thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
