"""Token streaming: per-tick emission fanned out to caller threads (a
copy of ``paddle_tpu/serving/stream.py``).

The engine already emits token-by-token — ``_emit`` runs once per
generated token inside the tick loop — but every front-end so far
buffered the whole response before answering.  ``TokenStream`` closes
that gap: it is a thread-safe sink a handler thread ATTACHES to a live
``Request``; attachment atomically replays the tokens already emitted
(attach races the engine, so replay-then-subscribe under the request's
sink lock is what makes delivery exactly-once) and then receives every
subsequent token the moment ``_emit`` records it.  The terminal event
carries the request's outcome — normal completion, or the engine error
(shed, preempt-timeout, migrated) the HTTP edge turns into a terminal
SSE ``error`` event instead of a silently truncated body.

Iteration yields ``StreamEvent``s; with ``heartbeat_s`` set, quiet
gaps yield ``heartbeat`` events so an SSE writer can emit keep-alive
comments and detect dead clients between tokens.

Chaos integration: the ``stream_disconnect`` fault site (same pure
(seed, site, tick) schedule as every other site) simulates a client
vanishing mid-response — ``TokenStream(faults=..., ordinal=n)`` aborts
iteration with ``StreamDisconnect`` after a schedule-derived number of
tokens, which is exactly what a TCP reset mid-SSE looks like to the
server loop.
"""
from __future__ import annotations

import queue
import time


class StreamClosed(Exception):
    """Iterating past the terminal event (the stream is over)."""


class StreamEvent:
    """One streamed occurrence.

    kind : "token" | "heartbeat" | "done" | "error"
    token/index : the generated id and its 0-based position (token)
    error : the request's failure (error kind)
    t : monotonic emission timestamp (client-side TTFT measurements)
    """

    __slots__ = ("kind", "token", "index", "error", "t")

    def __init__(self, kind, token=None, index=None, error=None):
        self.kind = kind
        self.token = token
        self.index = index
        self.error = error
        self.t = time.monotonic()

    def __repr__(self):
        if self.kind == "token":
            return f"StreamEvent(token={self.token}, i={self.index})"
        return f"StreamEvent({self.kind}, error={self.error!r})"


class TokenStream:
    """A consumer-side token stream over one ``Request``.

    Typical use (an HTTP handler thread)::

        req = engine.submit(prompt, max_new_tokens=64)
        for ev in TokenStream(req, heartbeat_s=0.5):
            if ev.kind == "token":
                write_sse(ev.token)
            elif ev.kind == "heartbeat":
                write_sse_comment()
        # terminal "done"/"error" ends iteration; .error holds failure

    The stream buffers internally, so a slow client never back-
    pressures the engine thread — ``feed`` is a lock-free Queue.put.
    """

    def __init__(self, req=None, heartbeat_s=None, faults=None,
                 ordinal=0):
        self._q = queue.Queue()
        self.heartbeat_s = heartbeat_s
        self.error = None
        self.closed = False
        self.tokens = []          # every token this stream delivered
        self.first_token_t = None  # client-side TTFT anchor
        self._disconnect_after = None
        self._faults = faults
        self._ordinal = int(ordinal)
        if faults is not None and faults.scheduled("stream_disconnect",
                                                   self._ordinal):
            # deterministic mid-response client kill: vanish after a
            # schedule-derived number of tokens (>= 1 so the stream is
            # genuinely mid-body, not refused)
            self._disconnect_after = 1 + self._ordinal % 3
        if req is not None:
            self.attach(req)

    # -- producer side (engine / request) --------------------------------
    def attach(self, req):
        """Subscribe to ``req``: replay already-emitted tokens, then
        receive the rest live — atomic under the request's sink lock,
        so no token is ever lost or duplicated."""
        with req._sink_lock:
            for i, tok in enumerate(req.generated):
                self._q.put(StreamEvent("token", token=tok, index=i))
            if req._done.is_set():
                self._q.put(StreamEvent(
                    "error" if req.error is not None else "done",
                    error=req.error))
            else:
                req._sinks.append(self)
        return self

    def feed(self, tok, index):
        self._q.put(StreamEvent("token", token=tok, index=index))

    def close(self, error=None):
        self._q.put(StreamEvent(
            "error" if error is not None else "done", error=error))

    # -- consumer side ----------------------------------------------------
    def __iter__(self):
        while not self.closed:
            try:
                ev = self._q.get(timeout=self.heartbeat_s)
            except queue.Empty:
                yield StreamEvent("heartbeat")
                continue
            if ev.kind == "token":
                if self.first_token_t is None:
                    self.first_token_t = ev.t
                if (self._disconnect_after is not None
                        and len(self.tokens) >= self._disconnect_after):
                    # the scheduled client kill: log through the
                    # injector (chaos forensics) and vanish
                    self.closed = True
                    self._faults.fire("stream_disconnect",
                                      self._ordinal)
                self.tokens.append(ev.token)
            else:
                self.closed = True
                self.error = ev.error
            yield ev

    def drain(self, timeout=None):
        """Consume to the terminal event; returns the delivered token
        list.  Raises the stream's error, mirroring
        ``Request.result``."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        for ev in self:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"stream: no terminal event after {timeout}s")
        if self.error is not None:
            raise self.error
        return list(self.tokens)


def sse_format(data=None, event=None, comment=None):
    """Serialize one SSE frame (bytes).  ``data`` may be any
    JSON-serializable value; ``comment`` renders a ``:``-prefixed
    keep-alive line (ignored by EventSource clients)."""
    import json
    out = []
    if comment is not None:
        out.append(f": {comment}")
    if event is not None:
        out.append(f"event: {event}")
    if data is not None:
        out.append("data: " + json.dumps(data))
    return ("\n".join(out) + "\n\n").encode()


def parse_sse(line_iter):
    """Incremental SSE parser over an iterator of raw lines (bytes or
    str, newline-stripped or not) — the client half ``sse_format`` is
    the server half of.  Yields (event, data_str) per frame; comments
    and blank keep-alives are skipped.  Used by the router's HTTP
    transport to follow a replica's stream token-by-token."""
    event, data = None, []
    for raw in line_iter:
        line = raw.decode() if isinstance(raw, bytes) else raw
        line = line.rstrip("\r\n")
        if not line:               # frame boundary
            if data:
                yield (event or "message", "\n".join(data))
            event, data = None, []
            continue
        if line.startswith(":"):
            continue               # keep-alive comment
        if line.startswith("event:"):
            event = line[6:].strip()
        elif line.startswith("data:"):
            data.append(line[5:].lstrip())
    if data:                       # unterminated final frame
        yield (event or "message", "\n".join(data))
