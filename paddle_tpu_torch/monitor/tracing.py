"""Tick-level span tracer + flight-recorder buffer (a copy of
``paddle_tpu/monitor/tracing.py``, with the profiler pass-through on
``torch.profiler``).

Reference parity: ``platform/profiler.h`` ``RecordEvent`` (RAII host
spans) collected per thread and exported through
``tools/timeline.py`` as a chrome://tracing (Catapult JSON) timeline.
The reproduction's twin is serving-shaped: the ``Tracer`` keeps a
BOUNDED ring buffer of complete-events per thread — cheap enough to
leave on in production — so the last N engine ticks are always
retained (the port's ``serving/engine.py`` feeds one per engine;
``Engine.chrome_trace()`` exports it).

Design points:

- **Low overhead.**  A span is two ``time.perf_counter()`` calls and
  one deque append under a lock; a disabled tracer (or the
  ``NullTracer``) short-circuits to a shared no-op context manager.
  No torch import at module level — like the rest of ``monitor``, this
  is pure stdlib and safe in fork'd workers and HTTP handler threads.
- **Thread-aware.**  Each thread appends into its own
  ``deque(maxlen=capacity)`` ring buffer, so the engine loop, HTTP
  handlers, and background threads never interleave events;
  ``events()`` merges the per-thread rings into one ts-sorted
  snapshot.
- **Chrome-trace native.**  Events are stored directly in Catapult
  complete-event shape (``ph="X"``, microsecond ``ts``/``dur``) plus
  instant events (``ph="i"``) for point-in-time lifecycle marks, so
  export is a dict build, not a format conversion.
- **Profiler pass-through.**  ``annotate=True`` (per tracer or per
  span) additionally enters a ``torch.profiler.record_function`` so the
  same spans land in a ``torch.profiler`` capture when one is active
  (lazy torch import — only paid when asked for).
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
from collections import deque

# Catapult instant-event scope: "t" = thread-scoped tick mark (the
# narrow arrow in chrome://tracing), vs "p"/"g" process/global.
_INSTANT_SCOPE = "t"


class TraceEvent:
    """One trace event in Catapult terms: ``ph="X"`` complete event
    (ts + dur) or ``ph="i"`` instant.  ``ts``/``dur`` are microseconds
    on the ``time.perf_counter`` clock (monotonic; arbitrary origin,
    like the reference profiler's host timeline)."""

    __slots__ = ("name", "ph", "ts", "dur", "tid", "cat", "args")

    def __init__(self, name, ph, ts, dur, tid, cat, args):
        self.name = name
        self.ph = ph
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.cat = cat
        self.args = args

    def to_json(self, pid=None):
        d = {"name": self.name, "ph": self.ph, "pid": int(
            os.getpid() if pid is None else pid), "tid": self.tid,
            "ts": self.ts, "cat": self.cat}
        if self.ph == "X":
            d["dur"] = self.dur
        elif self.ph == "i":
            d["s"] = _INSTANT_SCOPE
        if self.args:
            d["args"] = self.args
        return d

    def __repr__(self):
        return (f"TraceEvent({self.name!r}, ph={self.ph!r}, "
                f"ts={self.ts:.1f}, dur={self.dur:.1f}, "
                f"tid={self.tid})")


class RecordEvent:
    """RAII span, mirroring the reference ``platform::RecordEvent``:
    usable as a context manager or a decorator.

        with RecordEvent("tick", tracer, batch=4) as sp:
            ...
            sp.args["emitted"] = n     # args may be amended pre-exit

        @RecordEvent("load_batch", tracer)
        def load_batch(...): ...

    Exactly two clock reads per span (enter + exit) — the elapsed
    seconds land on ``.elapsed`` and the complete-event is appended to
    the tracer's ring buffer.  ``annotate=True`` additionally wraps
    the span in ``torch.profiler.record_function`` so it shows up in
    ``torch.profiler`` captures (lazily imported)."""

    def __init__(self, name, tracer=None, cat="serving", annotate=None,
                 **args):
        self.name = name
        self._tracer = tracer if tracer is not None else default_tracer()
        self.cat = cat
        self.args = args
        tr_ann = getattr(self._tracer, "annotate", False)
        self._annotate = tr_ann if annotate is None else annotate
        self._ann = None
        self.elapsed = 0.0

    def __enter__(self):
        if self._annotate:
            import torch.profiler
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.elapsed = t1 - self._t0
        self._tracer._append(
            self.name, "X", self._t0 * 1e6, self.elapsed * 1e6,
            self.cat, self.args or None)
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        return False

    def __call__(self, fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            # fresh args dict per call: the decorator form is reused
            # across calls, and a shared mutable dict would leak one
            # call's annotations into the next event
            with RecordEvent(self.name, self._tracer, cat=self.cat,
                             annotate=self._annotate,
                             **dict(self.args)):
                return fn(*a, **kw)
        return wrapped


class _NullSpan:
    """Shared no-op span for disabled tracing: supports the same
    ``with ... as sp: sp.args[...] = ...`` protocol at near-zero cost
    (the args dict is written but never read; keys are bounded by the
    instrumentation sites, so it cannot grow without bound)."""

    __slots__ = ()
    args = {}
    elapsed = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return fn


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Drop-in disabled tracer (``Engine(tracing=False)``): every hook
    is a no-op, exports are empty — the instrumented hot paths pay one
    attribute call and nothing else."""

    enabled = False
    annotate = False

    def span(self, name, cat="serving", annotate=None, **args):
        return _NULL_SPAN

    def instant(self, name, cat="serving", **args):
        pass

    def emit(self, name, ts_s, dur_s, cat="serving", args=None):
        pass

    def _append(self, *a, **k):
        pass

    def events(self):
        return []

    def clear(self):
        pass

    def chrome_trace(self, process_name="paddle_tpu_torch"):
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def dump(self, path, process_name="paddle_tpu_torch"):
        with open(path, "w") as f:
            json.dump(self.chrome_trace(process_name), f)
        return path


class Tracer:
    """Thread-aware span collector over bounded per-thread ring
    buffers.

    ``capacity`` bounds EACH thread's ring (oldest events fall off —
    that is the flight-recorder property: under sustained load the
    buffer always holds the most recent ~capacity events, never grows,
    and never needs draining).  Lanes are per thread LIFETIME, not per
    OS thread id: each thread gets a fresh lane id on its first event
    (resolved through a ``threading.local``), so a recycled pthread
    ident can never write into — or inherit the label of — a dead
    handler thread's lane.  Dead threads' lanes are retained (their
    recent lifecycle events are exactly what a post-mortem wants)
    until the lane count exceeds ``max_threads``, then pruned oldest
    first — live lanes are never evicted.  ``enabled=False`` mutes
    collection without tearing down the buffers; flip ``enabled``
    freely at runtime (profiler start/stop does)."""

    def __init__(self, capacity=16384, enabled=True, annotate=False,
                 max_threads=64):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_threads < 1:
            raise ValueError(
                f"max_threads must be >= 1, got {max_threads}")
        self.capacity = int(capacity)
        self.max_threads = int(max_threads)
        self.enabled = bool(enabled)
        self.annotate = bool(annotate)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._buffers = {}       # lane -> deque(maxlen=capacity)
        self._thread_names = {}  # lane -> thread name at first event
        self._thread_refs = {}   # lane -> weakref to the thread
        self._next_lane = 1

    # -- collection ----------------------------------------------------
    def _buf(self):
        cached = getattr(self._local, "lane_buf", None)
        if cached is not None:
            return cached
        t = threading.current_thread()
        with self._lock:
            self._prune_dead_locked()
            lane = self._next_lane
            self._next_lane += 1
            buf = deque(maxlen=self.capacity)
            self._buffers[lane] = buf
            self._thread_names[lane] = t.name
            self._thread_refs[lane] = weakref.ref(t)
        self._local.lane_buf = (lane, buf)
        return lane, buf

    def _prune_dead_locked(self):
        """Bound the lane table: once ``max_threads`` lanes exist,
        evict DEAD threads' lanes in creation order until back under
        the bound (short-lived HTTP handler threads each burn a lane;
        without this a thread-per-connection server grows the table
        forever).  Caller holds the lock."""
        if len(self._buffers) < self.max_threads:
            return
        for lane in list(self._buffers):
            if len(self._buffers) < self.max_threads:
                break
            th = self._thread_refs[lane]()
            if th is None or not th.is_alive():
                del self._buffers[lane]
                del self._thread_names[lane]
                del self._thread_refs[lane]

    def _append(self, name, ph, ts_us, dur_us, cat, args):
        if not self.enabled:
            return
        tid, buf = self._buf()
        # the lock covers the append/snapshot race: deque.append is
        # atomic, but ``events()`` listing a ring mid-append from
        # another thread would raise "deque mutated during iteration"
        with self._lock:
            buf.append(TraceEvent(name, ph, ts_us, dur_us, tid, cat,
                                  dict(args) if args else None))

    def span(self, name, cat="serving", annotate=None, **args):
        """Open a complete-event span (context manager / decorator).
        Keyword args become the event's chrome-trace ``args``; amend
        ``sp.args`` inside the block for values only known at exit."""
        if not self.enabled:
            return _NULL_SPAN
        return RecordEvent(name, self, cat=cat, annotate=annotate,
                           **args)

    def instant(self, name, cat="serving", **args):
        """Record a point-in-time instant event (``ph="i"``) — the
        per-request lifecycle marks (queued/admitted/first-token/...)."""
        if not self.enabled:
            return
        self._append(name, "i", time.perf_counter() * 1e6, 0.0, cat,
                     args or None)

    def emit(self, name, ts_s, dur_s, cat="serving", args=None):
        """Append a complete-event measured externally (seconds on the
        perf_counter clock) — the compile-event hook uses this: the
        wall time was measured around the first jitted call, the event
        is back-dated to when it started."""
        self._append(name, "X", ts_s * 1e6, dur_s * 1e6, cat, args)

    # -- snapshot / export ---------------------------------------------
    def events(self):
        """ts-sorted snapshot of every thread's ring buffer (the rings
        keep collecting; the snapshot is consistent per ring)."""
        with self._lock:
            merged = [ev for buf in self._buffers.values()
                      for ev in buf]
        merged.sort(key=lambda ev: ev.ts)
        return merged

    def clear(self):
        with self._lock:
            for buf in self._buffers.values():
                buf.clear()

    def thread_names(self):
        with self._lock:
            return dict(self._thread_names)

    def chrome_trace(self, process_name="paddle_tpu_torch"):
        """The current buffers as a Catapult JSON dict (chrome://tracing
        / Perfetto `Open trace file` compatible)."""
        return to_chrome_trace(self.events(),
                               thread_names=self.thread_names(),
                               process_name=process_name)

    def dump(self, path, process_name="paddle_tpu_torch"):
        """Write the current buffers as a chrome-trace JSON file;
        returns the path (the flight-recorder dump primitive)."""
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(process_name), f)
        return path


def to_chrome_trace(events, thread_names=None, process_name=None,
                    pid=None):
    """Render ``TraceEvent``s (or pre-built event dicts) as a Catapult
    JSON dict: ``{"traceEvents": [...], "displayTimeUnit": "ms"}``.

    ``thread_names``/``process_name`` add the ``ph="M"`` metadata
    events chrome://tracing uses to label lanes; pass neither for a
    bare event list (utils/profiler.py's reference-parity export keeps
    exactly one JSON object per recorded span)."""
    pid = int(os.getpid() if pid is None else pid)
    out = []
    if process_name:
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"name": str(process_name)}})
    for tid, tname in sorted((thread_names or {}).items()):
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": str(tname)}})
    for ev in events:
        out.append(ev.to_json(pid=pid) if isinstance(ev, TraceEvent)
                   else dict(ev))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


_default_tracer = Tracer()


def default_tracer():
    """Process-wide default tracer (``RecordEvent("x")`` with no
    explicit tracer lands here) — the serving engine builds its OWN
    tracer per instance so two engines' ticks never interleave."""
    return _default_tracer
