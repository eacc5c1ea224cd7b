"""Runtime stat registry (a copy of ``paddle_tpu/monitor/stats.py``).

Reference parity: ``platform/monitor.h`` — ``StatValue<T>`` (thread-safe
increase/decrease/reset counters) registered in a name-keyed
``StatRegistry`` singleton and bumped via ``STAT_ADD``/``STAT_SUB``
macros (GPU mem stats etc., exported to Python through pybind).

Extension: the reference had "no Prometheus/OpenTelemetry-
style exporter in-tree" (SURVEY §5.5); a serving system needs one, so
the registry grows Prometheus-flavored metric types (Counter / Gauge /
Histogram) and a text exposition renderer (exposition.py).  Everything
is pure stdlib + threads — no torch import, so DataLoader worker
processes and the HTTP metrics handler can use it freely.
"""
from __future__ import annotations

import re
import threading
import time


class Counter:
    """Monotonically increasing count (Prometheus counter)."""

    kind = "counter"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(
                f"Counter {self.name!r} is monotonic; inc({n}) would "
                "decrease it (use a Gauge for up/down values)")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0


class Gauge:
    """Instantaneous value that can go up or down (Prometheus gauge)."""

    kind = "gauge"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v):
        with self._lock:
            self._value = float(v)

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0


# Latency-shaped default buckets (seconds-as-milliseconds friendly):
# spans sub-ms jit dispatch to multi-second prefill/compile outliers.
DEFAULT_BUCKETS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                   1000, 2500, 5000, 10000)


class Histogram:
    """Cumulative-bucket histogram (Prometheus histogram semantics:
    each ``le`` bucket counts observations <= its bound, plus +Inf)."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("Histogram needs at least one bucket bound")
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self):
        """(cumulative_bucket_counts aligned to bounds + +Inf, sum,
        count) — cumulative per Prometheus exposition rules."""
        with self._lock:
            raw = list(self._counts)
            total, cum = 0, []
            for c in raw:
                total += c
                cum.append(total)
            return cum, self._sum, self._count

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def mean(self):
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def percentile(self, q):
        """Estimate the q-th percentile (``q`` in [0, 100]) from the
        bucket counts, linearly interpolating within the containing
        bucket (Prometheus ``histogram_quantile`` semantics: the first
        bucket interpolates up from 0, and a rank landing in the +Inf
        overflow bucket returns the highest finite bound — the
        histogram cannot resolve beyond it).  NaN on an empty
        histogram.  Bench and tests use this to assert latency bounds
        (e.g. TPOT p99) without a Prometheus server."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return float("nan")
        rank = q / 100.0 * total
        cum, lo = 0, 0.0
        for bound, c in zip(self.bounds, counts):
            if c > 0 and cum + c >= rank:
                frac = min(max((rank - cum) / c, 0.0), 1.0)
                return lo + (bound - lo) * frac
            cum += c
            lo = bound
        return self.bounds[-1]

    def reset(self):
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0


class StatValue:
    """reference: platform/monitor.h:30 StatValue<T> — a thread-safe
    int stat with increase/decrease/reset, bumped via stat_add/stat_sub
    (the STAT_ADD/STAT_SUB macro twins)."""

    kind = "stat"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def increase(self, n=1):
        with self._lock:
            self._value += n
            return self._value

    def decrease(self, n=1):
        with self._lock:
            self._value -= n
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0

    def get(self):
        with self._lock:
            return self._value

    @property
    def value(self):
        return self.get()


class StatRegistry:
    """Name-keyed metric registry (reference: monitor.h:77
    StatRegistry::Instance).  ``counter()``/``gauge()``/``histogram()``/
    ``stat()`` are get-or-create; asking for an existing name with a
    different metric type is a loud error, never a silent shadow."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def stat(self, name, help=""):
        return self._get_or_create(StatValue, name, help)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def items(self):
        """Point-in-time snapshot of (name, metric) pairs, sorted,
        taken under ONE lock acquisition.  This is the exposition
        contract: ``render_prometheus`` iterates the returned LIST, so
        a metric registered concurrently (e.g. the engine's
        compile-event hook firing while a /metrics or /debug handler
        renders) can never mutate the mapping mid-iteration — it
        simply appears in the next render."""
        with self._lock:
            return sorted(self._metrics.items())

    def reset(self):
        """Zero every metric, keeping registrations (test isolation)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()

    def clear(self):
        with self._lock:
            self._metrics.clear()


_default = StatRegistry()


def default_registry():
    return _default


# -- reference-macro twins (monitor.h:130 STAT_ADD/STAT_SUB) -------------

def stat_add(name, n=1):
    """STAT_ADD: bump the named int stat in the default registry."""
    return _default.stat(name).increase(n)


def stat_sub(name, n=1):
    """STAT_SUB twin of stat_add."""
    return _default.stat(name).decrease(n)


def stat_get(name):
    """Read the named int stat (0 if never touched — matching the
    reference's default-constructed StatValue)."""
    m = _default.get(name)
    return m.get() if isinstance(m, StatValue) else 0


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name):
    """Map internal dotted names ('serving.queue_depth') onto the
    Prometheus charset ([a-zA-Z_:][a-zA-Z0-9_:]*)."""
    out = _NAME_RE.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


class RateMeter:
    """Windowed events-per-second meter (tokens/sec and friends): feeds
    a Gauge from a monotonic-clock window so the value stays meaningful
    without a Prometheus server computing rate() over a Counter."""

    def __init__(self, gauge, window_s=2.0):
        self.gauge = gauge
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._events = []  # (t, n)

    def add(self, n, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            self._events.append((now, n))
            self._update(now)

    def refresh(self, now=None):
        """Re-evaluate the window without an event: an idle producer
        must decay the gauge to 0, not freeze the last burst's rate
        forever (call from the producer's idle loop)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._update(now)

    def _update(self, now):
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.pop(0)
        if not self._events:
            self.gauge.set(0.0)
            return
        total = sum(k for _, k in self._events)
        span = max(now - self._events[0][0], 1e-6)
        # span < window right after start; dividing by the true span
        # avoids the cold-start underestimate
        self.gauge.set(total / max(span, self.window_s / 10))
