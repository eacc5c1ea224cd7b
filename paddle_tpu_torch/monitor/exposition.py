"""Prometheus text exposition (format 0.0.4) for the stat registry (a
copy of ``paddle_tpu/monitor/exposition.py``).

The reference had no exporter in-tree (SURVEY §5.5 — glog + pybind
stat getters only); serving needs scrapeable metrics, so this renders
every registered Counter/Gauge/Histogram/StatValue as the standard
``# HELP`` / ``# TYPE`` / sample-line triple that Prometheus,
VictoriaMetrics, and ``curl | grep`` all understand.
"""
from __future__ import annotations

from .stats import (Counter, Gauge, Histogram, StatValue,
                    default_registry, sanitize_name)


def _fmt(v):
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _escape_help(text):
    """Prometheus text format 0.0.4: HELP text must escape ``\\`` as
    ``\\\\`` and line feeds as ``\\n`` — a raw newline would split the
    comment mid-line and corrupt the whole exposition (the line after
    it would parse as a malformed sample)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def render_prometheus(registry=None):
    """Render every metric in ``registry`` (default: the process-wide
    default registry) as Prometheus text exposition."""
    registry = registry or default_registry()
    lines = []
    # registry.items() is a sorted snapshot taken under one lock:
    # registrations landing mid-render (compile-event hooks, a sibling
    # engine initializing) never mutate the iteration — each metric's
    # own lock then keeps its sample lines internally consistent
    for name, m in registry.items():
        pname = sanitize_name(name)
        if m.help:
            lines.append(f"# HELP {pname} {_escape_help(m.help)}")
        if isinstance(m, Histogram):
            lines.append(f"# TYPE {pname} histogram")
            cum, total_sum, count = m.snapshot()
            for bound, c in zip(m.bounds, cum):
                lines.append(
                    f'{pname}_bucket{{le="{_fmt(bound)}"}} {c}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {count}')
            lines.append(f"{pname}_sum {_fmt(total_sum)}")
            lines.append(f"{pname}_count {count}")
        elif isinstance(m, Counter):
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {_fmt(m.value)}")
        elif isinstance(m, (Gauge, StatValue)):
            # StatValue maps onto gauge: it can decrease (STAT_SUB)
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(m.value)}")
    return "\n".join(lines) + ("\n" if lines else "")
