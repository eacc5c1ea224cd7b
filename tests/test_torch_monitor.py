"""The port's monitor (``paddle_tpu_torch/monitor``, its own copy of
``paddle_tpu/monitor``) held to the JAX package's monitor tests.

Each case runs one test of ``tests/test_monitor.py`` or
``tests/test_tracing.py`` with the port's monitor in place of the JAX
package's: the test module's names bound to ``paddle_tpu.monitor``
(and a test's own ``from paddle_tpu.monitor import ...``) resolve to the
port's objects for the length of the case.  The cases left out test what
the port's monitor does not cover: the JAX ``TrainStep``'s counters and
the ``tools/`` trace viewers.  JAX is imported inside the cases.
"""
import importlib.util
import os
import sys

import pytest
import torch

import paddle_tpu_torch.monitor as port_monitor
import paddle_tpu_torch.monitor.tracing as port_tracing
from paddle_tpu_torch.monitor import Tracer

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))

MONITOR_CASES = [
    "test_counter_monotonic", "test_gauge_up_down",
    "test_histogram_cumulative_buckets",
    "test_histogram_percentile_interpolation",
    "test_histogram_percentile_overflow_and_empty",
    "test_render_prometheus_escapes_help_text",
    "test_render_prometheus_empty_histogram",
    "test_registry_get_or_create_and_type_conflict",
    "test_stat_value_macros", "test_render_prometheus_format",
    "test_registry_reset_keeps_registrations", "test_rate_meter_sets_gauge",
    "test_rate_meter_refresh_decays_to_zero",
    "test_render_during_concurrent_registration",
]
TRACING_CASES = [
    "test_span_and_instant_events_valid_catapult",
    "test_ring_buffer_bounded_under_sustained_load",
    "test_thread_safety_concurrent_spans_and_snapshots",
    "test_record_event_decorator_and_disable", "test_null_tracer_and_emit",
    "test_to_chrome_trace_bare_event_list",
    "test_dead_thread_lanes_pruned_and_idents_not_recycled",
]
_loaded = {}


def _jax_test_module(name):
    """``tests/<name>.py`` loaded under a private module name (pytest
    collects the file itself; this copy only lends its functions)."""
    if name not in _loaded:
        spec = importlib.util.spec_from_file_location(
            f"_port_case_{name}", os.path.join(HERE, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[name] = mod
    return _loaded[name]


def _run_with_port_monitor(monkeypatch, module_name, case):
    import paddle_tpu
    import paddle_tpu.monitor
    mod = _jax_test_module(module_name)
    for attr, value in list(vars(mod).items()):
        owner = getattr(value, "__module__", "") or ""
        if value is paddle_tpu.monitor:
            monkeypatch.setattr(mod, attr, port_monitor)
        elif owner.startswith("paddle_tpu.monitor") and \
                hasattr(port_monitor, attr):
            monkeypatch.setattr(mod, attr, getattr(port_monitor, attr))
    monkeypatch.setitem(sys.modules, "paddle_tpu.monitor", port_monitor)
    monkeypatch.setitem(sys.modules, "paddle_tpu.monitor.tracing",
                        port_tracing)
    monkeypatch.setattr(paddle_tpu, "monitor", port_monitor)
    fn = getattr(mod, case)
    assert fn.__globals__ is vars(mod)
    fn()


@pytest.mark.parametrize("case", MONITOR_CASES)
def test_port_monitor_passes_jax_monitor_case(monkeypatch, case):
    _run_with_port_monitor(monkeypatch, "test_monitor", case)


@pytest.mark.parametrize("case", TRACING_CASES)
def test_port_tracer_passes_jax_tracing_case(monkeypatch, case):
    _run_with_port_monitor(monkeypatch, "test_tracing", case)


def test_cases_run_the_port_objects(monkeypatch):
    """The swap reaches the test bodies: inside a case, the Counter and
    the Tracer the module names are the port's."""
    from paddle_tpu.monitor import Counter as JaxCounter
    _run_with_port_monitor(monkeypatch, "test_monitor",
                           "test_counter_monotonic")
    assert _jax_test_module("test_monitor").Counter is port_monitor.Counter
    assert port_monitor.Counter is not JaxCounter
    seen = {}
    _run_with_port_monitor(monkeypatch, "test_tracing",
                           "test_null_tracer_and_emit")
    mod = _jax_test_module("test_tracing")
    real = mod.Tracer

    def spy(*a, **k):
        seen["tracer"] = real(*a, **k)
        return seen["tracer"]

    monkeypatch.setattr(mod, "Tracer", spy)
    mod.test_ring_buffer_bounded_under_sustained_load()
    assert type(seen["tracer"]).__module__ == \
        "paddle_tpu_torch.monitor.tracing"


def test_annotated_spans_reach_the_torch_profiler():
    """``annotate=True`` enters ``torch.profiler.record_function`` per
    span (the JAX copy enters a ``jax.profiler.TraceAnnotation``)."""
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer(annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("engine.phase", batch=2):
            torch.ones(4).sum()
    assert "engine.phase" in {e.key for e in prof.key_averages()}
    (ev,) = tr.events()
    assert ev.name == "engine.phase" and ev.args == {"batch": 2}
