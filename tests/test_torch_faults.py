"""The port's fault injector, tick watchdog and flight recorder held to
the JAX package.

* The schedule: for seeds 0-3, ``FaultInjector.scheduled(site, t)`` is
  the same in both packages for every site of ``SITES`` and t < 200
  (exact: the same blake2b draw), and the site tuples are equal.
* The non-slow tests of tests/test_faults.py run against the port
  (``torch_port_mirror``): the injector's unit behavior, each engine
  site's recovery (dispatch raise, pool exhaustion, the watchdog turning
  a wedged d2h into a recovery, a failing proposer) and the seeded
  mid-migration storm (``chaos``) over the port's CPU engine on weights
  bridged from the JAX ``tiny`` model; the three other storms are in
  tests/test_torch_fault_storms.py.  Greedy
  survivors are token-identical to JAX ``generate`` (no tolerance),
  every waiter unblocks, the pools return to refcount zero, and the same
  seed replays the same fault log.
* The flight recorder: after an injected ``dispatch`` fault in the same
  scenario, ``last_flight["metadata"]["flight-recorder"]`` and
  ``debug_requests()`` carry the JAX engine's key sets, level by level.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_port_mirror as mirror
from paddle_tpu import monitor as jax_monitor
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import faults as jax_faults
from paddle_tpu_torch.serving import faults as port_faults

torch.set_num_threads(1)

PORT = mirror.port_copy("test_faults.py")

UNIT_TIER = [
    "test_injector_schedule_is_pure_and_seeded",
    "test_injector_explicit_window_and_validation",
]
ENGINE_TIER = [
    "test_dispatch_fault_recovers_engine",
    "test_pool_exhaust_fault_requeues_popped_request",
    "test_watchdog_converts_wedged_d2h_to_recovery",
    "test_proposer_failure_degrades_not_fails",
    "test_migration_chaos_storm_deterministic",
]


@pytest.fixture(scope="module")
def tiny_gpt():
    paddle.seed(0)
    m = JaxGPT.from_config("tiny", dropout=0.0)
    m.eval()
    return m


def test_site_tuples_equal_jax():
    for name in ("ENGINE_SITES", "NET_SITES", "MIGRATE_SITES",
                 "PROC_SITES", "FRONTEND_SITES", "OFFLOAD_SITES",
                 "SITES"):
        assert getattr(port_faults, name) == getattr(jax_faults, name)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_schedule_equals_jax(seed):
    """Every site at rate 0.3 (inside a first/last window) fires on the
    same ticks in both packages, for t < 200."""
    kw = dict(seed=seed, rates={s: 0.3 for s in jax_faults.SITES},
              first_tick=5, last_tick=190)
    j = jax_faults.FaultInjector(**kw)
    p = port_faults.FaultInjector(**kw)
    for site in jax_faults.SITES:
        want = [j.scheduled(site, t) for t in range(200)]
        assert [p.scheduled(site, t) for t in range(200)] == want, site
        assert p._u01(site, 7) == j._u01(site, 7)


@pytest.mark.parametrize("name", mirror.cases(PORT, UNIT_TIER))
def test_unit_tier_on_the_port(name):
    """tests/test_faults.py's injector unit tests, on the port's copy."""
    mirror.run(PORT, name, {})


@pytest.mark.parametrize("name", mirror.cases(PORT, ENGINE_TIER))
def test_engine_tier_on_the_port(name, tiny_gpt):
    """tests/test_faults.py's engine sites and seeded storms, over the
    port's engine."""
    mirror.run(PORT, name, {"tiny_gpt": tiny_gpt})


def _keys(d, depth=3):
    """The nested key structure of a JSON dict (lists: their first
    dict element's), ``depth`` levels down."""
    if not isinstance(d, dict) or depth == 0:
        return None
    out = {}
    for k, v in d.items():
        if isinstance(v, list) and v and isinstance(v[0], dict):
            v = v[0]
        out[k] = _keys(v, depth - 1)
    return out


def _dispatch_fault_flight(make_engine, faults_mod):
    """Two requests on a paged 2-slot engine, a dispatch fault at tick 3
    (one request decoding, one prefilled): the flight record and the
    debug view taken at the failure."""
    inj = faults_mod.FaultInjector(seed=0).at(3, "dispatch")
    eng = make_engine(inj)
    prompts = [list(range(3, 12)), list(range(20, 37))]
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.step()
    eng.step()
    with pytest.raises(faults_mod.InjectedFault):
        eng.step()
    assert all(r.done() for r in reqs)
    fr = eng.last_flight["metadata"]["flight-recorder"]
    return fr, eng


def test_flight_record_and_debug_view_key_sets_equal_jax(tiny_gpt):
    """After a dispatch fault, the port's flight record carries the JAX
    engine's keys at every level (error, tick, requests with its slots,
    queue and engine blocks, preemptions, the async block with its
    in-flight ticks and next buffer), and ``debug_requests()`` the same
    keys as JAX's; the failing tick is the one the schedule named."""
    tm = mirror.port_model(tiny_gpt)

    def port_eng(inj):
        return mirror.port_engine(tm, num_slots=2, max_seq_len=48,
                                  kv_block_size=8, faults=inj)

    def jax_eng(inj):
        return JaxEngine(tiny_gpt, num_slots=2, max_seq_len=48,
                         kv_block_size=8, attn_impl="ragged",
                         registry=jax_monitor.StatRegistry(), faults=inj)

    pf, pe = _dispatch_fault_flight(port_eng, port_faults)
    jf, je = _dispatch_fault_flight(jax_eng, jax_faults)
    assert _keys(pf, 4) == _keys(jf, 4)
    assert pf["tick"] == jf["tick"] == 3
    assert "InjectedFault" in pf["error"]
    assert _keys(pe.debug_requests(), 3) == _keys(je.debug_requests(), 3)
    assert pe.registry.get("serving.faults_injected").value == 1


def test_flight_dir_dump_and_watchdog_on_a_clean_engine(tiny_gpt,
                                                        tmp_path):
    """``flight_dir`` receives the dump as chrome-trace JSON; an armed
    watchdog that never fires leaves a clean serve's stream, and its
    counter, untouched."""
    import json

    tm = mirror.port_model(tiny_gpt)
    inj = port_faults.FaultInjector(seed=0).at(2, "dispatch")
    eng = mirror.port_engine(tm, num_slots=2, max_seq_len=48,
                             kv_block_size=8, faults=inj,
                             flight_dir=str(tmp_path), watchdog_s=5.0)
    p = list(range(5, 14))
    eng.submit(p, max_new_tokens=4)
    eng.step()
    with pytest.raises(port_faults.InjectedFault):
        eng.step()
    with open(eng.last_flight_path) as f:
        dumped = json.load(f)
    assert dumped["metadata"]["flight-recorder"]["tick"] == 2
    r = eng.submit(p, max_new_tokens=6)
    eng.run_until_idle()
    want = tiny_gpt.generate(paddle.to_tensor(np.asarray([p], np.int32)),
                             max_new_tokens=6,
                             compiled="fused").numpy()[0].tolist()
    assert r.result(timeout=1).tolist() == want
    assert eng.registry.get("serving.watchdog_fires").value == 0
    eng.stop()
