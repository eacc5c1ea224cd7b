"""The port's router tier (``serving/router.py`` + ``routerd.py``, copies
of the JAX package's) held to the JAX package's tests and to the JAX
copies themselves.

The non-slow tests of tests/test_router.py run against the port
(``torch_port_mirror``): the fake-replica unit tier (affinity hashing,
rendezvous picks, the breaker, retries and hedging, routerd's endpoints
and JSON error contract, timeline expansion) and the in-process tier over
the port's CPU engine on weights bridged from the JAX ``tiny`` model,
whose ``generate`` stays the greedy reference (token-identical, no
tolerance) — the seeded chaos storm (``chaos``) among them: every
request delivered exactly once, the same seed replaying the same fault
and routing logs.  Beside them, the router's pure functions are held to
the JAX copies value for value: ``affinity_key``, the rendezvous target
of every key, and the seeded backoff jitter ``_u01``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_port_mirror as mirror
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.serving import router as jax_router
from paddle_tpu_torch.serving import router as port_router

torch.set_num_threads(1)

pytestmark = pytest.mark.router

PORT = mirror.port_copy("test_router.py")

UNIT_TIER = [
    "test_affinity_key_block_alignment",
    "test_rendezvous_stability_under_churn",
    "test_pick_affinity_with_load_fallback",
    "test_pick_excludes_draining_and_dead",
    "test_random_routing_arm_is_seeded",
    "test_breaker_trip_halfopen_and_recovery",
    "test_breaker_trips_through_router_and_probe_recovers",
    "test_retry_honors_retry_after_and_backoff_is_seeded",
    "test_non_retryable_4xx_fails_fast",
    "test_blackhole_timeout_retries_only_idempotent",
    "test_disconnect_resume_greedy_vs_restart_sampled",
    "test_hedge_fires_after_delay_and_cancels_loser",
    "test_hedge_default_p99_delay_path",
    "test_hedge_is_the_halfopen_trial",
    "test_probe_sweep_not_blocked_by_hung_replicas",
    "test_router_spans_and_lifecycle_instants",
    "test_net_sites_pure_schedule_and_actions",
    "test_blackhole_abort_hook_cuts_the_wait_short",
    "test_classify_probe_handles_both_healthz_shapes",
    "test_4xx_is_caller_fault_not_a_breaker_failure",
    "test_cancelled_attempt_releases_halfopen_trial",
    "test_http_retry_after_accepts_both_header_forms",
    "test_disconnect_after_eos_does_not_redispatch",
    "test_caller_timeout_caps_attempt_transport_budget",
    "test_http_client_maps_connect_phase_reset_retryable",
    "test_routerd_replica_spec_parsing",
    "test_routerd_main_fails_fast_when_no_replica_answers",
    "test_routerd_endpoints_and_json_error_contract",
    "test_timeline_expands_router_into_per_replica_sources",
    "test_incarnation_bump_resets_breaker_and_history",
    "test_stale_probe_from_dead_incarnation_is_discarded",
    "test_revive_without_bump_keeps_breaker_recovery_path",
]
ENGINE_TIER = [
    "test_probe_states_from_real_engine",
    "test_unstarted_request_fails_over_off_dead_replica",
    "test_draining_replica_stops_receiving_new_requests",
    "test_inprocess_caller_fault_maps_to_400_not_breaker",
    "test_chaos_storm_exactly_once_and_deterministic",
]


@pytest.fixture(scope="module")
def tiny_gpt():
    paddle.seed(0)
    m = JaxGPT.from_config("tiny", dropout=0.0)
    m.eval()
    return m


@pytest.mark.parametrize("name", mirror.cases(PORT, UNIT_TIER))
def test_unit_tier_on_the_port(name, tmp_path):
    """tests/test_router.py's fake-replica tier, on the port's copy."""
    mirror.run(PORT, name, {"tmp_path": tmp_path})


@pytest.mark.parametrize("name", mirror.cases(PORT, ENGINE_TIER))
def test_in_process_tier_on_the_port(name, tiny_gpt):
    """tests/test_router.py's ``InProcessReplica`` tier over the port's
    engine; greedy streams token-identical to JAX ``generate``."""
    mirror.run(PORT, name, {"tiny_gpt": tiny_gpt})


def _prompts(n=64, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 50257, (int(rng.randint(1, 40)),)).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("block_size", [1, 8, 16])
def test_affinity_key_equals_jax(block_size):
    """``affinity_key`` hashes the same block-aligned span to the same
    key in both packages (exact)."""
    for p in _prompts():
        assert port_router.affinity_key(p, block_size) \
            == jax_router.affinity_key(p, block_size)


def test_rendezvous_targets_equal_jax():
    """Over three replicas and every prompt, both packages' routers send
    a key to the same affinity target (no load: the pure rendezvous
    pick)."""
    def fleet(mod):
        class Rep:
            def __init__(self, name):
                self.name = name

            def probe(self):
                return {"queue_depth": 0, "slots_free": 4,
                        "draining": False}

            def generate(self, payload, should_abort=None):
                raise AssertionError("not dispatched")

        return mod.Router({n: Rep(n) for n in ("r0", "r1", "r2")},
                          policy=mod.RouterPolicy(seed=0),
                          kv_block_size=8)

    jr, pr = fleet(jax_router), fleet(port_router)
    for p in _prompts():
        key = jax_router.affinity_key(p, 8)
        assert pr._affinity_target(key, pr._reps()).name \
            == jr._affinity_target(key, jr._reps()).name


def test_backoff_jitter_equals_jax():
    """The router's seeded draw ``_u01`` (backoff spread, probe stagger,
    random-routing picks) and the backoff it shapes are the same numbers
    in both packages (exact), so a seeded retry schedule replays across
    them."""
    for seed in range(4):
        for parts in (("backoff", 3, 1), ("probe", "r1"),
                      ("random", 17, 0)):
            assert port_router._u01(seed, *parts) \
                == jax_router._u01(seed, *parts)
    j = jax_router.Router({}, policy=jax_router.RouterPolicy(seed=5))
    p = port_router.Router({}, policy=port_router.RouterPolicy(seed=5))
    for rid in range(20):
        for n in range(4):
            assert p._backoff(rid, n) == j._backoff(rid, n)
