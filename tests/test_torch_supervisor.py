"""The port's fleet tier (``serving/supervisor.py``, the SIGTERM drain of
``serving/httpd.py`` and ``distributed/launch.py``'s serving half)
held to the JAX package's tests and to the JAX copies themselves.

The non-slow tests of tests/test_supervisor.py run against the port
(``torch_port_mirror``): the supervisor's death, backoff, crash-loop,
wedge and incarnation logic over fake handles, the process sites,
``ServingFleet`` stop / kill / respawn over ``sleep`` children, and the
drain tier — two port ``EngineServer``s on the CPU over weights bridged
from the JAX ``tiny`` model, where ``drain_to_peers`` lands every live
stream on the peer, greedy and seeded, token-identical to an undrained
engine (exact) with zero lost tokens.  The restart jitter ``_u01`` equals
the JAX copy's.  One real-process fleet of ``python -m
paddle_tpu_torch.serving.httpd --device cpu`` replicas drains on SIGTERM
with ``lost_tokens=0`` and the drained streams equal to JAX
``generate``.
"""
import json
import os
import re
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_port_mirror as mirror
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.serving import supervisor as jax_sup
from paddle_tpu_torch.distributed.launch import spawn_serving_fleet
from paddle_tpu_torch.serving import supervisor as port_sup

torch.set_num_threads(1)

pytestmark = pytest.mark.supervisor

PORT = mirror.port_copy("test_supervisor.py")

UNIT_TIER = [
    "test_policy_validates_knobs",
    "test_exit_death_backoff_then_restart_bumps_incarnation",
    "test_backoff_doubles_and_jitter_is_seed_deterministic",
    "test_backoff_caps_and_zero_jitter_is_exact",
    "test_crashloop_quarantines_and_release_restarts",
    "test_deaths_outside_window_never_quarantine",
    "test_spawn_failure_walks_the_death_path_to_quarantine",
    "test_wedge_by_probe_timeout_kills_and_restarts",
    "test_wedge_strikes_reset_on_clean_probe",
    "test_watchdog_fired_probe_counts_as_wedge",
    "test_boot_grace_forgives_probes_but_not_exit",
    "test_trace_view_breaks_out_supervisor_and_drain_spans",
    "test_timeline_labels_carry_incarnation",
    "test_proc_sites_registered_and_schedule_is_pure",
    "test_proc_site_actions_signal_arm_and_log_first",
    "test_fleet_stop_escalates_past_sigstop_no_zombies",
    "test_fleet_kill_then_respawn_same_slot",
    "test_fleet_without_recorded_cmds_cannot_respawn",
]
DRAIN_TIER = [
    "test_drain_without_peer_falls_back_to_router_resume",
    "test_draining_server_rejects_new_work_but_serves_import",
]


@pytest.fixture(scope="module")
def tiny_gpt():
    paddle.seed(0)
    m = JaxGPT.from_config("tiny", dropout=0.0)
    m.eval()
    return m


@pytest.mark.parametrize("name", mirror.cases(PORT, UNIT_TIER))
def test_unit_tier_on_the_port(name, tmp_path):
    """tests/test_supervisor.py's fake-handle and process tiers, on the
    port's copies."""
    mirror.run(PORT, name, {"tmp_path": tmp_path})


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
def test_sigterm_drain_on_the_port(tiny_gpt, seeded):
    """tests/test_supervisor.py's drain of live ``/generate`` streams to
    a peer, over two port ``EngineServer``s."""
    mirror.run(PORT, "test_sigterm_drain_relays_streams_token_identical",
               {"tiny_gpt": tiny_gpt}, seeded=seeded)


@pytest.mark.parametrize("name", mirror.cases(PORT, DRAIN_TIER))
def test_drain_tier_on_the_port(name, tiny_gpt):
    """tests/test_supervisor.py's drain fallbacks, on the port."""
    mirror.run(PORT, name, {"tiny_gpt": tiny_gpt})


def test_restart_jitter_equals_jax():
    """The supervisor's seeded restart jitter is the same draw in both
    packages (exact), for seeds 0-3."""
    for seed in range(4):
        for parts in (("r0", 1, 0), ("r1", 3, 2), ("backoff", 7)):
            assert port_sup._u01(seed, *parts) == jax_sup._u01(seed,
                                                               *parts)


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _post(url, obj, timeout=60.0):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def test_real_fleet_sigterm_drain_loses_no_tokens(tmp_path):
    """Two ``python -m paddle_tpu_torch.serving.httpd --device cpu``
    replicas (same ``--seed``, so the same weights) wired as each
    other's drain peers.  Four 40-token streams decode on replica 0 when
    it gets SIGTERM: its drain line reports ``lost_tokens=0`` and at
    least one migrated stream, and every waiter's answer equals JAX
    ``generate`` on the replicas' weights (exact).  Every wait has its
    own timeout."""
    import jax.numpy as jnp

    from paddle_tpu_torch.convert import export_paddle_tpu_state
    from paddle_tpu_torch.models import GPTModel

    # the JAX reference on the replicas' own weights (from_config's seed)
    state = export_paddle_tpu_state(
        GPTModel.from_config("tiny", device="cpu", seed=0, dropout=0.0))
    jm = JaxGPT.from_config("tiny", dropout=0.0)
    jm.eval()
    for n, p in jm.named_parameters():
        p._data = jnp.asarray(state[n])
    prompts = [[(13 * k + 7 * i) % 127 + 1 for i in range(20)]
               for k in range(4)]
    max_new = 40
    refs = jm.generate(paddle.to_tensor(np.asarray(prompts, np.int32)),
                       max_new_tokens=max_new,
                       compiled="fused").numpy().tolist()
    with spawn_serving_fleet(2, config="tiny", device="cpu", seed=0,
                             num_slots=4, max_seq_len=64,
                             kv_block_size=8, prefill_chunk=8,
                             peers=True, log_dir=str(tmp_path),
                             ready_timeout_s=60.0) as fleet:
        url = fleet.urls[0]
        outs = [None] * len(prompts)

        def call(k):
            outs[k] = _post(url + "/generate",
                            {"prompt": prompts[k],
                             "max_new_tokens": max_new})

        threads = [threading.Thread(target=call, args=(k,), daemon=True)
                   for k in range(len(prompts))]
        for t in threads:
            t.start()
        # TERM replica 0 once every stream decodes (bounded wait)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            dbg = _get(url + "/debug/requests")
            if sum(1 for s in dbg["slots"] if s["state"] == "decoding"
                   and s.get("generated", 0) >= 1) == len(prompts):
                break
            time.sleep(0.002)
        fleet.procs[0].terminate()
        fleet.procs[0].wait(timeout=60)
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        with open(os.path.join(str(tmp_path), "replica.0.log")) as f:
            log = f.read()
    m = re.search(r"drain: migrated=(\d+) fallback=(\d+) "
                  r"lost_tokens=(\d+)", log)
    assert m, log
    assert int(m.group(3)) == 0 and int(m.group(2)) == 0, log
    assert int(m.group(1)) >= 1, log
    assert [o["ids"] for o in outs] == refs
    assert sum(1 for o in outs if o.get("migrated")) == int(m.group(1))
