"""KV migration in the port (``Engine.migrate_out`` / ``migrate_in`` /
``export_prefix`` / ``import_prefix``) held to the JAX package.

* The non-slow tests of tests/test_migration.py run against the port
  (``torch_port_mirror``): the parity matrix (a live stream exported
  after 3 tokens and resumed on a fresh engine equals the unmigrated
  stream exactly, greedy and seeded, on every engine shape), the deliver
  modes, victim choice, injected export and import faults (declined: the
  stream stays; rolled back to refcount zero: the payload replays), a
  geometry mismatch adopting nothing, disaggregated prefill / decode,
  rebalance and prefix warming through the router, and the ``/migrate``
  endpoints over real sockets, on the port's CPU engine over weights
  bridged from the JAX ``tiny`` model.
* Greedy migrated streams through the JSON wire form are token-identical
  to JAX ``generate`` on every port path (ragged, chunked, speculative,
  depth 1, XLA contiguous and paged); int8 KV equal the unmigrated int8
  stream exactly.  Host sampling carries the numpy generator's state.
* Across packages: a JAX payload imported by the port, and a port payload
  imported by the JAX engine, continue the greedy stream
  token-identically (the wire format is one format).
* fp32 blocks into int8 pools raise ``KVDtypeMismatch``; a mesh engine
  refuses migration naming ROADMAP Queue A 10.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_port_mirror as mirror
from paddle_tpu import monitor as jax_monitor
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import kvcache as jax_kv
from paddle_tpu_torch.distributed import ServingMesh
from paddle_tpu_torch.serving import (KVDtypeMismatch, payload_from_json,
                                      payload_to_json)
from paddle_tpu_torch.serving.engine import Migrated

torch.set_num_threads(1)

pytestmark = pytest.mark.migration

PORT = mirror.port_copy("test_migration.py")

PROMPT = list(range(11, 31))
MAX_NEW = 12

ENGINE_TIER = [
    "test_migrate_deliver_error_payload_rides_waiter",
    "test_migrate_out_unpinned_picks_a_victim",
    "test_migrate_out_of_completed_stream",
    "test_export_fault_declines_stream_stays",
    "test_import_fault_rolls_back_and_payload_replays",
    "test_import_geometry_mismatch_adopts_nothing",
    "test_disaggregation_degrades_without_decode_replicas",
    "test_rebalance_preempt_and_migrate",
    "test_prefix_warm_on_affinity_miss",
    "test_httpd_migrate_export_import_roundtrip",
]

PATHS = {
    "ragged": dict(kv_block_size=8),
    "ragged_chunked": dict(kv_block_size=8, prefill_chunk=8),
    "ragged_spec": dict(kv_block_size=8, prefill_chunk=8, spec_k=2),
    "ragged_depth1": dict(kv_block_size=8, prefill_chunk=8,
                          async_depth=1),
    "xla_contiguous": dict(attn_impl="xla"),
    "xla_paged": dict(attn_impl="xla", kv_block_size=8, prefill_chunk=8),
}


@pytest.fixture(scope="module")
def tiny_gpt():
    paddle.seed(0)
    m = JaxGPT.from_config("tiny", dropout=0.0)
    m.eval()
    return m


@pytest.fixture(scope="module")
def jax_ref(tiny_gpt):
    out = tiny_gpt.generate(paddle.to_tensor(np.asarray([PROMPT], np.int32)),
                            max_new_tokens=MAX_NEW,
                            compiled="fused").numpy()[0]
    return [int(t) for t in out]


@pytest.mark.parametrize("name", sorted(PORT.CONFIGS))
@pytest.mark.parametrize("seed", [None, 1234], ids=["greedy", "seeded"])
def test_parity_matrix_on_the_port(tiny_gpt, name, seed):
    """tests/test_migration.py's parity matrix, over the port's engine."""
    mirror.run(PORT, "test_migrate_mid_decode_token_identical",
               {"tiny_gpt": tiny_gpt}, name=name, seed=seed)


@pytest.mark.parametrize("seed", [None, 1234], ids=["greedy", "seeded"])
def test_disaggregated_parity_on_the_port(tiny_gpt, seed):
    """tests/test_migration.py's prefill -> decode disaggregation."""
    mirror.run(PORT, "test_disaggregated_prefill_decode_parity",
               {"tiny_gpt": tiny_gpt}, seed=seed)


@pytest.mark.parametrize("name", mirror.cases(PORT, ENGINE_TIER))
def test_engine_tier_on_the_port(name, tiny_gpt):
    """The rest of tests/test_migration.py's in-process tier."""
    mirror.run(PORT, name, {"tiny_gpt": tiny_gpt})


def _port(tiny_gpt, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq_len", 64)
    return mirror.port_engine(mirror.port_model(tiny_gpt), **kw)


def _jax(tiny_gpt, **kw):
    return JaxEngine(tiny_gpt, num_slots=2, max_seq_len=64,
                     registry=jax_monitor.StatRegistry(), **kw)


def _export(eng, min_tokens=3, **sample):
    """Submit PROMPT, step until ``min_tokens`` are out, export it (wait
    False + stepping: no loop thread).  Returns (verdict, request)."""
    r = eng.submit(PROMPT, max_new_tokens=MAX_NEW, **sample)
    for _ in range(200):
        if len(r.generated) >= min_tokens:
            break
        eng.step()
    d = eng.migrate_out(request_id=r.id, min_tokens=min_tokens, wait=False)
    for _ in range(200):
        eng.step()
        if d.done.is_set():
            break
    return d.wait(0), r


def _import(eng, payload):
    d = eng.migrate_in(payload, wait=False)
    for _ in range(200):
        eng.step()
        if d.done.is_set():
            break
    got = d.wait(0)
    eng.run_until_idle()
    return got


@pytest.mark.parametrize("path", sorted(PATHS))
def test_greedy_wire_migration_equals_jax_generate(tiny_gpt, jax_ref,
                                                   path):
    """A greedy stream exported mid-decode, sent through the JSON wire
    form and resumed on a second port engine equals JAX ``generate``
    token for token; paged paths move blocks, the source ends at
    refcount zero."""
    cfg = PATHS[path]
    src, dst = _port(tiny_gpt, **cfg), _port(tiny_gpt, **cfg)
    verdict, r = _export(src)
    assert verdict["completed"] is False and isinstance(r.error, Migrated)
    wire = payload_to_json(verdict["payload"])
    got = _import(dst, wire)
    assert got["request"].result(timeout=1).tolist() == jax_ref
    if cfg.get("kv_block_size"):
        assert got["blocks"] >= 2
        src.run_until_idle()
        src.prefix_cache.clear()
        assert src.block_pool.in_use() == 0
    else:
        assert got["blocks"] == 0


def test_int8_kv_migration_equals_unmigrated(tiny_gpt):
    """int8 pools: the codes and their scales travel (bitwise), and the
    migrated stream equals the unmigrated int8 stream exactly, greedy and
    seeded."""
    cfg = dict(kv_block_size=8, prefill_chunk=8, kv_dtype="int8")
    for sample in ({}, dict(temperature=0.8, top_k=8, seed=99)):
        ref_eng = _port(tiny_gpt, **cfg)
        rr = ref_eng.submit(PROMPT, max_new_tokens=MAX_NEW, **sample)
        ref_eng.run_until_idle()
        src, dst = _port(tiny_gpt, **cfg), _port(tiny_gpt, **cfg)
        verdict, _ = _export(src, **sample)
        kv = verdict["payload"]["kv"]
        assert kv["dtype"] == "int8" and kv["scales"].dtype == np.float32
        got = _import(dst, payload_to_json(verdict["payload"]))
        assert got["request"].result(timeout=1).tolist() \
            == rr.result(timeout=1).tolist()


def test_fp32_into_int8_raises_dtype_mismatch(tiny_gpt):
    src = _port(tiny_gpt, kv_block_size=8)
    dst = _port(tiny_gpt, kv_block_size=8, kv_dtype="int8")
    verdict, _ = _export(src)
    with pytest.raises(KVDtypeMismatch):
        _import(dst, verdict["payload"])
    assert dst.block_pool.in_use() == 0 and dst.queue.depth() == 0


def test_host_sampling_carries_rng_state(tiny_gpt):
    """``sample_mode="host"``: the numpy generator's state rides the
    payload, so a seeded migrated stream equals the unmigrated one."""
    cfg = dict(attn_impl="xla", sample_mode="host", async_depth=1)
    sample = dict(temperature=0.9, top_p=0.9, seed=7)
    ref_eng = _port(tiny_gpt, **cfg)
    rr = ref_eng.submit(PROMPT, max_new_tokens=MAX_NEW, **sample)
    ref_eng.run_until_idle()
    src, dst = _port(tiny_gpt, **cfg), _port(tiny_gpt, **cfg)
    verdict, _ = _export(src, **sample)
    assert verdict["payload"]["request"]["rng_state"] is not None
    got = _import(dst, payload_to_json(verdict["payload"]))
    assert got["request"].result(timeout=1).tolist() \
        == rr.result(timeout=1).tolist()


@pytest.mark.parametrize("jax_attn", ["ragged", "xla"])
def test_jax_payload_resumes_on_the_port(tiny_gpt, jax_ref, jax_attn):
    """A JAX engine's export (its JSON wire form, from its own
    ``payload_to_json``) imported by the port continues the greedy
    stream token-identically; the block bytes land unchanged."""
    src = _jax(tiny_gpt, kv_block_size=8, attn_impl=jax_attn)
    verdict, _ = _export(src)
    wire = jax_kv.payload_to_json(verdict["payload"])
    dst = _port(tiny_gpt, kv_block_size=8, prefill_chunk=8)
    got = _import(dst, wire)
    assert got["blocks"] == verdict["payload"]["kv"]["n_blocks"] >= 2
    assert got["request"].result(timeout=1).tolist() == jax_ref


def test_port_payload_resumes_on_jax(tiny_gpt, jax_ref):
    """A port export (JSON wire form) imported by the JAX engine
    continues the greedy stream token-identically; the payload's keys
    and dtypes are the JAX package's."""
    src = _port(tiny_gpt, kv_block_size=8, prefill_chunk=8)
    verdict, _ = _export(src)
    payload = verdict["payload"]
    jsrc = _jax(tiny_gpt, kv_block_size=8)
    jverdict, _ = _export(jsrc)
    jp = jverdict["payload"]
    assert sorted(payload) == sorted(jp)
    assert sorted(payload["request"]) == sorted(jp["request"])
    assert sorted(payload["kv"]) == sorted(jp["kv"])
    assert payload["kv"]["dtype"] == jp["kv"]["dtype"] == "float32"
    assert payload["kv"]["data"].dtype == jp["kv"]["data"].dtype
    wire = payload_to_json(payload)
    assert sorted(wire["kv"]) == sorted(jax_kv.payload_to_json(jp)["kv"])
    dst = _jax(tiny_gpt, kv_block_size=8)
    got = _import(dst, jax_kv.payload_from_json(wire))
    assert got["request"].result(timeout=1).tolist() == jax_ref


def test_prefix_export_import_raises_hits(tiny_gpt):
    """``export_prefix`` / ``import_prefix`` warm a second engine: its
    next admission of the prompt adopts the imported blocks (prefix hits
    rise), the stream is unchanged, and the exporter's blocks return."""
    a = _port(tiny_gpt, kv_block_size=8, prefill_chunk=8)
    b = _port(tiny_gpt, kv_block_size=8, prefill_chunk=8)
    r = a.submit(PROMPT, max_new_tokens=4)
    a.run_until_idle()
    d = a.export_prefix(PROMPT, wait=False)
    a.step()
    payload = d.wait(0)
    assert payload["request"] is None and payload["tier"] == "device"
    assert len(payload["prefix"]) == 16
    d = b.import_prefix(payload_from_json(payload_to_json(payload)),
                        wait=False)
    b.step()
    assert d.wait(0) == {"blocks": 2, "tokens": 16}
    hits = b.prefix_hits
    r2 = b.submit(PROMPT, max_new_tokens=4)
    b.run_until_idle()
    assert b.prefix_hits == hits + 1 and b.prefix_hit_tokens >= 16
    assert r2.result(timeout=1).tolist() == r.result(timeout=1).tolist()
    a.prefix_cache.clear()
    assert a.block_pool.in_use() == 0


def test_live_request_ids_refresh_params_and_mesh_refusal(tiny_gpt):
    """``live_request_ids`` lists the bound requests; ``refresh_params``
    flushes the prefix trie; a mesh engine refuses migration naming
    Queue A 10."""
    eng = _port(tiny_gpt, kv_block_size=8, prefill_chunk=8)
    r = eng.submit(PROMPT, max_new_tokens=4)
    eng.step()
    assert eng.live_request_ids() == [r.id]
    eng.run_until_idle()
    assert eng.live_request_ids() == []
    assert eng.prefix_cache.cached_blocks() > 0
    eng.refresh_params()
    assert eng.prefix_cache.cached_blocks() == 0
    assert eng.block_pool.in_use() == 0
    tp = mirror.port_model(tiny_gpt).to_tensor_parallel()
    mesh_eng = mirror.port_engine(
        tp, num_slots=2, max_seq_len=64, kv_block_size=8, prefill_chunk=8,
        mesh=ServingMesh(2, 1, devices=["cpu"] * 2))
    for call in (lambda: mesh_eng.migrate_out(),
                 lambda: mesh_eng.migrate_in({"request": {}}),
                 lambda: mesh_eng.export_prefix(PROMPT),
                 lambda: mesh_eng.import_prefix({})):
        with pytest.raises(NotImplementedError, match="Queue A 10"):
            call()
