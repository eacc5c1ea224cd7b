"""Weight-only int8, the host-RAM tier, KV migration, prefix warming and
the SIGTERM drain over the port's serving mesh, held to the JAX package.

The JAX side runs on the 8 virtual CPU devices tests/conftest.py forces;
the port maps every rank onto the CPU.  Weights are the JAX ``tiny``
model's, bridged.

* ``weight_dtype="int8"`` on ``(1, 2)`` (the int8 codes replicated over
  dp): greedy streams token-identical to the JAX engine's ``mesh=(1, 2),
  weight_dtype="int8"`` on the ragged and XLA paths, seeded equal to the
  port's unsharded int8-weight engine.
* The host tier on ``(2, 2)``: a served prompt's blocks demoted (each
  rank's head slice joined into the global host layout) and restored
  (split back by heads), fp32 and int8 pools: the demote and restore
  counts and the greedy streams equal the JAX engine's ``mesh=(2, 2),
  kv_host_mb=64``; the restored stream equals the no-cache one.
* Migration payloads in every direction — port mesh to JAX and JAX to
  port mesh, mesh to unsharded and unsharded to mesh, ``(2, 1)`` to ``(1,
  2)`` — through the JSON wire form: the resumed greedy stream equals JAX
  ``generate``, int8 pools' the unmigrated int8 stream; a mesh payload
  carries the JAX keys and the global ``[n, bs, H, hd]`` layout; prefix
  payloads warm across the same directions.
* The SIGTERM drain of a ``(2, 2)`` mesh ``EngineServer`` onto an
  unsharded peer: every live ``/generate`` stream completes on the peer,
  token-identical, with zero lost tokens.
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import monitor
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import kvcache as jax_kv
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import ServingMesh, get_mesh, set_mesh
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.serving import (Engine, EngineServer,
                                      payload_from_json, payload_to_json)

torch.set_num_threads(1)

PROMPT = list(range(11, 31))
MAX_NEW = 12
BASE = dict(num_slots=4, max_seq_len=64, kv_block_size=8)


@pytest.fixture(autouse=True)
def _mesh_guard():
    from paddle_tpu.distributed import mesh as jax_mesh
    prev, prev_port = jax_mesh.get_mesh(), get_mesh()
    yield
    jax_mesh.set_mesh(prev)
    set_mesh(prev_port)


def _jax_model():
    paddle.seed(0)
    m = JaxGPT.from_config("tiny", dropout=0.0)
    m.eval()
    return m


@pytest.fixture(scope="module")
def models():
    """(JAX dense, JAX tensor-parallel, port dense, port tensor-parallel)
    on the same weights, and JAX ``generate``'s greedy stream of
    PROMPT."""
    jm = _jax_model()
    tm = _port_model(jm)
    ref = jm.generate(paddle.to_tensor(np.asarray([PROMPT], np.int32)),
                      max_new_tokens=MAX_NEW, compiled="fused").numpy()[0]
    return jm, jm.to_tensor_parallel(), tm, tm.to_tensor_parallel(), \
        [int(t) for t in ref]


def _port_model(jm):
    tm = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    load_paddle_tpu_state(
        tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    return tm.eval()


def _mesh(mp, dp):
    return ServingMesh(mp, dp, devices=["cpu"] * (mp * dp))


def _port(models, mesh=None, **kw):
    """A port engine over ``mesh`` ((mp, dp) or None: one device)."""
    _, _, tm, tp, _ = models
    cfg = dict(BASE, prefill_chunk=8, **kw)
    if mesh is None:
        return Engine(tm, device="cpu", **cfg)
    return Engine(tp if mesh[0] > 1 else tm, mesh=_mesh(*mesh), **cfg)


def _jax(models, mesh=None, **kw):
    jm, jtp, _, _, _ = models
    model = jtp if mesh is not None and mesh[0] > 1 else jm
    return JaxEngine(model, mesh=mesh, registry=monitor.StatRegistry(),
                     **dict(BASE, **kw))


def _serve(eng, prompts, **sample):
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW, **sample)
            for p in prompts]
    eng.run_until_idle()
    return [[int(t) for t in r.result(timeout=5)] for r in reqs]


def _prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(0, 128, n).astype(np.int32) for n in (5, 19, 9, 28)]


# -- weight-only int8 over (1, 2) -----------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=8),
    dict(attn_impl="xla"),
    dict(attn_impl="xla", kv_block_size=None),
], ids=["ragged", "xla_paged", "xla_contiguous"])
def test_int8_weights_over_dp2_match_jax(kw):
    """Each engine relayouts its own fresh model in place; the port's
    ``(1, 2)`` mesh serves the dense int8 blocks replicated once per
    device."""
    jkw = {k: v for k, v in kw.items() if k != "attn_impl"}
    jkw["attn_impl"] = kw.get("attn_impl", "ragged")
    cfg = dict(BASE, weight_dtype="int8")
    cfg.update(jkw)
    prompts = _prompts()
    want = _serve(JaxEngine(_jax_model(), mesh=(1, 2),
                            registry=monitor.StatRegistry(), **cfg),
                  prompts)
    eng = Engine(_port_model(_jax_model()), mesh=_mesh(1, 2), **cfg)
    assert _serve(eng, prompts) == want
    assert eng._runner.dense is not None
    seeded = dict(temperature=0.8, top_k=8, seed=5)
    base = _serve(Engine(_port_model(_jax_model()), device="cpu", **cfg),
                  prompts, **seeded)
    assert _serve(Engine(_port_model(_jax_model()), mesh=_mesh(1, 2), **cfg),
                  prompts, **seeded) == base


# -- the host-RAM tier over (2, 2) -------------------------------------------
def _spill(eng):
    eng.prefix_cache.evict(10 ** 6)
    eng._flush_offload()


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_host_tier_over_2x2_matches_jax(models, kv_dtype):
    """Serve, spill every cached block to host RAM, serve again: the
    second admission restores the blocks on every rank.  Demotes,
    restores and both streams equal the JAX ``mesh=(2, 2)`` engine's; a
    host block holds the global head layout; the restored stream equals
    a no-cache engine's."""
    prompt = np.asarray(list(range(40, 68)), np.int32)      # 28 tokens
    kw = dict(kv_host_mb=64) | ({"kv_dtype": kv_dtype} if kv_dtype else {})
    jeng = _jax(models, mesh=(2, 2), attn_impl="ragged", prefill_chunk=8,
                **kw)
    eng = _port(models, (2, 2), **kw)
    got, want = [], []
    for e, out in ((jeng, want), (eng, got)):
        out.append(_serve(e, [prompt]))
        _spill(e)
        out.append(_serve(e, [prompt]))
    assert got == want
    for name in ("serving.offload_demotes", "serving.offload_promotes",
                 "serving.offload_hit_tokens"):
        assert eng.registry.get(name).value \
            == jeng.registry.get(name).value > 0, name
    data, _ = next(iter(eng.host_store._entries.values()))
    assert data.shape == (2, 2, 8, 4, 16)   # layers, K/V, bs, H, hd
    plain = _port(models, (2, 2), prefix_cache=False,
                  **({"kv_dtype": kv_dtype} if kv_dtype else {}))
    assert got[1] == _serve(plain, [prompt])


# -- migration and prefix warming ---------------------------------------------
def _export(eng, min_tokens=4):
    r = eng.submit(PROMPT, max_new_tokens=MAX_NEW)
    d = eng.migrate_out(request_id=r.id, min_tokens=min_tokens, wait=False)
    for _ in range(400):
        if d.done.is_set():
            break
        eng.step()
    return d.wait(0)["payload"]


def _import(eng, payload):
    d = eng.migrate_in(payload, wait=False)
    for _ in range(400):
        if d.done.is_set():
            break
        eng.step()
    got = d.wait(0)
    eng.run_until_idle()
    return got


DIRECTIONS = {
    "mesh_to_jax": ((2, 2), "jax"),
    "jax_to_mesh": ("jax", (2, 2)),
    "mesh_to_unsharded": ((2, 2), None),
    "unsharded_to_mesh": (None, (2, 2)),
    "mp2_to_dp2": ((2, 1), (1, 2)),
}


def _engine(models, where, **kw):
    if where == "jax":
        return _jax(models, attn_impl="ragged", **kw)
    return _port(models, where, **kw)


def _to_wire(payload, src):
    if src == "jax":
        return jax_kv.payload_to_json(payload)
    return payload_to_json(payload)


def _from_wire(wire, dst):
    return jax_kv.payload_from_json(wire) if dst == "jax" else wire


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_migration_payloads_cross_every_direction(models, direction):
    """A greedy stream exported after 4 tokens and resumed elsewhere
    equals JAX ``generate``; the blocks travel (three full blocks of the
    global layout); a mesh payload carries exactly the JAX payload's
    keys; the source ends with its blocks back in its trie or free."""
    src_at, dst_at = DIRECTIONS[direction]
    src, dst = _engine(models, src_at), _engine(models, dst_at)
    payload = _export(src)
    kv = payload["kv"]
    assert kv["n_blocks"] == 3
    assert np.asarray(kv["data"]).shape == (2, 2, 3, 8, 4, 16)
    if src_at != "jax":
        jp = _export(_engine(models, "jax"))
        assert sorted(payload) == sorted(jp)
        assert sorted(payload["request"]) == sorted(jp["request"])
        assert sorted(kv) == sorted(jp["kv"])
        np.testing.assert_allclose(kv["data"], jp["kv"]["data"], atol=1e-5)
    got = _import(dst, _from_wire(_to_wire(payload, src_at), dst_at))
    assert got["blocks"] == 3
    assert [int(t) for t in got["request"].result(timeout=5)] \
        == models[4]
    if src_at != "jax":
        src.run_until_idle()
        src.prefix_cache.clear()
        assert src.block_pool.in_use() == 0


@pytest.mark.parametrize("pair", ["mesh_to_unsharded", "unsharded_to_mesh"])
def test_int8_migration_over_the_mesh_equals_unmigrated(models, pair):
    """int8 pools: each rank's codes and scales join into the payload
    (scales ``[layers, 2, n, H]``) and split back; the migrated stream
    equals the unmigrated int8 stream exactly."""
    src_at, dst_at = DIRECTIONS[pair]
    want = _serve(_port(models, None, kv_dtype="int8"), [PROMPT])[0]
    src = _port(models, src_at, kv_dtype="int8")
    dst = _port(models, dst_at, kv_dtype="int8")
    payload = _export(src)
    assert np.asarray(payload["kv"]["scales"]).shape == (2, 2, 3, 4)
    got = _import(dst, payload_from_json(payload_to_json(payload)))
    assert [int(t) for t in got["request"].result(timeout=5)] == want


@pytest.mark.parametrize("direction", ["mesh_to_jax", "jax_to_mesh",
                                       "unsharded_to_mesh"])
def test_prefix_warming_over_the_mesh(models, direction):
    """``export_prefix`` from one side warms the other: its next admission
    of the prompt adopts the imported blocks, and the stream is the JAX
    ``generate`` one."""
    src_at, dst_at = DIRECTIONS[direction]
    src, dst = _engine(models, src_at), _engine(models, dst_at)
    _serve(src, [PROMPT])
    d = src.export_prefix(PROMPT, wait=False)
    src.step()
    payload = d.wait(0)
    assert payload["kv"]["n_blocks"] == 2
    d = dst.import_prefix(_from_wire(_to_wire(payload, src_at), dst_at),
                          wait=False)
    dst.step()
    assert d.wait(0) == {"blocks": 2, "tokens": 16}
    assert _serve(dst, [PROMPT])[0] == models[4]
    hits = (dst.prefix_hits if dst_at != "jax"
            else dst.registry.get("serving.prefix_hits").value)
    assert hits == 1


# -- the SIGTERM drain ----------------------------------------------------------
def _post(url, obj, timeout=120.0):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_drain_of_a_mesh_server_loses_no_tokens(models):
    """Three concurrent ``/generate`` streams decode on a ``(2, 2)`` mesh
    ``EngineServer`` when it drains to an unsharded peer: every waiter
    gets its complete stream, equal to an undrained engine's, and nothing
    falls back."""
    prompts = [[(17 * k + i) % 97 + 1 for i in range(16)] for k in range(3)]
    refs = _serve(_port(models), prompts)
    src, dst = _port(models, (2, 2)), _port(models)
    with EngineServer(dst) as b, \
            EngineServer(src, peers=[b.address], drain_grace_s=30.0) as a:
        results = [None] * len(prompts)

        def client(k):
            results[k] = _post(a.address + "/generate",
                               {"prompt": prompts[k],
                                "max_new_tokens": MAX_NEW})

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(len(prompts))]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if len(src.live_request_ids()) == len(prompts):
                break
            time.sleep(0.01)
        acct = a.drain_to_peers()
        for t in threads:
            t.join(timeout=120.0)
    assert acct["fallback"] == 0 and acct["lost_tokens"] == 0
    assert [r[0] for r in results] == [200] * len(prompts)
    assert [r[1]["ids"] for r in results] == refs
