"""The host-RAM KV offload tier and block export / import in the port.

``HostBlockStore`` and ``prefix_key`` are held to the JAX package's unit
tests (tests/test_offload.py: LRU within a byte budget, oversize refusal,
dedup, dtype and geometry refusal); ``export_blocks`` / ``import_blocks``
round-trip bitwise, fp and int8, equal JAX's export of the same pools,
and a dtype or geometry mismatch adopts nothing.

Engine tier, on the port's ragged and XLA paths: serve a prompt, spill its
cached blocks to the host tier, serve it again: the admission restores
the span from host RAM (the counters show it) and the restored stream is
token-identical to an engine with ``prefix_cache=False``, greedy and
seeded, fp32 and int8 KV (int8 payloads carry codes and scales, so the
restored pool content is bitwise).  Pool pressure demotes through the
tick boundary; a preempted stream resumes from restored blocks; the
trace has the ``offload.demote`` / ``offload.promote`` spans and the
``req.host_restored`` instant.  The fault sites, ``/healthz`` and the
router wait for ROADMAP Queue A 9.

JAX is imported inside the tests that compare with it, so the ``cuda``
test runs on a card without it.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.serving import (Engine, HostBlockStore,
                                      KVDtypeMismatch, QuantKV,
                                      export_blocks, import_blocks,
                                      payload_from_json, payload_to_json,
                                      prefix_key)
from paddle_tpu_torch.serving.quant import quantize_blocks

torch.set_num_threads(1)

PROMPT = list(range(11, 39))       # 28 tokens = 3 full blocks at bs=8
MAX_NEW = 8
SEEDED = dict(temperature=0.8, top_k=8, seed=1234)
CONFIGS = {
    "monolithic": dict(),
    "chunked": dict(prefill_chunk=8, tick_token_budget=16),
    "spec": dict(prefill_chunk=8, spec_k=2),
    "depth1": dict(prefill_chunk=8, async_depth=1),
    "xla_chunked": dict(attn_impl="xla", prefill_chunk=8),
}


@pytest.fixture(scope="module")
def tiny():
    m = GPTModel.from_config("tiny", device="cpu", seed=0, dropout=0.0)
    m.eval()
    return m


def _engine(model, **kw):
    cfg = dict(num_slots=4, max_seq_len=64, kv_block_size=8)
    cfg.update(kw)
    return Engine(model, device="cpu", **cfg)


def _serve_one(eng, prompt=PROMPT, n=MAX_NEW, **kw):
    r = eng.submit(prompt, max_new_tokens=n, **kw)
    eng.run_until_idle()
    return [int(t) for t in r.result(timeout=5)]


def _spill_all(eng):
    """Every unreferenced trie block through the demote hook, then the
    downloads parked (what pool pressure does, made deterministic)."""
    freed = eng.prefix_cache.evict(10 ** 6)
    eng._flush_offload()
    return freed


# -- HostBlockStore -----------------------------------------------------------
GEOM = dict(block_size=4, num_heads=2, head_dim=4, n_layers=2)
ENTRY = (GEOM["n_layers"], 2, GEOM["block_size"], GEOM["num_heads"],
         GEOM["head_dim"])
ENTRY_BYTES = int(np.prod(ENTRY)) * 4


def _entry(seed=0, dtype=np.float32):
    return np.random.RandomState(seed).randn(*ENTRY).astype(dtype)


def _store(n_entries, **kw):
    cfg = dict(GEOM, capacity_mb=n_entries * ENTRY_BYTES / 2 ** 20)
    cfg.update(kw)
    return HostBlockStore(**cfg)


def test_prefix_key_is_the_jax_full_prefix_hash():
    """The key changes with any earlier token, and equals JAX's."""
    from paddle_tpu.serving.offload import prefix_key as jax_key
    a = prefix_key([1, 2, 3, 4, 5, 6, 7, 8])
    assert a == prefix_key(np.asarray([1, 2, 3, 4, 5, 6, 7, 8]))
    assert a == prefix_key([1, 2, 3, 4, 5, 6, 7, 8, 99], n_tokens=8)
    assert a != prefix_key([9, 2, 3, 4, 5, 6, 7, 8])
    assert a != prefix_key([1, 2, 3, 4])
    for toks, n in (([1, 2, 3, 4, 5, 6, 7, 8], None), (PROMPT, 16)):
        assert prefix_key(toks, n) == jax_key(toks, n)


def test_store_lru_within_budget_and_byte_accounting():
    st = _store(3)
    for i in range(3):
        assert st.put(f"k{i}", _entry(i)) is True
    assert len(st) == 3 and st.bytes_used == 3 * ENTRY_BYTES
    assert st.get("k0") is not None
    assert st.put("k3", _entry(3)) is True
    assert "k1" not in st and st.evictions == 1
    assert sorted(st.keys()) == ["k0", "k2", "k3"]
    for _ in range(5):  # presence probes do not refresh recency
        assert "k2" in st
    assert st.put("k4", _entry(4)) is True
    assert "k2" not in st and "k0" in st


def test_store_oversize_refusal_and_clear():
    st = _store(1)
    st.capacity_bytes = ENTRY_BYTES - 1
    assert st.put("big", _entry()) is False
    assert st.refusals == 1 and len(st) == 0 and st.bytes_used == 0
    st.capacity_bytes = ENTRY_BYTES
    assert st.put("ok", _entry()) is True
    assert st.clear() == 1 and st.bytes_used == 0


def test_store_content_address_dedup():
    st = _store(4)
    e = _entry(0)
    assert st.put("k", e) is True
    assert st.put("k", _entry(1)) is True
    assert st.dedup_puts == 1 and len(st) == 1
    assert st.bytes_used == ENTRY_BYTES
    got, scales = st.get("k")
    np.testing.assert_array_equal(got, e)
    assert scales is None


def test_store_dtype_and_geometry_refusal():
    st = _store(4)
    sc = np.ones((GEOM["n_layers"], 2, GEOM["num_heads"]), np.float32)
    with pytest.raises(KVDtypeMismatch):
        st.put("k", _entry(), scales=sc)
    qst = _store(4, dtype="int8")
    with pytest.raises(KVDtypeMismatch):
        qst.put("k", _entry(dtype=np.int8))
    with pytest.raises(ValueError):
        st.put("k", _entry()[:, :1])
    with pytest.raises(ValueError):
        qst.put("k", _entry(dtype=np.int8), scales=sc[:, :, :1])
    for s in (st, qst):
        assert len(s) == 0 and s.bytes_used == 0
    assert qst.put("k", _entry(dtype=np.int8), scales=sc) is True
    assert qst.bytes_used == ENTRY_BYTES // 4 + sc.nbytes


def test_store_get_miss_discard_and_stats():
    st = _store(2)
    assert st.get("absent") is None and st.misses == 1
    st.put("k", _entry())
    assert st.stats()["blocks"] == 1 and st.stats()["hits"] == 0
    assert st.discard("k") is True and st.discard("k") is False
    assert st.bytes_used == 0


# -- export_blocks / import_blocks -------------------------------------------
def _pools(seed, quant, n_layers=2, NB=6, bs=4, H=2, hd=4):
    rng = np.random.RandomState(seed)
    k, v = [], []
    for _ in range(n_layers):
        for dst in (k, v):
            rows = torch.from_numpy(
                rng.randn(NB, bs, H, hd).astype(np.float32))
            if quant:
                codes, scale = quantize_blocks(rows)
                dst.append(QuantKV(codes, scale))
            else:
                dst.append(rows)
    return k, v


def _jax_pools(pools):
    import jax.numpy as jnp
    from paddle_tpu.serving.quant import QuantKV as JaxQuantKV
    return [JaxQuantKV(jnp.asarray(p.codes.numpy()),
                       jnp.asarray(p.scale.numpy()))
            if isinstance(p, QuantKV) else jnp.asarray(p.numpy())
            for p in pools]


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_export_import_roundtrip_bitwise_and_as_jax(quant):
    """Export blocks (3, 1, 4) of one pool set, import them into blocks
    (5, 2, 0) of another: those rows, and their scales, become bitwise
    the source's; no other row moves; the export equals JAX's
    ``export_blocks`` of the same pools."""
    from paddle_tpu.serving.kvcache import export_blocks as jax_export
    src_k, src_v = _pools(0, quant)
    dst_k, dst_v = _pools(1, quant)
    before = [(p.codes.clone(), p.scale.clone()) if quant else p.clone()
              for p in dst_k + dst_v]
    out = export_blocks(src_k, src_v, [3, 1, 4])
    want = jax_export(_jax_pools(src_k), _jax_pools(src_v), [3, 1, 4])
    if quant:
        data, scales = out
        np.testing.assert_array_equal(data, np.asarray(want[0]))
        np.testing.assert_array_equal(scales, np.asarray(want[1]))
        assert data.dtype == np.int8 and scales.shape == (2, 2, 3, 2)
    else:
        data, scales = out, None
        np.testing.assert_array_equal(data, np.asarray(want))
        assert data.shape == (2, 2, 3, 4, 2, 4)
    ret = import_blocks(dst_k, dst_v, [5, 2, 0], data, scales)
    assert ret[0] is dst_k and ret[1] is dst_v
    again = export_blocks(dst_k, dst_v, [5, 2, 0])
    if quant:
        np.testing.assert_array_equal(again[0], data)
        np.testing.assert_array_equal(again[1], scales)
    else:
        np.testing.assert_array_equal(again, data)
    for p, b in zip(dst_k + dst_v, before):
        for blk in (1, 3, 4):
            if quant:
                assert torch.equal(p.codes[blk], b[0][blk])
                assert torch.equal(p.scale[blk], b[1][blk])
            else:
                assert torch.equal(p[blk], b[blk])


def test_import_mismatch_adopts_nothing():
    """A dtype mismatch raises ``KVDtypeMismatch`` and a geometry or scale
    mismatch ``ValueError``, each before any row is written."""
    fk, fv = _pools(0, False)
    qk, qv = _pools(0, True)
    fdata = export_blocks(fk, fv, [1, 2])
    qdata, qscales = export_blocks(qk, qv, [1, 2])
    snap = [p.clone() for p in fk + fv] + [
        t.clone() for p in qk + qv for t in (p.codes, p.scale)]
    with pytest.raises(KVDtypeMismatch):
        import_blocks(fk, fv, [3, 4], qdata, qscales)
    with pytest.raises(KVDtypeMismatch):
        import_blocks(qk, qv, [3, 4], fdata)
    with pytest.raises(ValueError, match="shape"):
        import_blocks(fk, fv, [3, 4], fdata[:, :, :, :2])
    with pytest.raises(ValueError, match="shape"):
        import_blocks(fk, fv, [3], fdata)
    with pytest.raises(ValueError, match="scale shape"):
        import_blocks(qk, qv, [3, 4], qdata, qscales[:, :, :, :1])
    now = [p for p in fk + fv] + [t for p in qk + qv
                                  for t in (p.codes, p.scale)]
    for a, b in zip(now, snap):
        assert torch.equal(a, b)


def test_payload_json_roundtrip():
    """The wire encoding inverts exactly, scales included, and decodes
    JAX's encoding of the same payload."""
    from paddle_tpu.serving.kvcache import payload_to_json as jax_to_json
    qk, qv = _pools(2, True)
    data, scales = export_blocks(qk, qv, [0, 5])
    payload = {"prompt": [1, 2], "kv": {"data": data, "scales": scales,
                                        "block_size": 4}}
    wire = payload_to_json(payload)
    assert wire == jax_to_json(payload)
    back = payload_from_json(wire)
    np.testing.assert_array_equal(back["kv"]["data"], data)
    np.testing.assert_array_equal(back["kv"]["scales"], scales)
    assert back["prompt"] == [1, 2] and back["kv"]["block_size"] == 4


# -- Engine(kv_host_mb=...) -----------------------------------------------
def test_kv_host_mb_construction_contract(tiny):
    with pytest.raises(ValueError, match="paged"):
        Engine(tiny, device="cpu", num_slots=2, max_seq_len=64,
               attn_impl="xla", kv_host_mb=64)
    with pytest.raises(ValueError, match="prefix_cache"):
        _engine(tiny, kv_host_mb=64, prefix_cache=False)
    with pytest.raises(ValueError, match="kv_host_mb"):
        _engine(tiny, kv_host_mb=0)
    assert _engine(tiny, kv_host_mb=64).host_store.dtype == "float32"
    assert _engine(tiny, kv_host_mb=64,
                   kv_dtype="int8").host_store.dtype == "int8"
    assert _engine(tiny).host_store is None


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("seed", [None, 1234], ids=["greedy", "seeded"])
def test_restore_parity_matrix(tiny, name, kv, seed):
    """Serve, spill the cached blocks to the host tier, serve again: the
    admission restores the three full blocks from host RAM and the stream
    equals an engine's with ``prefix_cache=False``; a third serve is a
    pure device prefix hit."""
    cfg = dict(CONFIGS[name])
    if kv == "int8":
        cfg["kv_dtype"] = "int8"
    kw = {} if seed is None else dict(SEEDED, seed=seed)
    oracle = _serve_one(_engine(tiny, prefix_cache=False, **cfg), **kw)
    eng = _engine(tiny, kv_host_mb=64, **cfg)
    assert _serve_one(eng, **kw) == oracle
    spilled = _spill_all(eng)
    assert spilled and len(eng.host_store) == len(PROMPT) // 8
    assert eng._m_offload_demotes.value == len(eng.host_store)
    assert _serve_one(eng, **kw) == oracle, (name, kv, seed)
    n = int(eng._m_offload_promotes.value)
    assert n == len(PROMPT) // 8
    assert eng._m_offload_hit_tokens.value == n * 8
    assert _serve_one(eng, **kw) == oracle
    assert int(eng._m_offload_promotes.value) == n


def test_evict_then_readmit_hit_accounting(tiny):
    """Demotes == store entries; bytes == entries x entry bytes; promote
    hits land in ``prefix_hit_tokens`` and ``offload_hit_tokens``; a
    re-spill of restored content dedups; the gauges track the store."""
    eng = _engine(tiny, kv_host_mb=64)
    _serve_one(eng)
    _spill_all(eng)
    st = eng.host_store
    n_ent = len(st)
    assert n_ent == len(PROMPT) // 8
    entry_bytes = st.bytes_used // n_ent
    assert entry_bytes == 2 * 2 * 8 * 4 * 16 * 4   # layers K/V bs H hd f32
    hit0 = eng.prefix_hit_tokens
    _serve_one(eng)
    assert int(eng._m_offload_promotes.value) == n_ent == st.hits
    assert eng.prefix_hit_tokens - hit0 >= n_ent * 8
    _spill_all(eng)
    assert len(st) == n_ent and st.bytes_used == n_ent * entry_bytes
    assert eng._m_offload_demotes.value == n_ent
    assert eng._m_kv_host_blocks.value == n_ent
    assert eng._m_kv_host_bytes.value == st.bytes_used
    reg = eng.registry
    assert reg.get("serving.offload_promotes").value == n_ent


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_natural_pressure_demotes_through_tick_boundary(tiny, kv):
    """A deliberately small pool: admission's own eviction feeds the
    demote hook, the tick boundary parks the downloads, and the first
    prompt served again restores from host RAM to the same stream."""
    extra = {"kv_dtype": "int8"} if kv == "int8" else {}
    eng = _engine(tiny, num_slots=1, kv_blocks=8, kv_host_mb=64,
                  prefill_chunk=8, **extra)
    prompts = [PROMPT, [t + 40 for t in PROMPT], [t + 80 for t in PROMPT]]
    outs = [_serve_one(eng, p) for p in prompts]
    assert eng._m_offload_demotes.value >= 1
    promo0 = eng._m_offload_promotes.value
    assert _serve_one(eng, prompts[0]) == outs[0]
    assert eng._m_offload_promotes.value > promo0
    oracle = _engine(tiny, prefix_cache=False, **extra)
    assert outs[0] == _serve_one(oracle, prompts[0])


def test_preempt_then_restore_parity(tiny):
    """A preempted stream whose parked blocks were spilled resumes from
    the restored blocks, token-identical to an uninterrupted run."""
    kw = dict(num_slots=1, prefill_chunk=8)
    oracle = _serve_one(_engine(tiny, **kw), n=12)
    eng = _engine(tiny, kv_host_mb=64, **kw)
    r1 = eng.submit(PROMPT, max_new_tokens=12, priority=0)
    for _ in range(200):
        eng.step()
        if len(r1.generated) >= 2:
            break
    hi = eng.submit([t + 60 for t in PROMPT], max_new_tokens=4, priority=5)
    for _ in range(200):
        eng.step()
        if hi.done():
            break
    assert r1.preemptions == 1
    assert len(_spill_all(eng)) >= 1
    assert len(eng.host_store) >= len(PROMPT) // 8
    eng.run_until_idle()
    assert [int(t) for t in r1.result(timeout=5)] == oracle
    assert eng._m_offload_promotes.value >= len(PROMPT) // 8


def test_offload_spans_in_trace(tiny):
    """The demote and promote spans and the restore instant are in the
    trace, with their counts."""
    eng = _engine(tiny, kv_host_mb=64, prefill_chunk=8)
    _serve_one(eng)
    _spill_all(eng)
    _serve_one(eng)
    events = eng.chrome_trace()["traceEvents"]
    demote = [e for e in events if e.get("name") == "offload.demote"]
    promote = [e for e in events if e.get("name") == "offload.promote"]
    restored = [e for e in events if e.get("name") == "req.host_restored"]
    assert len(demote) == 3 and all(e["args"]["stored"] for e in demote)
    assert len(promote) == 1 and promote[0]["args"]["blocks"] == 3
    assert len(restored) == 1 and restored[0]["args"]["tokens"] == 24


def test_adapter_lanes_never_promote(tiny):
    """An adapter request neither restores from the host tier nor adopts
    device blocks: its admission prefills the whole prompt."""
    from paddle_tpu_torch.serving import LoRAAdapter
    ad = LoRAAdapter.random(4, 64, n_layers=2, seed=3, scale=0.5)
    eng = _engine(tiny, kv_host_mb=64, adapters={"ad": ad}, prefill_chunk=8)
    _serve_one(eng)
    _spill_all(eng)
    pre = eng.prefill_tokens
    _serve_one(eng, adapter="ad")
    assert eng._m_offload_promotes.value == 0
    assert eng.prefill_tokens - pre == len(PROMPT)


def test_mesh_host_tier_names_its_roadmap_item(tiny):
    """The host tier over a ``(1, 2)`` mesh (this test's name is the
    refusal's it replaced): serve, spill, serve again restores the three
    full blocks into the owning dp shard, and the stream equals the
    unsharded engine's; tests/test_torch_mesh_serving_features.py holds
    ``(2, 2)`` to the JAX engine."""
    from paddle_tpu_torch.distributed import ServingMesh
    eng = Engine(tiny, mesh=ServingMesh(1, 2, devices=["cpu"] * 2),
                 num_slots=2, max_seq_len=64, kv_block_size=8,
                 prefill_chunk=8, kv_host_mb=64)
    first = _serve_one(eng)
    _spill_all(eng)
    assert eng._m_offload_demotes.value == 3
    assert _serve_one(eng) == first
    assert eng._m_offload_promotes.value == 3
    assert first == _serve_one(_engine(tiny, prefill_chunk=8))


# -- on the card ----------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_offload_restore_on_card(kv):
    """Serve, spill, serve again on the card: the restore is counted, the
    download went through pinned memory behind an event, and the
    restored stream equals the CPU engine's on the same state (greedy;
    int8 except from a divergence at a top-2 margin under 1e-3 of the
    CPU engine's own first stream)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ragged kernel runs only there")
    cpu = GPTModel.from_config("tiny", device="cpu", seed=0, dropout=0.0)
    card = GPTModel.from_config("tiny", device="cuda", dropout=0.0)
    card.load_state_dict(cpu.state_dict())
    extra = {"kv_dtype": "int8"} if kv == "int8" else {}
    eng = Engine(card, num_slots=4, max_seq_len=64, kv_block_size=8,
                 prefill_chunk=8, kv_host_mb=64, **extra)
    first = _serve_one(eng)
    _spill_all(eng)
    assert eng._m_offload_demotes.value == 3
    restored = _serve_one(eng)
    assert eng._m_offload_promotes.value == 3
    assert restored == first
    want = _serve_one(_engine(cpu, prefill_chunk=8, **extra))
    if first != want:
        t = next(i for i, (x, y) in enumerate(zip(first, want)) if x != y)
        with torch.no_grad():
            row = cpu(torch.tensor([want[:t]]))[0, -1]
        top2 = row.topk(2).values
        assert float(top2[0] - top2[1]) < (1e-3 if kv == "int8" else 1e-4)
