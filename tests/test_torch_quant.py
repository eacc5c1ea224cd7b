"""Quantized serving in the PyTorch port, held to the JAX package.

The quantizer (``_quantize_arr``, ``quantize_blocks``,
``dequantize_blocks``), the touched-block ``paged_insert`` and the
weight-only int8 relayout give codes and scales bitwise equal to the JAX
functions on the same f32 inputs (numpy seeds); weight-only forwards
agree at rtol 1e-5 (the two frameworks' f32 matmuls sum in another
order).  ``paged_insert`` is compared on every block but the scratch
block: where several lanes write one (block, row), which only masked
lanes parked on the scratch block do, the JAX fold sums them and the
port keeps one.

At ``tiny``, the port's engine serves the same bridged weights as the
JAX engine with ``kv_dtype="int8"``, ``weight_dtype="int8"``, both, and
``attn_impl="ragged_gather"`` over fp and int8 pools: greedy streams
token-identical, seeded streams repeating on a second engine.  The
``kv_budget_mb`` block count equals the JAX engine's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import monitor
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import quant as jq
from paddle_tpu_torch.convert import (export_paddle_tpu_state,
                                      load_paddle_tpu_state)
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.quantization import (WeightOnlyInt8Linear,
                                           _quantize_arr)
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving import quant as tq

torch.set_num_threads(1)

MAX_NEW = 8
ENGINE_KW = dict(num_slots=4, max_seq_len=48, kv_block_size=8,
                 prefill_chunk=8)


def _jnp(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def _np(t):
    return t.detach().cpu().numpy()


def _pool(seed, n=6, bs=8, H=2, hd=4):
    v = np.random.RandomState(seed).randn(n, bs, H, hd).astype(np.float32)
    q, s = jq.quantize_blocks(_jnp(v))
    return np.asarray(q), np.asarray(s)


# -- the quantizer ----------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 8, 4, 8), (5, 16, 16, 64)])
def test_quantize_blocks_bitwise_and_requant_exact(shape):
    """Codes and scales bitwise equal to JAX's; the dequantized blocks
    equal JAX's and re-quantize exactly (the round trip of
    tests/test_quant_serving.py)."""
    v = (np.random.RandomState(0).randn(*shape) * 3).astype(np.float32)
    v[0, :, 0] = 0.0       # an all-zero head: the 1e-8 amax clamp
    jc, js = jq.quantize_blocks(_jnp(v))
    tc, ts = tq.quantize_blocks(torch.tensor(v))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    jd = np.asarray(jq.dequantize_blocks(jc, js))
    td = tq.dequantize_blocks(tc, ts)
    np.testing.assert_array_equal(_np(td), jd)
    tc2, ts2 = tq.quantize_blocks(td)
    assert torch.equal(tc2, tc) and torch.equal(ts2, ts)


def test_quantize_arr_matches_jax_bitwise():
    """``_quantize_arr`` at a scalar and at per-axis scales, including
    values at .5 code steps (round half to even in both)."""
    from paddle_tpu.quantization.int8 import _quantize_arr as jax_qa
    rng = np.random.RandomState(3)
    x = rng.randn(16, 24).astype(np.float32)
    x[0, :5] = np.asarray([0.5, 1.5, 2.5, -0.5, -2.5]) / 127.0
    s_all = np.float32(1.0)
    s_ax = np.abs(x).max(axis=0).astype(np.float32)
    np.testing.assert_array_equal(
        _np(_quantize_arr(torch.tensor(x), torch.tensor(s_all))),
        np.asarray(jax_qa(_jnp(x), _jnp(s_all))))
    np.testing.assert_array_equal(
        _np(_quantize_arr(torch.tensor(x), torch.tensor(s_ax), axis=1)),
        np.asarray(jax_qa(_jnp(x), _jnp(s_ax), axis=1)))


# -- paged_insert / paged_gather ---------------------------------------------
def _insert_both(codes, scale, blk, off, rows):
    jout = jq.paged_insert(jq.QuantKV(_jnp(codes), _jnp(scale)),
                           _jnp(np.asarray(blk, np.int32)),
                           _jnp(np.asarray(off, np.int32)), _jnp(rows))
    pool = tq.QuantKV(torch.tensor(codes), torch.tensor(scale))
    tout = tq.paged_insert(pool, torch.tensor(blk, dtype=torch.int32),
                           torch.tensor(off, dtype=torch.int32),
                           torch.tensor(rows))
    assert tout is pool      # in place
    return (np.asarray(jout.codes), np.asarray(jout.scale),
            _np(tout.codes), _np(tout.scale))


def test_paged_insert_matches_jax_off_scratch():
    """A ragged window's lanes: a chunk spanning two blocks, a decode
    lane, a lane into a block with a grown amax, and masked lanes parked
    on the scratch block 0 (row 0).  Every block but the scratch block
    matches JAX code for code and scale for scale; untouched blocks keep
    theirs."""
    codes, scale = _pool(1)
    rng = np.random.RandomState(2)
    blk = [2, 2, 2, 3, 3, 0, 0, 0, 4, 0, 5]
    off = [5, 6, 7, 0, 1, 0, 0, 0, 3, 0, 2]
    rows = rng.randn(len(blk), 2, 4).astype(np.float32)
    rows[-1] *= 10.0          # block 5's amax grows
    jc, js, tc, ts = _insert_both(codes, scale, blk, off, rows)
    np.testing.assert_array_equal(tc[1:], jc[1:])
    np.testing.assert_array_equal(ts[1:], js[1:])
    np.testing.assert_array_equal(tc[1], codes[1])     # untouched
    np.testing.assert_array_equal(ts[1], scale[1])
    # the scratch block took one of its writers' rows, as finite codes
    assert np.all(np.isfinite(ts[0]))


def test_paged_insert_duplicate_block_lanes():
    """Lanes sharing one physical block (a window spanning a block) all
    land, as in tests/test_quant_serving.py, bitwise equal to JAX."""
    codes, scale = _pool(1, n=4)
    rows = np.random.RandomState(2).randn(3, 2, 4).astype(np.float32)
    jc, js, tc, ts = _insert_both(codes, scale, [2, 2, 2], [1, 5, 6],
                                  rows)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)
    deq = _np(tq.dequantize_blocks(torch.tensor(tc), torch.tensor(ts)))
    for o, row in zip((1, 5, 6), rows):
        np.testing.assert_allclose(deq[2, o], row, atol=0.05)


def test_paged_gather_matches_jax():
    codes, scale = _pool(4)
    tables = np.asarray([[1, 3, 0], [5, 5, 2]], np.int32)
    want = np.asarray(jq.paged_gather(jq.QuantKV(_jnp(codes), _jnp(scale)),
                                      _jnp(tables)))
    got = tq.paged_gather(tq.QuantKV(torch.tensor(codes),
                                     torch.tensor(scale)),
                          torch.tensor(tables))
    np.testing.assert_array_equal(_np(got), want)


# -- weight-only int8 ---------------------------------------------------------
def test_weight_only_linear_matches_jax():
    """Codes (transposed: torch is [out, in]), scales and the forward at
    rtol 1e-5; ``.weight`` is the dequantized matrix."""
    from paddle_tpu import nn as jnn
    from paddle_tpu.quantization.weight_only import (
        WeightOnlyInt8Linear as JaxW8)
    rng = np.random.RandomState(5)
    w = rng.randn(24, 40).astype(np.float32)          # [in, out]
    b = rng.randn(40).astype(np.float32)
    x = rng.randn(3, 24).astype(np.float32)
    jl = jnn.Linear(24, 40)
    jl.weight._data = _jnp(w)
    jl.bias._data = _jnp(b)
    jw = JaxW8(jl)
    tl = torch.nn.Linear(24, 40)
    with torch.no_grad():
        tl.weight.copy_(torch.tensor(w.T))
        tl.bias.copy_(torch.tensor(b))
    tw = WeightOnlyInt8Linear(tl)
    np.testing.assert_array_equal(_np(tw.weight_int8).T,
                                  np.asarray(jw.weight_int8._data))
    np.testing.assert_array_equal(_np(tw.weight_scale),
                                  np.asarray(jw.weight_scale._data))
    assert tw.compute_dtype == torch.float32
    np.testing.assert_array_equal(_np(tw.weight).T,
                                  np.asarray(jw.weight._data))
    want = np.asarray(jw(paddle.to_tensor(x))._data)
    got = _np(tw(torch.tensor(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _jax_model():
    paddle.seed(0)
    jm = JaxGPT.from_config("tiny", dropout=0.0)
    jm.eval()
    return jm


def _bridged(jm):
    tm = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    load_paddle_tpu_state(
        tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    tm.eval()
    return tm


def _jax_state(jm):
    state = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    state.update({n: np.asarray(b._data) for n, b in jm.named_buffers()})
    return state


def test_relayout_matches_jax_and_bridges_codes():
    """``relayout_weights_int8`` on the same weights gives the JAX codes
    and scales layer for layer; a relayouted JAX state loads into a
    relayouted port model and exports back unchanged; the dense forward
    through the int8 layers agrees at rtol 1e-5."""
    jm = _jax_model()
    tm = _bridged(jm)
    n_j = jq.relayout_weights_int8(jm)
    n_t = tq.relayout_weights_int8(tm)
    assert n_j == n_t == 8
    jstate = _jax_state(jm)
    tstate = export_paddle_tpu_state(tm)
    assert sorted(tstate) == sorted(jstate)
    for name, arr in jstate.items():
        if name.endswith(("weight_int8", "weight_scale")):
            np.testing.assert_array_equal(tstate[name], arr, err_msg=name)
    fresh = _bridged(_jax_model())
    tq.relayout_weights_int8(fresh)
    with torch.no_grad():
        for m in fresh.modules():
            if isinstance(m, WeightOnlyInt8Linear):
                m.weight_int8.zero_()
    load_paddle_tpu_state(fresh, jstate)
    for name, arr in export_paddle_tpu_state(fresh).items():
        np.testing.assert_array_equal(arr, tstate[name], err_msg=name)
    ids = np.random.RandomState(0).randint(0, 128, (2, 12)).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    got = _np(tm(torch.tensor(ids.astype(np.int64))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bridge_refuses_codes_into_a_dense_model():
    jm = _jax_model()
    jq.relayout_weights_int8(jm)
    tm = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    with pytest.raises(ValueError, match="weight_int8"):
        load_paddle_tpu_state(tm, _jax_state(jm))


def test_relayout_validation_names_the_layer():
    """A bad layer is named before anything is swapped; a relayouted
    model has no Linear left to code."""
    tm = _bridged(_jax_model())
    tm.blocks[1].mlp.fc2.weight = torch.nn.Parameter(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match=r"blocks\[1\]\.mlp\.fc2"):
        tq.relayout_weights_int8(tm)
    assert not any(isinstance(m, WeightOnlyInt8Linear)
                   for m in tm.modules())
    tm2 = _bridged(_jax_model())
    tq.relayout_weights_int8(tm2)
    with pytest.raises(ValueError, match="no Linear layers"):
        tq.relayout_weights_int8(tm2)


# -- engines against the JAX engine ----------------------------------------
CONFIGS = {
    "kv_int8": dict(kv_dtype="int8"),
    "weight_int8": dict(weight_dtype="int8"),
    "both_int8": dict(kv_dtype="int8", weight_dtype="int8"),
    "gather_fp": dict(attn_impl="ragged_gather"),
    "gather_int8": dict(attn_impl="ragged_gather", kv_dtype="int8"),
}


def _prompts(n, lens=(5, 21, 3, 17, 7, 12)):
    rng = np.random.RandomState(7)
    return [rng.randint(0, 128, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


def _serve(eng, prompts, seeded=False):
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW,
                       **(dict(temperature=0.8, top_k=20, seed=500 + i)
                          if seeded and i % 2 else {}))
            for i, p in enumerate(prompts)]
    eng.run_until_idle()
    return [r.result(timeout=5).tolist() for r in reqs]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_matches_jax_engine(name):
    """Six prompts on four slots (chunks of 8 beside decode lanes): the
    port's greedy streams equal the JAX engine's on the same bridged
    weights, token for token; with int8 pools they are QuantKV; seeded
    streams repeat on a second port engine."""
    kw = dict(CONFIGS[name])
    attn = kw.pop("attn_impl", "ragged")
    prompts = _prompts(6)
    jm = _jax_model()
    tm = _bridged(jm)
    want = _serve(JaxEngine(jm, attn_impl=attn,
                            registry=monitor.StatRegistry(), **ENGINE_KW,
                            **kw), prompts)
    eng = Engine(tm, device="cpu", attn_impl=attn, **ENGINE_KW, **kw)
    got = _serve(eng, prompts)
    assert got == want
    assert isinstance(eng.k_pools[0], tq.QuantKV) == ("kv_dtype" in kw)
    assert any(isinstance(m, WeightOnlyInt8Linear)
               for m in tm.modules()) == ("weight_dtype" in kw)
    # the model is relayouted already: the second engine serves it as is
    kw.pop("weight_dtype", None)
    a = _serve(Engine(tm, device="cpu", attn_impl=attn, **ENGINE_KW, **kw),
               prompts, seeded=True)
    b = _serve(Engine(tm, device="cpu", attn_impl=attn, **ENGINE_KW, **kw),
               prompts, seeded=True)
    assert a == b
    assert [a[i] for i in (0, 2, 4)] == [got[i] for i in (0, 2, 4)]


def test_stale_codes_in_recycled_blocks_do_not_leak():
    """Every pool starts full of garbage codes and scales, as recycled
    blocks would be: the admission zeroes the fresh blocks' scale rows
    before their first write, so the streams equal a clean engine's."""
    tm = _bridged(_jax_model())
    prompts = _prompts(6)
    clean = _serve(Engine(tm, device="cpu", kv_dtype="int8", **ENGINE_KW),
                   prompts)
    eng = Engine(tm, device="cpu", kv_dtype="int8", **ENGINE_KW)
    for p in eng.k_pools + eng.v_pools:
        p.codes.fill_(127)
        p.scale.fill_(3.0)
    assert _serve(eng, prompts) == clean


def test_shared_prefix_blocks_never_change():
    """Prefix sharing under int8 pools: the cached prompt blocks' codes
    and scales stay the same while later requests adopt and extend
    them, and the later streams equal an engine's without the cache."""
    tm = _bridged(_jax_model())
    system = np.random.RandomState(11).randint(0, 128, 17).astype(np.int32)
    tails = _prompts(3, lens=(3, 9, 6))
    prompts = [np.concatenate([system, t]) for t in tails]
    eng = Engine(tm, device="cpu", kv_dtype="int8", **ENGINE_KW)
    first = _serve(eng, prompts[:1])
    shared = eng.prefix_cache.match(prompts[0])[0]
    eng.block_pool.decref(shared)
    assert len(shared) == 2
    idx = torch.tensor(shared)
    before = [(p.codes[idx].clone(), p.scale[idx].clone())
              for p in eng.k_pools + eng.v_pools]
    rest = _serve(eng, prompts[1:])
    assert eng.prefix_hits == 2
    for (c, s), p in zip(before, eng.k_pools + eng.v_pools):
        assert torch.equal(p.codes[idx], c) and torch.equal(p.scale[idx], s)
    plain = Engine(tm, device="cpu", kv_dtype="int8", prefix_cache=False,
                   **ENGINE_KW)
    assert _serve(plain, prompts[:1]) + _serve(plain, prompts[1:]) \
        == first + rest


def test_step_failure_rebuilds_quantized_pools(monkeypatch):
    tm = _bridged(_jax_model())
    prompts = _prompts(2)
    eng = Engine(tm, device="cpu", kv_dtype="int8", **ENGINE_KW)
    want = _serve(Engine(tm, device="cpu", kv_dtype="int8", **ENGINE_KW),
                  prompts)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]

    def boom(*a, **k):
        raise RuntimeError("injected dispatch failure")

    monkeypatch.setattr(tm, "_fused_ragged_tick_slots", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    monkeypatch.undo()
    for r in reqs:
        with pytest.raises(RuntimeError, match="engine step failed"):
            r.result(timeout=1)
    assert isinstance(eng.k_pools[0], tq.QuantKV)
    assert all(int(p.codes.abs().sum()) == 0
               for p in eng.k_pools + eng.v_pools)
    assert _serve(eng, prompts) == want


# -- capacity and construction ------------------------------------------------
def test_kv_budget_capacity_ratio_matches_jax():
    """The same ``kv_budget_mb`` holds >= 1.9x the blocks with int8
    pools at ``tiny`` (as ``test_kv_budget_capacity_ratio``), and each
    block count equals the JAX engine's; the code and scale bytes add up
    to the block's footprint."""
    from paddle_tpu.serving.kvcache import per_shard_block_bytes
    counts = {}
    for kv in (None, "int8"):
        jeng = JaxEngine(_jax_model(), kv_dtype=kv, kv_budget_mb=0.5,
                         registry=monitor.StatRegistry(), num_slots=4,
                         max_seq_len=64, kv_block_size=8)
        teng = Engine(_bridged(_jax_model()), device="cpu", kv_dtype=kv,
                      kv_budget_mb=0.5, num_slots=4, max_seq_len=64,
                      kv_block_size=8, prefill_chunk=8)
        assert teng._kv_managed == jeng._kv_managed
        assert teng.block_pool.num_blocks == teng._kv_managed + 1
        assert teng.kv_block_bytes + teng.kv_scale_bytes \
            == jeng._kv_block_bytes_per_shard
        assert teng.kv_block_bytes == jeng._kv_code_bytes_per_shard
        counts[kv] = teng._kv_managed
    assert counts["int8"] >= 1.9 * counts[None]
    assert per_shard_block_bytes(8, 4, 16, "int8", 2,
                                 scale_dtype="float32") \
        == teng.kv_block_bytes + teng.kv_scale_bytes


@pytest.mark.parametrize("kw, match", [
    (dict(kv_dtype="fp16"), "kv_dtype must be 'int8'"),
    (dict(weight_dtype="fp16"), "weight_dtype must be"),
    (dict(kv_budget_mb=1.0, kv_blocks=40), "kv_budget_mb and kv_blocks"),
    (dict(kv_budget_mb=0.01), "cannot hold even one max-length"),
    (dict(kv_dtype="int8", kv_block_size=None), "paged KV layout"),
])
def test_construction_errors_name_the_cause(kw, match):
    tm = _bridged(_jax_model())
    cfg = dict(ENGINE_KW, **kw)
    with pytest.raises(ValueError, match=match):
        Engine(tm, device="cpu", **cfg)
    assert not any(isinstance(m, WeightOnlyInt8Linear)
                   for m in tm.modules())
