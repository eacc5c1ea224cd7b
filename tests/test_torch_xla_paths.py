"""The port's XLA and monolithic paths held to the JAX package.

The JAX engine's default configuration (``attn_impl="xla"``, contiguous
slot rows, whole-prompt prefill) and its neighbours: the plain paged
windows, bucketed prefill, the XLA chunk loop, host sampling, and the
ragged decode after a monolithic paged prefill.  A JAX ``tiny`` GPT made
from a seed is bridged into the port (``load_paddle_tpu_state``).

- Each attention window (``decode``, ``decode_slots``, ``verify_slots``,
  the three paged windows over fp and ``QuantKV`` pools,
  ``forward(cache=)``) is held to the JAX method on the same numpy
  inputs: outputs and pools at atol / rtol 1e-5, int8 codes exactly and
  scales within 1e-6.
- The fused decode and verify ticks, contiguous and paged, are held to
  JAX's: logits allclose; picks, accept and emit counts, done mask and
  cursors equal.
- The engine serves nine configurations token-identically to the JAX
  engine of the same configuration; a divergence is tolerated only where
  JAX's top-2 margin is below 1e-5 (tests/test_torch_serving.py).
  Host-mode seeded streams are token-identical to the JAX host-mode
  engine's (both draw with numpy), a divergence tolerated only where the
  draw from JAX's logits row and from the port's differ at that step.
- Depth 1 equals depth 2, preemption resumes unchanged, a failed step
  recovers, and the validation errors are JAX's.  Over a ``(1, 2)`` mesh
  the XLA and monolithic paths serve the unsharded engine's streams.
- ``GPTModel(attn_impl=...)`` validates as JAX's does, and
  ``Engine(attn_impl=None)`` takes the model's; only the model's default
  differs (``"ragged"``, JAX's ``"xla"``).

JAX is imported inside the fixtures, so the ``cuda`` test runs on a card
without it.
"""
import copy

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import ServingMesh
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving.quant import QuantKV, quantize_blocks

torch.set_num_threads(1)

MAX_NEW = 6
BASE = dict(num_slots=4, max_seq_len=48)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    import paddle_tpu as paddle
    from paddle_tpu.models import GPTModel as JaxGPT
    paddle.seed(0)
    jm = JaxGPT.from_config("tiny", dropout=0.0)
    jm.eval()
    tm = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    load_paddle_tpu_state(
        tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    tm.eval()
    return jm, tm


def _prompts(n, lens=(5, 21, 3, 17, 7, 12)):
    rng = np.random.RandomState(7)
    return [rng.randint(0, 128, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


def _jax_engine(jm, **kw):
    from paddle_tpu import monitor
    from paddle_tpu.serving import Engine as JaxEngine
    return JaxEngine(jm, registry=monitor.StatRegistry(), **BASE, **kw)


def _port_engine(tm, **kw):
    kw.setdefault("attn_impl", "xla")
    return Engine(tm, device="cpu", **BASE, **kw)


def _run(eng, prompts, seeded=(), max_new=MAX_NEW, **sample):
    """Submit every prompt (prompt i of ``seeded`` samples with seed
    300 + i), drive the engine idle; the generated streams."""
    sample = sample or dict(temperature=0.8, top_p=0.9, top_k=20)
    reqs = [eng.submit(p, max_new_tokens=max_new,
                       **(dict(sample, seed=300 + i) if i in seeded
                          else {}))
            for i, p in enumerate(prompts)]
    eng.run_until_idle()
    return [r.result(timeout=1)[len(p):].tolist()
            for r, p in zip(reqs, prompts)]


def _jax_row(jm, ids):
    import paddle_tpu as paddle
    return np.asarray(jm(paddle.to_tensor(
        np.asarray(ids, np.int32)[None])).numpy())[0, -1]


def _assert_greedy_equal(jm, prompts, got, want):
    """Token-identical, or from a first divergence at a JAX near tie."""
    for p, a, b in zip(prompts, got, want):
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        top2 = np.sort(_jax_row(jm, list(p) + b[:t]))[-2:]
        assert top2[1] - top2[0] < 1e-5, (
            f"prompt len {len(p)}: token {t} is {a[t]}, the JAX engine "
            f"gives {b[t]} (JAX top-2 margin {top2[1] - top2[0]})")


# -- attention windows ----------------------------------------------------
def _jt(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def _jpool(pool):
    from paddle_tpu.serving import quant as jq
    if isinstance(pool, QuantKV):
        return jq.QuantKV(_jt(pool.codes.numpy()), _jt(pool.scale.numpy()))
    return _jt(pool.numpy())


def _assert_pool(tp, jp, skip_blocks=()):
    """A port pool against the JAX one: fp allclose; int8 codes equal,
    scales within 1e-6 (``skip_blocks``: blocks two lanes wrote at one
    row, where JAX sums the lanes and the port keeps one)."""
    keep = [b for b in range(tp.shape[0]) if b not in skip_blocks]
    if isinstance(tp, QuantKV):
        np.testing.assert_array_equal(tp.codes.numpy()[keep],
                                      np.asarray(jp.codes)[keep])
        np.testing.assert_allclose(tp.scale.numpy()[keep],
                                   np.asarray(jp.scale)[keep], atol=1e-6,
                                   rtol=0)
    else:
        np.testing.assert_allclose(tp.numpy()[keep], np.asarray(jp)[keep],
                                   **TOL)


def _attn_inputs(seed, B, S, L=16, H=4, hd=16, E=64):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, E).astype(np.float32)
    k = rng.randn(B, L, H, hd).astype(np.float32)
    v = rng.randn(B, L, H, hd).astype(np.float32)
    return x, k, v


def _block_pools(seed, NB=9, bs=4, H=4, hd=16, quant=False):
    rng = np.random.RandomState(seed)
    pools = [torch.tensor(rng.randn(NB, bs, H, hd).astype(np.float32))
             for _ in range(2)]
    if quant:
        pools = [QuantKV(*quantize_blocks(p)) for p in pools]
    return pools


def _copy_pool(p):
    if isinstance(p, QuantKV):
        return QuantKV(p.codes.clone(), p.scale.clone())
    return p.clone()


def _call_both(models, method, x, k, v, *args, **kw):
    """One attention window on block 0 of both packages: returns ((JAX
    out, k, v), (port out, k, v))."""
    from paddle_tpu.core import autograd
    from paddle_tpu.core.tensor import Tensor
    jm, tm = models
    jargs = [_jt(a.numpy()) if isinstance(a, torch.Tensor) else a
             for a in args]
    with autograd.no_grad():
        jo, jk, jv = getattr(jm.blocks[0].attn, method)(
            Tensor(_jt(x)), _jpool(k), _jpool(v), *jargs, **kw)
    with torch.no_grad():
        to, tk, tv = getattr(tm.blocks[0].attn, method)(
            torch.tensor(x), _copy_pool(k), _copy_pool(v), *args, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo._data), **TOL)
    return (jk, jv), (tk, tv)


@pytest.mark.parametrize("pos", [3, 14], ids=["inside", "clamped"])
def test_decode_shared_position_matches_jax(models, pos):
    """The contiguous chunk prefill's window: one shared position (a
    window reaching past L starts at L - S, as dynamic_update_slice
    clamps it)."""
    x, k, v = _attn_inputs(0, 2, 4)
    (jk, jv), (tk, tv) = _call_both(models, "decode", x, torch.tensor(k),
                                    torch.tensor(v), pos)
    _assert_pool(tk, jk)
    _assert_pool(tv, jv)


@pytest.mark.parametrize("method,S,pos", [
    ("decode_slots", 1, [0, 7, 15]),
    ("decode_slots", 1, [2, 16, 40]),           # past L: dropped
    ("verify_slots", 3, [0, 6, 13]),
    ("verify_slots", 4, [1, 14, 16]),           # lanes past L dropped
], ids=["decode", "decode-oob", "verify", "verify-oob"])
def test_contiguous_windows_match_jax(models, method, S, pos):
    x, k, v = _attn_inputs(1, 3, S)
    pos = torch.tensor(pos, dtype=torch.int32)
    (jk, jv), (tk, tv) = _call_both(models, method, x, torch.tensor(k),
                                    torch.tensor(v), pos)
    _assert_pool(tk, jk)
    _assert_pool(tv, jv)


def _tables():
    """Three slots' tables over a 9-block pool of 4-row blocks (L = 16):
    slot 0 blocks 1-4, slot 1 blocks 5-8, slot 2 parked on block 0."""
    return torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]],
                        dtype=torch.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("method,S", [("decode_slots_paged", 1),
                                      ("verify_slots_paged", 3)],
                         ids=["decode", "verify"])
def test_paged_windows_match_jax(models, method, S, quant):
    x, _, _ = _attn_inputs(2, 3, S)
    k, v = _block_pools(3, quant=quant)
    pos = torch.tensor([5, 12, 0], dtype=torch.int32)
    (jk, jv), (tk, tv) = _call_both(models, method, x, k, v, _tables(),
                                    pos)
    _assert_pool(tk, jk)
    _assert_pool(tv, jv)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("pos,true_len", [(4, 4), (8, 2)],
                         ids=["full", "partial"])
def test_prefill_chunk_paged_matches_jax(models, pos, true_len, quant):
    """One slot's chunk through its table; a partial final chunk's pad
    lanes write row 0 of the slot's scratch block (two of them here:
    JAX sums their rows and the port keeps one, so that block is not
    compared)."""
    x, _, _ = _attn_inputs(4, 1, 4)
    k, v = _block_pools(5, quant=quant)
    table = torch.tensor([2, 6, 3, 7], dtype=torch.int32)
    (jk, jv), (tk, tv) = _call_both(models, "prefill_chunk_paged", x, k,
                                    v, table, pos, true_len, scratch=0)
    skip = (0,) if true_len < 3 else ()
    _assert_pool(tk, jk, skip)
    _assert_pool(tv, jv, skip)


@pytest.mark.parametrize("P", [0, 5], ids=["empty-cache", "cache"])
def test_forward_with_cache_matches_jax(models, P):
    """``forward(cache=)``: the window's K/V appended to the cache, the
    queries attending under the bottom-right causal diagonal."""
    from paddle_tpu.core import autograd
    from paddle_tpu.core.tensor import Tensor
    jm, tm = models
    x, k, v = _attn_inputs(6, 2, 4, L=P)
    with autograd.no_grad():
        jo, (jk, jv) = jm.blocks[1].attn(
            Tensor(_jt(x)), cache=(Tensor(_jt(k)), Tensor(_jt(v))))
    with torch.no_grad():
        to, (tk, tv) = tm.blocks[1].attn(
            torch.tensor(x), cache=(torch.tensor(k), torch.tensor(v)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo._data), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk._data), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv._data), **TOL)


def test_model_forward_with_caches_matches_jax(models):
    """``GPTModel.forward(caches=, position_offset=)``: logits and every
    layer's grown cache."""
    import paddle_tpu as paddle
    from paddle_tpu.core import autograd
    from paddle_tpu.core.tensor import Tensor
    jm, tm = models
    rng = np.random.RandomState(8)
    ids = rng.randint(0, 128, (1, 6)).astype(np.int32)
    caches = [(rng.randn(1, 4, 4, 16).astype(np.float32),
               rng.randn(1, 4, 4, 16).astype(np.float32)) for _ in range(2)]
    with autograd.no_grad():
        jl, jc = jm(paddle.to_tensor(ids), position_offset=4,
                    caches=[(Tensor(_jt(a)), Tensor(_jt(b)))
                            for a, b in caches])
    with torch.no_grad():
        tl, tc = tm(torch.tensor(ids.astype(np.int64)), position_offset=4,
                    caches=[(torch.tensor(a), torch.tensor(b))
                            for a, b in caches])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._data), **TOL)
    for (a, b), (c, d) in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(c._data), **TOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(d._data), **TOL)


# -- the model's ticks ----------------------------------------------------
def _tick_state(seed, B=3, L=16, W=1):
    """Greedy lanes: slot 0 live, slot 1 live with eos on the way, slot 2
    frozen (rem 0)."""
    rng = np.random.RandomState(seed)
    return dict(
        toks=rng.randint(0, 128, (B, W)).astype(np.int32),
        pos=np.array([3, 9, 0], np.int32),
        temp=np.zeros(B, np.float32), top_k=np.zeros(B, np.int32),
        top_p=np.ones(B, np.float32),
        seed_lo=np.zeros(B, np.uint32), seed_hi=np.zeros(B, np.uint32),
        ctr=np.array([2, 5, 0], np.int32), eos=np.array([-1, 7, -1],
                                                        np.int32),
        rem=np.array([4, 1, 0], np.int32))


def _pools_both(paged, seed):
    """(port pools, JAX pools) per layer: contiguous [3, 16, 4, 16] rows
    or 9-block pools."""
    rng = np.random.RandomState(seed)
    shape = (9, 4, 4, 16) if paged else (3, 16, 4, 16)
    arrs = [rng.randn(*shape).astype(np.float32) for _ in range(4)]
    return ([torch.tensor(a) for a in arrs[:2]],
            [torch.tensor(a) for a in arrs[2:]],
            [_jt(a) for a in arrs[:2]], [_jt(a) for a in arrs[2:]])


def _t(a):
    return torch.tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("paged", [False, True],
                         ids=["contiguous", "paged"])
def test_fused_decode_tick_matches_jax(models, paged):
    from paddle_tpu.core import autograd
    jm, tm = models
    st = _tick_state(10)
    tk, tv, jk, jv = _pools_both(paged, 11)
    tables = _tables() if paged else None
    jtab = _jt(tables.numpy()) if paged else None
    args = [st[n] for n in ("pos", "temp", "top_k", "top_p", "seed_lo",
                            "seed_hi", "ctr", "eos", "rem")]
    with autograd.no_grad():
        jlast = (jm._decode_tick_slots_paged(_jt(st["toks"]), jk, jv, jtab,
                                             _jt(st["pos"]))[0] if paged
                 else jm._decode_tick_slots(_jt(st["toks"]), jk, jv,
                                            _jt(st["pos"]))[0])
        tk2, tv2, jk2, jv2 = _pools_both(paged, 11)
        jout = jm._fused_decode_tick_slots(
            _jt(st["toks"]), jk2, jv2, *map(_jt, args), block_tables=jtab)
    with torch.no_grad():
        tlast = (tm._decode_tick_slots_paged(_t(st["toks"]), tk, tv, tables,
                                             _t(st["pos"]))[0] if paged
                 else tm._decode_tick_slots(_t(st["toks"]), tk, tv,
                                            _t(st["pos"]))[0])
        tout = tm._fused_decode_tick_slots(
            _t(st["toks"]), tk2, tv2, *map(_t, args), block_tables=tables)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    ids, done, new_tok, new_pos, new_ctr, new_rem = tout[:6]
    jids, jdone, jtok, jpos, jctr, jrem = [np.asarray(a) for a in jout[:6]]
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(
        done.numpy(), np.unpackbits(jdone, count=3).astype(bool))
    for a, b in ((new_tok, jtok), (new_pos, jpos), (new_ctr, jctr),
                 (new_rem, jrem)):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(tout[6] + tout[7], list(jout[6]) + list(jout[7])):
        _assert_pool(a, b)


@pytest.mark.parametrize("paged", [False, True],
                         ids=["contiguous", "paged"])
def test_fused_spec_verify_tick_matches_jax(models, paged):
    """A 4-lane verify window: slot 0 drafts JAX's own greedy picks
    (every lane accepted), slot 1 drafts one right then a wrong token,
    slot 2 is frozen."""
    from paddle_tpu.core import autograd
    jm, tm = models
    W = 4
    st = _tick_state(12, W=W)
    st["rem"] = np.array([9, 5, 0], np.int32)
    st["eos"] = np.full(3, -1, np.int32)
    tables = _tables() if paged else None
    jtab = _jt(tables.numpy()) if paged else None

    def jax_logits(toks):
        _, _, jk, jv = _pools_both(paged, 13)
        with autograd.no_grad():
            if paged:
                return np.asarray(jm._spec_verify_tick_slots_paged(
                    _jt(toks), jk, jv, jtab, _jt(st["pos"]))[0])
            return np.asarray(jm._spec_verify_tick_slots(
                _jt(toks), jk, jv, _jt(st["pos"]))[0])

    toks = st["toks"].copy()
    for j in range(1, W):  # drafts = the picks of the lanes before them
        toks[0, j] = jax_logits(toks)[0, j - 1].argmax()
    toks[1, 1] = jax_logits(toks)[1, 0].argmax()
    toks[1, 2] = (toks[1, 1] + 1) % 128
    lanes = np.array([3, 3, 0], np.int32)
    jlog = jax_logits(toks)
    tk, tv, jk, jv = _pools_both(paged, 13)
    args = [st[n] for n in ("pos",)] + [lanes] + [
        st[n] for n in ("temp", "top_k", "top_p", "seed_lo", "seed_hi",
                        "ctr", "eos", "rem")]
    with autograd.no_grad():
        jout = jm._fused_spec_verify_tick_slots(
            _jt(toks), jk, jv, *map(_jt, args), block_tables=jtab)
    tk0, tv0, _, _ = _pools_both(paged, 13)
    with torch.no_grad():
        tlog = (tm._spec_verify_tick_slots_paged(_t(toks), tk0, tv0, tables,
                                                 _t(st["pos"]))[0] if paged
                else tm._spec_verify_tick_slots(_t(toks), tk0, tv0,
                                                _t(st["pos"]))[0])
        tout = tm._fused_spec_verify_tick_slots(
            _t(toks), tk, tv, *map(_t, args), block_tables=tables)
    np.testing.assert_allclose(tlog.numpy(), jlog, **TOL)
    picks, n_acc, n_emit, done = tout[:4]
    jp, jacc, jemit, jdone = [np.asarray(a) for a in jout[:4]]
    np.testing.assert_array_equal(picks.numpy(), jp)
    assert n_acc.tolist() == jacc.tolist() and n_acc.tolist()[:2] == [3, 1]
    assert n_emit.tolist() == jemit.tolist()
    np.testing.assert_array_equal(
        done.numpy(), np.unpackbits(jdone, count=3).astype(bool))
    for a, b in zip(tout[4:8], jout[4:8]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_prefill_writes_the_whole_slot_row(models):
    """Whole-prompt prefill zeroes the slot row past the prompt, as JAX
    writes its padded row: an earlier request's non-finite rows must not
    reach ``_slot_attn``'s value contraction (0 x NaN)."""
    _, tm = models
    eng = _port_engine(tm)
    for kp in eng.k_pools + eng.v_pools:
        kp[1].fill_(float("nan"))
    prompt = _prompts(1)[0]
    reqs = [eng.submit(prompt, max_new_tokens=3) for _ in range(2)]
    eng.run_until_idle()
    assert reqs[0].generated == reqs[1].generated
    assert all(bool(torch.isfinite(kp).all())
               for kp in eng.k_pools + eng.v_pools)


# -- the engine matrix ----------------------------------------------------
MATRIX = [
    ({}, {}),                                           # contiguous
    ({"kv_block_size": 8}, {}),                         # paged
    ({"prefill_chunk": 8, "tick_token_budget": 16}, {}),
    ({"kv_block_size": 8, "prefill_chunk": 8, "tick_token_budget": 16},
     {}),
    ({"spec_k": 2}, {}),
    ({"kv_block_size": 8, "spec_k": 2}, {}),
    ({"prefill_buckets": "pow2"}, {}),
    # the ragged kernel's plain version after a monolithic paged prefill,
    # held to JAX's XLA paged engine (the two are greedy-identical there)
    ({"kv_block_size": 8}, {"attn_impl": "ragged"}),
    ({"kv_block_size": 8, "kv_dtype": "int8"}, {}),
]
MATRIX_IDS = ["contiguous", "paged", "contiguous-chunked", "paged-chunked",
              "spec", "paged-spec", "pow2", "ragged-monolithic",
              "int8-paged"]


@pytest.mark.parametrize("cfg,port", MATRIX, ids=MATRIX_IDS)
def test_engine_matches_jax_engine(models, cfg, port):
    jm, tm = models
    prompts = _prompts(6)
    want = _run(_jax_engine(jm, **cfg), prompts)
    eng = _port_engine(tm, **cfg, **port)
    got = _run(eng, prompts)
    _assert_greedy_equal(jm, prompts, got, want)
    assert eng.tokens_generated == 6 * MAX_NEW
    assert (eng.ragged_dispatches > 0) == (eng.attn_impl == "ragged")
    chunks = eng.registry.get("serving.prefill_chunks").value
    names = {e["name"] for e in eng.chrome_trace()["traceEvents"]}
    assert (chunks > 0) == ("prefill_chunk" in cfg)
    assert ("prefill.chunk" in names) == ("prefill_chunk" in cfg)
    assert ("prefill" in names) == ("prefill_chunk" not in cfg)


def test_default_engine_serves_like_jax_default(models):
    """``Engine(tm, attn_impl="xla")`` with no layout or chunk knob is
    the JAX engine's ``Engine(jm)``; its metrics and spans carry JAX's
    names."""
    jm, tm = models
    prompts = _prompts(5)
    from paddle_tpu import monitor
    from paddle_tpu.serving import Engine as JaxEngine
    want = _run(JaxEngine(jm, registry=monitor.StatRegistry()), prompts)
    eng = Engine(tm, attn_impl="xla", device="cpu")
    got = _run(eng, prompts)
    _assert_greedy_equal(jm, prompts, got, want)
    names = {e["name"] for e in eng.chrome_trace()["traceEvents"]}
    assert {"prefill", "decode.dispatch", "decode.d2h_wait",
            "decode.emit"} <= names
    reg = eng.registry
    assert reg.get("serving.fused_sample_ticks").value > 0
    assert reg.get("serving.d2h_bytes_per_tick").value == eng.num_slots * 16
    assert eng.block_pool is None and eng.kv_block_bytes == 0


def _filter_cases():
    rng = np.random.RandomState(21)
    return [(rng.randn(257).astype(np.float32) * 3, t, k, p)
            for t, k, p in ((1.0, 0, 1.0), (0.7, 20, 1.0), (1.3, 0, 0.9),
                            (0.8, 5, 0.5), (1.0, 300, 0.95))]


def test_filter_logits_np_is_bitwise_jax():
    from paddle_tpu.serving import engine as jax_engine_mod
    for row, t, k, p in _filter_cases():
        np.testing.assert_array_equal(
            engine_mod._filter_logits_np(row, t, k, p),
            jax_engine_mod._filter_logits_np(row, t, k, p))
        np.testing.assert_array_equal(
            engine_mod._softmax_np(row.astype(np.float64)),
            jax_engine_mod._softmax_np(row.astype(np.float64)))


def _host_draw_differs(jm, tm, prompt, prefix, kw, seed):
    """At the token after ``prompt + prefix``: replay the request's numpy
    stream over the JAX engine's path, then draw once from JAX's logits
    row and once from the port's; True when the two draws differ."""
    from paddle_tpu.serving import engine as jax_engine_mod
    rng = np.random.default_rng(seed)
    f = jax_engine_mod._filter_logits_np
    for t in range(len(prefix)):
        row = f(_jax_row(jm, list(prompt) + prefix[:t]), **kw)
        rng.choice(len(row), p=jax_engine_mod._softmax_np(row))
    ids = list(prompt) + prefix
    with torch.no_grad():
        trow = tm(torch.tensor([ids]))[0, -1].numpy()
    draws = []
    for row in (_jax_row(jm, ids), trow):
        r = copy.deepcopy(rng)
        filt = f(row, **kw)
        draws.append(r.choice(len(filt), p=jax_engine_mod._softmax_np(filt)))
    return draws[0] != draws[1]


@pytest.mark.parametrize("cfg", [{}, {"kv_block_size": 8, "spec_k": 2}],
                         ids=["contiguous", "paged-spec"])
def test_host_sampling_matches_jax_host_mode(models, cfg):
    """``sample_mode="host"``: greedy and seeded streams token-identical
    to the JAX host-mode engine's (numpy draws on both sides); the
    logits come home every tick."""
    jm, tm = models
    prompts = _prompts(4)
    seeded = (1, 2)
    want = _run(_jax_engine(jm, sample_mode="host", **cfg), prompts, seeded)
    eng = _port_engine(tm, sample_mode="host", **cfg)
    got = _run(eng, prompts, seeded)
    kw = dict(temperature=0.8, top_k=20, top_p=0.9)
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        if a == b:
            continue
        t = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        if i in seeded:
            assert _host_draw_differs(jm, tm, p, b[:t], kw, 300 + i), (
                f"seeded host stream {i} diverges at token {t} though "
                "both rows draw the same token")
        else:
            _assert_greedy_equal(jm, [p], [a], [b])
    reg = eng.registry
    assert reg.get("serving.sample_ms").count > 0
    assert reg.get("serving.fused_sample_ticks").value == 0
    W = (cfg.get("spec_k") or 0) + 1
    assert reg.get("serving.d2h_bytes_per_tick").value == 4 * W * 4 * 128
    names = {e["name"] for e in eng.chrome_trace()["traceEvents"]}
    assert {"prefill", "decode.dispatch", "decode.d2h",
            "decode.sample"} <= names


@pytest.mark.parametrize("cfg", [
    {}, {"kv_block_size": 8}, {"prefill_chunk": 8},
    {"kv_block_size": 8, "prefill_chunk": 8}, {"spec_k": 2},
    {"kv_block_size": 8, "attn_impl": "ragged"}],
    ids=["contiguous", "paged", "contiguous-chunked", "paged-chunked",
         "spec", "ragged-monolithic"])
def test_depth1_equals_depth2(models, cfg):
    """Greedy and seeded streams are equal across pipeline depths on
    every layout (the XLA chunk loop dirties the state every chunk: the
    ring drains before each upload)."""
    _, tm = models
    prompts = _prompts(6)
    got = {}
    for depth in (1, 2):
        eng = _port_engine(tm, async_depth=depth, **cfg)
        half = _prompts(3)
        reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in half]
        eng.step()
        eng.step()
        reqs += [eng.submit(p, max_new_tokens=MAX_NEW, temperature=0.9,
                            seed=40 + i) for i, p in enumerate(prompts[3:])]
        eng.run_until_idle()
        got[depth] = [r.result(timeout=1).tolist() for r in reqs]
    assert got[1] == got[2]


@pytest.mark.parametrize("cfg", [{}, {"kv_block_size": 8},
                                 {"prefill_chunk": 8}],
                         ids=["contiguous", "paged", "contiguous-chunked"])
def test_preempt_resume_greedy_unchanged(models, cfg):
    """A priority-5 arrival preempts a running priority-0 stream on one
    slot; both streams equal the JAX engine's uninterrupted ones
    (contiguous resume re-prefills the whole context)."""
    jm, tm = models
    p_low, p_high = _prompts(2)
    want = _run(_jax_engine(jm, **cfg), [p_low, p_high], max_new=12)
    eng = Engine(tm, device="cpu", attn_impl="xla", num_slots=1,
                 max_seq_len=48, **cfg)
    low = eng.submit(p_low, max_new_tokens=12, priority=0)
    for _ in range(5):
        eng.step()
    high = eng.submit(p_high, max_new_tokens=12, priority=5)
    eng.run_until_idle()
    got = [low.result(timeout=1)[len(p_low):].tolist(),
           high.result(timeout=1)[len(p_high):].tolist()]
    _assert_greedy_equal(jm, [p_low, p_high], got, want)
    assert low.preemptions >= 1
    assert eng.registry.get("serving.resumed_total").value >= 1


@pytest.mark.parametrize("cfg", [{}, {"kv_block_size": 8}],
                         ids=["contiguous", "paged"])
def test_preempt_host_seeded_stream_unchanged(models, cfg):
    """Host sampling keeps the request's numpy stream across a
    preemption: the resumed draws continue it."""
    _, tm = models
    p_low, p_high = _prompts(2)

    def run(interrupt):
        eng = Engine(tm, device="cpu", attn_impl="xla", num_slots=1,
                     max_seq_len=48, sample_mode="host", **cfg)
        r = eng.submit(p_low, max_new_tokens=10, temperature=0.9, top_p=0.9,
                       seed=123)
        if interrupt:
            for _ in range(4):
                eng.step()
            eng.submit(p_high, max_new_tokens=3, priority=9)
        eng.run_until_idle()
        return r.result(timeout=1).tolist(), r.preemptions

    (plain, n0), (cut, n1) = run(False), run(True)
    assert n0 == 0 and n1 >= 1
    assert plain == cut


def test_step_failure_recovers_on_contiguous_rows(models, monkeypatch):
    """A dispatch that raises fails the bound requests, rebuilds the
    contiguous pools, and the engine then serves the JAX engine's
    stream again."""
    jm, tm = models
    prompts = _prompts(2)
    eng = _port_engine(tm)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]

    def boom(*a, **k):
        raise RuntimeError("injected dispatch failure")

    monkeypatch.setattr(tm, "_fused_decode_tick_slots", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    monkeypatch.undo()
    for r in reqs:
        with pytest.raises(RuntimeError, match="engine step failed"):
            r.result(timeout=1)
    assert eng.scheduler.occupancy() == 0 and not eng._ring
    got = _run(eng, prompts[:1])
    want = _run(_jax_engine(jm), prompts[:1])
    _assert_greedy_equal(jm, prompts[:1], got, want)


# -- validation -----------------------------------------------------------
REFUSED = [
    dict(sample_mode="bogus"),
    dict(sample_mode="host", async_depth=2),
    dict(async_depth=0),
    dict(attn_impl="bogus"),
    dict(kv_dtype="int8"),
    dict(kv_dtype="int8", kv_block_size=8, sample_mode="host"),
    dict(kv_dtype="int4", kv_block_size=8),
    dict(kv_block_size=7),
    dict(prefill_chunk=7),
    dict(prefill_chunk=8, tick_token_budget=4),
    dict(tick_token_budget=16),
    dict(prefill_chunk=8, prefill_buckets="pow2"),
    dict(kv_block_size=8, prefill_buckets="pow2"),
    dict(prefill_buckets=[0, 8]),
    dict(prefill_buckets=[8, 100]),
    dict(kv_budget_mb=1),
    dict(kv_block_size=8, kv_budget_mb=1, kv_blocks=12),
    dict(attn_impl="ragged"),
    dict(attn_impl="ragged_gather", kv_block_size=8, sample_mode="host"),
    dict(spec_k=0),
    dict(spec_k=47),
]


@pytest.mark.parametrize("kw", REFUSED,
                         ids=[",".join(f"{k}={v}" for k, v in c.items())
                              for c in REFUSED])
def test_validation_errors_match_jax(models, kw):
    """Each combination the JAX engine refuses, the port refuses with
    the same exception type."""
    jm, tm = models
    with pytest.raises(Exception) as jax_err:
        _jax_engine(jm, **kw)
    with pytest.raises(Exception) as port_err:
        _port_engine(tm, **kw)
    assert port_err.type is jax_err.type, (port_err.value, jax_err.value)


def test_default_attn_impl_needs_a_layout(models):
    """The port's default is the ragged kernel path (JAX's is "xla"):
    ``Engine(model)`` with no block size raises naming both remedies."""
    _, tm = models
    with pytest.raises(ValueError) as err:
        Engine(tm, device="cpu")
    assert "kv_block_size" in str(err.value)
    assert "attn_impl='xla'" in str(err.value)


def test_engine_inherits_the_models_attn_impl(models):
    """``GPTModel(attn_impl=)`` takes JAX's values and refuses others with
    JAX's error; ``Engine(attn_impl=None)`` serves the model's choice, an
    explicit ``attn_impl`` wins, and the choice survives
    ``to_tensor_parallel()``."""
    from paddle_tpu.models import GPTModel as JaxGPT
    _, tm = models
    with pytest.raises(ValueError) as terr:
        GPTModel(num_layers=1, hidden_size=32, num_heads=2, vocab_size=64,
                 max_position=32, attn_impl="flash")
    with pytest.raises(ValueError) as jerr:
        JaxGPT(num_layers=1, hidden_size=32, num_heads=2, vocab_size=64,
               max_position=32, attn_impl="flash")
    assert str(terr.value) == str(jerr.value)
    assert GPTModel.from_config("tiny", device="cpu").attn_impl == "ragged"
    xm = GPTModel.from_config("tiny", device="cpu", dropout=0.0,
                              attn_impl="xla")
    xm.load_state_dict(tm.state_dict())
    assert xm.to_tensor_parallel().attn_impl == "xla"
    eng = Engine(xm, device="cpu", **BASE)
    assert eng.attn_impl == "xla" and not eng._ragged
    prompts = _prompts(3)
    assert _run(eng, prompts) == _run(_port_engine(tm), prompts)
    assert Engine(xm, device="cpu", kv_block_size=8, attn_impl="ragged",
                  **BASE).attn_impl == "ragged"


@pytest.mark.parametrize("kw", [dict(attn_impl="xla", kv_block_size=8),
                                dict(kv_block_size=8, prefill_chunk=None)],
                         ids=["xla", "monolithic"])
def test_xla_and_monolithic_paths_refuse_a_mesh(models, kw):
    """The XLA path and the monolithic prefill over a ``(1, 2)`` mesh
    (this test's name is the refusal's it replaced): greedy and seeded
    streams equal the unsharded engine's of the same configuration
    (tests/test_torch_mesh_xla.py holds every mesh layout to JAX)."""
    _, tm = models
    prompts = _prompts(4)
    mesh = Engine(tm, device="cpu", mesh=ServingMesh(1, 2,
                                                     devices=["cpu"] * 2),
                  num_slots=2, max_seq_len=48, **kw)
    one = Engine(tm, device="cpu", num_slots=2, max_seq_len=48, **kw)
    assert _run(mesh, prompts, seeded=(1, 3)) == _run(one, prompts,
                                                      seeded=(1, 3))


# -- on the card ----------------------------------------------------------
@pytest.mark.cuda
def test_ragged_after_monolithic_prefill_on_card():
    """The ragged kernel's decode after a monolithic paged prefill on the
    card, held to the same engine's CPU run (the kernel's plain
    version) on the same weights: greedy streams equal, except from a
    first divergence at a near tie (top-2 margin under 1e-4 of the CPU
    model's logits).  (One seed draws other weights on the card's
    generator, so the card's model takes the CPU model's state.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ragged kernel runs only there")
    cpu = GPTModel.from_config("tiny", device="cpu", seed=0, dropout=0.0)
    card = GPTModel.from_config("tiny", device="cuda", dropout=0.0)
    card.load_state_dict(cpu.state_dict())
    prompts = _prompts(6)
    kw = dict(num_slots=4, max_seq_len=48, kv_block_size=8)
    got = _run(Engine(card, **kw), prompts)
    want = _run(Engine(cpu, device="cpu", **kw), prompts)
    for p, a, b in zip(prompts, got, want):
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        with torch.no_grad():
            row = cpu(torch.tensor([list(p) + b[:t]]))[0, -1]
        top2 = row.topk(2).values
        assert float(top2[0] - top2[1]) < 1e-4
