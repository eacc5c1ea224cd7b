"""Multi-adapter (LoRA) serving and token streaming in the port, held to
the JAX package and to the merged-weights oracle.

A JAX ``tiny`` GPT made from a seed is bridged into the port; adapters are
``LoRAAdapter.random`` factors from a seed (numpy, identical in both
packages).

- The padded bank factors reconstruct the merged delta (rtol 1e-6); the
  registry's lane lifecycle is JAX's; ``GPTAttention._out`` under a
  ``_lora_scope`` is within 1e-5 of JAX's ``_lora_out`` in f32.
- Adapter streams through the banked lanes are token-identical to
  engines serving the merged weights (greedy and seeded), on the ragged
  and XLA paths, and to the JAX engine with the same adapters (greedy);
  base lanes in the same batch equal the adapter-free engine's.
- A hot load mid-serve changes no other lane's stream; a pinned unload is
  refused; an unknown adapter raises ``UnknownAdapter``; the refusals of
  the JAX engine's constructor are the port's.
- A ``TokenStream`` attached before or during the decode yields exactly
  the buffered result; a terminal error reaches the stream.

JAX is imported inside the fixtures, so the ``cuda`` test runs on a card
without it.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import ServingMesh
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.models import gpt as gpt_mod
from paddle_tpu_torch.serving import (AdapterInUse, AdapterRegistry, Engine,
                                      LoRAAdapter, PromptLookupProposer,
                                      RegistryFull, TokenStream,
                                      UnknownAdapter, parse_sse, sse_format)

torch.set_num_threads(1)

MAX_NEW = 8
BASE = dict(num_slots=4, max_seq_len=48)
PATHS = {
    "ragged_chunked": dict(kv_block_size=8, prefill_chunk=4,
                           tick_token_budget=8),
    "ragged_monolithic": dict(kv_block_size=8),
    "ragged_spec": dict(kv_block_size=8, prefill_chunk=8, spec_k=2),
    "xla": dict(attn_impl="xla"),
    "xla_paged_spec": dict(attn_impl="xla", kv_block_size=8, spec_k=2),
}


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


def _fresh(tm):
    """A new port model with ``tm``'s weights (the oracle merges in
    place)."""
    m = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    m.load_state_dict(tm.state_dict())
    m.eval()
    return m


def _engine(model, **kw):
    if "spec_k" in kw:
        kw.setdefault("proposer", PromptLookupProposer(ngram=1))
    return Engine(model, device="cpu", **BASE, **kw)


def _prompts(n, lens=(5, 7, 3, 9, 4, 6)):
    rng = np.random.RandomState(7)
    return [rng.randint(0, 128, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


def _adapter(seed, rank=4):
    # scale large enough that the delta moves the tiny model's argmax
    return LoRAAdapter.random(rank, 64, n_layers=2, seed=seed, scale=0.5)


def _jax_adapter(seed, rank=4):
    from paddle_tpu.serving import LoRAAdapter as JaxLoRA
    return JaxLoRA.random(rank, 64, n_layers=2, seed=seed, scale=0.5)


def _tail(req):
    return [int(t) for t in req.generated]


def _serve_one(eng, prompt, **kw):
    r = eng.submit(prompt, max_new_tokens=MAX_NEW, **kw)
    eng.run_until_idle()
    return _tail(r)


# -- units ------------------------------------------------------------------
def test_adapter_factors_padding_matches_merged_delta():
    """Zero-padding a rank-2 adapter into r_max=8 lanes is exact, and the
    factors and merged delta are JAX's to the bit."""
    from paddle_tpu.serving import LoRAAdapter as JaxLoRA
    ad = LoRAAdapter.random(2, 16, n_layers=3, seed=1)
    a, b = ad.factors(3, 8)
    assert a.shape == (3, 8, 16) and b.shape == (3, 16, 8)
    for i in range(3):
        np.testing.assert_allclose((b[i] @ a[i]).T, ad.merged_delta(3)[i],
                                   rtol=1e-6)
    jad = JaxLoRA.random(2, 16, n_layers=3, seed=1)
    for got, want in zip(ad.factors(3, 8), jad.factors(3, 8)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ad.merged_delta(3), jad.merged_delta(3))


def test_registry_lane_lifecycle():
    reg = AdapterRegistry(2, 16, max_adapters=2, r_max=4, device="cpu")
    l1 = reg.load("x", LoRAAdapter.random(2, 16, n_layers=2, seed=1))
    l2 = reg.load("y", LoRAAdapter.random(4, 16, n_layers=2, seed=2))
    assert {l1, l2} == {1, 2} and reg.names() == ["x", "y"]
    assert reg.a_bank.shape == (3, 2, 4, 16) and reg.a_bank.dtype == \
        torch.float32
    with pytest.raises(RegistryFull):
        reg.load("z", LoRAAdapter.random(2, 16, n_layers=2, seed=3))
    reg.pin("x")
    with pytest.raises(AdapterInUse):
        reg.unload("x")
    reg.unpin("x")
    assert reg.unload("x") == l1
    assert float(reg.a_bank[l1].abs().sum()) == 0.0  # the lane is zeroed
    with pytest.raises(UnknownAdapter):
        reg.lane("x")
    assert reg.load("z", LoRAAdapter.random(2, 16, n_layers=2,
                                            seed=3)) == l1
    with pytest.raises(ValueError, match="rank 8 exceeds"):
        reg.load("w", LoRAAdapter.random(8, 16, n_layers=2, seed=4))
    assert float(reg.a_bank[0].abs().sum()) == 0.0  # the base lane


def test_lora_delta_matches_jax_lora_out(models):
    """``_out`` under a scope of three rows on lanes (2, 0, 1), every
    layer, against JAX's ``_lora_out`` on the same x: within 1e-5."""
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu.models import gpt as jax_gpt
    from paddle_tpu.serving.lora import AdapterRegistry as JaxRegistry
    jm, tm = models
    reg = AdapterRegistry(2, 64, max_adapters=2, r_max=4, device="cpu")
    jreg = JaxRegistry(2, 64, max_adapters=2, r_max=4)
    for name, seed, rank in (("p", 5, 4), ("q", 6, 2)):
        reg.load(name, _adapter(seed, rank))
        jreg.load(name, _jax_adapter(seed, rank))
    aid = np.array([2, 0, 1], np.int32)
    x = np.random.RandomState(3).randn(3, 5, 64).astype(np.float32)
    for li in range(2):
        with jax_gpt._lora_scope((jnp.asarray(aid), jreg.a_bank,
                                  jreg.b_bank)):
            want = np.asarray(jm.blocks[li].attn._lora_out(
                paddle.to_tensor(x)).numpy())
        with torch.no_grad(), gpt_mod._lora_scope(
                (torch.from_numpy(aid), reg.a_bank, reg.b_bank)):
            got = tm.blocks[li].attn._out(
                torch.from_numpy(x).view(3, 5, 4, 16)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        with torch.no_grad():
            base = tm.blocks[li].attn._out(
                torch.from_numpy(x).view(3, 5, 4, 16)).numpy()
        np.testing.assert_array_equal(got[1], base[1])  # lane 0
        assert np.abs(got[0] - base[0]).max() > 1e-3


# -- oracle and JAX parity ---------------------------------------------------
@pytest.mark.parametrize("path", sorted(PATHS))
def test_lora_oracle_parity_greedy(models, path):
    """Adapter lanes equal engines serving the merged weights; the base
    lane in the same batch equals the adapter-free engine's; adapted
    streams differ from the base one."""
    _, tm = models
    kw = PATHS[path]
    a1, a2 = _adapter(11), _adapter(22, rank=2)
    eng = _engine(tm, adapters={"a1": a1, "a2": a2}, **kw)
    prompts = _prompts(3)
    reqs = [eng.submit(prompts[0], max_new_tokens=MAX_NEW, adapter="a1"),
            eng.submit(prompts[1], max_new_tokens=MAX_NEW, adapter="a2"),
            eng.submit(prompts[2], max_new_tokens=MAX_NEW)]
    eng.run_until_idle()
    for ad, p, r in ((a1, prompts[0], reqs[0]), (a2, prompts[1], reqs[1])):
        oracle = _engine(ad.merge_into(_fresh(tm)), **kw)
        assert _tail(r) == _serve_one(oracle, p)
    assert _tail(reqs[2]) == _serve_one(_engine(tm, **kw), prompts[2])
    assert _tail(reqs[0]) != _tail(reqs[2])
    assert eng.adapters.pins("a1") == eng.adapters.pins("a2") == 0


@pytest.mark.parametrize("jax_kw,port_paths", [
    (dict(kv_block_size=8, prefill_chunk=4, tick_token_budget=8,
          attn_impl="ragged"), ("ragged_chunked", "xla")),
    (dict(), ("xla", "ragged_monolithic")),
], ids=["jax_ragged", "jax_xla"])
def test_lora_streams_match_jax_engine(models, jax_kw, port_paths):
    """The JAX engine with the same adapters and traffic: every greedy
    stream of the port's ragged and XLA paths is token-identical."""
    from paddle_tpu import monitor
    from paddle_tpu.serving import Engine as JaxEngine
    jm, tm = models
    prompts = _prompts(4)
    names = ("a1", None, "a2", "a1")

    def run(eng):
        reqs = [eng.submit(p, max_new_tokens=MAX_NEW, adapter=n)
                for p, n in zip(prompts, names)]
        eng.run_until_idle()
        return [_tail(r) for r in reqs]

    want = run(JaxEngine(jm, registry=monitor.StatRegistry(),
                         adapters={"a1": _jax_adapter(11),
                                   "a2": _jax_adapter(22, 2)},
                         **BASE, **jax_kw))
    for path in port_paths:
        got = run(_engine(tm, adapters={"a1": _adapter(11),
                                        "a2": _adapter(22, 2)},
                          **PATHS[path]))
        assert got == want, path


@pytest.mark.parametrize("path", ["ragged_chunked", "xla"])
def test_lora_oracle_parity_seeded(models, path):
    """A seeded adapter stream equals the merged-weights engine's draw for
    draw (the same logits and the same key stream)."""
    _, tm = models
    ad = _adapter(33)
    kw = dict(temperature=0.8, top_k=12, seed=1234)
    eng = _engine(tm, adapters={"ad": ad}, **PATHS[path])
    got = _serve_one(eng, _prompts(1)[0], adapter="ad", **kw)
    oracle = _engine(ad.merge_into(_fresh(tm)), **PATHS[path])
    assert got == _serve_one(oracle, _prompts(1)[0], **kw)


def test_hot_load_changes_no_other_lane(models):
    """Loading a third adapter while a1 and base streams decode: their
    streams equal those of an engine that never loaded it, and the new
    adapter serves its merged oracle's stream; the bank shapes never
    change."""
    _, tm = models
    kw = PATHS["ragged_chunked"]
    a1, a2 = _adapter(11), _adapter(22)
    prompts = _prompts(3)
    ref = _engine(tm, adapters={"a1": a1}, max_adapters=3, **kw)
    want = [ref.submit(prompts[0], max_new_tokens=MAX_NEW, adapter="a1"),
            ref.submit(prompts[1], max_new_tokens=MAX_NEW)]
    ref.run_until_idle()
    eng = _engine(tm, adapters={"a1": a1}, max_adapters=3, **kw)
    shapes = (eng.adapters.a_bank.shape, eng.adapters.b_bank.shape)
    live = [eng.submit(prompts[0], max_new_tokens=MAX_NEW, adapter="a1"),
            eng.submit(prompts[1], max_new_tokens=MAX_NEW)]
    for _ in range(3):
        eng.step()
    assert eng.load_adapter("a2", a2)["lane"] == 2
    new = eng.submit(prompts[2], max_new_tokens=MAX_NEW, adapter="a2")
    eng.run_until_idle()
    assert [_tail(r) for r in live] == [_tail(r) for r in want]
    oracle = _engine(a2.merge_into(_fresh(tm)), **kw)
    assert _tail(new) == _serve_one(oracle, prompts[2])
    assert (eng.adapters.a_bank.shape, eng.adapters.b_bank.shape) == shapes
    eng.unload_adapter("a2")
    assert eng.adapters.names() == ["a1"]


def test_hot_load_on_the_background_loop(models):
    """With ``start()``'s loop running, load and unload are serviced on
    the engine thread and the served stream is the merged oracle's."""
    _, tm = models
    ad = _adapter(11)
    eng = _engine(tm, max_adapters=2, **PATHS["ragged_chunked"])
    eng.start()
    try:
        assert eng.load_adapter("ad", ad, timeout=30)["lane"] == 1
        r = eng.submit(_prompts(1)[0], max_new_tokens=MAX_NEW, adapter="ad")
        r.result(timeout=60)
        assert eng.unload_adapter("ad", timeout=30)["name"] == "ad"
    finally:
        eng.stop()
    oracle = _engine(ad.merge_into(_fresh(tm)), **PATHS["ragged_chunked"])
    assert _tail(r) == _serve_one(oracle, _prompts(1)[0])


def test_pinned_unload_refused(models):
    _, tm = models
    ad = _adapter(11)
    eng = _engine(tm, adapters={"ad": ad}, **PATHS["ragged_chunked"])
    req = eng.submit(_prompts(1)[0], max_new_tokens=MAX_NEW, adapter="ad")
    assert eng.adapters.pins("ad") == 1
    with pytest.raises(AdapterInUse):
        eng.unload_adapter("ad")
    eng.run_until_idle()
    assert req.done() and eng.adapters.pins("ad") == 0
    eng.unload_adapter("ad")
    assert eng.adapters.names() == []
    with pytest.raises(UnknownAdapter):
        eng.submit(_prompts(1)[0], max_new_tokens=4, adapter="ad")


def test_submit_unknown_adapter_raises(models):
    _, tm = models
    with pytest.raises(UnknownAdapter):
        _engine(tm, kv_block_size=8).submit(_prompts(1)[0],
                                            max_new_tokens=4,
                                            adapter="nope")
    eng = _engine(tm, adapters={"a": _adapter(1)}, kv_block_size=8)
    with pytest.raises(UnknownAdapter):
        eng.submit(_prompts(1)[0], max_new_tokens=4, adapter="b")
    with pytest.raises(RuntimeError, match="no adapters"):
        _engine(tm, kv_block_size=8).load_adapter("a", _adapter(1))


def test_adapter_lanes_never_share_cached_blocks(models):
    """An adapter request neither adopts the base lane's cached prefix
    nor inserts its own blocks, and a preempted adapter stream resumes on
    its own lane unchanged."""
    _, tm = models
    ad = _adapter(11)
    kw = PATHS["ragged_chunked"]
    p = np.arange(20, dtype=np.int32)
    eng = _engine(tm, adapters={"ad": ad}, **kw)
    _serve_one(eng, p)                      # the base lane caches p
    cached = eng.prefix_cache.cached_blocks()
    hits = eng.prefix_hits
    got = _serve_one(eng, p, adapter="ad")
    assert eng.prefix_hits == hits
    assert eng.prefix_cache.cached_blocks() == cached
    assert got == _serve_one(_engine(ad.merge_into(_fresh(tm)), **kw), p)
    one = Engine(tm, device="cpu", num_slots=1, max_seq_len=48,
                 adapters={"ad": ad}, **kw)
    low = one.submit(p, max_new_tokens=12, adapter="ad", priority=0)
    for _ in range(50):
        one.step()
        if len(low.generated) >= 2:
            break
    hi = one.submit(_prompts(1)[0], max_new_tokens=3, priority=5)
    one.run_until_idle()
    assert low.preemptions == 1 and hi.done()
    ref = Engine(ad.merge_into(_fresh(tm)), device="cpu", num_slots=1,
                 max_seq_len=48, **kw)
    r = ref.submit(p, max_new_tokens=12)
    ref.run_until_idle()
    assert _tail(low) == _tail(r)


def test_constructor_refusals_as_jax(models):
    """What the JAX engine refuses, with the same exception types."""
    _, tm = models
    with pytest.raises(ValueError, match="sample_mode='device'"):
        _engine(tm, attn_impl="xla", sample_mode="host",
                adapters={"a": _adapter(1)})
    with pytest.raises(ValueError, match="tensor-parallel"):
        Engine(tm.to_tensor_parallel(), device="cpu", kv_block_size=8,
               prefill_chunk=8, adapters={"a": _adapter(1)}, **BASE)
    with pytest.raises(ValueError, match="tensor-parallel"):
        Engine(tm, mesh=ServingMesh(1, 2, devices=["cpu"] * 2),
               kv_block_size=8, prefill_chunk=8,
               adapters={"a": _adapter(1)}, **BASE)
    with pytest.raises(ValueError, match="cannot hold"):
        _engine(tm, kv_block_size=8, max_adapters=1,
                adapters={"a": _adapter(1), "b": _adapter(2)})
    with pytest.raises(TypeError, match="LoRAAdapter"):
        _engine(tm, kv_block_size=8, adapters={"a": object()})
    eng = _engine(tm, kv_block_size=8, max_adapters=1)
    assert eng.adapters.r_max == 8 and eng.adapters.n_lanes == 2


# -- token streaming ---------------------------------------------------------
@pytest.mark.parametrize("path", ["ragged_chunked", "ragged_spec", "xla",
                                  "depth1"])
def test_streamed_equals_buffered(models, path):
    """A stream attached before the first tick and one attached mid-decode
    (replay, then live) both yield exactly the buffered tokens, with an
    adapter in the mix."""
    _, tm = models
    kw = (dict(PATHS["ragged_chunked"], async_depth=1) if path == "depth1"
          else PATHS[path])
    eng = _engine(tm, adapters={"ad": _adapter(11)}, **kw)
    p = _prompts(1)[0]
    streamed = eng.submit(p, max_new_tokens=MAX_NEW, adapter="ad")
    live = TokenStream(streamed)
    buffered = eng.submit(p, max_new_tokens=MAX_NEW, adapter="ad")
    base = eng.submit(p, max_new_tokens=MAX_NEW)
    for _ in range(3):
        eng.step()
    late = TokenStream(streamed)
    eng.run_until_idle()
    want = _tail(buffered)
    assert live.drain(timeout=1) == want
    assert late.drain(timeout=1) == want
    assert _tail(streamed) == want
    assert want != _tail(base)


def test_stream_terminal_error_and_emit_span(models):
    """A finished stream drains to its tokens and the trace has
    ``stream.emit`` spans; a request that dies ends its stream with the
    error; ``streams_active`` counts attached sinks."""
    _, tm = models
    eng = _engine(tm, **PATHS["ragged_chunked"])
    req = eng.submit(_prompts(1)[0], max_new_tokens=6)
    stream = TokenStream(req)
    assert eng.streams_active() == 1
    eng.run_until_idle()
    assert stream.drain(timeout=1) == _tail(req)
    names = {ev.get("name") for ev in eng.chrome_trace()["traceEvents"]}
    assert "stream.emit" in names
    assert eng.streams_active() == 0
    req2 = eng.submit(_prompts(2)[1], max_new_tokens=6)
    s2 = TokenStream(req2)
    req2._finish(RuntimeError("synthetic mid-stream death"))
    with pytest.raises(RuntimeError, match="synthetic"):
        s2.drain(timeout=1)
    events = list(TokenStream(req2))
    assert events[-1].kind == "error"


def test_sse_roundtrip_and_unported_faults():
    """``sse_format`` frames parse back through ``parse_sse`` (comments
    skipped), as the JAX pair does; ``TokenStream(faults=...)`` (ported
    since: the name is kept) fires the ``stream_disconnect`` site as
    JAX's does: a stream whose ordinal the schedule names vanishes after
    ``1 + ordinal % 3`` tokens, and the injector logs it."""
    from paddle_tpu.serving.stream import sse_format as jax_sse
    frames = (sse_format({"token": 5}, event="token")
              + sse_format(comment="keep-alive")
              + sse_format({"done": True, "ids": [1, 2]}, event="done"))
    assert frames == (jax_sse({"token": 5}, event="token")
                      + jax_sse(comment="keep-alive")
                      + jax_sse({"done": True, "ids": [1, 2]}, event="done"))
    got = list(parse_sse(frames.decode().splitlines(keepends=True)))
    assert got == [("token", '{"token": 5}'),
                   ("done", '{"done": true, "ids": [1, 2]}')]
    from paddle_tpu_torch.serving import FaultInjector
    from paddle_tpu_torch.serving.faults import StreamDisconnect
    from paddle_tpu_torch.serving.request import Request
    inj = FaultInjector(seed=0).at(4, "stream_disconnect")
    req = Request(np.arange(3, dtype=np.int32), 5)
    stream = TokenStream(req, faults=inj, ordinal=4)
    for t in (7, 8, 9):
        req._emit_token(t)
    got = []
    with pytest.raises(StreamDisconnect):
        for ev in stream:
            got.append(ev.token)
    assert got == [7, 8] and inj.log == [(4, "stream_disconnect")]


# -- on the card ----------------------------------------------------------
@pytest.mark.cuda
def test_lora_serve_on_card():
    """Adapter and base streams on the card's ragged path, held to the
    same engine on the CPU model with the same state: greedy streams
    equal, except from a first divergence at a near tie (top-2 margin
    under 1e-4 of the CPU merged model's logits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ragged kernel runs only there")
    cpu = GPTModel.from_config("tiny", device="cpu", seed=0, dropout=0.0)
    card = GPTModel.from_config("tiny", device="cuda", dropout=0.0)
    card.load_state_dict(cpu.state_dict())
    ads = {"a1": _adapter(11), "a2": _adapter(22, 2)}
    kw = dict(BASE, adapters=ads, **PATHS["ragged_chunked"])
    prompts = _prompts(6)
    names = ("a1", None, "a2", "a1", None, "a2")

    def run(eng):
        reqs = [eng.submit(p, max_new_tokens=MAX_NEW, adapter=n)
                for p, n in zip(prompts, names)]
        eng.run_until_idle()
        return [_tail(r) for r in reqs]

    got = run(Engine(card, **kw))
    want = run(Engine(cpu, device="cpu", **kw))
    for p, n, a, b in zip(prompts, names, got, want):
        if a == b:
            continue
        oracle = ads[n].merge_into(_fresh(cpu)) if n else cpu
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        with torch.no_grad():
            row = oracle(torch.tensor([list(p) + b[:t]]))[0, -1]
        top2 = row.topk(2).values
        assert float(top2[0] - top2[1]) < 1e-4
