"""The port's pipelined engine loop (``async_depth=2``) held to depth 1
and to the JAX package.

A JAX ``tiny`` GPT made from a seed is bridged into the port; the port's
CPU engine serves the prompts of tests/test_torch_serving.py at depth 2
(tick N+1 dispatched before tick N is consumed) and at depth 1.  Greedy
streams must be token-identical across depths and to the JAX reference:
``GPTModel.generate()`` for fp pools, the gather body, prefix adoption
and the ``(1, 2)`` CPU mesh; the JAX engine on the same int8 pools for
``kv_dtype="int8"``.  Seeded streams must be equal across depths and
engine restarts (the RNG contract: same seed, same stream).  Preemption
resumes streams token-identically, greedy and seeded.  JAX is imported
inside the fixtures, so the ``cuda`` tests run on a card without it.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import monitor
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import ServingMesh
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.serving import Engine, QueueFull, RateLimited
from paddle_tpu_torch.serving.request import RequestTimeout

torch.set_num_threads(1)

MAX_NEW = 8
ENGINE_KW = dict(num_slots=4, max_seq_len=48, kv_block_size=8,
                 prefill_chunk=8)


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


@pytest.fixture(scope="module")
def generate(models):
    """JAX ``generate()``'s greedy continuation of a prompt, cached."""
    import paddle_tpu as paddle
    jm, _ = models
    cache = {}

    def run(prompt, n):
        key = (prompt.tobytes(), n)
        if key not in cache:
            out = jm.generate(paddle.to_tensor(prompt[None, :]),
                              max_new_tokens=n, compiled="fused").numpy()[0]
            cache[key] = [int(t) for t in out[len(prompt):]]
        return cache[key]

    return run


def _prompts(n, lens=(5, 21, 3, 17, 7, 12)):
    rng = np.random.RandomState(7)
    return [rng.randint(0, 128, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


def _shared_prefix_prompts():
    system = np.random.RandomState(11).randint(0, 128, 17).astype(np.int32)
    return [np.concatenate([system, t]) for t in _prompts(4, (3, 9, 1, 6))]


def _serve(eng, prompts, seeded=(), waves=1):
    """Submit ``prompts`` in ``waves`` (a later wave finds the first's
    prompts cached), drive the engine idle; the generated streams.
    Prompt i of ``seeded`` samples with seed 500 + i."""
    reqs = []
    per = -(-len(prompts) // waves)
    for w in range(waves):
        for i in range(w * per, min((w + 1) * per, len(prompts))):
            kw = (dict(temperature=0.8, top_k=20, top_p=0.9, seed=500 + i)
                  if i in seeded else {})
            reqs.append(eng.submit(prompts[i], max_new_tokens=MAX_NEW,
                                   **kw))
        eng.run_until_idle()
    return [r.result(timeout=5)[len(p):].tolist()
            for r, p in zip(reqs, prompts)]


def _jax_int8_streams(models, prompts):
    from paddle_tpu import monitor as jax_monitor
    from paddle_tpu.serving import Engine as JaxEngine
    jm, _ = models
    eng = JaxEngine(jm, attn_impl="ragged", kv_dtype="int8",
                    registry=jax_monitor.StatRegistry(), **ENGINE_KW)
    return _serve(eng, prompts)


# name: (engine knobs, prompts, submission waves)
CASES = {
    "fp": (dict(), _prompts(6), 1),
    "gather": (dict(attn_impl="ragged_gather"), _prompts(6), 1),
    "int8_kv": (dict(kv_dtype="int8"), _prompts(6), 1),
    "prefix": (dict(), _shared_prefix_prompts(), 2),
    "mesh_1x2": (dict(mesh=ServingMesh(1, 2, devices=["cpu"] * 2)),
                 _prompts(6), 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_depth2_greedy_matches_depth1_and_jax(models, generate, case):
    """Greedy streams at depth 2 equal depth 1's token for token, and the
    JAX reference's; the engines count the same tokens and prefix hits
    (not the same dispatches: depth 2 dispatches before it knows which
    lanes the in-flight tick finishes)."""
    _, tm = models
    kw, prompts, waves = CASES[case]
    engines = {d: Engine(tm, device="cpu", async_depth=d, **ENGINE_KW, **kw)
               for d in (1, 2)}
    got = {d: _serve(e, prompts, waves=waves) for d, e in engines.items()}
    assert got[2] == got[1]
    if case == "int8_kv":
        assert got[2] == _jax_int8_streams(models, prompts)
    else:
        assert got[2] == [generate(p, MAX_NEW) for p in prompts]
    e1, e2 = engines[1], engines[2]
    assert e2.async_depth == 2 and e1.async_depth == 1
    assert e2.tokens_generated == e1.tokens_generated == len(prompts) * \
        MAX_NEW
    assert e2.prefix_hits == e1.prefix_hits
    assert (e2.prefix_hits > 0) == (case == "prefix")
    assert e2._ring == [] and e2.block_pool.in_use() == \
        (e2.prefix_cache.cached_blocks() if e2.prefix_cache else 0)


def test_seeded_streams_equal_across_depths_and_restarts(models):
    """Sampled streams (seeded, beside greedy ones) repeat: depth 1, depth
    2, and a second depth-2 engine give the same tokens; another seed
    gives other sampled tokens and the same greedy ones."""
    _, tm = models
    prompts = _prompts(5)

    def serve(depth, seed_base=0):
        eng = Engine(tm, device="cpu", async_depth=depth, **ENGINE_KW)
        reqs = [eng.submit(p, max_new_tokens=MAX_NEW, temperature=0.8,
                           top_p=0.9, top_k=20, seed=seed_base + 77 + i)
                if i % 2 else eng.submit(p, max_new_tokens=MAX_NEW)
                for i, p in enumerate(prompts)]
        eng.run_until_idle()
        return [r.result(timeout=5).tolist() for r in reqs]

    a, b, c = serve(1), serve(2), serve(2)
    assert a == b == c
    d = serve(2, seed_base=1000)
    assert [a[i] for i in (0, 2, 4)] == [d[i] for i in (0, 2, 4)]
    assert [a[i] for i in (1, 3)] != [d[i] for i in (1, 3)]


def test_async_depth_validation_and_defaults(models):
    """Depth resolution, as ``tests/test_serving.py::
    test_async_depth_validation_and_defaults``: device sampling defaults
    to 2; depth 1 stays available; depth < 1 and a depth > 1 without
    device sampling are refused."""
    _, tm = models
    assert Engine(tm, device="cpu", **ENGINE_KW).async_depth == 2
    assert Engine(tm, device="cpu", async_depth=1,
                  **ENGINE_KW).async_depth == 1
    with pytest.raises(ValueError, match="async_depth"):
        Engine(tm, device="cpu", sample_mode="host", async_depth=2,
               **ENGINE_KW)
    with pytest.raises(ValueError, match="async_depth"):
        Engine(tm, device="cpu", async_depth=0, **ENGINE_KW)
    with pytest.raises(ValueError, match="sample_mode"):
        Engine(tm, device="cpu", sample_mode="host", **ENGINE_KW)


def test_depth1_counts_the_synchronous_tick(models):
    """At depth 1 one 5-token prompt with 3 new tokens takes three ticks,
    each one dispatch (final chunk, two decode lanes) walking one
    block; depth 2 takes a fourth tick to consume the last dispatch."""
    _, tm = models
    for depth, ticks in ((1, 3), (2, 4)):
        eng = Engine(tm, device="cpu", async_depth=depth, **ENGINE_KW)
        req = eng.submit(_prompts(1)[0], max_new_tokens=3)
        eng.run_until_idle()
        assert len(req.generated) == 3
        assert (eng.ticks, eng.ragged_dispatches) == (ticks, 3)
        assert eng.kv_blocks_walked == 3
        assert (eng.prefill_tokens, eng.tokens_generated) == (5, 3)
        assert eng.requests_completed == 1


def test_depth2_keeps_a_tick_in_flight(models):
    """In steady state a depth-2 tick ends with one dispatch unconsumed;
    the consume's wait and the overlapped host work are measured, and
    the download is the packed picks + counts + done mask."""
    _, tm = models
    eng = Engine(tm, device="cpu", **ENGINE_KW)
    for p in _prompts(3):
        eng.submit(p, max_new_tokens=MAX_NEW)
    in_flight = []
    while not eng.scheduler.idle():
        eng.step()
        in_flight.append(len(eng._ring))
    assert max(in_flight) == 1 and in_flight[-1] == 0
    reg = eng.registry
    assert reg.get("serving.d2h_wait_ms").count == eng.ragged_dispatches
    assert reg.get("serving.tick_overlap_ms").count == eng.ticks
    assert reg.get("serving.tick_overlap_ms").sum > 0
    # picks [B, 1] + n_acc + n_emit + done, int32
    assert reg.get("serving.d2h_bytes_per_tick").value == 4 * 4 * 4
    assert reg.get("serving.async_depth").value == 2


def test_step_failure_with_a_tick_in_flight_recovers(models, generate,
                                                     monkeypatch):
    """A consume that raises while tick N+1 is in flight fails the bound
    requests loudly, drops the ring, rebuilds the pools, and the engine
    then serves token-identically."""
    _, tm = models
    eng = Engine(tm, device="cpu", **ENGINE_KW)
    prompts = _prompts(2)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.step()
    eng.step()
    assert len(eng._ring) == 1

    def boom(slot, tok):
        raise RuntimeError("injected consume failure")

    monkeypatch.setattr(eng, "_emit", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    monkeypatch.undo()
    for r in reqs:
        with pytest.raises(RuntimeError, match="engine step failed"):
            r.result(timeout=1)
    assert eng._ring == [] and eng.scheduler.occupancy() == 0
    assert eng.block_pool.in_use() == 0
    again = eng.submit(prompts[0], max_new_tokens=MAX_NEW)
    eng.run_until_idle()
    assert again.generated == generate(prompts[0], MAX_NEW)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("cfg", [dict(), dict(spec_k=3)],
                         ids=["plain", "spec"])
def test_preempt_resume_parity(models, generate, depth, cfg):
    """``tests/test_ragged_attn.py::test_ragged_preempt_resume_parity``:
    on one slot a priority-5 request preempts a running priority-0
    stream; both streams equal JAX ``generate()``, the preempted one
    resumed from its cached blocks."""
    _, tm = models
    eng = Engine(tm, device="cpu", async_depth=depth,
                 **dict(ENGINE_KW, num_slots=1), **cfg)
    p_low, p_high = _prompts(2)
    low = eng.submit(p_low, max_new_tokens=12, priority=0)
    for _ in range(5):
        eng.step()
    assert not low.done()
    high = eng.submit(p_high, max_new_tokens=4, priority=5)
    eng.run_until_idle()
    assert high.generated == generate(p_high, 4)
    assert low.generated == generate(p_low, 12)
    assert low.preemptions >= 1
    reg = eng.registry
    assert reg.get("serving.preemptions_total").value >= 1
    assert reg.get("serving.resumed_total").value >= 1
    eng.prefix_cache.clear()
    assert eng.block_pool.in_use() == 0


def test_preempt_seeded_stream_unchanged(models):
    """``tests/test_ragged_attn.py::
    test_ragged_preempt_seeded_stream_unchanged``: a seeded stream across
    a preemption equals the uninterrupted one (the key folds the
    emitted-token counter)."""
    _, tm = models
    p_low, p_high = _prompts(2)
    kw = dict(max_new_tokens=12, temperature=0.8, top_p=0.9, seed=5)
    un = Engine(tm, device="cpu", **dict(ENGINE_KW, num_slots=1))
    r0 = un.submit(p_low, **kw)
    un.run_until_idle()
    eng = Engine(tm, device="cpu", **dict(ENGINE_KW, num_slots=1))
    low = eng.submit(p_low, **kw)
    for _ in range(5):
        eng.step()
    eng.submit(p_high, max_new_tokens=4, priority=5)
    eng.run_until_idle()
    assert low.preemptions >= 1
    assert low.generated == r0.generated


def test_no_preemption_when_disabled(models):
    """``preemption=False``: the higher-priority request waits for the
    slot instead."""
    _, tm = models
    eng = Engine(tm, device="cpu", preemption=False,
                 **dict(ENGINE_KW, num_slots=1))
    p_low, p_high = _prompts(2)
    low = eng.submit(p_low, max_new_tokens=6)
    eng.step()
    high = eng.submit(p_high, max_new_tokens=2, priority=5)
    eng.run_until_idle()
    assert low.preemptions == 0 and len(high.generated) == 2
    assert eng.registry.get("serving.preemptions_total").value == 0


def test_submit_sheds_at_the_edge(models):
    """``max_queue`` sheds with ``QueueFull``, a tenant bucket with
    ``RateLimited``; a request whose queue deadline passes times out with
    ``RequestTimeout`` and counts as completed."""
    _, tm = models
    p = _prompts(1)[0]
    eng = Engine(tm, device="cpu", max_queue=1, **ENGINE_KW)
    eng.submit(p, max_new_tokens=2)
    with pytest.raises(QueueFull):
        eng.submit(p, max_new_tokens=2)
    assert eng.registry.get("serving.shed_queue_full_total").value == 1
    eng = Engine(tm, device="cpu", tenants={"a": dict(rate=1.0, burst=12)},
                 **ENGINE_KW)
    with pytest.raises(RateLimited):
        eng.submit(p, max_new_tokens=8, tenant="a")   # 13 > burst 12
    eng.submit(p, max_new_tokens=2, tenant="b")       # no bucket
    late = eng.submit(p, max_new_tokens=2, timeout=0.0)
    eng.run_until_idle()
    with pytest.raises(RequestTimeout):
        late.result(timeout=1)
    assert eng.registry.get("serving.requests_timeout").value == 1
    assert eng.requests_completed == 2


def test_background_loop_serves_and_drains(models, generate):
    """``start()`` runs the ticks on a thread; ``stop(drain=True)`` (the
    context manager's exit) lets in-flight streams finish and leaves no
    thread behind."""
    _, tm = models
    prompts = _prompts(3)
    with Engine(tm, device="cpu", **ENGINE_KW) as eng:
        thread = eng.start()
        reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        got = [r.result(timeout=60)[len(p):].tolist()
               for r, p in zip(reqs, prompts)]
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert got == [generate(p, MAX_NEW) for p in prompts]
    assert eng._ring == []


def test_trace_spans_and_metrics(models):
    """The tracer sees the tick's spans (admit, the ragged dispatch with
    its walked blocks, the download wait, overlapped host work) and the
    request instants; ``tracing=False`` records nothing; the registry
    renders as Prometheus text under the JAX names."""
    _, tm = models
    eng = Engine(tm, device="cpu", **ENGINE_KW)
    _serve(eng, _prompts(3), seeded=(1,))
    evs = eng.chrome_trace()["traceEvents"]
    names = {e["name"] for e in evs}
    assert {"tick", "admit", "decode.ragged_stream", "decode.d2h_wait",
            "host.overlap", "decode.emit", "req.queued", "req.admitted",
            "req.first_token", "req.finished"} <= names
    walked = sum(e["args"]["kv_blocks_walked"] for e in evs
                 if e["name"] == "decode.ragged_stream")
    assert walked == eng.kv_blocks_walked
    text = monitor.render_prometheus(eng.registry)
    assert f"serving_tokens_total {3 * MAX_NEW}" in text
    assert "serving_ttft_ms_count 3" in text
    assert "serving_tpot_ms_count 3" in text
    quiet = Engine(tm, device="cpu", tracing=False, **ENGINE_KW)
    _serve(quiet, _prompts(2))
    assert quiet.chrome_trace()["traceEvents"] == []
    assert quiet.tokens_generated == 2 * MAX_NEW


# -- on the card ------------------------------------------------------------
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ring's pinned staging and the "
                    "sync-free dispatch exist only there")


def _card_model():
    return GPTModel.from_config("tiny", device="cuda", seed=0, dropout=0.0)


@pytest.mark.cuda
def test_pinned_staging_depth2_equals_depth1_on_card():
    """On the card the ring's pinned staging sets carry every tick's
    uploads and download: greedy and seeded streams at depth 2 equal
    depth 1's."""
    _need_cuda()
    model = _card_model()
    prompts = _prompts(6)
    got = {d: _serve(Engine(model, async_depth=d, **ENGINE_KW), prompts,
                     seeded=(1, 4))
           for d in (1, 2)}
    assert got[2] == got[1]


@pytest.mark.cuda
def test_dispatch_is_sync_free_on_card():
    """Steady-state ticks with no dirty state, one with a sampling lane
    and one with a final chunk lane among them, run under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in the dispatch
    synchronizes.  The consume's one wait is lifted out of the check."""
    _need_cuda()
    eng = Engine(_card_model(), **ENGINE_KW)
    long_prompt = np.arange(30, dtype=np.int32) % 128
    eng.submit(_prompts(1)[0], max_new_tokens=20, temperature=0.8, seed=3)
    eng.submit(long_prompt, max_new_tokens=4)
    for _ in range(2):          # admission dirties: drained, uploaded
        eng.step()
    real_wait = eng._d2h_wait

    def wait_unchecked(stg):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            real_wait(stg)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    eng._d2h_wait = wait_unchecked
    modes = []
    real_dispatch = eng._dispatch_ragged

    def dispatch(active, plan, tr):
        modes.extend(2 if final else 1 for _, _, final in plan)
        return real_dispatch(active, plan, tr)

    eng._dispatch_ragged = dispatch
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):      # the long prompt's chunks 2..4, final last
            assert not eng._state_dirty
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert 2 in modes
    eng.run_until_idle()
