"""The port's serving engine held to the JAX package.

A JAX ``tiny`` GPT made from a seed is converted into the port; the
port's CPU engine (``Engine(device="cpu")``, ragged path, chunked
prefill) serves the prompts of tests/test_ragged_attn.py.  Greedy
streams must be token-identical to JAX ``GPTModel.generate()``; a
divergence is tolerated only where JAX's own top-2 logit margin at that
step is below 1e-5 (a near tie the two frameworks may round apart),
which the test checks and reports.  Seeded streams cannot match JAX
(torch's and jax's generators differ): they are held to repeating for
one seed.  The block pool and prefix cache are held to the JAX copies
op for op; the package is held to importing no JAX.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.serving import kvcache as jax_kv
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import ServingMesh
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving import kvcache as torch_kv

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_NEW = 8


@pytest.fixture(scope="module")
def models():
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


def _engine(model, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_seq_len", 48)
    kw.setdefault("kv_block_size", 8)
    kw.setdefault("prefill_chunk", 8)
    return Engine(model, device="cpu", **kw)


def _jax_stream(jm, prompt, n):
    # the fused form: one compiled decode loop, the same greedy tokens as
    # the eager loop in a fraction of the CPU time
    out = jm.generate(paddle.to_tensor(prompt[None, :]),
                      max_new_tokens=n, compiled="fused").numpy()[0]
    return [int(t) for t in out[len(prompt):]]


def _jax_margin(jm, prompt, prefix):
    """JAX's top-2 logit margin for the token after prompt + prefix."""
    ids = np.concatenate([prompt, np.asarray(prefix, np.int32)])
    row = np.asarray(jm(paddle.to_tensor(ids[None].astype(np.int32)))
                     .numpy())[0, -1]
    top2 = np.sort(row)[-2:]
    return float(top2[1] - top2[0])


def _assert_greedy_parity(jm, prompts, streams):
    near_ties = []
    for p, got in zip(prompts, streams):
        want = _jax_stream(jm, p, len(got))
        for t, (a, b) in enumerate(zip(got, want)):
            if a != b:
                margin = _jax_margin(jm, p, want[:t])
                assert margin < 1e-5, (
                    f"prompt len {len(p)}: token {t} is {a}, JAX "
                    f"generate() gives {b} (JAX top-2 margin {margin})")
                near_ties.append((len(p), t, margin))
                break
    return near_ties


def test_engine_greedy_matches_jax_generate(models):
    """Six prompts on four slots: admission waits for free slots, chunks
    of 8 mix with one-token decode lanes in one dispatch."""
    jm, tm = models
    prompts = _prompts(6)
    eng = _engine(tm)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.run_until_idle()
    streams = [r.result(timeout=1)[len(p):].tolist()
               for r, p in zip(reqs, prompts)]
    assert all(len(s) == MAX_NEW for s in streams)
    near_ties = _assert_greedy_parity(jm, prompts, streams)
    print(f"near-tie divergences (prompt len, step, margin): {near_ties}")
    assert eng.tokens_generated == 6 * MAX_NEW
    assert eng.requests_completed == 6
    assert eng.block_pool.in_use() == eng.prefix_cache.cached_blocks()


def test_prefix_cache_hits_keep_greedy_parity(models):
    """Prompts sharing a 17-token system prefix adopt its cached blocks
    (prefix hits rise) and stay token-identical to an engine without
    the cache."""
    _, tm = models
    system = np.random.RandomState(11).randint(0, 128, 17).astype(np.int32)
    tails = _prompts(4, lens=(3, 9, 1, 6))
    prompts = [np.concatenate([system, t]) for t in tails]

    def serve(prefix_cache):
        eng = _engine(tm, prefix_cache=prefix_cache)
        first = eng.submit(prompts[0], max_new_tokens=MAX_NEW)
        eng.run_until_idle()
        rest = [eng.submit(p, max_new_tokens=MAX_NEW)
                for p in prompts[1:]]
        eng.run_until_idle()
        return ([r.result(timeout=1).tolist() for r in [first] + rest],
                eng)

    cached, eng = serve(True)
    plain, eng_plain = serve(False)
    assert cached == plain
    assert eng.prefix_hits == 3
    assert eng.prefix_hit_tokens == 3 * 16
    assert eng_plain.prefix_hits == 0
    assert eng.prefill_tokens < eng_plain.prefill_tokens


def test_seeded_streams_repeat(models):
    _, tm = models
    prompts = _prompts(5)

    def serve(seed0):
        eng = _engine(tm)
        reqs = [eng.submit(p, max_new_tokens=MAX_NEW, temperature=0.8,
                           top_p=0.9, top_k=20, seed=seed0 + i)
                if i % 2 else eng.submit(p, max_new_tokens=MAX_NEW)
                for i, p in enumerate(prompts)]
        eng.run_until_idle()
        return [r.result(timeout=1).tolist() for r in reqs]

    a, b, c = serve(77), serve(77), serve(1000)
    assert a == b
    assert [a[i] for i in (0, 2, 4)] == [c[i] for i in (0, 2, 4)]
    assert [a[i] for i in (1, 3)] != [c[i] for i in (1, 3)]


def test_eos_stops_the_stream(models):
    """eos on the first token (a final-chunk lane) and mid-decode (a
    decode lane): the stream ends at the eos token, the slot frees."""
    jm, tm = models
    prompts = _prompts(2)
    want = [_jax_stream(jm, p, MAX_NEW) for p in prompts]
    eng = _engine(tm)
    eos = [want[0][0], want[1][3]]
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW, eos_token_id=e)
            for p, e in zip(prompts, eos)]
    eng.run_until_idle()
    for r, w, e in zip(reqs, want, eos):
        assert r.generated == w[:w.index(e) + 1]
    assert eng.scheduler.occupancy() == 0


def test_counters_track_a_request(models):
    """One 5-token prompt, 3 new tokens, blocks of 8: a final-chunk
    dispatch and two decode dispatches, each walking one block.  At the
    default ``async_depth=2`` a fourth tick consumes the last dispatch
    (the bursty-tail cutoff: the in-flight tick already spends the
    budget); ``tests/test_torch_async_engine.py`` holds depth 1's three
    ticks."""
    _, tm = models
    eng = _engine(tm)
    req = eng.submit(_prompts(1)[0], max_new_tokens=3)
    eng.run_until_idle()
    assert len(req.generated) == 3
    assert (eng.ticks, eng.ragged_dispatches) == (4, 3)
    assert eng.kv_blocks_walked == 3
    assert (eng.prefill_tokens, eng.tokens_generated) == (5, 3)
    assert eng.requests_completed == 1


def test_gather_engine_greedy_matches_jax_generate(models):
    """attn_impl="ragged_gather" (the gather body, kernel B3's plain
    version here) serves the six prompts token-identically to JAX
    ``generate()``, as the streaming body does."""
    jm, tm = models
    prompts = _prompts(6)
    eng = _engine(tm, attn_impl="ragged_gather")
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.run_until_idle()
    streams = [r.result(timeout=1)[len(p):].tolist()
               for r, p in zip(reqs, prompts)]
    near_ties = _assert_greedy_parity(jm, prompts, streams)
    print(f"near-tie divergences (prompt len, step, margin): {near_ties}")
    assert eng.attn_impl == "ragged_gather"


def test_gather_counters_walk_the_whole_table(models):
    """The gather body walks every table entry of each dispatched slot:
    the request of ``test_counters_track_a_request`` walks 3 x 6 blocks
    (max_seq_len 48 / blocks of 8), where the streaming body walks 3."""
    _, tm = models
    eng = _engine(tm, attn_impl="ragged_gather")
    req = eng.submit(_prompts(1)[0], max_new_tokens=3)
    eng.run_until_idle()
    assert len(req.generated) == 3
    assert eng.ragged_dispatches == 3
    assert eng.kv_blocks_walked == 3 * 6


def test_block_pool_and_prefix_cache_match_jax_copies():
    """One sequence of pool and trie operations gives the same block ids
    and counts in the port's copy and in the JAX package's."""
    def script(kv):
        out = []
        pool = kv.BlockPool(12, 4, reserved_blocks=1)
        cache = kv.PrefixCache(pool)
        toks = list(range(100, 120))
        a = pool.alloc(5)
        cache.insert(toks, a)
        out += [a, pool.free_count(), cache.cached_blocks()]
        m = cache.match(toks[:13] + [7, 7])
        out.append(m)
        b = pool.alloc(3)
        out += [b, pool.refcount(a[0])]
        out.append(pool.decref(a))
        out.append(pool.decref(m[0]))
        out.append(sorted(cache.evict(2)))
        out += [pool.free_count(), pool.in_use(), pool.cow(b[0])]
        try:
            pool.alloc(50)
        except kv.NoFreeBlocks:
            out.append("no_free")
        out.append(kv.per_shard_block_bytes(16, 16, 64, "float32", 24))
        return out

    assert script(torch_kv) == script(jax_kv)


def test_package_imports_no_jax():
    """Every module of paddle_tpu_torch (the monitor, the proposers, the
    LoRA lanes, the host tier, the streams, the fault injector and the
    front ends and fleet among them), and
    chip_smoke.py, import without pulling in jax or the
    JAX package (exact module names: ``paddle_tpu_torch`` has
    ``paddle_tpu`` as a prefix)."""
    code = r"""
import importlib, importlib.util, pkgutil, sys
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    paddle_tpu_torch.__path__, prefix="paddle_tpu_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k in sys.modules
             if k in ("jax", "paddle_tpu") or k.startswith("jax.")
             or k.startswith("jaxlib") or k.startswith("paddle_tpu."))
new = {"paddle_tpu_torch.monitor", "paddle_tpu_torch.monitor.stats",
       "paddle_tpu_torch.monitor.exposition",
       "paddle_tpu_torch.monitor.tracing", "paddle_tpu_torch.serving.spec",
       "paddle_tpu_torch.serving.lora", "paddle_tpu_torch.serving.offload",
       "paddle_tpu_torch.serving.stream", "paddle_tpu_torch.serving.faults",
       "paddle_tpu_torch.serving.httpd", "paddle_tpu_torch.serving.router",
       "paddle_tpu_torch.serving.routerd",
       "paddle_tpu_torch.serving.supervisor",
       "paddle_tpu_torch.distributed.launch"}
assert new <= set(names), sorted(new - set(names))
print(len(names), bad)
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_mods = int(res.stdout.split()[0])
    assert n_mods >= 10


def test_no_silent_cpu():
    """Without ``device``, the model and the engine want the card: with
    no card they raise and name ``device="cpu"``."""
    if torch.cuda.is_available():
        m = GPTModel.from_config("tiny")
        assert m.head.lm_head.weight.is_cuda
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GPTModel.from_config("tiny")
    cpu_model = GPTModel.from_config("tiny", device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Engine(cpu_model, kv_block_size=8, prefill_chunk=8)


def test_engine_refuses_weights_elsewhere():
    with torch.device("meta"):
        m = GPTModel(num_layers=1, hidden_size=32, num_heads=2,
                     vocab_size=64, max_position=32)
    with pytest.raises(ValueError, match="never moves weights"):
        Engine(m, device="cpu", kv_block_size=8, prefill_chunk=8)


@pytest.mark.parametrize("knob", [
    # the mesh is ported; weight-only int8 over a dense dp mesh is not,
    # nor the XLA paths or the host-RAM tier over a mesh
    dict(mesh=ServingMesh(1, 2, devices=["cpu"] * 2), weight_dtype="int8"),
    dict(mesh=ServingMesh(1, 2, devices=["cpu"] * 2), attn_impl="xla"),
    dict(mesh=ServingMesh(1, 2, devices=["cpu"] * 2), prefill_chunk=None),
    dict(mesh=ServingMesh(1, 2, devices=["cpu"] * 2), kv_host_mb=64),
    dict(mesh=ServingMesh(1, 2, devices=["cpu"] * 2), kv_dtype="int8",
         kv_host_mb=64)])
def test_unported_knobs_raise(models, knob):
    """Every knob still unported raises naming its ROADMAP item, also
    beside the ported int8 and gather knobs (and before a weight relayout
    could touch the model)."""
    _, tm = models
    kw = dict(num_slots=2, max_seq_len=48, kv_block_size=8,
              prefill_chunk=8, device="cpu")
    kw.update(knob)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Engine(tm, **kw)


def test_step_failure_fails_requests_and_recovers(models, monkeypatch):
    """A dispatch that raises fails the bound requests loudly, rebuilds
    the pools, and the engine then serves again token-identically."""
    jm, tm = models
    prompts = _prompts(2)
    eng = _engine(tm)
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
    assert eng.block_pool.in_use() == 0
    again = eng.submit(prompts[0], max_new_tokens=MAX_NEW)
    eng.run_until_idle()
    assert again.generated == _jax_stream(jm, prompts[0], MAX_NEW)
