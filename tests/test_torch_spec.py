"""Speculative decoding in the port, held to the non-speculative engine
and to the JAX package.

``Engine(spec_k=k)`` widens every decode lane of the ragged window to a
k+1 verify window drafted by a ``serving.spec`` proposer; the dispatch's
epilogue accepts the longest matching prefix plus one bonus token.
Greedy streams must equal the non-speculative port engine's and JAX
``GPTModel.generate()``'s on the same bridged weights, at both pipeline
depths, over fp and int8 pools and on the ``(1, 2)`` CPU mesh; the
acceptance metrics must count exactly (as ``tests/test_serving.py``'s
spec tests hold the JAX engine).  JAX is imported inside the fixtures.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import ServingMesh
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving.spec import (DraftModelProposer,
                                           PromptLookupProposer, Proposer)

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


def _repetitive_prompts():
    """Prompts whose n-grams repeat, so prompt lookup drafts something."""
    rng = np.random.RandomState(5)
    return [np.tile(rng.randint(0, 128, n).astype(np.int32), 3)
            for n in (3, 5, 4, 2)]


def _serve(eng, prompts, max_new=MAX_NEW):
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_idle()
    return [r.result(timeout=5)[len(p):].tolist()
            for r, p in zip(reqs, prompts)]


class _OracleProposer(Proposer):
    """Drafts the target's own greedy continuation (precomputed): every
    lane matches, so the acceptance accounting is exactly predictable."""

    def __init__(self, ref_ids):
        self.ref = [int(x) for x in ref_ids]

    def propose(self, history, k):
        n = len(history)
        assert self.ref[:n] == [int(x) for x in history]
        return np.asarray(self.ref[n:n + k], np.int32)


CASES = {
    "fp_k3": dict(spec_k=3),
    "fp_k2_depth1": dict(spec_k=2, async_depth=1),
    "gather_k3": dict(spec_k=3, attn_impl="ragged_gather"),
    "mesh_1x2_k3": dict(spec_k=3, mesh=ServingMesh(1, 2,
                                                   devices=["cpu"] * 2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_greedy_matches_nonspec_and_jax(models, generate, case):
    """Greedy speculative streams equal the non-speculative engine's and
    JAX ``generate()``'s.  Prompt lookup over unigrams drafts whenever the
    last token occurred before, so the windows carry real drafts."""
    _, tm = models
    kw = dict(CASES[case])
    prompts = _prompts(6) + _repetitive_prompts()
    eng = Engine(tm, device="cpu", proposer=PromptLookupProposer(ngram=1),
                 **ENGINE_KW, **kw)
    got = _serve(eng, prompts)
    kw.pop("spec_k")
    assert got == _serve(Engine(tm, device="cpu", **ENGINE_KW, **kw),
                         prompts)
    assert got == [generate(p, MAX_NEW) for p in prompts]
    reg = eng.registry
    assert reg.get("serving.spec_proposed").value > 0
    assert reg.get("serving.spec_windows").value > 0
    assert eng._wmax == max(8, eng._spec_k + 1)
    assert eng.block_pool.in_use() == eng.prefix_cache.cached_blocks()


def test_spec_int8_pools_match_the_jax_engine(models):
    """Over int8 pools the speculative streams equal the JAX engine's with
    the same knobs (rejected lanes re-quantize the blocks they land in, in
    both packages alike)."""
    from paddle_tpu import monitor as jax_monitor
    from paddle_tpu.serving import Engine as JaxEngine
    jm, tm = models
    prompts = _prompts(4) + _repetitive_prompts()[:2]
    want = _serve(JaxEngine(jm, attn_impl="ragged", kv_dtype="int8",
                            spec_k=3, registry=jax_monitor.StatRegistry(),
                            **ENGINE_KW), prompts)
    got = _serve(Engine(tm, device="cpu", kv_dtype="int8", spec_k=3,
                        **ENGINE_KW), prompts)
    assert got == want


@pytest.mark.parametrize("depth", [1, 2])
def test_spec_acceptance_accounting_exact(models, generate, depth):
    """``tests/test_serving.py::test_spec_acceptance_accounting_exact``:
    an oracle proposer accepts every lane, so the 11 tokens after the
    final chunk's first take windows emitting 4 + 4 + 3, proposing 3 + 3
    + 2 lanes (the last window only what the request can still take)."""
    _, tm = models
    p = _prompts(1)[0]
    ref = list(p) + generate(p, 12)
    eng = Engine(tm, device="cpu", spec_k=3, async_depth=depth,
                 proposer=_OracleProposer(ref), **ENGINE_KW)
    req = eng.submit(p, max_new_tokens=12)
    eng.run_until_idle()
    assert req.result(timeout=1).tolist() == ref
    reg = eng.registry
    assert reg.get("serving.spec_proposed").value == 8
    assert reg.get("serving.spec_accepted").value == 8
    assert reg.get("serving.spec_windows").value == 3
    assert reg.get("serving.spec_acceptance_rate").value == 1.0
    assert reg.get("serving.spec_tokens_per_tick").value == 3.0
    assert reg.get("serving.tokens_total").value == 12


def test_spec_empty_proposer_counts_nothing(models, generate):
    """``tests/test_serving.py::test_spec_empty_proposer_counts_nothing``:
    a proposer that never drafts runs the window on pad filler — one
    token a window, outputs exact, no pad lane counted as proposed or
    accepted."""

    class _Never(Proposer):
        def propose(self, history, k):
            return np.zeros(0, np.int32)

    _, tm = models
    eng = Engine(tm, device="cpu", spec_k=4, proposer=_Never(), **ENGINE_KW)
    p = _prompts(1)[0]
    req = eng.submit(p, max_new_tokens=6)
    eng.run_until_idle()
    assert req.generated == generate(p, 6)
    reg = eng.registry
    assert reg.get("serving.spec_windows").value == 5
    assert reg.get("serving.spec_proposed").value == 0
    assert reg.get("serving.spec_accepted").value == 0
    assert reg.get("serving.spec_acceptance_rate").value == 0.0


def test_spec_eos_inside_a_window_stops_the_stream(models, generate):
    """EOS drafted inside a verify window: the stream ends at it, the
    lane that drafted it counts as accepted, the slot frees."""
    _, tm = models
    p = _prompts(1)[0]
    want = generate(p, 12)
    eos = want[2]
    stop = want.index(eos) + 1
    eng = Engine(tm, device="cpu", spec_k=3,
                 proposer=_OracleProposer(list(p) + want), **ENGINE_KW)
    req = eng.submit(p, max_new_tokens=12, eos_token_id=eos)
    eng.run_until_idle()
    assert req.generated == want[:stop]
    assert eng.scheduler.occupancy() == 0
    assert eng.registry.get("serving.spec_accepted").value == stop - 1


def test_spec_raising_proposer_degrades(models, generate):
    """A proposer that raises costs its drafts, not the tick: the stream
    is exact, the failures are counted, nothing is proposed."""

    class _Broken(Proposer):
        def propose(self, history, k):
            raise RuntimeError("proposer outage")

    _, tm = models
    eng = Engine(tm, device="cpu", spec_k=2, proposer=_Broken(),
                 **ENGINE_KW)
    p = _prompts(1)[0]
    req = eng.submit(p, max_new_tokens=5)
    eng.run_until_idle()
    assert req.generated == generate(p, 5)
    reg = eng.registry
    # windows after tokens 1, 2 and 3 ask for 2, 2 and 1 lanes; the last
    # (one token left) asks for none
    assert reg.get("serving.proposer_failures").value == 3
    assert reg.get("serving.spec_proposed").value == 0
    assert "spec.proposer_failed" in {
        e["name"] for e in eng.chrome_trace()["traceEvents"]}


@pytest.fixture(scope="module")
def cyclic_model():
    """The tiny model trained (in the port) to emit a short cycle:
    prompt-lookup drafts then accept, as ``tests/test_serving.py``'s
    ``cyclic_gpt`` fixture makes them accept in the JAX package."""
    torch.manual_seed(3)
    m = GPTModel.from_config("tiny", device="cpu", seed=3, dropout=0.0,
                             max_position=128)
    cyc = torch.tensor(np.tile(np.array([11, 22, 33, 44]), 16))
    opt = torch.optim.Adam(m.parameters(), lr=5e-3)
    m.train()
    for _ in range(60):
        loss = m(cyc[None, :-1], labels=cyc[None, 1:])
        opt.zero_grad()
        loss.backward()
        opt.step()
    assert float(loss) < 0.1, float(loss)
    m.eval()
    return m


def test_spec_accepts_on_repetitive_workload(cyclic_model):
    """``tests/test_serving.py::test_spec_accepts_on_repetitive_workload``:
    on a cyclic model the prompt-lookup drafts accept — rate > 0.5, more
    than one accepted lane a window — in far fewer ticks than tokens,
    token-identical to the non-speculative engine."""
    prompts = [np.tile(np.array([11, 22, 33, 44], np.int32), 3),
               np.tile(np.array([22, 33, 44, 11], np.int32), 3)]
    n_new = 24
    kw = dict(num_slots=2, max_seq_len=64, kv_block_size=8,
              prefill_chunk=16)
    eng = Engine(cyclic_model, device="cpu", spec_k=4, **kw)
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    n_ticks = 0
    while not eng.scheduler.idle():
        eng.step()
        n_ticks += 1
    ref = Engine(cyclic_model, device="cpu", **kw)
    ref_reqs = [ref.submit(p, max_new_tokens=n_new) for p in prompts]
    ref.run_until_idle()
    assert [r.result(timeout=1).tolist() for r in reqs] == \
        [r.result(timeout=1).tolist() for r in ref_reqs]
    reg = eng.registry
    proposed = reg.get("serving.spec_proposed").value
    accepted = reg.get("serving.spec_accepted").value
    rate = reg.get("serving.spec_acceptance_rate").value
    assert proposed > 0 and rate == pytest.approx(accepted / proposed)
    assert rate > 0.5
    assert accepted / reg.get("serving.spec_windows").value > 1.0
    assert n_ticks < n_new / 2


def test_spec_validation(models):
    """``spec_k`` and ``proposer`` are validated as the JAX engine
    validates them; the window margin counts at submit;
    ``DraftModelProposer`` names its ROADMAP item."""
    _, tm = models
    with pytest.raises(ValueError, match="spec_k must be >= 1"):
        Engine(tm, device="cpu", spec_k=0, **ENGINE_KW)
    with pytest.raises(ValueError, match="leaves no room"):
        Engine(tm, device="cpu", spec_k=47, **ENGINE_KW)
    with pytest.raises(ValueError, match="proposer requires spec_k"):
        Engine(tm, device="cpu", proposer=PromptLookupProposer(),
               **ENGINE_KW)

    class _OtherVocab(Proposer):
        vocab_size = 64

    with pytest.raises(ValueError, match="proposer vocab"):
        Engine(tm, device="cpu", spec_k=2, proposer=_OtherVocab(),
               **ENGINE_KW)
    eng = Engine(tm, device="cpu", spec_k=4, **ENGINE_KW)
    assert isinstance(eng.proposer, PromptLookupProposer)
    eng.submit(np.arange(20, dtype=np.int32), max_new_tokens=24)
    with pytest.raises(ValueError, match="spec_k"):
        eng.submit(np.arange(20, dtype=np.int32), max_new_tokens=25)
    with pytest.raises(NotImplementedError, match="Queue A 13"):
        DraftModelProposer(tm)
