"""``GPTModel.generate`` and the draft-model proposer of the port, held to
the JAX package.

A JAX ``tiny`` GPT made from a seed is bridged into the port
(``load_paddle_tpu_state``) and both get the same numpy prompts.

- Greedy ``generate`` is token-identical to JAX's in each of the four
  modes (eager, ``compiled=True``, ``"fused"``, ``"speculative"``), equal
  across the modes, and each token is the dense forward's argmax;
  ``last_spec_forwards`` equals JAX's.  ``max_new_tokens=0``, the
  position overflow, the speculative margin and eos truncation behave as
  JAX's (tests/test_generation.py).
- Seeded runs repeat under one seed in every mode and stay in range (the
  port's splitmix64 keys cannot reproduce jax's threefry draws, so no
  seeded stream is compared with JAX's); the sampling filters equal
  JAX's ``_filter_logits`` at atol 1e-6.
- ``DraftModelProposer`` drafting with the target itself accepts every
  lane (6 proposed, 6 accepted, as tests/test_serving.py holds the JAX
  engine), and an int8 draft leaves the served streams unchanged
  (tests/test_quant_serving.py).

JAX is imported inside the fixtures, so the ``cuda`` test runs on a card
without it.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.quantization import WeightOnlyInt8Linear
from paddle_tpu_torch.serving import DraftModelProposer, Engine

torch.set_num_threads(1)

MODES = (False, True, "fused", "speculative")
ENGINE_KW = dict(num_slots=4, max_seq_len=48, kv_block_size=8,
                 prefill_chunk=8)


def _bridged(max_position=64, seed=0):
    import paddle_tpu as paddle
    from paddle_tpu.models import GPTModel as JaxGPT
    paddle.seed(seed)
    jm = JaxGPT.from_config("tiny", dropout=0.0, max_position=max_position)
    jm.eval()
    tm = GPTModel.from_config("tiny", device="cpu", dropout=0.0,
                              max_position=max_position)
    load_paddle_tpu_state(
        tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _bridged()


@pytest.fixture(scope="module")
def long_models():
    """max_position 256, as JAX's speculative tests build the model."""
    return _bridged(max_position=256)


def _jax_generate(jm, ids, **kw):
    import paddle_tpu as paddle
    return jm.generate(paddle.to_tensor(np.asarray(ids, np.int32)),
                       **kw).numpy()


def _port(tm, ids, **kw):
    return tm.generate(np.asarray(ids, np.int32), **kw).numpy()


def _dense_argmax_chain(tm, ids, n):
    """The greedy continuation by full re-forwards (no cache)."""
    seq = torch.as_tensor(np.asarray(ids, np.int64))
    with torch.no_grad():
        for _ in range(n):
            nxt = tm(seq)[:, -1].argmax(-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    return seq.numpy()


@pytest.mark.parametrize("mode", MODES, ids=["eager", "compiled", "fused",
                                             "speculative"])
def test_greedy_matches_jax_in_each_mode(models, mode):
    """Token-identical to JAX's ``generate`` in the same mode (B=2)."""
    jm, tm = models
    ids = np.random.RandomState(3).randint(0, 128, (2, 5)).astype(np.int32)
    want = _jax_generate(jm, ids, max_new_tokens=7, compiled=mode)
    got = _port(tm, ids, max_new_tokens=7, compiled=mode)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 12)


def test_greedy_identical_across_modes_and_dense_argmax(models):
    """Every mode gives the same tokens, each the dense forward's argmax
    over prompt + output (tests/test_generation.py's full re-forward)."""
    _, tm = models
    ids = np.random.RandomState(0).randint(0, 128, (2, 6)).astype(np.int32)
    outs = [_port(tm, ids, max_new_tokens=9, compiled=m) for m in MODES]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    np.testing.assert_array_equal(outs[0], _dense_argmax_chain(tm, ids, 9))


def test_speculative_forwards_match_jax(long_models):
    """The prompts of JAX's ``test_exactness_vs_fused``: tokens and the
    forward count equal JAX's speculative run, the tokens equal the fused
    ones."""
    jm, tm = long_models
    rs = np.random.RandomState(0)
    for prompt in (rs.randint(0, 128, (1, 16)).astype(np.int32),
                   np.tile(np.array([5, 9, 17, 23], np.int32), 8)[None, :]):
        want = _jax_generate(jm, prompt, max_new_tokens=20,
                             compiled="speculative")
        got = _port(tm, prompt, max_new_tokens=20, compiled="speculative")
        np.testing.assert_array_equal(got, want)
        assert tm.last_spec_forwards == jm.last_spec_forwards
        assert 1 <= tm.last_spec_forwards <= 20
        np.testing.assert_array_equal(
            got, _port(tm, prompt, max_new_tokens=20, compiled="fused"))


def test_batched_speculative_matches_jax(long_models):
    """B=3 rows accepting at different rates advance by the batch minimum:
    every row stays its fused greedy trajectory, and the forward count
    equals JAX's (``test_batched_exactness_vs_fused``'s prompts)."""
    jm, tm = long_models
    rs = np.random.RandomState(6)
    prompts = np.concatenate(
        [np.tile(np.array([5, 9, 17, 23], np.int32), 4)[None, :],
         rs.randint(0, 128, (1, 16)).astype(np.int32),
         np.zeros((1, 16), np.int32)])
    want = _jax_generate(jm, prompts, max_new_tokens=18,
                         compiled="speculative")
    got = _port(tm, prompts, max_new_tokens=18, compiled="speculative")
    np.testing.assert_array_equal(got, want)
    assert tm.last_spec_forwards == jm.last_spec_forwards
    np.testing.assert_array_equal(
        got, _port(tm, prompts, max_new_tokens=18, compiled="fused"))


def test_zero_new_tokens_returns_the_prompt(models):
    _, tm = models
    ids = np.random.RandomState(9).randint(0, 128, (2, 5)).astype(np.int32)
    for mode in MODES:
        np.testing.assert_array_equal(
            _port(tm, ids, max_new_tokens=0, compiled=mode), ids)


def test_argument_checks_as_jax(models):
    """Position overflow and the speculative margin raise ValueError, as
    JAX's do."""
    jm, tm = models
    max_pos = tm.embeddings.position_embeddings.weight.shape[0]
    long = np.zeros((1, max_pos - 2), np.int32)
    with pytest.raises(ValueError, match="max_position"):
        _port(tm, long, max_new_tokens=8)
    with pytest.raises(ValueError):
        _jax_generate(jm, long, max_new_tokens=8)
    one = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match="max_position|draft_k"):
        _port(tm, one, max_new_tokens=50, compiled="speculative",
              draft_k=16)
    with pytest.raises(ValueError, match="max_position|draft_k"):
        _jax_generate(jm, one, max_new_tokens=50, compiled="speculative",
                      draft_k=16)


def test_eos_truncation_as_jax(models):
    """An eos equal to the first generated token stops every mode right
    after it, as JAX's eager loop and fused truncation do; an eos that
    only some rows emit truncates nothing."""
    jm, tm = models
    ids = np.zeros((1, 3), np.int32)
    full = _port(tm, ids, max_new_tokens=8)
    eos = int(full[0, 3])
    want = _jax_generate(jm, ids, max_new_tokens=8, eos_token_id=eos,
                         compiled="fused")
    assert want.shape[1] == 4
    for mode in MODES:
        got = _port(tm, ids, max_new_tokens=8, eos_token_id=eos,
                    compiled=mode)
        np.testing.assert_array_equal(got, want)
    two = np.random.RandomState(1).randint(0, 128, (2, 4)).astype(np.int32)
    ref = _port(tm, two, max_new_tokens=6)
    row0_only = next(int(t) for t in ref[0, 4:] if t not in ref[1, 4:])
    for mode in ("fused", False):
        np.testing.assert_array_equal(
            _port(tm, two, max_new_tokens=6, eos_token_id=row0_only,
                  compiled=mode), ref)


@pytest.mark.parametrize("mode", MODES, ids=["eager", "compiled", "fused",
                                             "speculative"])
def test_seeded_sampling_repeats_and_stays_in_range(models, mode):
    """top-k / top-p draws repeat under one seed, stay in the vocabulary,
    and another seed gives another stream."""
    _, tm = models
    ids = np.zeros((2, 3), np.int32)
    kw = dict(max_new_tokens=8, top_k=8, top_p=0.9, temperature=0.9,
              compiled=mode)
    a = _port(tm, ids, seed=7, **kw)
    np.testing.assert_array_equal(a, _port(tm, ids, seed=7, **kw))
    assert a.shape == (2, 11) and (a >= 0).all() and (a < 128).all()
    assert not np.array_equal(a, _port(tm, ids, seed=8, **kw))


def test_seeded_draws_shared_by_the_step_modes(models):
    """The eager, fixed-buffer and fused modes draw token i of row r with
    key(seed, i * B + r), so on the same logits they give the same
    sampled stream; ``top_p`` near 0 and ``top_p=0`` keep the top token
    only (greedy); temperature alone samples."""
    _, tm = models
    ids = np.zeros((2, 3), np.int32)
    kw = dict(max_new_tokens=6, top_k=5, temperature=0.8, seed=11)
    outs = [_port(tm, ids, compiled=m, **kw) for m in (False, True, "fused")]
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[2], outs[0])
    greedy = _port(tm, ids, max_new_tokens=6)
    for p in (1e-6, 0.0):
        np.testing.assert_array_equal(
            _port(tm, ids, max_new_tokens=6, top_p=p, seed=7), greedy)
    hot = _port(tm, ids, max_new_tokens=6, temperature=5.0, seed=1)
    assert not np.array_equal(hot, greedy)


def test_filter_logits_matches_jax():
    """JAX's scalar ``_filter_logits`` (temperature, top-k, top-p and all
    three) and the port's ``_filter_logits_lanes`` with every lane set
    alike, which ``generate`` samples through, on the same logits: atol
    1e-6."""
    import jax.numpy as jnp
    from paddle_tpu.models import GPTModel as JaxGPT
    logits = np.random.RandomState(2).randn(3, 50).astype(np.float32) * 3
    for t, k, p in ((0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.8),
                    (1.3, 10, 0.6), (1.0, 0, 0.0)):
        want = np.asarray(JaxGPT._filter_logits(jnp.asarray(logits), t, k,
                                                p))
        got = GPTModel._filter_logits_lanes(
            torch.from_numpy(logits), torch.full((3,), t),
            torch.full((3,), k, dtype=torch.int32),
            torch.full((3,), p)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_generate_in_bfloat16_runs(models):
    """A bf16 model generates with bf16 caches in every mode."""
    _, tm = models
    m = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    m.load_state_dict(tm.state_dict())
    m.to(torch.bfloat16)
    for mode in MODES:
        out = m.generate(np.zeros((1, 3), np.int32), max_new_tokens=2,
                         compiled=mode)
        assert tuple(out.shape) == (1, 5)


# -- the draft-model proposer ---------------------------------------------
def _serve(eng, prompts, max_new):
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_idle()
    return [r.result(timeout=5)[len(p):].tolist()
            for r, p in zip(reqs, prompts)]


def _prompts(n, lens=(5, 7, 3, 9)):
    rng = np.random.RandomState(7)
    return [rng.randint(0, 128, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


def test_draft_model_proposer_self_draft_accepts_every_lane(models):
    """Drafting with the target itself: the stream equals JAX's
    ``generate``, and 9 post-prefill tokens take three windows emitting
    4 + 4 + 1 with 6 lanes proposed and 6 accepted (the last window
    proposes none: only the bonus token fits under max_new_tokens)."""
    jm, tm = models
    eng = Engine(tm, device="cpu", spec_k=3,
                 proposer=DraftModelProposer(tm), **ENGINE_KW)
    p = _prompts(1)[0]
    got = _serve(eng, [p], 10)[0]
    want = _jax_generate(jm, p[None], max_new_tokens=10)[0, len(p):]
    assert got == want.tolist()
    reg = eng.registry
    assert reg.get("serving.spec_proposed").value == 6
    assert reg.get("serving.spec_accepted").value == 6
    assert reg.get("serving.spec_acceptance_rate").value == 1.0
    assert eng.proposer.vocab_size == 128


def test_draft_model_proposer_cuts_the_history_to_its_positions(models):
    """A history longer than the draft's position table keeps its tail,
    as JAX's proposer does: the draft is ``generate`` of that tail."""
    _, tm = models
    prop = DraftModelProposer(tm)
    h = np.random.RandomState(4).randint(0, 128, 100).astype(np.int32)
    d = prop.propose(h, 3)
    tail = h[-(64 - 3):]
    want = tm.generate(tail[None], max_new_tokens=3).numpy()[0, len(tail):]
    np.testing.assert_array_equal(d, want)
    assert prop.propose(h, 64).size == 0


def test_quantized_draft_proposer(models):
    """``weight_dtype="int8"`` relayouts the draft; the engine still emits
    exactly the target's own tokens.  Other dtypes raise."""
    _, tm = models
    draft = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    with pytest.raises(ValueError, match="weight_dtype"):
        DraftModelProposer(draft, weight_dtype="fp16")
    draft.load_state_dict(tm.state_dict())
    prompts = _prompts(2)
    ref = _serve(Engine(tm, device="cpu", **ENGINE_KW), prompts, 8)
    prop = DraftModelProposer(draft, weight_dtype="int8")
    assert isinstance(draft.blocks[0].attn.qkv_proj, WeightOnlyInt8Linear)
    eng = Engine(tm, device="cpu", spec_k=2, proposer=prop, **ENGINE_KW)
    assert _serve(eng, prompts, 8) == ref
    assert eng.registry.get("serving.spec_proposed").value > 0


def test_draft_vocab_mismatch_refused(models):
    """The engine refuses a draft with another vocabulary (JAX's check)."""
    _, tm = models
    other = GPTModel.from_config("tiny", device="cpu", dropout=0.0,
                                 vocab_size=64)
    with pytest.raises(ValueError, match="proposer vocab"):
        Engine(tm, device="cpu", spec_k=2,
               proposer=DraftModelProposer(other), **ENGINE_KW)


# -- on the card ----------------------------------------------------------
@pytest.mark.cuda
def test_generate_and_draft_serve_on_card():
    """``generate`` in every mode and a draft-model speculative serve on
    the card, held to the same calls on the CPU model with the same state:
    greedy tokens equal, except from a first divergence at a near tie
    (top-2 margin under 1e-4 of the CPU model's logits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ragged kernel runs only there")
    cpu = GPTModel.from_config("tiny", device="cpu", seed=0, dropout=0.0)
    card = GPTModel.from_config("tiny", device="cuda", dropout=0.0)
    card.load_state_dict(cpu.state_dict())
    card.eval()
    cpu.eval()

    def near_tie_or_equal(p, a, b):
        if a == b:
            return
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        with torch.no_grad():
            row = cpu(torch.tensor([list(p) + b[:t]]))[0, -1]
        top2 = row.topk(2).values
        assert float(top2[0] - top2[1]) < 1e-4

    ids = np.random.RandomState(0).randint(0, 128, (2, 6)).astype(np.int32)
    for mode in MODES:
        got = card.generate(ids, max_new_tokens=9, compiled=mode).cpu()
        want = cpu.generate(ids, max_new_tokens=9, compiled=mode)
        for p, a, b in zip(ids, got[:, 6:].tolist(), want[:, 6:].tolist()):
            near_tie_or_equal(p, a, b)
    prompts = _prompts(4)
    kw = dict(ENGINE_KW, spec_k=3)
    got = _serve(Engine(card, proposer=DraftModelProposer(card), **kw),
                 prompts, 8)
    want = _serve(Engine(cpu, device="cpu", proposer=DraftModelProposer(cpu),
                         **kw), prompts, 8)
    for p, a, b in zip(prompts, got, want):
        near_tie_or_equal(p, a, b)
