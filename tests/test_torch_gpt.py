"""The port's GPT model held to the JAX package's, through the weight
bridge.

A JAX ``GPTModel`` made from a seed is converted with
``paddle_tpu_torch.convert.load_paddle_tpu_state``; the same numpy inputs
then go through both.  Dense logits and one ragged window tick agree at
rtol 1e-5 / atol 1e-5 in fp32 (the two frameworks' matmuls and
reductions sum in other orders); the ragged tick's K/V pools agree row
for row, scratch-block writes included; the sampling filter agrees at
the same tolerance.  ``__graft_entry__.entry()``'s gpt2-medium forward
at B=2, S=512 agrees with the port's on the same weights at atol 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.models import GPT_CONFIGS, GPTModel, sample_rows

torch.set_num_threads(1)

# tiny (hd=16) and a 2-layer model with gpt2's head width hd=64
CONFIGS = {
    "tiny": dict(GPT_CONFIGS["tiny"]),
    "hd64": dict(num_layers=2, hidden_size=128, num_heads=2,
                 vocab_size=96, max_position=64),
}


def _pair(name):
    paddle.seed(0)
    jm = JaxGPT(**CONFIGS[name], dropout=0.0)
    jm.eval()
    tm = GPTModel(**CONFIGS[name], dropout=0.0)
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    load_paddle_tpu_state(tm, arrays)
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def tiny_pair():
    return _pair("tiny")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dense_logits_match_jax(name):
    jm, tm = _pair(name)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, CONFIGS[name]["vocab_size"], (2, 19))
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32))).numpy())
    with torch.no_grad():
        got = tm(torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_convert_refuses_bad_state(tiny_pair):
    jm, _ = tiny_pair
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = GPTModel(**CONFIGS["tiny"])
    missing = dict(arrays)
    missing.pop("head.lm_head.weight")
    with pytest.raises(ValueError, match="missing"):
        load_paddle_tpu_state(tm, missing)
    extra = dict(arrays, **{"head.lm_head.bias": np.zeros(128)})
    with pytest.raises(ValueError, match="unexpected"):
        load_paddle_tpu_state(tm, extra)
    bad = dict(arrays)
    # a torch-layout [out, in] weight is refused, not silently transposed
    bad["blocks.0.attn.qkv_proj.weight"] = \
        arrays["blocks.0.attn.qkv_proj.weight"].T
    with pytest.raises(ValueError, match="qkv_proj"):
        load_paddle_tpu_state(tm, bad)


def test_from_config_is_seeded_and_on_the_asked_device():
    a = GPTModel.from_config("tiny", device="cpu", seed=3)
    b = GPTModel.from_config("tiny", device="cpu", seed=3)
    c = GPTModel.from_config("tiny", device="cpu", seed=4)
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert pa.device.type == "cpu"
        assert torch.equal(pa, pb), n
        if n.endswith("weight") and "ln" not in n:
            assert not torch.equal(pa, pc), n
            assert abs(float(pa.detach().std()) - 0.02) < 0.01, n


def _window_inputs(seed=2):
    """Pools, tables and a mixed window: a decode lane, a prefill chunk
    whose offsets run past the table (range-masked), a parked slot and a
    full-width chunk."""
    cfg = CONFIGS["tiny"]
    H = cfg["num_heads"]
    hd = cfg["hidden_size"] // H
    bs, bps, NB, B, W = 8, 4, 14, 4, 8
    rng = np.random.RandomState(seed)
    k_pools = [rng.randn(NB, bs, H, hd).astype(np.float32)
               for _ in range(cfg["num_layers"])]
    v_pools = [rng.randn(NB, bs, H, hd).astype(np.float32)
               for _ in range(cfg["num_layers"])]
    tables = np.zeros((B, bps), np.int32)
    tables[0] = [1, 2, 3, 4]
    tables[1] = [5, 6, 7, 8]
    tables[3] = [9, 10, 11, 12]
    pos = np.array([13, 27, 0, 8], np.int32)
    width = np.array([1, 8, 0, 8], np.int32)
    toks = rng.randint(0, cfg["vocab_size"], (B, W)).astype(np.int32)
    return toks, k_pools, v_pools, tables, pos, width


def test_ragged_window_tick_matches_jax(tiny_pair):
    import jax.numpy as jnp
    jm, tm = tiny_pair
    toks, kp, vp, tables, pos, width = _window_inputs()
    with paddle.no_grad():
        want, jk, jv = jm._ragged_window_tick_slots(
            jnp.asarray(toks), [jnp.asarray(a) for a in kp],
            [jnp.asarray(a) for a in vp], jnp.asarray(tables),
            jnp.asarray(pos), jnp.asarray(width))
    tk = [torch.tensor(a) for a in kp]
    tv = [torch.tensor(a) for a in vp]
    with torch.no_grad():
        got, _, _ = tm._ragged_window_tick_slots(
            torch.tensor(toks), tk, tv, torch.tensor(tables),
            torch.tensor(pos), torch.tensor(width))
    want = np.asarray(want)
    for b, w in enumerate(width):
        np.testing.assert_allclose(got[b, :w].numpy(), want[b, :w],
                                   rtol=1e-5, atol=1e-5)
    bs = kp[0].shape[1]
    for layer in range(len(kp)):
        for pools, jpool, tpool in ((kp, jk, tk), (vp, jv, tv)):
            before = pools[layer].reshape(-1, *pools[layer].shape[2:])
            after_j = np.asarray(jpool[layer]).reshape(before.shape)
            after_t = tpool[layer].numpy().reshape(before.shape)
            changed_j = np.any(after_j != before, axis=(1, 2))
            changed_t = np.any(after_t != before, axis=(1, 2))
            # the same rows written, the scratch block's row 0 among them
            np.testing.assert_array_equal(changed_t, changed_j)
            assert changed_t[0] and not changed_t[1:bs].any()
            np.testing.assert_allclose(after_t, after_j, rtol=1e-5,
                                       atol=1e-5)


def test_ragged_window_paged_matches_slot_attn_oracle(tiny_pair):
    """One layer's ragged window equals ``_slot_attn`` (the gather-then-
    softmax oracle) over each slot's rows gathered through its table
    after the window's writes, on every real lane."""
    _, tm = tiny_pair
    toks, kp, vp, tables, pos, width = _window_inputs()
    attn = tm.blocks[0].attn
    x = torch.tensor(np.random.RandomState(4).randn(
        *toks.shape, attn.hidden_size).astype(np.float32))
    k_pool, v_pool = torch.tensor(kp[0]), torch.tensor(vp[0])
    tables_t, pos_t = torch.tensor(tables), torch.tensor(pos)
    with torch.no_grad():
        got, k_pool, v_pool = attn.ragged_window_paged(
            x, k_pool, v_pool, tables_t, pos_t, torch.tensor(width))
        qa, _, _ = attn._qkv_step(x)
        bs = k_pool.shape[1]
        k_rows = k_pool[tables_t.long()].flatten(1, 2)   # [B, L, H, hd]
        v_rows = v_pool[tables_t.long()].flatten(1, 2)
        want = attn._slot_attn(qa, k_rows, v_rows, pos_t)
    for b, w in enumerate(width):
        # lanes that stay inside the table (offsets past it are masked)
        w = min(int(w), tables.shape[1] * bs - int(pos[b]))
        torch.testing.assert_close(got[b, :w], want[b, :w], rtol=1e-5,
                                   atol=1e-5)


def test_ragged_window_matches_dense_forward(tiny_pair):
    """A prompt run through the ragged window in chunks gives the dense
    forward's logits at every position (the window writes its K/V
    through the table, later chunks read them back)."""
    _, tm = tiny_pair
    cfg = CONFIGS["tiny"]
    H, hd = cfg["num_heads"], cfg["hidden_size"] // cfg["num_heads"]
    bs, bps, W = 8, 4, 8
    ids = np.random.RandomState(5).randint(0, 128, (1, 21))
    pools = [[torch.zeros(bps + 1, bs, H, hd) for _ in range(2)]
             for _ in range(2)]
    tables = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    out = []
    with torch.no_grad():
        for p0 in range(0, 21, W):
            n = min(W, 21 - p0)
            toks = torch.zeros(1, W, dtype=torch.int32)
            toks[0, :n] = torch.tensor(ids[0, p0:p0 + n])
            lg, _, _ = tm._ragged_window_tick_slots(
                toks, [p[0] for p in pools], [p[1] for p in pools], tables,
                torch.tensor([p0], dtype=torch.int32),
                torch.tensor([n], dtype=torch.int32))
            out.append(lg[0, :n])
        dense = tm(torch.tensor(ids))[0]
    torch.testing.assert_close(torch.cat(out), dense, rtol=1e-5,
                               atol=1e-5)


def test_filter_logits_lanes_matches_jax():
    import jax.numpy as jnp
    rng = np.random.RandomState(3)
    last = rng.randn(5, 40).astype(np.float32) * 3
    temp = np.array([0.0, 0.8, 1.0, 1.3, 0.5], np.float32)
    top_k = np.array([0, 5, 0, 1, 12], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 1.0, 0.3], np.float32)
    want = np.asarray(JaxGPT._filter_logits_lanes(
        jnp.asarray(last), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p)))
    got = GPTModel._filter_logits_lanes(
        torch.tensor(last), torch.tensor(temp), torch.tensor(top_k),
        torch.tensor(top_p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sample_lanes_greedy_seeded_and_distribution():
    """Greedy lanes take the first maximum; a sampling lane repeats for
    one key and changes with the counter; top-k keeps only the top k;
    draws follow the filtered softmax."""
    last = torch.tensor([[0.0, 2.0, 2.0, -1.0],
                         [0.5, 1.0, 0.2, 0.1]])
    temp = torch.tensor([0.0, 1.0])
    top_k = torch.tensor([0, 2], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0])
    lo = torch.tensor([0, 11])
    hi = torch.tensor([0, 1])

    def draw(c):
        return sample_rows(last, temp, top_k, top_p, lo, hi,
                           torch.tensor([c, c], dtype=torch.int32)).tolist()

    picks = [draw(c) for c in range(4000)]
    assert all(p[0] == 1 for p in picks)      # first of the tied maxima
    assert draw(7) == draw(7)
    lane1 = np.array([p[1] for p in picks])
    assert set(lane1.tolist()) <= {0, 1}      # top-2 of lane 1
    assert len(set(lane1[:64].tolist())) == 2
    want = torch.softmax(torch.tensor([0.5, 1.0]), 0)[1].item()
    assert abs(lane1.mean() - want) < 0.03
    # an all-greedy batch never needs keys
    assert GPTModel._sample_lanes(last, torch.zeros(2), top_k, top_p,
                                  None).tolist() == [1, 1]


def test_entry_shape_forward_matches_jax():
    """``__graft_entry__.entry()``'s forward (gpt2-medium at full width and
    depth, seed 0, dropout 0, B=2, S=512) against the port's forward with
    the same weights carried across: logits at atol 1e-4 (f32 over 24
    layers in another summation order; measured 5.7e-6 at logits up to
    3.4)."""
    import __graft_entry__ as graft
    fn, (p_list, ids) = graft.entry()
    want = np.asarray(fn(p_list, ids))
    tm = GPTModel.from_config("gpt2-medium", device="cpu", dropout=0.0)
    names = sorted(n for n, _ in tm.named_parameters())
    assert len(names) == len(p_list)
    load_paddle_tpu_state(tm, {n: np.asarray(a)
                               for n, a in zip(names, p_list)})
    del p_list, fn
    tm.eval()
    with torch.no_grad():
        got = tm(torch.tensor(np.asarray(ids)).long()).numpy()
    assert got.shape == want.shape == (2, 512, 50304)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
