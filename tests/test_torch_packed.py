"""Packed pretraining (several documents a row) in the port, held to the
JAX package's ``packed_doc_inputs`` / ``GPTModel.forward(doc_lens=)``.

* ``packed_doc_inputs``: position ids, document ids and label mask equal
  JAX's exactly, for full rows, padded rows, empty document slots and a
  1-D ``doc_lens``.
* The packed loss and its gradients against one JAX reference at S=128,
  on the dense route (the reference attention over the block-diagonal
  mask) and on the flash route (``FLASH_MIN_SEQ`` lowered to 128: the
  segment ids go into the flash op's plain version): loss at rtol 1e-5,
  gradients at rtol 1e-4 / atol 1e-6 (fp32; the two frameworks sum in
  another order).
* A packed row's loss equals the token-weighted loss of its documents
  run alone (rtol 1e-5), on both routes, and at least one padded row.
* Overflowing ``doc_lens`` and ``doc_lens`` with ``caches`` raise.
* ``GPTPretrainingCriterion`` against JAX (rtol 1e-6), with ignored
  labels.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models.gpt import packed_doc_inputs as jax_packed
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.models import (GPTModel, GPTPretrainingCriterion,
                                     packed_doc_inputs)
from paddle_tpu_torch.nn.functional import attention as attn_mod

torch.set_num_threads(1)

CFG = dict(num_layers=2, hidden_size=128, num_heads=2, vocab_size=128,
           max_position=128)
DOC_LENS = {
    "full_and_padded": ([[50, 40, 38], [100, 0, 0]], 128),
    "empty_slots": ([[3, 0, 2, 0], [0, 0, 0, 7], [7, 0, 0, 0]], 7),
    "one_row_1d": ([5, 3, 4], 16),
    "single_docs": ([[16], [9]], 16),
}


@pytest.mark.parametrize("case", sorted(DOC_LENS))
def test_packed_doc_inputs_equal_jax(case):
    dl, seq = DOC_LENS[case]
    want = [np.asarray(t.numpy()) for t in jax_packed(np.array(dl), seq)]
    got = packed_doc_inputs(torch.tensor(dl), seq)
    assert [g.dtype for g in got] == [torch.int32, torch.int32, torch.bool]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


SEQ = 128


@pytest.fixture(scope="module")
def jax_packed_reference():
    """A JAX GPT's packed loss and gradients at S=128, and its weights."""
    paddle.seed(7)
    jm = JaxGPT(**CFG, dropout=0.0, fused_loss=True)
    rng = np.random.RandomState(8)
    ids = rng.randint(0, 128, (2, SEQ)).astype(np.int32)
    labels = rng.randint(0, 128, (2, SEQ)).astype(np.int32)
    dl = np.array([[SEQ // 2 - 3, SEQ // 4, 5], [SEQ - 9, 0, 0]], np.int32)
    jl = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels),
            doc_lens=paddle.to_tensor(dl))
    jl.backward()
    return ({n: np.asarray(p._data) for n, p in jm.named_parameters()},
            (ids, labels, dl), float(jl.numpy()),
            {n: p.grad.numpy() for n, p in jm.named_parameters()})


@pytest.mark.parametrize("route", ["dense", "flash"])
def test_packed_loss_and_grads_match_jax(monkeypatch, jax_packed_reference,
                                         route):
    """One JAX reference at S=128 for both routes: the default gate sends
    it to the reference attention over the block-diagonal mask, the
    lowered one to the flash op's plain version with the segment ids."""
    arrays, (ids, labels, dl), jl, jgrads = jax_packed_reference
    calls = []
    real = attn_mod.flash_attention
    monkeypatch.setattr(attn_mod, "flash_attention",
                        lambda *a, **k: calls.append(a[3]) or real(*a, **k))
    if route == "flash":
        monkeypatch.setattr(attn_mod, "FLASH_MIN_SEQ", 128)
    tm = GPTModel(**CFG, dropout=0.0, fused_loss=True)
    load_paddle_tpu_state(tm, arrays)
    tl = tm(torch.tensor(ids).long(), labels=torch.tensor(labels).long(),
            doc_lens=torch.tensor(dl))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-5)
    tgrads = dict(tm.named_parameters())
    for n, want in jgrads.items():
        got = tgrads[n].grad.numpy()
        if got.ndim == 2 and "embeddings" not in n:
            got = got.T
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=n)
    if route == "flash":
        assert len(calls) == CFG["num_layers"]
        assert all(s is not None and tuple(s.shape) == (2, SEQ)
                   for s in calls)
    else:
        assert not calls


@pytest.mark.parametrize("route,seq", [("dense", 64), ("flash", 128)])
def test_packed_equals_per_document(monkeypatch, route, seq):
    """Each document alone (positions from 0, its own last label dropped)
    gives the same summed CE as its span of the packed row."""
    if route == "flash":
        monkeypatch.setattr(attn_mod, "FLASH_MIN_SEQ", 128)
    tm = GPTModel.from_config("tiny", device="cpu", dropout=0.0,
                              max_position=128, fused_loss=True)
    rng = np.random.RandomState(9)
    lens = [seq // 2 + 5, seq // 4, seq // 8]        # the row is padded
    row = rng.randint(0, 128, seq)
    nxt = rng.randint(0, 128, seq)
    with torch.no_grad():
        packed = tm(torch.tensor(row[None]), labels=torch.tensor(nxt[None]),
                    doc_lens=torch.tensor([lens]))
        total, count, off = 0.0, 0, 0
        for n in lens:
            lab = torch.tensor(nxt[None, off:off + n])
            lab[0, -1] = -100            # its target lies in the next doc
            loss = tm(torch.tensor(row[None, off:off + n]), labels=lab)
            total += float(loss) * (n - 1)
            count += n - 1
            off += n
    np.testing.assert_allclose(float(packed), total / count, rtol=1e-5)


def test_overflow_and_caches_raise():
    tm = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    with pytest.raises(ValueError, match="phantom"):
        packed_doc_inputs(torch.tensor([[5, 5]]), 8)
    ids = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="phantom"):
        tm(ids, labels=ids, doc_lens=torch.tensor([[6, 3]]))
    empty = torch.zeros(1, 0, 4, 16)
    with pytest.raises(ValueError, match="KV-cache"):
        tm(ids, caches=[(empty, empty)] * 2, doc_lens=torch.tensor([[8]]))


def test_pretraining_criterion_matches_jax():
    rng = np.random.RandomState(10)
    logits = rng.randn(2, 12, 40).astype(np.float32)
    labels = rng.randint(0, 40, (2, 12)).astype(np.int64)
    labels[0, :3] = -100
    jl = JaxCriterion()(paddle.to_tensor(logits, stop_gradient=False),
                        paddle.to_tensor(labels))
    t = torch.tensor(logits, requires_grad=True)
    tl = GPTPretrainingCriterion()(t, torch.tensor(labels))
    np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()),
                               rtol=1e-6)
