"""BERT and the transformer encoder in the port
(``paddle_tpu_torch.models.bert``, ``nn.layer.transformer``) held to the
JAX package on the ``tiny`` config with bridged weights
(``convert.load_paddle_tpu_state``) and numpy-seeded inputs.

* ``BertModel`` with and without a padding mask (the ``[B, S]`` mask as
  the additive ``[B, 1, 1, S]`` one): sequence output and pooled output
  at atol 1e-5 (f32, another summation order), unrolled and with
  ``scan_layers``.
* Both heads and ``BertPretrainingCriterion`` (with ignored labels).
* ``TransformerEncoder(scan_layers=True)`` equals the unrolled encoder
  with the same weights; ``MultiHeadAttention`` with ``need_weights``, a
  bool mask and its caches, and a pre-LN encoder layer, against JAX's.
* 3 ``TrainStep(amp_level="O1")`` losses of the classifier against JAX's
  (rtol 2e-2: bf16 rounding of every linear's inputs).
* The amp sites and dtypes of one BERT forward under O1 equal JAX's:
  the linears go to bf16, the masked attention stays as it comes
  (bf16 q, k, v beside the f32 mask), the GELU, tanh and norms are left
  alone.
"""
from collections import Counter

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import dispatch
from paddle_tpu.models import bert as jbert
from paddle_tpu.nn import functional as JF
from paddle_tpu.parallel.train_step import TrainStep as JaxTrainStep
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import (export_paddle_tpu_state,
                                      load_paddle_tpu_state)
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.nn import layer as tlayer
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.parallel import TrainStep

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 16


def _arrays(jm):
    return {n: np.asarray(p._data) for n, p in jm.named_parameters()}


def _pair(head=None, scan=False, dropout=0.0):
    paddle.seed(0)
    jm = jbert.BertModel.from_config("tiny", dropout=dropout,
                                     scan_layers=scan)
    torch.manual_seed(0)
    tm = bert.BertModel.from_config("tiny", device="cpu", dropout=dropout,
                                    scan_layers=scan)
    if head == "cls":
        jm = jbert.BertForSequenceClassification(jm, 2, dropout=dropout)
        tm = bert.BertForSequenceClassification(tm, 2, dropout=dropout)
    elif head == "mlm":
        jm, tm = jbert.BertForMaskedLM(jm), bert.BertForMaskedLM(tm)
    load_paddle_tpu_state(tm, _arrays(jm))
    jm.eval()
    tm.eval()
    return jm, tm


def _inputs(masked):
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 128, (B, S)).astype(np.int32)
    tt = (np.arange(S)[None] >= S // 2).astype(np.int32).repeat(B, 0)
    mask = None
    if masked:
        mask = np.ones((B, S), np.int32)
        mask[1, 11:] = 0
    return ids, tt, mask


def _run_jax(jm, ids, tt, mask):
    return jm(paddle.to_tensor(ids), paddle.to_tensor(tt),
              None if mask is None else paddle.to_tensor(mask))


def _run_port(tm, ids, tt, mask):
    return tm(torch.tensor(ids).long(), torch.tensor(tt).long(),
              None if mask is None else torch.tensor(mask))


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_bert_model_matches_jax(masked, scan):
    jm, tm = _pair(scan=scan)
    args = _inputs(masked)
    jseq, jpool = _run_jax(jm, *args)
    tseq, tpool = _run_port(tm, *args)
    np.testing.assert_allclose(tseq.detach().numpy(), jseq.numpy(), **TOL)
    np.testing.assert_allclose(tpool.detach().numpy(), jpool.numpy(), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_heads_and_criterion_match_jax(masked):
    args = _inputs(masked)
    jc, tc = _pair("cls")
    np.testing.assert_allclose(_run_port(tc, *args).detach().numpy(),
                               _run_jax(jc, *args).numpy(), **TOL)
    jl, tl = _pair("mlm")
    jscores = _run_jax(jl, *args)
    tscores = _run_port(tl, *args)
    assert tuple(tscores.shape) == (B, S, 128)
    np.testing.assert_allclose(tscores.detach().numpy(), jscores.numpy(),
                               **TOL)
    labels = np.random.RandomState(2).randint(0, 128, (B, S))
    labels[:, ::3] = -100
    labels = labels.astype(np.int32)
    want = jbert.BertPretrainingCriterion()(jscores,
                                            paddle.to_tensor(labels))
    got = bert.BertPretrainingCriterion()(tscores, torch.tensor(labels))
    np.testing.assert_allclose(float(got.detach()), float(want.numpy()),
                               rtol=1e-5)


def test_scan_encoder_equals_unrolled():
    torch.manual_seed(0)
    unrolled = bert.BertModel.from_config("tiny", device="cpu", dropout=0.0)
    scanned = bert.BertModel.from_config("tiny", device="cpu", dropout=0.0,
                                         scan_layers=True)
    load_paddle_tpu_state(scanned, export_paddle_tpu_state(unrolled))
    assert "encoder.layers.linear1.weight" in dict(
        scanned.named_parameters())
    args = _inputs(True)
    for a, b in zip(_run_port(unrolled.eval(), *args),
                    _run_port(scanned.eval(), *args)):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6)


def test_multi_head_attention_weights_and_caches_match_jax():
    """``need_weights`` with a bool mask (probabilities too), the growing
    ``Cache`` over two calls and a ``StaticCache``, against JAX's layer;
    and a pre-LN encoder layer with an additive mask."""
    paddle.seed(3)
    jmha = jnn.MultiHeadAttention(32, 4, need_weights=True)
    with torch.device("cpu"):  # a Layer builds on the card by default
        tmha = tlayer.MultiHeadAttention(32, 4, need_weights=True)
    load_paddle_tpu_state(tmha, _arrays(jmha))
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 32).astype(np.float32)
    mask = rng.rand(2, 1, 6, 6) > 0.3
    mask[..., 0] = True
    jo, jw = jmha(paddle.to_tensor(x), attn_mask=paddle.to_tensor(mask))
    to, tw = tmha(torch.tensor(x), attn_mask=torch.tensor(mask))
    np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), **TOL)
    np.testing.assert_allclose(tw.detach().numpy(), jw.numpy(), **TOL)
    for m in (jmha, tmha):
        m.need_weights = False
    jcache = jmha.gen_cache(paddle.to_tensor(x))
    tcache = tmha.gen_cache(torch.tensor(x))
    for part in (x[:, :2], x[:, 2:3]):
        jo, jcache = jmha(paddle.to_tensor(part), cache=jcache)
        to, tcache = tmha(torch.tensor(part), cache=tcache)
        np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), **TOL)
    assert tuple(tcache.k.shape) == (2, 3, 4, 8)
    jst = jmha.gen_cache(paddle.to_tensor(x), type=jmha.StaticCache)
    tst = tmha.gen_cache(torch.tensor(x), type=tmha.StaticCache)
    np.testing.assert_allclose(
        tmha(torch.tensor(x[:, :2]), cache=tst).detach().numpy(),
        jmha(paddle.to_tensor(x[:, :2]), cache=jst).numpy(), **TOL)
    paddle.seed(5)
    jlayer = jnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                         activation="gelu",
                                         normalize_before=True)
    with torch.device("cpu"):
        tlay = tlayer.TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                              activation="gelu",
                                              normalize_before=True)
    load_paddle_tpu_state(tlay, _arrays(jlayer))
    add = np.where(mask, 0.0, -1e4).astype(np.float32)
    np.testing.assert_allclose(
        tlay(torch.tensor(x), torch.tensor(add)).detach().numpy(),
        jlayer(paddle.to_tensor(x), paddle.to_tensor(add)).numpy(), **TOL)


def test_o1_train_steps_match_jax():
    """The classifier under ``TrainStep(amp_level="O1")`` with AdamW over
    3 steps on one padded batch: losses at rtol 2e-2, falling."""
    jm, tm = _pair("cls")
    ids, tt, mask = _inputs(True)
    y = np.array([0, 1], np.int32)
    js = JaxTrainStep(jm, jopt.AdamW(learning_rate=1e-3,
                                     parameters=jm.parameters()),
                      loss_fn=JF.cross_entropy, amp_level="O1",
                      donate=False)
    ts = TrainStep(tm, topt.AdamW(learning_rate=1e-3,
                                  parameters=tm.parameters(), device="cpu"),
                   loss_fn=cross_entropy, amp_level="O1", device="cpu")
    jl = [float(np.asarray(js.step([ids, tt, mask], [y])))
          for _ in range(3)]
    tl = [float(ts.step([ids, tt, mask], [y])) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert tl[2] < tl[0]


SITES = {"linear", "layer_norm", "gelu", "tanh",
         "scaled_dot_product_attention_masked",
         "scaled_dot_product_attention"}


def _dt(x):
    if x is None or not hasattr(x, "dtype"):
        return None
    name = str(x.dtype).replace("torch.", "")
    return "int" if "int" in name else name


def test_amp_sites_of_a_forward_match_jax(monkeypatch):
    jrec, trec = [], []
    real_hook = dispatch.amp_input_hook

    def jhook(name, arrays):
        out = real_hook(name, arrays)
        jrec.append((name, tuple(map(_dt, arrays)), tuple(map(_dt, out))))
        return out

    real_cast = amp.cast_inputs

    def tcast(name, *ts):
        out = real_cast(name, *ts)
        trec.append((name, tuple(map(_dt, ts)), tuple(map(_dt, out))))
        return out

    monkeypatch.setattr(dispatch, "amp_input_hook", jhook)
    monkeypatch.setattr(amp, "cast_inputs", tcast)
    jm, tm = _pair("cls")
    args = _inputs(True)
    with jamp.auto_cast(level="O1"):
        jout = _run_jax(jm, *args)
    with amp.auto_cast(level="O1"):
        tout = _run_port(tm, *args)
    cast_names = {n for n, i, o in jrec if i != o}
    assert cast_names == {"linear"}, cast_names
    want = Counter(r for r in jrec if r[0] in SITES)
    assert Counter(trec) == want
    masked = [r for r in trec if r[0] == "scaled_dot_product_attention_masked"]
    assert len(masked) == 2 and all(
        r[1] == r[2] == ("bfloat16",) * 3 + ("float32",) for r in masked)
    np.testing.assert_allclose(tout.detach().float().numpy(),
                               np.asarray(jout.numpy(), np.float32),
                               rtol=2e-2, atol=2e-2)
