"""The port's AMP (``paddle_tpu_torch/amp``) held to the JAX package's.

* The casts happen at the same sites: a wrapper on the JAX package's
  ``core.dispatch.amp_input_hook`` (set inside the test) records each
  primitive's name with its input and output dtypes over one training
  step of a 2-layer GPT under O1 and under O2; a wrapper on the port's
  ``amp.cast_inputs`` records the port's.  The multisets agree over the
  port's sites, and every JAX primitive whose dtypes the hook changed
  is one of them.
* ``cast_inputs`` against ``_amp_hook`` for every list, level and custom
  list combination on f32, bf16 and int inputs: the same output dtypes.
* A 2-layer GPT's loss and gradients under ``auto_cast`` (O1) against
  JAX: loss at rtol 2e-2, each gradient within a relative L2 error of
  2e-2 (bf16 rounding of every matmul input).
* ``TrainStep(amp_level="O1")`` (attention through the flash op's plain
  version, ``FLASH_MIN_SEQ`` lowered to 128) and ``strategy.amp`` with
  ``use_pure_fp16`` (O2 on a model ``decorate``d to bf16) for 3 steps:
  losses at rtol 2e-2.
* A forward recomputed in backward (outside ``auto_cast``) casts as the
  first one did: O1 with recompute equals O1 without it (atol 1e-6).
* ``GradScaler`` in fp16 against JAX's over a gradient sequence with an
  inf: the skipped step, the scale halving and growing, the parameter
  and the state, exactly (the same float arithmetic).
"""
from collections import Counter

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import dispatch
from paddle_tpu.core.tensor import Parameter as JParam
from paddle_tpu.distributed.fleet.strategy import DistributedStrategy
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.parallel.train_step import TrainStep as JaxTrainStep
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.nn.functional import attention as attn_mod
from paddle_tpu_torch.parallel import TrainStep

torch.set_num_threads(1)

CFG = dict(num_layers=2, hidden_size=128, num_heads=2, vocab_size=128,
           max_position=128)
# the port's amp sites, under the JAX package's primitive names
SITES = {"linear", "layer_norm", "scaled_dot_product_attention", "gelu",
         "fused_linear_cross_entropy", "softmax_with_cross_entropy",
         "einsum"}


def _dt(x):
    if x is None or not hasattr(x, "dtype"):
        return None
    name = str(x.dtype).replace("torch.", "")
    return "int" if "int" in name else name


def _pair(seed, **kw):
    paddle.seed(seed)
    jm = JaxGPT(**CFG, dropout=0.0, fused_loss=True, **kw)
    tm = GPTModel(**CFG, dropout=0.0, fused_loss=True, **kw)
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


def _batch(seed, s=128):
    ids = np.random.RandomState(seed).randint(0, 128, (2, s + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


def _strategy(level):
    if level == "O1":
        return None
    s = DistributedStrategy()
    s.amp = True
    s.amp_configs["use_pure_fp16"] = True
    return s


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_cast_sites_match_jax(monkeypatch, level):
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
    jm, tm = _pair(1)
    if level == "O2":
        jamp.decorate(jm, level="O2")
        amp.decorate(tm, level="O2")
    x, y = _batch(2, s=32)
    js = JaxTrainStep(jm, jopt.AdamW(parameters=jm.parameters()),
                      amp_level=level if level == "O1" else None,
                      strategy=_strategy(level), donate=False)
    ts = TrainStep(tm, topt.AdamW(parameters=tm.parameters(), device="cpu"),
                   amp_level=level if level == "O1" else None,
                   strategy=_strategy(level), device="cpu")
    assert ts.amp_level == js.amp_level == level
    js.step([x, y])
    ts.step([x, y])
    cast_names = {n for n, i, o in jrec if i != o}
    assert cast_names and cast_names <= SITES, cast_names
    want = Counter(r for r in jrec if r[0] in SITES)
    assert Counter(trec) == want


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("custom", [None, "white", "black"])
def test_cast_inputs_matches_the_jax_hook(level, custom):
    import jax.numpy as jnp
    names = ["linear", "layer_norm", "gelu", "softmax_with_cross_entropy",
             "einsum", "matmul", "dropout", "scaled_dot_product_attention"]
    white = ["gelu"] if custom == "white" else None
    black = ["linear", "dropout"] if custom == "black" else None
    arrays = [jnp.zeros(2, jnp.float32), jnp.zeros(2, jnp.bfloat16),
              jnp.zeros(2, jnp.int32)]
    tensors = [torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16),
               torch.zeros(2, dtype=torch.int32)]
    for name in names:
        with jamp.auto_cast(level=level, custom_white_list=white,
                            custom_black_list=black):
            want = [_dt(a) for a in jamp._amp_hook(name, arrays)]
        with amp.auto_cast(level=level, custom_white_list=white,
                           custom_black_list=black):
            got = [_dt(t) for t in amp.cast_inputs(name, *tensors)]
        assert got == want, (name, got, want)
    assert [_dt(t) for t in amp.cast_inputs("linear", *tensors)] == \
        ["float32", "bfloat16", "int"]


def test_auto_cast_loss_and_grads_match_jax():
    jm, tm = _pair(3)
    x, y = _batch(4, s=64)
    with jamp.auto_cast(level="O1"):
        jloss = jm(paddle.to_tensor(x), labels=paddle.to_tensor(y))
    jloss.backward()
    with amp.auto_cast(level="O1"):
        tloss = tm(torch.tensor(x).long(), labels=torch.tensor(y).long())
    tloss.backward()
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()),
                               rtol=2e-2)
    tgrads = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        want = p.grad.numpy()
        got = tgrads[n].grad.numpy()
        if tgrads[n].dim() == 2 and "embeddings" not in n:
            got = got.T
        assert tgrads[n].grad.dtype == torch.float32
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 2e-2, (n, rel)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_train_step_amp_matches_jax(monkeypatch, level):
    monkeypatch.setattr(attn_mod, "FLASH_MIN_SEQ", 128)
    jm, tm = _pair(5)
    if level == "O2":
        jamp.decorate(jm, level="O2")
        amp.decorate(tm, level="O2")
        assert tm.blocks[0].mlp.fc1.weight.dtype == torch.bfloat16
    x, y = _batch(6)
    kw = dict(amp_level=level if level == "O1" else None,
              strategy=_strategy(level))
    js = JaxTrainStep(jm, jopt.AdamW(learning_rate=1e-3,
                                     parameters=jm.parameters()),
                      donate=False, **kw)
    ts = TrainStep(tm, topt.AdamW(learning_rate=1e-3,
                                  parameters=tm.parameters(),
                                  device="cpu"), device="cpu", **kw)
    for i in range(3):
        want = float(js.step([x, y]).numpy())
        got = ts.step([x, y])
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=2e-2,
                                   err_msg=f"step {i}")


def test_grad_scaler_fp16_matches_jax():
    scale_kw = dict(init_loss_scaling=8.0, incr_ratio=2.0, decr_ratio=0.5,
                    incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
    js, ts = jamp.GradScaler(**scale_kw), amp.GradScaler(**scale_kw)
    jp = JParam(paddle.to_tensor(np.ones(3, np.float32))._data)
    tp = torch.nn.Parameter(torch.ones(3))
    jo = jopt.SGD(learning_rate=0.5, parameters=[jp])
    to = topt.SGD(learning_rate=0.5, parameters=[tp], device="cpu")
    seq = [[1.0, 2.0, 3.0], [1.0, np.inf, 0.0], [0.5, 0.5, 0.5],
           [0.25, 0.0, 1.0], [np.nan, 1.0, 1.0], [1.0, 1.0, 1.0],
           [2.0, 2.0, 2.0]]
    scales, skipped = [], []
    with amp.auto_cast(dtype="float16"):
        for g in seq:
            g = np.asarray(g, np.float32)
            # the scaled gradient, as backward of scale(loss) gives it
            jp.grad = paddle.to_tensor(g * js.get_init_loss_scaling())
            tp.grad = torch.tensor(g * ts.get_init_loss_scaling())
            before = tp.detach().clone()
            js.step(jo)
            ts.step(to)
            skipped.append(bool(torch.equal(before, tp.detach())))
            scales.append(ts.get_init_loss_scaling())
            assert ts.get_init_loss_scaling() == js.get_init_loss_scaling()
            np.testing.assert_array_equal(tp.detach().numpy(), jp.numpy())
            assert ts.state_dict() == js.state_dict()
    assert skipped == [False, True, False, False, True, False, False]
    assert scales == [8.0, 4.0, 4.0, 8.0, 4.0, 4.0, 8.0]
    fresh = amp.GradScaler(**scale_kw)
    fresh.load_state_dict(ts.state_dict())
    assert fresh.state_dict() == ts.state_dict()
    assert float(ts.scale(torch.tensor(1.0))) == 8.0


@pytest.mark.parametrize("policy", [None, "dots", "everything"])
def test_recompute_under_auto_cast_casts_as_the_first_forward(monkeypatch,
                                                              policy):
    """Backward runs outside ``auto_cast``; the recomputed forward still
    casts as the first one did: loss and gradients under O1 with
    recompute equal those without it (atol 1e-6), through the flash op's
    plain version at S=128 and packed rows."""
    monkeypatch.setattr(attn_mod, "FLASH_MIN_SEQ", 128)
    x, y = (torch.tensor(a).long() for a in _batch(7))
    dl = torch.tensor([[64, 40, 24], [100, 0, 0]])
    out = []
    for rc in (False, True):
        m = GPTModel(**CFG, dropout=0.0, fused_loss=True, use_recompute=rc,
                     recompute_policy=policy)
        m.reset_parameters(8)
        with amp.auto_cast(level="O1"):
            loss = m(x, labels=y, doc_lens=dl)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    m.named_parameters()}))
    (l0, g0), (l1, g1) = out
    torch.testing.assert_close(l1, l0, rtol=0, atol=1e-6)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=1e-6, msg=n)
