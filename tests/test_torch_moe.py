"""The port's Mixture-of-Experts (``paddle_tpu_torch.distributed.moe``)
and MoE GPT held to the JAX package on the same numpy-seeded inputs and
bridged weights (``convert.load_paddle_tpu_state``), in f32.

* ``top_k_gating`` / ``top_k_routing``: expert choices, slots and keep
  masks exactly; gates, dispatch / combine and the aux loss at rtol
  1e-6 (one softmax in f32, summed in another order).
* ``MoELayer``: the output and the gradients of the router and of every
  expert stack (and of the input) at rtol 1e-5 / atol 1e-6 (f32
  matmuls summed in another order), with drops (capacity factor 0.5).
* A tiny GPT with ``moe_experts=8, moe_every=1``: logits, the loss with
  the aux loss, and 3 ``TrainStep`` losses at dropout 0 (rtol 1e-5).
* The refusals JAX makes (``scan_layers``, ``to_tensor_parallel``), the
  aux loss under recompute, and the weight bridge (router and expert
  stacks carried without a transpose, their optimizer moments too).

The engine's streams of an MoE model are held in
tests/test_torch_moe_serving.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.parallel.train_step import TrainStep as JaxTrainStep
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import (export_optimizer_state,
                                      export_paddle_tpu_state,
                                      load_paddle_tpu_state)
from paddle_tpu_torch.distributed import moe
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.parallel import TrainStep

torch.set_num_threads(1)

CFG = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=128,
           max_position=64, dropout=0.0, moe_experts=8, moe_every=1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _arrays(jm):
    return {n: np.asarray(p._data) for n, p in jm.named_parameters()}


def _pair(capacity_factor=None, **kw):
    paddle.seed(0)
    jm = JaxGPT(**dict(CFG, **kw))
    tm = GPTModel(**dict(CFG, **kw))
    load_paddle_tpu_state(tm, _arrays(jm))
    if capacity_factor is not None:
        for m in (jm, tm):
            for blk in m.blocks:
                blk.mlp.capacity_factor = capacity_factor
    return jm, tm


@pytest.mark.parametrize("k,capacity", [(1, 3), (2, 7), (2, 40)])
def test_routing_and_gating_match_jax(k, capacity):
    import jax.numpy as jnp
    logits = np.random.RandomState(k + capacity).randn(40, 8) \
        .astype(np.float32)
    got = moe.top_k_routing(torch.tensor(logits), k, capacity)
    want = jmoe.top_k_routing(jnp.asarray(logits), k, capacity)
    for name, g, w in zip(("choice", "pos", "keep", "gates", "aux"), got,
                          want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, err_msg=name)
    if capacity < 40:
        assert not bool(got[2].all())      # some tokens dropped
    for name, g, w in zip(("dispatch", "combine", "aux"),
                          moe.top_k_gating(torch.tensor(logits), k, capacity),
                          jmoe.top_k_gating(jnp.asarray(logits), k,
                                            capacity)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_moe_layer_forward_and_grads_match_jax():
    paddle.seed(1)
    jl = jmoe.MoELayer(32, num_experts=4, capacity_factor=0.5)
    tl = moe.MoELayer(32, num_experts=4, capacity_factor=0.5)
    load_paddle_tpu_state(tl, _arrays(jl))
    rng = np.random.RandomState(2)
    x, do = (rng.randn(2, 12, 32).astype(np.float32) for _ in range(2))
    jx = paddle.to_tensor(x, stop_gradient=False)
    jo = jl(jx)
    jloss = (jo * paddle.to_tensor(do)).sum() + jl.aux_loss()
    jloss.backward()
    tx = torch.tensor(x, requires_grad=True)
    to = tl(tx)
    tloss = (to * torch.tensor(do)).sum() + tl.aux_loss()
    tloss.backward()
    np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), **TOL)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()),
                               rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL)
    jp = dict(jl.named_parameters())
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jp[name].grad.numpy(),
                                   err_msg=name, **TOL)
    # capacity 0.5 * 24 * 2 / 4 = 6 slots an expert for 48 choices
    keep = moe.top_k_routing(torch.tensor(x).reshape(24, 32)
                             @ tl.gate.detach(), 2, 6)[2]
    assert int((~keep).sum()) > 0


def test_moe_gpt_logits_and_loss_with_aux_match_jax():
    jm, tm = _pair(capacity_factor=0.5)
    assert [type(b.mlp).__name__ for b in tm.blocks] == ["MoELayer"] * 2
    ids = np.random.RandomState(3).randint(0, 128, (2, 17)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]
    jlog = jm(paddle.to_tensor(x)).numpy()
    tlog = tm(torch.tensor(x).long())
    np.testing.assert_allclose(tlog.detach().numpy(), jlog, rtol=1e-5,
                               atol=1e-5)
    jloss = jm(paddle.to_tensor(x), labels=paddle.to_tensor(y))
    jtot = float((jloss + jmoe.collect_moe_aux_loss(jm)).numpy())
    tloss = tm(torch.tensor(x).long(), labels=torch.tensor(y).long())
    aux = moe.collect_moe_aux_loss(tm)
    assert aux is not None and float(aux.detach()) > 0
    np.testing.assert_allclose(float((tloss + aux).detach()), jtot,
                               rtol=1e-5)


def _steps(jm, tm, x, y, n=3):
    js = JaxTrainStep(jm, jopt.AdamW(learning_rate=1e-2,
                                     parameters=jm.parameters()),
                      donate=False)
    ts = TrainStep(tm, topt.AdamW(learning_rate=1e-2,
                                  parameters=tm.parameters(), device="cpu"),
                   device="cpu")
    jl = [float(np.asarray(js.step([x, y]))) for _ in range(n)]
    tx, ty = torch.tensor(x).long(), torch.tensor(y).long()
    tl = [float(ts.step([tx, ty])) for _ in range(n)]
    return jl, tl


def test_train_step_adds_the_aux_loss_as_jax():
    """3 AdamW steps: the losses (CE + aux) at rtol 1e-5, falling; the
    router and expert stacks move."""
    jm, tm = _pair()
    ids = np.random.RandomState(4).randint(0, 128, (2, 17)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]
    before = tm.blocks[0].mlp.experts.w1.detach().clone()
    jl, tl = _steps(jm, tm, x, y)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[2] < tl[0]
    assert not torch.equal(before, tm.blocks[0].mlp.experts.w1.detach())


def test_recompute_adds_the_aux_once():
    """Under ``use_recompute`` the recomputed forward in backward runs the
    MoE again, but the aux loss enters each step's loss once: the losses
    equal the non-recompute run's.  (The JAX package's own MoE under
    recompute raises UnexpectedTracerError in its train step: the aux
    tracer leaks out of ``jax.checkpoint``.)"""
    ids = np.random.RandomState(5).randint(0, 128, (2, 17))
    x, y = torch.tensor(ids[:, :-1]), torch.tensor(ids[:, 1:])
    losses = []
    for rc in (False, True):
        torch.manual_seed(0)
        tm = GPTModel(**dict(CFG, use_recompute=rc))
        tm.reset_parameters(0)
        ts = TrainStep(tm, topt.AdamW(learning_rate=1e-2,
                                      parameters=tm.parameters(),
                                      device="cpu"), device="cpu")
        losses.append([float(ts.step([x, y])) for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)


def test_bridge_carries_router_and_experts_without_a_transpose():
    jm, tm = _pair()
    want = _arrays(jm)
    got = export_paddle_tpu_state(tm)
    assert got["blocks.0.mlp.gate"].shape == (64, 8)
    assert got["blocks.0.mlp.experts.w1"].shape == (8, 64, 256)
    assert got["blocks.0.mlp.experts.w2"].shape == (8, 256, 64)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    opt = topt.AdamW(learning_rate=1e-2, parameters=tm.parameters(),
                     device="cpu")
    ts = TrainStep(tm, opt, device="cpu")
    ids = torch.randint(0, 128, (2, 9))
    ts.step([ids[:, :-1], ids[:, 1:]])
    state = export_optimizer_state(opt, tm)
    params = dict(tm.named_parameters())
    moe_keys = [k for k in state if ".mlp." in k and "moment" in k]
    assert len(moe_keys) == 2 * 5 * 2      # 2 moments, 5 params, 2 layers
    for k in moe_keys:
        name = k.split("__")[0]
        assert state[k].shape == tuple(params[name].shape), k
    for name in ("blocks.1.mlp.gate", "blocks.1.mlp.experts.w2"):
        np.testing.assert_array_equal(
            state[f"{name}__moment1"],
            opt.state[params[name]]["moment1"].numpy())


def test_moe_refusals_match_jax():
    for kw in (dict(scan_layers=True),):
        with pytest.raises(ValueError, match="scan_layers supports"):
            JaxGPT(**dict(CFG, **kw))
        with pytest.raises(ValueError, match="scan_layers supports"):
            GPTModel(**dict(CFG, **kw))
    with pytest.raises(ValueError, match="moe_every must be >= 1"):
        GPTModel(**dict(CFG, moe_every=0))
    jm, tm = _pair()
    with pytest.raises(ValueError, match="MoE blocks"):
        jm.to_tensor_parallel()
    with pytest.raises(ValueError, match="MoE blocks"):
        tm.to_tensor_parallel()
    # moe_every=2: blocks 2, 4, ... (1-based) are MoE, as in JAX
    m = GPTModel(**dict(CFG, num_layers=4, moe_every=2))
    assert [type(b.mlp).__name__ for b in m.blocks] == \
        ["GPTMLP", "MoELayer", "GPTMLP", "MoELayer"]


def test_o1_leaves_the_moe_ffn_in_f32_as_jax(monkeypatch):
    """Under O1 the amp sites of an MoE GPT forward (with its loss) and
    their dtypes equal JAX's: ``moe_ffn`` is on no list, so the router and
    experts run in f32 while the attention's linears go to bf16."""
    from collections import Counter
    from paddle_tpu import amp as jamp
    from paddle_tpu.core import dispatch
    from paddle_tpu_torch import amp

    def dt(x):
        if x is None or not hasattr(x, "dtype"):
            return None
        name = str(x.dtype).replace("torch.", "")
        return "int" if "int" in name else name

    jrec, trec = [], []
    real_hook, real_cast = dispatch.amp_input_hook, amp.cast_inputs

    def jhook(name, arrays):
        out = real_hook(name, arrays)
        jrec.append((name, tuple(map(dt, arrays)), tuple(map(dt, out))))
        return out

    def tcast(name, *ts):
        out = real_cast(name, *ts)
        trec.append((name, tuple(map(dt, ts)), tuple(map(dt, out))))
        return out

    monkeypatch.setattr(dispatch, "amp_input_hook", jhook)
    monkeypatch.setattr(amp, "cast_inputs", tcast)
    jm, tm = _pair(num_layers=2, moe_every=2)
    ids = np.random.RandomState(6).randint(0, 128, (2, 9)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]
    with jamp.auto_cast(level="O1"):
        jm(paddle.to_tensor(x), labels=paddle.to_tensor(y))
    with amp.auto_cast(level="O1"):
        tm(torch.tensor(x).long(), labels=torch.tensor(y).long())
    sites = {r[0] for r in trec}
    assert "moe_ffn" in sites
    assert Counter(trec) == Counter(r for r in jrec if r[0] in sites)
    moe_calls = [r for r in trec if r[0] == "moe_ffn"]
    assert moe_calls == [("moe_ffn", ("float32",) * 6, ("float32",) * 6)]
