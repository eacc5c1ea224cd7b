"""``scan_layers`` and ``use_recompute`` in the port, held to the unrolled
model and to the JAX package's ``GPTScanBlocks`` / ``fleet.utils.recompute``.

* A scan model has the JAX package's stacked names (``blocks.ln1.weight``
  ``[L, E]``, ...), draws the unrolled model's weights from a seed
  (equal), and computes its logits, loss and gradients (fp32, atol 1e-6;
  the same ops on the same slices).
* Through the weight bridge the scan model matches the JAX scan model:
  loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6 (fp32, another
  summation order), and 3 ``TrainStep`` steps with ``use_recompute`` and
  the ``"dots"`` policy against the JAX ``TrainStep`` (losses rtol 1e-4).
* Every recompute policy gives the no-recompute loss and gradients
  (atol 1e-6) and JAX's (as above), with the flash op's forward run
  again in backward (counted through a wrapper on its plain version:
  2 forward calls a layer, 1 of each backward); dropout under recompute
  equals the same seed without it (atol 1e-6).
* ``generate`` and ``Engine`` on a scan model run through the unrolled
  twin: token-identical to the unrolled model's and to JAX's scan
  ``generate``; the twin follows weights updated in place and stays out
  of ``state_dict``.
* Decay masks see the same dotted names as in JAX.
* ``TrainStep`` takes ``strategy.recompute`` and ``donate=`` as the JAX
  flat step does (no effect), and counts its steps in the ``monitor``
  registry.

The launch counts on the card under recompute are ``cuda``-marked tests
in ``tests/test_torch_flash_attn.py`` (which the card imports without
jax).
"""
import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.parallel.train_step import TrainStep as JaxTrainStep
from paddle_tpu_torch.convert import (export_paddle_tpu_state,
                                      load_paddle_tpu_state)
from paddle_tpu_torch.distributed.fleet.utils import REMAT_POLICIES
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.nn.functional import attention as attn_mod
from paddle_tpu_torch.nn.layer import ScanLayers
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import TrainStep

torch.set_num_threads(1)

CFG = dict(num_layers=2, hidden_size=128, num_heads=2, vocab_size=128,
           max_position=128)
POLICIES = [None, "full", "dots", "nothing", "everything"]


def _batch(seed, b=2, s=128):
    ids = np.random.RandomState(seed).randint(0, 128, (b, s + 1))
    return torch.tensor(ids[:, :-1]), torch.tensor(ids[:, 1:])


def _loss_grads(m, x, y, **kw):
    m.zero_grad(set_to_none=True)
    loss = m(x, labels=y, **kw)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in
                           m.named_parameters()}


def _stacked(grads, L):
    """Unrolled gradients under the scan model's (JAX's) stacked names."""
    out, parts = {}, {}
    for n, g in grads.items():
        m = re.fullmatch(r"blocks\.(\d+)\.(.+)", n)
        if m:
            parts.setdefault(f"blocks.{m.group(2)}", [None] * L)[
                int(m.group(1))] = g
        else:
            out[n] = g
    out.update({n: torch.stack(v) for n, v in parts.items()})
    return out


def _unstacked(grads, L):
    """Scan gradients under the unrolled model's names."""
    out = {}
    for n, g in grads.items():
        if n.startswith("blocks."):
            for i in range(L):
                out[f"blocks.{i}.{n[7:]}"] = g[i]
        else:
            out[n] = g
    return out


@pytest.fixture
def flash_counts(monkeypatch):
    """Route attention through the flash op's plain version at S=128 and
    count the op's calls per kernel."""
    monkeypatch.setattr(attn_mod, "FLASH_MIN_SEQ", 128)
    counts = {k: 0 for k in fa.KERNEL_OPS}
    for k, op in list(fa.KERNEL_OPS.items()):
        def counted(*a, _op=op, _k=k, **kw):
            counts[_k] += 1
            return _op(*a, **kw)
        monkeypatch.setitem(fa.KERNEL_OPS, k, counted)
    return counts


def test_scan_names_init_and_math_equal_unrolled():
    un = GPTModel.from_config("tiny", device="cpu", seed=3, dropout=0.0)
    sc = GPTModel.from_config("tiny", device="cpu", seed=3, dropout=0.0,
                              scan_layers=True)
    assert isinstance(sc.blocks, ScanLayers)
    assert sc.blocks.ln1.weight.shape == (2, 64)
    assert sc.blocks.attn.qkv_proj.weight.shape == (2, 192, 64)
    un_p = dict(un.named_parameters())
    for n, p in sc.named_parameters():
        want = (torch.stack([un_p[f"blocks.{i}.{n[7:]}"] for i in range(2)])
                if n.startswith("blocks.") else un_p[n])
        assert torch.equal(p, want), n
    x, y = _batch(1, s=32)
    with torch.no_grad():
        torch.testing.assert_close(sc(x), un(x), rtol=0, atol=1e-6)
    lu, gu = _loss_grads(un, x, y)
    ls, gs = _loss_grads(sc, x, y)
    torch.testing.assert_close(ls, lu, rtol=0, atol=1e-6)
    for n, g in _unstacked(gs, 2).items():
        torch.testing.assert_close(g, gu[n], rtol=0, atol=1e-6, msg=n)
    torch.manual_seed(4)
    a = GPTModel(**CFG)
    torch.manual_seed(4)
    b = GPTModel(**CFG, scan_layers=True)
    assert torch.equal(b.blocks.mlp.fc1.weight[1],
                       a.blocks[1].mlp.fc1.weight)
    assert torch.equal(b.head.lm_head.weight, a.head.lm_head.weight)


def test_scan_refusals():
    with pytest.raises(ValueError, match="buffer-free"):
        ScanLayers(lambda: torch.nn.BatchNorm1d(4), 2)
    with pytest.raises(ValueError, match="dense block only"):
        GPTModel(**CFG, scan_layers=True, use_mp=True)
    m = GPTModel(**CFG, scan_layers=True)
    empty = torch.zeros(1, 0, 2, 64)
    with pytest.raises(NotImplementedError, match="twin"):
        m(torch.zeros(1, 4, dtype=torch.long), caches=[(empty, empty)] * 2)


def _jax_pair(seed, **kw):
    paddle.seed(seed)
    jm = JaxGPT(**CFG, dropout=0.0, fused_loss=True, **kw)
    tm = GPTModel(**CFG, dropout=0.0, fused_loss=True, **kw)
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


def _jax_loss_grads(jm, x, y, **kw):
    kw = {k: paddle.to_tensor(v.numpy()) for k, v in kw.items()}
    loss = jm(paddle.to_tensor(x.numpy().astype(np.int32)),
              labels=paddle.to_tensor(y.numpy().astype(np.int32)), **kw)
    loss.backward()
    return float(loss.numpy()), {n: p.grad.numpy()
                                 for n, p in jm.named_parameters()}


def _close_to_jax(loss, grads, jloss, jgrads):
    """``grads`` under the stacked names; linear weights' in torch's
    layout, swapped to JAX's here."""
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    assert sorted(grads) == sorted(jgrads)
    for n, g in grads.items():
        g = g.numpy()
        if n.endswith("weight") and any(t in n for t in ("proj", "fc",
                                                         "lm_head")):
            g = g.swapaxes(-1, -2)
        np.testing.assert_allclose(g, jgrads[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)


@pytest.fixture(scope="module")
def jax_scan_reference():
    """The JAX scan model's loss and gradients on a packed batch, and
    its weights."""
    jm, _ = _jax_pair(11, scan_layers=True)
    x, y = _batch(12)
    dl = torch.tensor([[60, 40, 28], [120, 0, 0]])
    jl, jg = _jax_loss_grads(jm, x, y, doc_lens=dl)
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return arrays, (x, y, dl), jl, jg


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
@pytest.mark.parametrize("policy", POLICIES + ["none"])
def test_recompute_policies_match(flash_counts, jax_scan_reference, scan,
                                  policy):
    """Loss and gradients with each policy (``"none"``: no recompute)
    equal the no-recompute model's and JAX's scan model's."""
    arrays, (x, y, dl), jl, jg = jax_scan_reference
    kw = dict(use_recompute=policy != "none",
              recompute_policy=None if policy == "none" else policy)
    tm = GPTModel(**CFG, dropout=0.0, fused_loss=True, scan_layers=scan,
                  **kw)
    load_paddle_tpu_state(tm, arrays)
    ref = GPTModel(**CFG, dropout=0.0, fused_loss=True, scan_layers=scan)
    load_paddle_tpu_state(ref, arrays)
    l0, g0 = _loss_grads(ref, x, y, doc_lens=dl)
    for k in flash_counts:
        flash_counts[k] = 0
    loss, grads = _loss_grads(tm, x, y, doc_lens=dl)
    L = CFG["num_layers"]
    assert flash_counts == {"fwd": (2 if kw["use_recompute"] else 1) * L,
                            "bwd_dkv": L, "bwd_dq": L}
    torch.testing.assert_close(loss, l0, rtol=0, atol=1e-6)
    for n, g in grads.items():
        torch.testing.assert_close(g, g0[n], rtol=0, atol=1e-6, msg=n)
    _close_to_jax(loss, grads if scan else _stacked(grads, L), jl, jg)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
@pytest.mark.parametrize("policy", ["full", "dots", "everything"])
def test_dropout_under_recompute_equals_no_recompute(flash_counts, scan,
                                                     policy):
    """The recomputed forward draws the masks the first forward drew."""
    x, y = _batch(13)
    out = []
    for rc in (False, True):
        m = GPTModel(**CFG, dropout=0.1, fused_loss=True, scan_layers=scan,
                     use_recompute=rc, recompute_policy=policy)
        m.reset_parameters(5)
        torch.manual_seed(6)
        out.append(_loss_grads(m, x, y,
                               doc_lens=torch.tensor([[70, 58], [128, 0]])))
    (l0, g0), (l1, g1) = out
    torch.testing.assert_close(l1, l0, rtol=0, atol=1e-6)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=1e-6, msg=n)


def test_remat_policies_table():
    assert set(REMAT_POLICIES) == {"full", "dots", "nothing", "everything"}


def test_train_step_recompute_scan_matches_jax():
    """3 TrainStep steps of a scan model with recompute ("dots") and
    AdamW: losses at rtol 1e-4 against the JAX step (which remats under
    jit)."""
    jm, tm = _jax_pair(14, scan_layers=True, use_recompute=True,
                       recompute_policy="dots")
    x, y = _batch(15, s=32)
    js = JaxTrainStep(jm, jopt.AdamW(learning_rate=1e-3,
                                     parameters=jm.parameters()),
                      donate=False)
    ts = TrainStep(tm, AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                             device="cpu"), device="cpu")
    for i in range(3):
        want = float(js.step([x.numpy().astype(np.int32),
                              y.numpy().astype(np.int32)]).numpy())
        np.testing.assert_allclose(float(ts.step([x, y])), want, rtol=1e-4,
                                   err_msg=f"step {i}")


def test_decay_mask_sees_stacked_dotted_names():
    """``apply_decay_param_fun`` gets the JAX package's stacked names, so
    one predicate selects the same parameters in both."""
    seen = []
    m = GPTModel(**CFG, scan_layers=True, dropout=0.0)
    opt = AdamW(parameters=m.named_parameters(), device="cpu",
                apply_decay_param_fun=lambda n: seen.append(n)
                or not n.endswith("bias"))
    x, y = _batch(16, s=16)
    m(x, labels=y).backward()
    opt.step()
    paddle.seed(0)
    jnames = [n for n, _ in JaxGPT(**CFG, scan_layers=True)
              .named_parameters()]
    assert sorted(seen) == sorted(jnames)


def test_generate_and_engine_on_a_scan_model():
    """Greedy ``generate`` (eager and ``compiled=True``) equals the
    unrolled model's and JAX's scan ``generate``; after an in-place update
    the twin decodes the new weights; an ``Engine`` serves the scan model
    through the twin; the twin is not in ``state_dict``."""
    from paddle_tpu_torch.serving.engine import Engine
    paddle.seed(17)
    jm = JaxGPT.from_config("tiny", scan_layers=True, dropout=0.0)
    sc = GPTModel.from_config("tiny", device="cpu", dropout=0.0,
                              scan_layers=True)
    un = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    load_paddle_tpu_state(sc, arrays)
    load_paddle_tpu_state(un, arrays)
    ids = np.random.RandomState(18).randint(0, 128, (2, 5))
    want = jm.generate(paddle.to_tensor(ids.astype(np.int32)),
                       max_new_tokens=6, compiled=True).numpy()
    for mode in (False, True):
        got = sc.generate(ids, max_new_tokens=6, compiled=mode)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, un.generate(ids, max_new_tokens=6,
                                            compiled=mode))
    assert not any("twin" in k for k in sc.state_dict())
    with torch.no_grad():
        sc.blocks.mlp.fc2.weight.mul_(-1.0)
        un.blocks[0].mlp.fc2.weight.mul_(-1.0)
        un.blocks[1].mlp.fc2.weight.mul_(-1.0)
    assert torch.equal(sc.generate(ids, max_new_tokens=6),
                       un.generate(ids, max_new_tokens=6))
    eng = Engine(sc, device="cpu", kv_block_size=8, prefill_chunk=8)
    reqs = [eng.submit(list(ids[i]), max_new_tokens=6) for i in range(2)]
    eng.run_until_idle()
    ref = un.generate(ids, max_new_tokens=6)
    for i, r in enumerate(reqs):
        assert r.result(timeout=1).tolist() == ref[i].tolist()
    tp = sc.to_tensor_parallel()
    with torch.no_grad():
        torch.testing.assert_close(tp(torch.tensor(ids)),
                                   un(torch.tensor(ids)), rtol=1e-5,
                                   atol=1e-5)


def test_strategy_recompute_and_donate_are_accepted():
    """``strategy.recompute`` and ``donate=`` change nothing on a flat
    model (the JAX flat step ignores both): the losses equal a plain
    step's exactly.  Each step adds one to ``train.steps`` and one
    observation to ``train.step_time_ms``."""
    from paddle_tpu.distributed.fleet.strategy import DistributedStrategy
    from paddle_tpu_torch import monitor
    x, y = _batch(19, s=16)
    s = DistributedStrategy()
    s.recompute = True
    losses = []
    for kw in ({}, dict(strategy=s, donate=False)):
        m = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
        step = TrainStep(m, AdamW(parameters=m.parameters(), device="cpu"),
                         device="cpu", **kw)
        steps = monitor.default_registry().get("train.steps")
        times = monitor.default_registry().get("train.step_time_ms")
        n0, t0 = steps.value, times.snapshot()[-1]
        losses.append([float(step.step([x, y])) for _ in range(2)])
        assert steps.value == n0 + 2 and times.snapshot()[-1] == t0 + 2
    assert losses[0] == losses[1]
