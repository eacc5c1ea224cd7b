"""Sequence parallelism in the port (``paddle_tpu_torch.distributed.ring``
and ``GPTModel(use_sp=...)``) held to the JAX package.

* ``ring_attention`` / ``ulysses_attention`` over ``build_mesh(sp=n)``
  (n = 2, 4: the port's ranks all on the CPU, JAX's on its 8-device CPU
  mesh, ``XLA_FLAGS`` of tests/conftest.py), causal and not: the output
  and dq/dk/dv at atol 2e-6 (f32, another summation order of the blocks'
  online softmax).
* The degenerate path (no sp axis) against JAX's
  ``_single_block_attention`` and ``_reference_attention``; dropout on
  the probabilities, replayed by the same generator state.
* The Ulysses error for a head count the sp degree does not divide.
* A tiny ``GPTModel(use_sp="ring" / "ulysses")`` loss and 3 train
  steps against JAX's at dropout 0, over an sp=2 mesh and an sp=1 one;
  packed documents under ``use_sp`` raise as in JAX; the degenerate path
  never takes the flash op.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import ring as jring
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.nn.functional.attention import \
    _reference_attention as jax_reference
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import build_mesh, mesh as tmesh, ring
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.nn.functional import attention as attn_mod
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

ATOL = 2e-6


@pytest.fixture
def meshes():
    """Restores both packages' process meshes after the test (JAX's
    ``ensure_mesh`` and the GPT's sp attention read them)."""
    jprev, tprev = jmesh.get_mesh(), tmesh.get_mesh()
    yield
    jmesh.set_mesh(jprev)
    tmesh.set_mesh(tprev)


def _qkvd(shape=(2, 32, 4, 8), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _jax_call(fn, q, k, v, do, **kw):
    def f(a, b, c):
        out = fn(paddle.Tensor(a), paddle.Tensor(b), paddle.Tensor(c), **kw)
        return out._data if hasattr(out, "_data") else out

    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_call(fn, q, k, v, do, **kw):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fn(tq, tk, tv, **kw)
    out.backward(torch.tensor(do))
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["ring_attention", "ulysses_attention"])
def test_sequence_parallel_attention_matches_jax(name, causal, sp):
    q, k, v, do = _qkvd()
    jm = jmesh.build_mesh(sp=sp, devices=jax.devices()[:sp])
    tm = build_mesh(sp=sp, devices=["cpu"] * sp)
    assert tm.shape == dict(jm.shape)
    want, want_g = _jax_call(getattr(jring, name), q, k, v, do,
                             causal=causal, mesh=jm)
    got, got_g = _port_call(getattr(ring, name), q, k, v, do,
                            causal=causal, mesh=tm)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for n, g, w in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"d{n}")


@pytest.mark.parametrize("causal", [False, True])
def test_degenerate_path_matches_jax(causal):
    """No sp axis: ``_single_block_attention`` (f32, the dropout path at
    p=0) and ``ring_attention`` / ``ulysses_attention`` without a mesh
    (``_reference_attention``) equal JAX's."""
    q, k, v, do = _qkvd(seed=1)
    want, want_g = _jax_call(
        lambda a, b, c: jring._single_block_attention(
            a._data, b._data, c._data, None, causal, None, 0.0),
        q, k, v, do)
    got, got_g = _port_call(
        lambda a, b, c: ring._single_block_attention(a, b, c, None, causal,
                                                     None, 0.0),
        q, k, v, do)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    ref = np.asarray(jax_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                   None, None, causal))
    one = build_mesh(devices=["cpu"])          # dp=1: no sp axis
    for fn in (ring.ring_attention, ring.ulysses_attention):
        for mesh in (None, one):
            out = fn(*(torch.tensor(a) for a in (q, k, v)), causal=causal,
                     mesh=mesh)
            np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_probability_dropout_replays_with_the_generator():
    """Dropout on the probabilities (the output rows no longer sum the
    values' convex combination) replays exactly from the same generator
    state, and is off without a generator, as JAX's is without a key."""
    q, k, v, _ = (torch.tensor(a) for a in _qkvd(seed=2))
    gen = torch.Generator().manual_seed(3)
    a = ring.ring_attention(q, k, v, causal=True, dropout_p=0.5,
                            rng_key=gen)
    gen.manual_seed(3)
    b = ring.ring_attention(q, k, v, causal=True, dropout_p=0.5,
                            rng_key=gen)
    plain = ring.ring_attention(q, k, v, causal=True, dropout_p=0.5)
    assert torch.equal(a, b)
    assert not torch.allclose(a, plain)
    torch.testing.assert_close(
        plain, attn_mod._reference_attention(q, k, v, None, None, True))
    tm = build_mesh(sp=2, devices=["cpu"] * 2)
    gen.manual_seed(4)
    c = ring.ring_attention(q, k, v, causal=True, mesh=tm, dropout_p=0.5,
                            rng_key=gen)
    gen.manual_seed(4)
    d = ring.ring_attention(q, k, v, causal=True, mesh=tm, dropout_p=0.5,
                            rng_key=gen)
    assert torch.equal(c, d) and not torch.allclose(c, plain)


def test_ulysses_indivisible_heads_raise_as_jax():
    q = np.zeros((1, 8, 3, 4), np.float32)
    jm = jmesh.build_mesh(sp=2, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="not divisible") as jerr:
        jring.ulysses_attention(paddle.Tensor(jnp.asarray(q)),
                                paddle.Tensor(jnp.asarray(q)),
                                paddle.Tensor(jnp.asarray(q)), mesh=jm)
    t = torch.tensor(q)
    with pytest.raises(ValueError, match="not divisible") as terr:
        ring.ulysses_attention(t, t, t,
                               mesh=build_mesh(sp=2, devices=["cpu"] * 2))
    assert str(terr.value) == str(jerr.value)


def test_build_mesh_matches_jax_shapes():
    for kw in (dict(), dict(sp=4), dict(dp=2, sp=2), dict(dp=-1, mp=2)):
        jm = jmesh.build_mesh(devices=jax.devices()[:4], **kw)
        tm = build_mesh(devices=["cpu"] * 4, **kw)
        assert tm.shape == dict(jm.shape), kw
        assert tm.devices.shape == jm.devices.shape
    with pytest.raises(ValueError, match="require 8 devices"):
        build_mesh(sp=8, devices=["cpu"] * 4)


CFG = dict(num_layers=2, hidden_size=32, num_heads=4, vocab_size=64,
           max_position=64, dropout=0.0)


def _gpt_pair(use_sp):
    paddle.seed(0)
    jm = JaxGPT(**CFG, use_sp=use_sp)
    tm = GPTModel(**CFG, use_sp=use_sp)
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.mark.parametrize("sp", [1, 2])
@pytest.mark.parametrize("use_sp", ["ring", "ulysses"])
def test_sp_gpt_loss_and_train_steps_match_jax(meshes, use_sp, sp):
    """The forward loss and 3 AdamW ``TrainStep`` losses at rtol 1e-5
    (f32; sp=1 is the degenerate single block).  JAX's eager tape does
    not pass through its sp attention (it unwraps the arrays), so the
    gradients are held through the train steps, which JAX traces."""
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.parallel.train_step import TrainStep as JaxTrainStep
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.parallel import TrainStep
    jm, tm = _gpt_pair(use_sp)
    jmesh.set_mesh(jmesh.build_mesh(sp=sp, devices=jax.devices()[:sp]))
    tmesh.set_mesh(build_mesh(sp=sp, devices=["cpu"] * sp))
    ids = np.random.RandomState(3).randint(0, 64, (2, 33)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]
    tx, ty = torch.tensor(x).long(), torch.tensor(y).long()
    jloss = jm(paddle.to_tensor(x), labels=paddle.to_tensor(y))
    np.testing.assert_allclose(float(tm(tx, labels=ty).detach()),
                               float(jloss.numpy()), rtol=1e-5)
    js = JaxTrainStep(jm, jopt.AdamW(learning_rate=1e-2,
                                     parameters=jm.parameters()),
                      donate=False)
    ts = TrainStep(tm, topt.AdamW(learning_rate=1e-2,
                                  parameters=tm.parameters(), device="cpu"),
                   device="cpu")
    jl = [float(np.asarray(js.step([x, y]))) for _ in range(3)]
    tl = [float(ts.step([tx, ty])) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[2] < tl[0]


def test_packed_documents_under_sp_raise_as_jax():
    jm, tm = _gpt_pair("ring")
    ids = np.zeros((1, 16), np.int32)
    with pytest.raises(NotImplementedError, match="packed-sequence") as jerr:
        jm(paddle.to_tensor(ids), doc_lens=paddle.to_tensor(
            np.array([[8, 8]], np.int32)))
    with pytest.raises(NotImplementedError, match="packed-sequence") as terr:
        tm(torch.tensor(ids).long(), doc_lens=torch.tensor([[8, 8]]))
    assert str(terr.value) == str(jerr.value)


def test_degenerate_sp_never_takes_the_flash_op(monkeypatch, meshes):
    """With no sp mesh a ``use_sp`` model computes JAX's one-device ring:
    the reference attention at any length, where the dense model takes
    the flash op past the gate (``FLASH_MIN_SEQ`` lowered to 128)."""
    tmesh.set_mesh(None)
    monkeypatch.setattr(attn_mod, "FLASH_MIN_SEQ", 128)
    calls = []
    real = fa.KERNEL_OPS["fwd"]
    monkeypatch.setitem(fa.KERNEL_OPS, "fwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ids = torch.randint(0, 64, (1, 128))
    cfg = dict(CFG, hidden_size=128, num_heads=2, max_position=128)
    sp_out = GPTModel(**cfg, use_sp="ring")(ids)
    assert calls == [] and sp_out.shape == (1, 128, 64)
    GPTModel(**cfg)(ids)
    assert len(calls) == 2
