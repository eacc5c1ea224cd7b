"""The port's transformer layers held to the JAX package's on the CPU,
with the JAX layers' weights carried by ``set_state_dict`` of their
``state_dict()`` (the names and ``[in, out]`` layouts are the same):

* a small ``nn.Transformer`` (post-LN and pre-LN, masks from
  ``generate_square_subsequent_mask``) at atol 1e-4, forward and the
  weights' gradients;
* ``MultiHeadAttention`` with ``kdim`` / ``vdim``, ``need_weights`` and a
  bool mask, the growing ``Cache`` and a ``StaticCache``; encoder and
  decoder layers and stacks; ``test_nn.py``'s shape cases;
* incremental decoding: ``TransformerDecoder.gen_cache`` plus one token
  a step equals the full causal forward at every position (atol 1e-5),
  with the cross-attention's ``StaticCache`` made once; ``do_zip``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as core_device

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


def _pair(make):
    J.seed(0)
    jl, pl = make(J.nn), make(P.nn)
    pl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    return jl.eval(), pl.eval()


rs = np.random.RandomState(1)
SRC = rs.rand(2, 6, 16).astype(np.float32) - 0.5
TGT = rs.rand(2, 4, 16).astype(np.float32) - 0.5


@pytest.mark.parametrize("pre_ln", [False, True], ids=["post_ln", "pre_ln"])
def test_transformer_with_carried_weights_matches_jax(pre_ln):
    jm, pm = _pair(lambda nn: nn.Transformer(
        16, 2, 1, 1, 32, dropout=0.0, normalize_before=pre_ln,
        activation="gelu"))
    assert list(pm.state_dict()) == list(jm.state_dict())
    res = {}
    for pkg, m in ((J, jm), (P, pm)):
        mask = m.generate_square_subsequent_mask(4)
        out = m(pkg.to_tensor(SRC), pkg.to_tensor(TGT), tgt_mask=mask)
        w = pkg.to_tensor(np.random.RandomState(2).rand(2, 4, 16).astype(
            np.float32))
        pkg.sum(out * w).backward()
        res[pkg] = (out.numpy(), [p.grad.numpy() for p in m.parameters()])
    np.testing.assert_allclose(res[P][0], res[J][0], rtol=1e-4, atol=1e-4)
    for g, w in zip(res[P][1], res[J][1]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_multi_head_attention_matches_jax():
    jm, pm = _pair(lambda nn: nn.MultiHeadAttention(
        16, 4, kdim=8, vdim=12, need_weights=True))
    key = rs.rand(2, 5, 8).astype(np.float32)
    val = rs.rand(2, 5, 12).astype(np.float32)
    mask = rs.rand(2, 1, 4, 5) > 0.3
    mask[..., 0] = True
    outs = {}
    for pkg, m in ((J, jm), (P, pm)):
        out, wts = m(pkg.to_tensor(TGT), pkg.to_tensor(key),
                     pkg.to_tensor(val), attn_mask=pkg.to_tensor(mask))
        m.need_weights = False
        st = m.gen_cache(pkg.to_tensor(key), pkg.to_tensor(val),
                         type=m.StaticCache)
        cached = m(pkg.to_tensor(TGT[:, :2]), cache=st)
        m.need_weights = True
        outs[pkg] = [out.numpy(), wts.numpy(), cached.numpy()]
    for g, w in zip(outs[P], outs[J]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_encoder_and_decoder_stacks_match_jax():
    for make, args in [
            (lambda nn: nn.TransformerEncoder(nn.TransformerEncoderLayer(
                16, 2, 32, dropout=0.0), 2, nn.LayerNorm(16)), (SRC,)),
            (lambda nn: nn.TransformerDecoder(nn.TransformerDecoderLayer(
                16, 2, 32, dropout=0.0, normalize_before=True), 2), (TGT,
                                                                      SRC))]:
        jm, pm = _pair(make)
        np.testing.assert_allclose(
            pm(*[P.to_tensor(a) for a in args]).numpy(),
            jm(*[J.to_tensor(a) for a in args]).numpy(), rtol=1e-5,
            atol=1e-5)


def test_incremental_decoding_equals_the_full_forward():
    """``gen_cache`` + one token a step equals the full forward under the
    causal mask at every position; the static cross-attention cache is
    made once and passed back unchanged."""
    jm, pm = _pair(lambda nn: nn.TransformerDecoder(
        nn.TransformerDecoderLayer(16, 2, 32, dropout=0.0), 2))
    memory = P.to_tensor(SRC)
    tgt = P.to_tensor(TGT)
    mask = P.nn.Transformer.generate_square_subsequent_mask(4)
    full = pm(tgt, memory, tgt_mask=mask).numpy()
    np.testing.assert_allclose(
        full, jm(J.to_tensor(TGT), J.to_tensor(SRC),
                 tgt_mask=J.nn.Transformer.generate_square_subsequent_mask(
                     4)).numpy(), rtol=1e-5, atol=1e-5)
    cache = pm.gen_cache(memory)
    static = [c[1] for c in cache]
    for t in range(4):
        step, cache = pm(tgt[:, t:t + 1], memory, cache=cache)
        np.testing.assert_allclose(step.numpy()[:, 0], full[:, t],
                                   rtol=1e-5, atol=1e-5)
    assert all(c[1].k.torch() is s.k.torch() for c, s in zip(cache, static))
    assert cache[0][0].k.shape == [2, 4, 2, 8]
    zipped = pm.gen_cache(memory, do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2


def test_shapes_of_test_nn():
    nn = P.nn
    mha = nn.MultiHeadAttention(16, 4)
    x = P.to_tensor(SRC)
    assert mha(x, x, x).shape == [2, 6, 16]
    enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(16, 2, 32), 2)
    assert enc(x).shape == [2, 6, 16]
    model = nn.Transformer(d_model=16, nhead=2, num_encoder_layers=1,
                           num_decoder_layers=1, dim_feedforward=32)
    assert model(x, P.to_tensor(TGT)).shape == [2, 4, 16]
    assert [p.name for p in enc.parameters()][0].endswith(".w_0")
