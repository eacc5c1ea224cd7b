"""The port's gradient clipping and ``nn.utils`` held to the JAX
package's on the CPU: ``ClipGradByValue`` / ``ByNorm`` / ``ByGlobalNorm``
over ``(parameter, gradient)`` pairs (rtol 1e-6), ``clip_grad_norm_``
over dense and sparse gradients (the ``test_selected_rows.py`` case
slice 17 deferred), the process-wide ``set_gradient_clip`` an optimizer
takes when given none, ``ErrorClipByValue``; an MLP trained eagerly with
``Adam(parameters=net.parameters(), grad_clip=ClipGradByGlobalNorm)``
tracks the JAX package's losses for 3 steps (rtol 1e-4);
``parameters_to_vector`` / ``vector_to_parameters`` and ``weight_norm``
/ ``remove_weight_norm`` compute the JAX package's values (1e-5)."""
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


GS = [np.random.RandomState(k).randn(*s).astype(np.float32)
      for k, s in enumerate([(3, 4), (5,), (2, 2)])]


@pytest.mark.parametrize("make", [
    lambda nn: nn.ClipGradByValue(0.5), lambda nn: nn.ClipGradByValue(
        0.3, min=-0.1), lambda nn: nn.ClipGradByNorm(1.0),
    lambda nn: nn.ClipGradByGlobalNorm(1.5)],
    ids=["value", "value_min", "norm", "global_norm"])
def test_clip_pairs_match_jax(make):
    out = {}
    for pkg in (J, P):
        pairs = [(pkg.to_tensor(g), pkg.to_tensor(g)) for g in GS]
        pairs.append((pkg.to_tensor(GS[0]), None))
        out[pkg] = [g for _, g in make(pkg.nn)(pairs)]
    assert out[P][-1] is None
    for g, w in zip(out[P][:-1], out[J][:-1]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_clip_grad_norm_dense_and_sparse():
    """Dense: the total norm and the scaled gradients equal the JAX
    package's; sparse (an ``Embedding(sparse=True)``): a tiny
    ``max_norm`` makes the SGD update tiny, as in
    ``test_selected_rows.py``."""
    res = {}
    for pkg in (J, P):
        ps = [pkg.to_tensor(g, stop_gradient=False) for g in GS]
        pkg.sum(sum(pkg.sum(p * p * p) for p in ps)).backward()
        total = pkg.nn.utils.clip_grad_norm_(ps, max_norm=2.0)
        res[pkg] = [float(total)] + [p.grad.numpy() for p in ps]
    np.testing.assert_allclose(res[P][0], res[J][0], rtol=1e-5)
    for g, w in zip(res[P][1:], res[J][1:]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    emb = P.nn.Embedding(10, 4, sparse=True)
    opt = P.optimizer.SGD(learning_rate=1.0, parameters=[emb.weight])
    (emb(P.to_tensor(np.array([1, 1, 3]))) ** 2).sum().backward()
    assert isinstance(emb.weight.grad, P.SelectedRows)
    w0 = emb.weight.numpy().copy()
    P.nn.utils.clip_grad_norm_([emb.weight], max_norm=1e-4)
    opt.step()
    assert np.abs(emb.weight.numpy() - w0).max() < 1e-3


def test_global_gradient_clip_and_error_clip():
    clip = P.nn.ClipGradByValue(0.01)
    P.nn.clip.set_gradient_clip(clip)
    try:
        w = P.Parameter(np.ones(3, np.float32))
        opt = P.optimizer.SGD(learning_rate=1.0, parameters=[w])
        assert opt._grad_clip is clip and P.nn.clip.get_gradient_clip() is clip
        (w * 100.0).sum().backward()
        opt.step()
        np.testing.assert_allclose(w.numpy(), 0.99, rtol=1e-6)
    finally:
        P.nn.clip.set_gradient_clip(None)
    g = P.nn.clip.ErrorClipByValue(0.2)(P.to_tensor(np.array(
        [-1.0, 0.1, 3.0], np.float32)))
    np.testing.assert_allclose(g.numpy(), [-0.2, 0.1, 0.2])


def _mlp(pkg, jm=None):
    nn = pkg.nn
    net = nn.Sequential(nn.Linear(6, 16), nn.Tanh(), nn.Linear(16, 3))
    if jm is not None:
        net.set_state_dict({k: v.numpy() for k, v in
                            jm.state_dict().items()})
    return net


def _data():
    rs = np.random.RandomState(4)
    return (rs.rand(8, 6).astype(np.float32),
            rs.rand(8, 3).astype(np.float32))


def test_eager_adam_training_matches_jax():
    J.seed(4)
    jm = _mlp(J)
    pm = _mlp(P, jm)
    x, y = _data()
    losses = {}
    for pkg, net in ((J, jm), (P, pm)):
        opt = pkg.optimizer.Adam(learning_rate=0.01,
                                 parameters=net.parameters(),
                                 grad_clip=pkg.nn.ClipGradByGlobalNorm(0.5))
        out = []
        for _ in range(3):
            loss = pkg.nn.MSELoss()(net(pkg.to_tensor(x)), pkg.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss))
        losses[pkg] = out
    np.testing.assert_allclose(losses[P], losses[J], rtol=1e-4)
    assert losses[P][2] < losses[P][0]


def test_utils_match_jax():
    rs = np.random.RandomState(9)
    state = {"weight": rs.randn(3, 4).astype(np.float32),
             "bias": rs.randn(4).astype(np.float32)}
    x = np.random.RandomState(1).rand(2, 3).astype(np.float32)
    res = {}
    for pkg in (J, P):
        lin = pkg.nn.Linear(3, 4)
        lin.set_state_dict(state)
        vec = pkg.nn.utils.parameters_to_vector(lin.parameters())
        pkg.nn.utils.vector_to_parameters(vec * 2.0, lin.parameters())
        pkg.nn.utils.weight_norm(lin, dim=1)
        out = lin(pkg.to_tensor(x)).numpy()
        names = sorted(n for n, _ in lin.named_parameters())
        pkg.nn.utils.remove_weight_norm(lin)
        res[pkg] = (vec.numpy(), out, names, lin(pkg.to_tensor(x)).numpy(),
                    sorted(n for n, _ in lin.named_parameters()))
    for g, w in zip(res[P], res[J]):
        if isinstance(g, list):
            assert g == w
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
