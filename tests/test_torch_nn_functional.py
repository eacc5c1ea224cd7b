"""The port's activations, common functionals, convolutions and pooling
(``nn.functional`` and their layers) held to the JAX package's on the
CPU.

Every case of those sections of ``tests/torch_nn_cases.py`` (the
functionals and layers of ``test_nn.py``, ``test_nn_extras.py`` and
``test_op_sweep.py``'s ``TestNNFunctionalSweep`` / ``TestNNGradSweep``,
and every other one the port exports): the same seeded numpy inputs and
weights through ``paddle_tpu`` and ``paddle_tpu_torch``, outputs at the
case's tolerance (fp32 rtol/atol 1e-5; chains of transcendentals,
convolutions and reductions 1e-4), integer outputs exactly; the
gradients of every differentiable case, functional or layer (inputs and
parameters), at 1e-4 (the JAX side traced whole, ``torch_nn_jax.py``).
The random functionals (dropout, ``gumbel_softmax``) are held by their
statistics and by repeating under one seed, since torch's generators do
not draw JAX's values.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as core_device

import torch_nn_cases as C
import torch_nn_jax as R

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


SECTIONS = ("activation", "common", "conv", "pooling")
CASES = [c for c in C.CASES if c[5] in SECTIONS and c[0].startswith("F.")]
GRAD = [c for c in C.CASES if c[5] in SECTIONS and c[4]]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_jax(case):
    C.parity(P, lambda c: R.reference(c, c[4]), case, grad=False)


@pytest.mark.parametrize("case", GRAD, ids=[c[0] for c in GRAD])
def test_grad_matches_jax(case):
    C.parity(P, lambda c: R.reference(c, True), case, grad=True)


def test_torch_tensors_in_torch_tensors_out():
    """A functional called with torch tensors returns torch tensors (the
    models call them so), with handles it returns handles."""
    x = np.random.RandomState(0).rand(2, 3).astype(np.float32)
    w = np.random.RandomState(1).rand(3, 4).astype(np.float32)
    out = P.nn.functional.linear(torch.tensor(x), P.to_tensor(w))
    assert type(out) is torch.Tensor
    out = P.nn.functional.linear(P.to_tensor(x), torch.tensor(w))
    assert isinstance(out, P.Tensor)
    assert isinstance(P.nn.functional.relu(x), P.Tensor)


def test_dropout_statistics_and_seed():
    """``dropout`` keeps about 1 - p of the elements, scaled by 1 / (1 -
    p), draws again under the same seed, and along ``axis`` drops whole
    slices; ``gumbel_softmax`` rows sum to one and ``hard`` gives one-hot
    rows."""
    F = P.nn.functional
    x = P.ones([4000])
    P.seed(7)
    a = F.dropout(x, 0.3).numpy()
    P.seed(7)
    b = F.dropout(x, 0.3).numpy()
    np.testing.assert_array_equal(a, b)
    assert 0.25 < float((a == 0).mean()) < 0.35
    np.testing.assert_allclose(a[a != 0], 1 / 0.7, rtol=1e-6)
    m = F.dropout(P.ones([50, 6]), 0.5, axis=0).numpy()
    assert ((m == 0).all(1) | (m != 0).all(1)).all()
    d = F.dropout(x, 0.5, mode="downscale_in_infer").numpy()
    assert set(np.unique(d)) <= {0.0, 1.0}
    g = F.gumbel_softmax(P.to_tensor(np.zeros((64, 5), np.float32)))
    np.testing.assert_allclose(g.numpy().sum(-1), 1.0, rtol=1e-5)
    h = F.gumbel_softmax(P.to_tensor(np.zeros((64, 5), np.float32)),
                         hard=True).numpy()
    assert (h.sum(-1) == 1).all() and set(np.unique(h)) == {0.0, 1.0}
    y = F.alpha_dropout(P.to_tensor(np.random.RandomState(2).randn(
        20000).astype(np.float32)), 0.2).numpy()
    assert abs(y.mean()) < 0.05 and abs(y.std() - 1) < 0.05


def test_npair_loss_single_implementation():
    """``common.npair_loss`` is ``extension.npair_loss``'s."""
    F = P.nn.functional
    rs = np.random.RandomState(1)
    a = P.to_tensor(rs.rand(4, 8).astype(np.float32))
    p = P.to_tensor(rs.rand(4, 8).astype(np.float32))
    lab = P.to_tensor(np.array([0, 1, 0, 1], np.int64))
    assert float(F.npair_loss(a, p, lab)) == pytest.approx(
        float(F.common.npair_loss(a, p, lab)), rel=1e-6)


def test_static_builders_run_eagerly():
    """``fc``, ``data_norm``, ``nce``, ``spectral_norm``, ``warpctc``,
    ``pool2d`` and the step counter: the JAX package's eager forms."""
    F = P.nn.functional
    x = P.to_tensor(np.random.RandomState(3).rand(4, 2, 3).astype(
        np.float32))
    assert F.fc(x, 5, activation="relu").shape == [4, 5]
    np.testing.assert_allclose(F.data_norm(x).numpy(),
                               x.numpy() / np.sqrt(1 + 1e-5), rtol=1e-6)
    y = P.to_tensor(np.array([[1], [3], [0], [2]], np.int64))
    assert F.nce(P.reshape(x, [4, 6]), y, 10).shape == [4, 1]
    w = P.to_tensor(np.random.RandomState(4).rand(3, 4).astype(np.float32))
    sv = np.linalg.svd(F.spectral_norm(w, power_iters=20).numpy(),
                       compute_uv=False)
    assert sv[0] == pytest.approx(1.0, rel=1e-3)
    a, b = F.autoincreased_step_counter("c"), F.autoincreased_step_counter(
        "c")
    assert int(b.numpy()[0]) == int(a.numpy()[0]) + 1


def _public(mod, root):
    """Public names of ``mod`` whose value is a function, a class or a
    module of ``root`` (what ``from ... import *`` of the JAX package's
    own files brings, without their jax/numpy helpers)."""
    import types
    out = set()
    for n in dir(mod):
        if n.startswith("_"):
            continue
        v = getattr(mod, n)
        home = v.__name__ if isinstance(v, types.ModuleType) else \
            getattr(v, "__module__", "") or ""
        if home.startswith(root) and (callable(v) or isinstance(
                v, types.ModuleType)):
            out.add(n)
    return out


def test_missing_functional_names_are_the_deferred_ones():
    """Every public name of ``paddle_tpu.nn.functional`` exists in the
    port but the deferred ones: ``legacy``'s, and the detection aliases
    of ``vision.ops`` (the ``_vision_alias`` functions and the SSD head
    ``multi_box_head`` over ``prior_box``)."""
    from paddle_tpu.nn.functional import legacy
    JF = J.nn.functional
    names = _public(JF, "paddle_tpu.nn") | _public(JF, "paddle_tpu.ops")
    deferred = {"multi_box_head", "legacy"} | {
        n for n in names
        if getattr(getattr(JF, n), "__module__", None) == legacy.__name__
        or "_vision_alias" in getattr(getattr(JF, n), "__qualname__", "")}
    missing = {n for n in names if not hasattr(P.nn.functional, n)}
    assert missing == deferred
