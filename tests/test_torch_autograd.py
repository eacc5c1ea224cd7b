"""The port's autograd (torch's engine under ``core/autograd.py`` and the
top-level ``grad``) held to the JAX package's tape on the CPU: the
cases of ``test_autograd.py`` and ``test_double_grad.py``, each run in
both packages on the same inputs, gradients at rtol 1e-5."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as core_device

torch.set_num_threads(1)
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


def both(fn):
    """``fn(pkg)`` in the port and in the JAX package."""
    return fn(P), fn(J)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=1e-6)


def test_simple_backward():
    def run(pkg):
        x = pkg.to_tensor([2.0, 3.0], stop_gradient=False)
        (x * x).sum().backward()
        return x.grad.numpy()
    p, j = both(run)
    close(p, j)
    close(p, [4.0, 6.0])


def test_chain_rule():
    def run(pkg):
        x = pkg.to_tensor([1.0], stop_gradient=False)
        z = pkg.log(pkg.exp(x)) * 3.0
        z.backward()
        return x.grad.numpy()
    close(*both(run))


def test_grad_accumulation_two_paths():
    def run(pkg):
        x = pkg.to_tensor([2.0], stop_gradient=False)
        (x * 3.0 + x * x).backward()
        return x.grad.numpy()
    p, j = both(run)
    close(p, j)
    close(p, [7.0])


def test_backward_twice_accumulates_on_leaf():
    def run(pkg):
        x = pkg.to_tensor([1.0], stop_gradient=False)
        (x * 2.0).backward()
        (x * 3.0).backward()
        return x.grad.numpy()
    p, j = both(run)
    close(p, j)
    close(p, [5.0])


def test_no_grad_blocks_the_graph():
    for pkg in (P, J):
        x = pkg.to_tensor([1.0], stop_gradient=False)
        with pkg.no_grad():
            y = x * 2.0
        assert y.stop_gradient
        with pkg.no_grad():
            with pkg.enable_grad():
                assert not (x * 2.0).stop_gradient

    @P.no_grad()
    def f(t):
        return t * 2.0
    assert f(P.to_tensor([1.0], stop_gradient=False)).stop_gradient


def test_stop_gradient_cuts_graph():
    for pkg in (P, J):
        x = pkg.to_tensor([1.0], stop_gradient=False)
        z = (x * 2.0).detach() * 3.0
        assert z.stop_gradient


def test_backward_on_a_constant_does_nothing():
    for pkg in (P, J):
        x = pkg.to_tensor([1.0])
        (x * 2.0).backward()
        assert x.grad is None


def test_retain_graph_error_without():
    for pkg in (P, J):
        x = pkg.to_tensor([1.0], stop_gradient=False)
        y = x * 2.0
        y.backward()
        with pytest.raises(RuntimeError, match="second time"):
            y.backward()


def test_retain_graph_allows_second_backward():
    def run(pkg):
        x = pkg.to_tensor([1.0], stop_gradient=False)
        y = x * x
        y.backward(retain_graph=True)
        y.backward()
        return x.grad.numpy()
    p, j = both(run)
    close(p, j)


def test_non_scalar_backward_needs_grad():
    def run(pkg):
        x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        with pytest.raises(RuntimeError, match="non-scalar"):
            (x * 2.0).backward()
        (x * 2.0).backward(pkg.ones([2]))
        return x.grad.numpy()
    p, j = both(run)
    close(p, j)
    close(p, [2.0, 2.0])


def test_matmul_grad():
    rs = np.random.RandomState(0)
    av, bv = rs.rand(3, 4).astype(np.float32), rs.rand(4, 5).astype(
        np.float32)

    def run(pkg):
        a = pkg.to_tensor(av, stop_gradient=False)
        b = pkg.to_tensor(bv, stop_gradient=False)
        pkg.matmul(a, b).sum().backward()
        return a.grad.numpy(), b.grad.numpy()
    (pa, pb), (ja, jb) = both(run)
    close(pa, ja)
    close(pb, jb)
    close(pa, np.ones((3, 5)) @ bv.T)


def test_broadcast_grad():
    def run(pkg):
        a = pkg.to_tensor(np.ones((3, 4), np.float32), stop_gradient=False)
        b = pkg.to_tensor(np.ones((4,), np.float32), stop_gradient=False)
        (a + b).sum().backward()
        return b.grad.numpy()
    p, j = both(run)
    close(p, j)
    close(p, [3.0] * 4)


def test_multi_output_split_grad():
    def run(pkg):
        x = pkg.to_tensor(np.arange(6, dtype=np.float32),
                          stop_gradient=False)
        a, b = pkg.split(x, 2)
        (a.sum() * 2 + b.sum() * 3).backward()
        return x.grad.numpy()
    p, j = both(run)
    close(p, j)
    close(p, [2, 2, 2, 3, 3, 3])


def test_unused_output_gets_zero_grad():
    def run(pkg):
        x = pkg.to_tensor(np.arange(6, dtype=np.float32),
                          stop_gradient=False)
        a, _ = pkg.split(x, 2)
        a.sum().backward()
        return x.grad.numpy()
    p, j = both(run)
    close(p, j)
    close(p, [1, 1, 1, 0, 0, 0])


def test_paddle_grad_api():
    def run(pkg):
        x = pkg.to_tensor([2.0], stop_gradient=False)
        (g,) = pkg.grad(x * x, x)
        assert x.grad is None       # paddle.grad leaves .grad alone
        return g.numpy()
    p, j = both(run)
    close(p, j)
    close(p, [4.0])


def test_grad_with_grad_outputs_and_intermediate_inputs():
    def run(pkg):
        x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        y = x * 3.0
        z = y * y
        gy, gx = pkg.grad([z], [y, x],
                          grad_outputs=[pkg.to_tensor([1.0, 0.5])])
        return gy.numpy(), gx.numpy()
    (py_, px), (jy, jx) = both(run)
    close(py_, jy)
    close(px, jx)


def test_retain_grads_intermediate():
    def run(pkg):
        x = pkg.to_tensor([1.0], stop_gradient=False)
        y = x * 2.0
        y.retain_grads()
        (y * 3.0).backward()
        return y.grad.numpy()
    p, j = both(run)
    close(p, j)
    close(p, [3.0])


def test_intermediate_without_retain_has_no_grad():
    x = P.to_tensor([1.0], stop_gradient=False)
    y = x * 2.0
    (y * 3.0).backward()
    assert y.grad is None


def test_getitem_grad():
    def run(pkg):
        x = pkg.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3),
                          stop_gradient=False)
        x[0].sum().backward()
        return x.grad.numpy()
    p, j = both(run)
    close(p, j)
    close(p, [[1, 1, 1], [0, 0, 0]])


@pytest.mark.parametrize("idx", [
    0, (slice(None), 1), (slice(0, 2), slice(1, 3))], ids=str)
def test_setitem_keeps_grad_chain(idx):
    def run(pkg):
        x = pkg.to_tensor(np.ones((3, 3), np.float32), stop_gradient=False)
        z = x * 3.0
        z[idx] = 0.0
        (z * z).sum().backward()
        return x.grad.numpy()
    close(*both(run))


def test_setitem_with_a_differentiable_value():
    def run(pkg):
        x = pkg.to_tensor(np.ones(4, np.float32), stop_gradient=False)
        v = pkg.to_tensor([2.0], stop_gradient=False)
        z = x * 1.0
        z[1:2] = v * 5.0
        (z * z).sum().backward()
        return x.grad.numpy(), v.grad.numpy()
    (px, pv), (jx, jv) = both(run)
    close(px, jx)
    close(pv, jv)


# ---- double grad -------------------------------------------------------
def test_cubic_second_derivative():
    xv = np.array([2.0, -1.5, 0.5], np.float32)

    def run(pkg):
        x = pkg.to_tensor(xv, stop_gradient=False)
        (g1,) = pkg.grad(pkg.sum(x ** 3), x, create_graph=True)
        (g2,) = pkg.grad(pkg.sum(g1), x)
        return g1.numpy(), g2.numpy()
    (p1, p2), (j1, j2) = both(run)
    close(p1, j1)
    close(p2, j2)
    close(p2, 6 * xv)


def test_triple_derivative():
    def run(pkg):
        x = pkg.to_tensor(np.array([1.3], np.float32), stop_gradient=False)
        (g1,) = pkg.grad(x ** 4, x, create_graph=True)
        (g2,) = pkg.grad(g1, x, create_graph=True)
        (g3,) = pkg.grad(g2, x)
        return g3.numpy()
    p, j = both(run)
    close(p, j)
    close(p, [24 * 1.3])


def test_mixed_partial():
    def run(pkg):
        x = pkg.to_tensor(np.array([2.0], np.float32), stop_gradient=False)
        y = pkg.to_tensor(np.array([3.0], np.float32), stop_gradient=False)
        (gx,) = pkg.grad((x ** 2) * (y ** 3), x, create_graph=True)
        (gxy,) = pkg.grad(gx, y)
        return gxy.numpy()
    p, j = both(run)
    close(p, j)
    close(p, [6 * 2.0 * 9.0])


def test_through_matmul_and_nonlinearity():
    rs = np.random.RandomState(0)
    xv, wv = rs.randn(4, 3).astype(np.float32), rs.randn(3, 2).astype(
        np.float32)

    def run(pkg):
        x = pkg.to_tensor(xv, stop_gradient=False)
        w = pkg.to_tensor(wv, stop_gradient=False)
        y = pkg.sum(pkg.tanh(pkg.matmul(x, w)) ** 2)
        (gx,) = pkg.grad(y, x, create_graph=True)
        (gw,) = pkg.grad(pkg.sum(gx * gx), w)
        return gw.numpy()
    close(*both(run))


def test_gradient_penalty_backprops_into_the_critic():
    """The WGAN-GP loss of ``test_double_grad.py`` with the critic
    written in ops (the ``nn.Sequential`` of the JAX test is slice 12b's):
    every parameter's gradient equals the JAX package's."""
    rs = np.random.RandomState(7)
    vals = [rs.randn(4, 8).astype(np.float32) * 0.5,
            rs.randn(8).astype(np.float32) * 0.1,
            rs.randn(8, 1).astype(np.float32) * 0.5,
            rs.randn(1).astype(np.float32) * 0.1]
    xv = rs.randn(5, 4).astype(np.float32)

    def run(pkg):
        w1, b1, w2, b2 = [pkg.to_tensor(v, stop_gradient=False)
                          for v in vals]
        x = pkg.to_tensor(xv, stop_gradient=False)
        out = pkg.matmul(pkg.tanh(pkg.matmul(x, w1) + b1), w2) + b2
        (gx,) = pkg.grad(pkg.sum(out), x, create_graph=True)
        norm = pkg.sqrt(pkg.sum(gx * gx, axis=1) + 1e-12)
        loss = pkg.mean((norm - 1.0) ** 2)
        loss.backward()
        return [p.grad.numpy() for p in (w1, b1, w2)]
    for p, j in zip(*both(run)):
        close(p, j)


def test_create_graph_false_unchanged():
    for pkg in (P, J):
        x = pkg.to_tensor(np.array([2.0], np.float32), stop_gradient=False)
        (g,) = pkg.grad(x ** 2, x)
        close(g.numpy(), [4.0])
        assert g.stop_gradient


def test_second_backward_without_create_graph_raises():
    for pkg in (P, J):
        x = pkg.to_tensor(np.array([2.0], np.float32), stop_gradient=False)
        y = pkg.sum(x ** 2)
        y.backward()
        with pytest.raises(RuntimeError, match="second time"):
            y.backward()


def test_backward_with_create_graph_leaves_a_differentiable_grad():
    def run(pkg):
        x = pkg.to_tensor(np.array([1.5, 2.0], np.float32),
                          stop_gradient=False)
        pkg.sum(x ** 3).backward(create_graph=True)
        g = x.grad
        assert not g.stop_gradient
        (h,) = pkg.grad(pkg.sum(g), x)
        return h.numpy()
    close(*both(run))
