"""The port's ``py_func`` held to the JAX package's on the CPU: the eager
cases of ``test_py_func.py``, each run in both packages (values and
gradients at rtol 1e-6).  Its static-Program and ``@to_static`` cases
(``test_static_forward_and_backward``, ``test_fluid_layers_alias``,
``test_to_static_with_py_func``) wait for slice 12f."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu.ops.py_func import py_func as jpy_func
from paddle_tpu_torch.core import device as core_device

torch.set_num_threads(1)

PY_FUNC = {P: P.py_func, J: jpy_func}


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


def _tanh_np(x):
    return np.tanh(x)


def _tanh_grad_np(x, y, dy):
    return [dy * (1 - y * y)]


def both(fn):
    return [fn(pkg, PY_FUNC[pkg]) for pkg in (P, J)]


def close(a, b):
    for x, y in zip(a if isinstance(a, (list, tuple)) else [a],
                    b if isinstance(b, (list, tuple)) else [b]):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-6)


def test_eager_forward():
    xv = np.linspace(-2, 2, 12).reshape(3, 4).astype(np.float32)

    def run(pkg, py_func):
        out = py_func(_tanh_np, pkg.to_tensor(xv), pkg.zeros([3, 4]))
        return out.numpy()
    p, j = both(run)
    close(p, j)
    close(p, np.tanh(xv))


def test_eager_backward_custom_grad():
    xv = np.linspace(-1.5, 1.5, 8).astype(np.float32)

    def run(pkg, py_func):
        x = pkg.to_tensor(xv, stop_gradient=False)
        out = py_func(_tanh_np, x, pkg.zeros([8]),
                      backward_func=_tanh_grad_np)
        pkg.sum(out * out).backward()
        return x.grad.numpy()
    p, j = both(run)
    close(p, j)
    y = np.tanh(xv)
    close(p, 2 * y * (1 - y * y))


def test_eager_custom_backward_is_used():
    def run(pkg, py_func):
        x = pkg.to_tensor(np.ones(4, np.float32), stop_gradient=False)
        out = py_func(lambda a: a * 2.0, x, pkg.zeros([4]),
                      backward_func=lambda a, y, dy: [np.full_like(dy, 7.0)])
        pkg.sum(out).backward()
        return x.grad.numpy()
    p, j = both(run)
    close(p, j)
    close(p, np.full(4, 7.0))


def test_eager_no_backward_func_stops_gradient():
    for pkg in (P, J):
        x = pkg.to_tensor(np.ones(4, np.float32), stop_gradient=False)
        assert PY_FUNC[pkg](_tanh_np, x, pkg.zeros([4])).stop_gradient


def test_multi_io_and_int_input():
    def gather_scale(table, idx, scale):
        return table[idx] * scale, table[idx]

    def gather_scale_grad(table, idx, scale, y0, y1, dy0, dy1):
        g = np.zeros_like(table)
        np.add.at(g, idx, dy0 * scale + dy1)
        return [g, None, np.sum(dy0 * table[idx])]

    tv = np.arange(12, dtype=np.float32).reshape(4, 3)
    iv = np.array([0, 2, 2], np.int32)

    def run(pkg, py_func):
        table = pkg.to_tensor(tv, stop_gradient=False)
        scale = pkg.to_tensor(np.float32(2.0), stop_gradient=False)
        y0, y1 = py_func(gather_scale, [table, pkg.to_tensor(iv), scale],
                         [pkg.zeros([3, 3]), pkg.zeros([3, 3])],
                         backward_func=gather_scale_grad)
        pkg.sum(y0 + 0.5 * y1).backward()
        return y0.numpy(), table.grad.numpy(), scale.grad.numpy()
    p, j = both(run)
    close(p, j)
    close(p[0], tv[iv] * 2.0)


def test_int_output_with_backward():
    def fwd(x):
        return x * 2.0, np.argsort(x).astype("int32")

    def bwd(x, y0, y1, dy0, dy1):
        assert dy1.dtype.kind == "i" and not dy1.any()
        return [dy0 * 2.0]

    def run(pkg, py_func):
        x = pkg.to_tensor(np.arange(4, dtype=np.float32),
                          stop_gradient=False)
        y0, y1 = py_func(fwd, x, [pkg.zeros([4]),
                                  pkg.zeros([4], dtype="int32")],
                         backward_func=bwd)
        assert y1.dtype == "int32"
        pkg.sum(y0).backward()
        return x.grad.numpy()
    p, j = both(run)
    close(p, j)
    close(p, np.full(4, 2.0))


def test_skip_vars_in_backward_input():
    def run(pkg, py_func):
        seen = {}

        def bwd(*arrays):
            seen["n"] = len(arrays)
            y, dy = arrays
            return [dy * 3.0]

        x = pkg.to_tensor(np.ones(5, np.float32), stop_gradient=False)
        out = py_func(lambda a: a + 1.0, x, pkg.zeros([5]),
                      backward_func=bwd, skip_vars_in_backward_input=x)
        pkg.sum(out).backward()
        assert seen["n"] == 2
        return x.grad.numpy()
    p, j = both(run)
    close(p, j)
    close(p, np.full(5, 3.0))


def test_skip_var_must_be_known():
    for pkg in (P, J):
        x = pkg.to_tensor(np.ones(2, np.float32))
        stranger = pkg.to_tensor(np.ones(2, np.float32))
        with pytest.raises(ValueError):
            PY_FUNC[pkg](_tanh_np, x, pkg.zeros([2]),
                         backward_func=_tanh_grad_np,
                         skip_vars_in_backward_input=stranger)


def test_shape_mismatch_raises():
    for pkg in (P, J):
        x = pkg.to_tensor(np.ones(5, np.float32))
        with pytest.raises(Exception):
            PY_FUNC[pkg](lambda a: np.ones((2, 2), np.float32), x,
                         pkg.zeros([5])).numpy()


def test_wrong_number_of_outputs_raises():
    x = P.to_tensor(np.ones(3, np.float32))
    with pytest.raises(ValueError, match="returned 2 values"):
        P.py_func(lambda a: (a, a), x, P.zeros([3]))


def test_func_must_be_callable():
    with pytest.raises(TypeError):
        P.py_func(None, P.to_tensor([1.0]), P.zeros([1]))
