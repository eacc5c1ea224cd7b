"""The port's ops held to the JAX package's on the CPU.

* Every case of ``tests/torch_op_cases.py`` (the lists of
  ``test_ops.py`` and ``test_op_sweep.py``, and every other public op of
  ``ops/``, the Tensor dunders included): the same numpy inputs through
  ``paddle_tpu`` and ``paddle_tpu_torch``, forward at the case's
  tolerance (fp32 rtol 1e-5 / atol 1e-6; transcendentals and reductions
  1e-4 / 1e-5; linear algebra by reconstruction and sorted values at
  1e-4), integer and bool outputs exactly; for the differentiable cases
  the gradients of ``sum(out * w)`` against the JAX package's gradients
  at the same tolerance.
* The places where torch's function of the same name differs
  (``split``, ``gather``, ``scatter(overwrite=False)``, reductions and
  sorts, integer dtypes, writes into a leaf, ``grad(allow_unused)``,
  ``cross(axis=9)``, out-of-range indices), one case each.

Integer dtypes differ on purpose: the JAX package runs without x64, so
its int64 inputs become int32; the port keeps int64.  Values are
compared.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as core_device

import torch_op_cases as C

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


GRAD_CASES = [c for c in C.CASES if c[5]]


@pytest.mark.parametrize("case", C.CASES, ids=[c[0] for c in C.CASES])
def test_forward_matches_jax(case):
    got, _ = C.run_case(P, case, grad=False)
    want, _ = C.run_case(J, case, grad=False)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        C.compare(g, w, case[4], f"{case[0]} output {k}")


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_grad_matches_jax(case):
    _, got = C.run_case(P, case, grad=True)
    _, want = C.run_case(J, case, grad=True)
    C.compare_grads(got, want, case[4], case[0])


def test_every_public_op_is_swept():
    assert C.uncovered(P) == []


# ---- where torch differs from the JAX package ------------------------------
def test_split_int_is_the_number_of_pieces():
    x = np.arange(12, dtype=np.float32).reshape(2, 6)
    parts = P.split(P.to_tensor(x), 3, axis=1)
    assert [p.shape for p in parts] == [[2, 2]] * 3
    assert [p.shape for p in J.split(J.to_tensor(x), 3, axis=1)] == \
        [[2, 2]] * 3
    # torch's int is the piece size
    assert len(torch.split(torch.from_numpy(x), 3, dim=1)) == 2
    with pytest.raises(ValueError, match="divisible"):
        P.split(P.to_tensor(x), 4, axis=1)
    parts = P.split(P.to_tensor(x), [2, -1], axis=1)
    assert [p.shape for p in parts] == [[2, 2], [2, 4]]


def test_gather_is_take_along_an_axis():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([[3], [1]], np.int64)
    got = P.gather(P.to_tensor(x), P.to_tensor(idx)).numpy()
    np.testing.assert_array_equal(got, x[[3, 1]])
    np.testing.assert_array_equal(
        got, J.gather(J.to_tensor(x), J.to_tensor(idx)).numpy())
    # torch.gather would pick one element a row
    assert torch.gather(torch.from_numpy(x), 0,
                        torch.from_numpy(idx)).shape == (2, 1)


def test_scatter_without_overwrite_zeroes_then_adds():
    x = np.ones((4, 2), np.float32)
    idx = np.array([1, 1, 3], np.int64)
    upd = np.array([[1, 2], [3, 4], [5, 6]], np.float32)
    got = P.scatter(P.to_tensor(x), P.to_tensor(idx), P.to_tensor(upd),
                    overwrite=False).numpy()
    want = J.scatter(J.to_tensor(x), J.to_tensor(idx), J.to_tensor(upd),
                     overwrite=False).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], [4, 6])
    np.testing.assert_array_equal(got[0], [1, 1])


def test_reductions_and_sorts_keep_paddle_semantics():
    x = np.array([[3.0, 1.0, 2.0], [5.0, 6.0, 4.0]], np.float32)
    t = P.to_tensor(x)
    assert isinstance(P.max(t, axis=1), P.Tensor)   # values only
    assert P.argmax(t, axis=1).dtype == "int64"
    v, i = P.topk(t, 2)                             # axis=None: the last
    np.testing.assert_array_equal(v.numpy(), [[3, 2], [6, 5]])
    np.testing.assert_array_equal(i.numpy(), [[0, 2], [1, 0]])
    assert i.dtype == "int64"
    u = P.unique(P.to_tensor(np.array([2, 1, 2, 0])), return_index=True,
                 return_inverse=True, return_counts=True)
    ju = J.unique(J.to_tensor(np.array([2, 1, 2, 0])), return_index=True,
                  return_inverse=True, return_counts=True)
    for a, b in zip(u, ju):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_put_along_axis_add_accumulates():
    # the JAX package's reduce="add" raises (jnp.put_along_axis has no
    # such mode: "Unknown gather mode"); the port's accumulates, as
    # numpy's add.at does
    x = np.zeros((3, 4), np.float32)
    idx = np.array([[0, 0], [2, 3], [1, 1]], np.int64)
    v = np.ones((3, 2), np.float32)
    got = P.put_along_axis(P.to_tensor(x), P.to_tensor(idx),
                           P.to_tensor(v), 1, reduce="add").numpy()
    want = x.copy()
    for r in range(3):
        np.add.at(want[r], idx[r], v[r])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="gather mode"):
        J.put_along_axis(J.to_tensor(x), J.to_tensor(idx), J.to_tensor(v),
                         1, reduce="add")


def test_integer_dtypes_stay_64_bit():
    a = np.array([1, 2, 3], np.int64)
    assert P.to_tensor(a).dtype == "int64"
    assert J.to_tensor(a).dtype == "int32"      # no x64 in the JAX package
    assert P.to_tensor(np.array([0.5])).dtype == "float32"
    assert P.to_tensor(np.array([0.5]), dtype="float64").dtype == "float64"
    assert P.arange(4).dtype == "int64"
    assert P.full([2], 3).dtype == "int64"


@pytest.mark.parametrize("write", ["setitem", "reshape_", "tanh_"])
def test_writes_into_a_leaf_rebind(write):
    """Torch refuses an in-place write into a leaf that needs a gradient;
    the port's handle rebinds to the out-of-place result (as the JAX
    handle does), so the gradient reaches the original leaf through the
    write."""
    xv = np.array([0.5, 1.0, 2.0], np.float32)
    grads = []
    for pkg in (P, J):
        x = pkg.to_tensor(xv, stop_gradient=False)
        y = x * 1.0 if write != "setitem" else x * 3.0
        if write == "setitem":
            y[0] = 0.0
        elif write == "reshape_":
            pkg.reshape_(y, [3, 1])
        else:
            pkg.tanh_(y)
        pkg.sum(y * y).backward()
        grads.append(x.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-5)
    # a leaf itself
    x = P.to_tensor(xv, stop_gradient=False)
    x[1] = 5.0
    assert not x.is_leaf
    np.testing.assert_array_equal(x.numpy(), [0.5, 5.0, 2.0])


def test_grad_of_an_unused_input_is_zeros():
    xs = []
    for pkg in (P, J):
        x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        z = pkg.to_tensor([3.0], stop_gradient=False)
        y = pkg.sum(x * x)
        gx, gz = pkg.grad(y, [x, z])
        xs.append((gx.numpy(), gz.numpy()))
        y2 = pkg.sum(x * 2.0)
        assert pkg.grad(y2, [x, z], allow_unused=True)[1] is None
    np.testing.assert_allclose(xs[0][0], xs[1][0])
    np.testing.assert_array_equal(xs[0][1], [0.0])
    np.testing.assert_array_equal(xs[1][1], [0.0])


def test_cross_default_axis_is_the_first_of_size_3():
    a = C.f32(4, 3)
    b = C.f32(4, 3)
    got = P.linalg.cross(P.to_tensor(a), P.to_tensor(b)).numpy()
    np.testing.assert_allclose(got, np.cross(a, b, axis=1), rtol=1e-5)
    a2, b2 = C.f32(3, 3, 2), C.f32(3, 3, 2)
    got = P.linalg.cross(P.to_tensor(a2), P.to_tensor(b2)).numpy()
    np.testing.assert_allclose(got, np.cross(a2, b2, axis=0), rtol=1e-5)
    np.testing.assert_allclose(
        got, J.linalg.cross(J.to_tensor(a2), J.to_tensor(b2)).numpy(),
        rtol=1e-5)


def test_decompositions_hold_by_reconstruction():
    a = C.f32(5, 4)
    u, s, vh = P.linalg.svd(P.to_tensor(a))
    np.testing.assert_allclose((u.numpy() * s.numpy()) @ vh.numpy(), a,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        s.numpy(), np.linalg.svd(a, compute_uv=False), rtol=1e-4)
    lu, piv = P.linalg.lu(P.to_tensor(C.spd(4)))
    jlu, jpiv = J.linalg.lu(J.to_tensor(C.spd(4)))
    np.testing.assert_array_equal(piv.numpy(), jpiv.numpy())  # 1-based


def test_out_of_range_indices_raise():
    """On purpose: torch checks an index, where ``jnp.take`` fills (NaN
    rows for floats) and the JAX getitem clamps."""
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    bad = np.array([0, 7], np.int64)
    with pytest.raises(IndexError):
        P.gather(P.to_tensor(x), P.to_tensor(bad))
    with pytest.raises(IndexError):
        P.to_tensor(x)[P.to_tensor(bad)]
    got = J.gather(J.to_tensor(x), J.to_tensor(bad)).numpy()
    assert np.isnan(got[1]).all()


def test_integer_input_to_float_ops():
    a = np.array([1, 4, 9], np.int64)
    np.testing.assert_allclose(P.sqrt(P.to_tensor(a)).numpy(),
                               J.sqrt(J.to_tensor(a)).numpy())
    np.testing.assert_allclose(P.mean(P.to_tensor(a)).numpy(),
                               J.mean(J.to_tensor(a)).numpy(), rtol=1e-6)
    # a Python scalar takes the tensor's dtype (paddle semantics)
    assert (P.to_tensor(a) + 2.7).dtype == "int64"
    np.testing.assert_array_equal((P.to_tensor(a) + 2.7).numpy(),
                                  (J.to_tensor(a) + 2.7).numpy())


def test_create_parameter_and_printoptions():
    p = P.create_parameter([6, 4], "float32")
    assert isinstance(p, P.Parameter) and not p.stop_gradient
    limit = np.sqrt(6.0 / 10)
    assert np.abs(p.numpy()).max() <= limit
    b = P.create_parameter([4], "float32", is_bias=True)
    np.testing.assert_array_equal(b.numpy(), np.zeros(4))
    c = P.create_parameter([2], "float32",
                           default_initializer=lambda s, d: np.ones(s))
    np.testing.assert_array_equal(c.numpy(), [1, 1])
    old = np.get_printoptions()
    try:
        P.set_printoptions(precision=2)
        assert np.get_printoptions()["precision"] == 2
    finally:
        np.set_printoptions(**old)
