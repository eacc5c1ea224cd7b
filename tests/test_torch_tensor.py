"""The port's tensor layer core held to the JAX package's on the CPU:
``core/dtype``, ``flags``, ``device``, ``rng``, ``Tensor`` /
``Parameter`` / ``to_tensor`` and the cases of ``test_tensor.py``.

Values are compared exactly where both packages compute them exactly
and at rtol 1e-6 otherwise.  Random ops follow the RNG contract: the
same seed repeats the port's stream, the values lie in range and their
moments match the distribution; they never equal JAX's draws.  The
JAX package's int64 becomes int32 (no x64) where the port keeps int64.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import device as core_device
from paddle_tpu_torch.core import dtype as pdt
from paddle_tpu_torch.core import flags as pflags
from paddle_tpu.core import dtype as jdt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


# ---- dtype -------------------------------------------------------------
@pytest.mark.parametrize("spec", [
    "float32", "float", "double", "half", "int", "long", "bfloat", "bool",
    "uint8", "int8", "int16", "complex64", np.float32, np.int64,
    np.dtype("float16"), np.bool_, None])
def test_canonical_name_matches_jax(spec):
    assert pdt.canonical_name(spec) == jdt.canonical_name(spec)


@pytest.mark.parametrize("torch_dtype,name", [
    (torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
    (torch.int64, "int64"), (torch.bool, "bool")])
def test_torch_dtypes_have_names(torch_dtype, name):
    assert pdt.canonical_name(torch_dtype) == name
    assert pdt.to_torch(name) is torch_dtype


def test_unsupported_dtype_raises_like_jax():
    for mod in (pdt, jdt):
        with pytest.raises(TypeError, match="unsupported dtype"):
            mod.canonical_name("float8")


@pytest.mark.parametrize("fn", ["is_floating", "is_integer", "is_complex"])
def test_dtype_predicates(fn):
    for name in pdt._DTYPE_MAP:
        assert getattr(pdt, fn)(name) == getattr(jdt, fn)(name)


def test_default_dtype():
    assert P.get_default_dtype() == J.get_default_dtype() == "float32"
    try:
        P.set_default_dtype("float64")
        assert P.to_tensor([1.0]).dtype == "float64"
        assert P.zeros([2]).dtype == "float64"
        with pytest.raises(TypeError):
            P.set_default_dtype("int32")
    finally:
        P.set_default_dtype("float32")
    assert P.float32 == J.float32 == "float32" and P.bool8 == "bool"


# ---- flags -------------------------------------------------------------
def test_flag_registry_matches_jax():
    assert set(pflags._REGISTRY) == set(J.core.flags._REGISTRY)
    for name, entry in pflags._REGISTRY.items():
        assert entry["default"] == J.core.flags._REGISTRY[name]["default"]
    assert P.get_flags("FLAGS_check_nan_inf") == \
        J.get_flags("FLAGS_check_nan_inf")
    with pytest.raises(KeyError):
        P.set_flags({"FLAGS_no_such_flag": 1})


def test_flags_read_from_the_environment():
    code = ("import paddle_tpu_torch.core.flags as f; "
            "print(f.flag('check_nan_inf'), f.flag('log_level'))")
    env = dict(os.environ, FLAGS_check_nan_inf="1", FLAGS_log_level="3",
               PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["True", "3"], out.stderr


def test_check_nan_inf_raises_like_jax():
    x = np.array([1.0, 0.0], np.float32)
    msgs = []
    for pkg in (P, J):
        pkg.set_flags({"FLAGS_check_nan_inf": True})
        try:
            with pytest.raises(FloatingPointError) as err:
                pkg.log(pkg.to_tensor(x) - 1.0)
            msgs.append(str(err.value))
            pkg.exp(pkg.to_tensor(x))  # finite: no raise
        finally:
            pkg.set_flags({"FLAGS_check_nan_inf": False})
    assert msgs[0].replace("'log'", "") == msgs[1].replace("'log'", "")


# ---- device ------------------------------------------------------------
def test_places_and_set_device():
    assert P.get_device() == "cpu:0"
    assert P.to_tensor([1.0]).place == P.CPUPlace()
    assert P.TPUPlace is P.CUDAPlace
    assert P.CUDAPlace(1) == P.TPUPlace(1) != P.CPUPlace()
    assert P.CUDAPlace(0).is_tpu_place() and P.CUDAPlace(0).is_gpu_place()
    assert P.CPUPlace().is_cpu_place()
    assert not P.is_compiled_with_tpu() and not P.is_compiled_with_xpu()
    with pytest.raises(ValueError):
        P.set_device("npu")
    assert P.device_count() == torch.cuda.device_count()


def _need_a_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("checks a host without a card")


@pytest.mark.parametrize("name", ["gpu", "gpu:0", "xpu", "tpu"])
def test_the_card_without_a_card_raises(name):
    _need_a_cpu_host()
    with pytest.raises(RuntimeError, match=r'set_device\("cpu"\)'):
        P.set_device(name)


@pytest.mark.parametrize("make", [
    lambda: P.to_tensor([1.0]), lambda: P.zeros([2]), lambda: P.rand([2]),
    lambda: P.arange(3)])
def test_default_place_is_the_card(make):
    """Without ``set_device("cpu")`` the layer asks for the card, and
    raises without one, naming the remedy."""
    _need_a_cpu_host()
    core_device._current = None
    assert P.get_device() == "gpu:0"
    with pytest.raises(RuntimeError, match=r'set_device\("cpu"\)'):
        make()


# ---- rng ---------------------------------------------------------------
def test_random_reproducible():
    for draw in (lambda: P.rand([4]), lambda: P.randn([3, 2]),
                 lambda: P.randint(0, 9, [5]), lambda: P.randperm(7),
                 lambda: P.normal(0.0, 2.0, [4]),
                 lambda: P.uniform([3], min=-2.0, max=2.0)):
        P.seed(7)
        a = draw().numpy()
        P.seed(7)
        b = draw().numpy()
        np.testing.assert_array_equal(a, b)
        c = draw().numpy()
        assert not np.array_equal(a, c)
    assert P.core.rng.get_seed() == 7


def test_seed_also_seeds_torch():
    P.seed(11)
    a = torch.rand(3)
    P.seed(11)
    np.testing.assert_array_equal(a.numpy(), torch.rand(3).numpy())


def test_uniform_with_its_own_seed():
    a = P.uniform([5], seed=3).numpy()
    P.rand([4])
    np.testing.assert_array_equal(a, P.uniform([5], seed=3).numpy())


def test_randperm_and_randint():
    p = P.randperm(10)
    assert sorted(p.tolist()) == list(range(10)) and p.dtype == "int64"
    r = P.randint(0, 5, [100])
    assert r.numpy().min() >= 0 and r.numpy().max() < 5
    assert P.randint_like(P.zeros([3], dtype="int32"), 0, 4).dtype == \
        "int32"


@pytest.mark.parametrize("draw,mean,std,lo,hi", [
    (lambda: P.rand([20000]), 0.5, np.sqrt(1 / 12), 0.0, 1.0),
    (lambda: P.randn([20000]), 0.0, 1.0, -np.inf, np.inf),
    (lambda: P.standard_normal([20000]), 0.0, 1.0, -np.inf, np.inf),
    (lambda: P.uniform([20000], min=2.0, max=4.0), 3.0, np.sqrt(4 / 12),
     2.0, 4.0),
    (lambda: P.normal(1.0, 0.5, [20000]), 1.0, 0.5, -np.inf, np.inf),
    (lambda: P.normal(P.full([20000], 2.0), P.full([20000], 0.1)), 2.0, 0.1,
     -np.inf, np.inf),
    (lambda: P.bernoulli(P.full([20000], 0.3)), 0.3, np.sqrt(0.21), 0, 1),
    (lambda: P.poisson(P.full([20000], 4.0)), 4.0, 2.0, 0, np.inf),
])
def test_random_moments(draw, mean, std, lo, hi):
    P.seed(0)
    x = draw().numpy().astype(np.float64)
    assert x.min() >= lo and x.max() <= hi
    assert abs(x.mean() - mean) < 4 * std / np.sqrt(x.size)
    assert abs(x.std() - std) < 0.05 * std


def test_multinomial():
    P.seed(0)
    probs = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    s = P.multinomial(P.to_tensor(probs), 4000, replacement=True).numpy()
    assert s.dtype == np.int64 and 1 not in s
    np.testing.assert_allclose(np.bincount(s, minlength=4) / 4000, probs,
                               atol=0.03)
    s = P.multinomial(P.to_tensor(probs), 3).numpy()
    assert len(set(s.tolist())) == 3


# ---- Tensor ------------------------------------------------------------
def test_to_tensor_roundtrip():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for pkg in (P, J):
        t = pkg.to_tensor(x)
        assert t.shape == [3, 4] and t.dtype == "float32" and t.size == 12
        assert t.ndim == 2 and len(t) == 3
        np.testing.assert_array_equal(t.numpy(), x)


def test_default_dtype_f64_literal():
    assert P.to_tensor([1.0, 2.0]).dtype == J.to_tensor([1.0, 2.0]).dtype
    assert P.to_tensor(3.5).shape == J.to_tensor(3.5).shape == []
    assert P.to_tensor(True).dtype == "bool"


def test_to_tensor_wraps_a_torch_tensor_without_a_copy():
    raw = torch.arange(4.0)
    t = P.to_tensor(raw)
    assert t.torch() is raw and t._data is raw
    raw[0] = 9.0
    assert t.numpy()[0] == 9.0
    # numpy input is copied
    a = np.zeros(3, np.float32)
    t2 = P.to_tensor(a)
    a[0] = 1.0
    assert t2.numpy()[0] == 0.0


def test_to_tensor_of_a_tensor_cuts_the_graph():
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * 2.0
    z = P.to_tensor(y, stop_gradient=False)
    assert z.is_leaf and not z.stop_gradient
    assert P.to_tensor(x, dtype="int32").dtype == "int32"


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "pow", "neg",
                                "radd", "rsub", "rdiv"])
def test_arithmetic_operators(op):
    fns = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
           "mul": lambda a, b: a * b, "div": lambda a, b: b / a,
           "pow": lambda a, b: a ** 2, "neg": lambda a, b: -a,
           "radd": lambda a, b: 2 + a, "rsub": lambda a, b: 10 - a,
           "rdiv": lambda a, b: 1 / a}
    outs = []
    for pkg in (P, J):
        a = pkg.to_tensor([1.0, 2.0, 3.0])
        b = pkg.to_tensor([4.0, 5.0, 6.0])
        outs.append(fns[op](a, b).numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6)


def test_comparisons():
    for pkg in (P, J):
        a = pkg.to_tensor([1.0, 2.0, 3.0])
        b = pkg.to_tensor([3.0, 2.0, 1.0])
        np.testing.assert_array_equal((a < b).numpy(), [True, False, False])
        np.testing.assert_array_equal((a == b).numpy(), [False, True, False])


@pytest.mark.parametrize("idx", [1, (slice(1, 3), slice(2, 4)), -1,
                                 (Ellipsis, 0), [0, 2]],
                         ids=["int", "slices", "neg", "ellipsis", "list"])
def test_indexing(idx):
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    got = P.to_tensor(x)[idx].numpy()
    np.testing.assert_array_equal(got, J.to_tensor(x)[idx].numpy())
    np.testing.assert_array_equal(got, x[idx])


def test_index_by_a_tensor():
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    got = P.to_tensor(x)[P.to_tensor(np.array([0, 2]))]
    np.testing.assert_array_equal(got.numpy(), x[[0, 2]])


def test_setitem():
    for pkg in (P, J):
        t = pkg.zeros([3, 3])
        t[1, 1] = 5.0
        t[0] = pkg.to_tensor([1.0, 2.0, 3.0])
        np.testing.assert_array_equal(
            t.numpy(), [[1, 2, 3], [0, 5, 0], [0, 0, 0]])


def test_item_and_scalar():
    t = P.to_tensor(3.5)
    assert t.item() == pytest.approx(3.5)
    assert float(t) == pytest.approx(3.5) and int(t) == 3 and bool(t)
    assert P.to_tensor([[1, 2]]).item(1) == 2
    assert P.to_tensor([1.0, 2.0]).tolist() == [1.0, 2.0]
    assert [float(v) for v in P.to_tensor([1.0, 2.0])] == [1.0, 2.0]
    assert np.asarray(P.to_tensor([1, 2])).tolist() == [1, 2]


def test_astype_cast():
    t = P.to_tensor([1.5, 2.5])
    assert t.astype("int32").dtype == "int32"
    assert t.cast("float16").dtype == "float16"
    np.testing.assert_array_equal(t.astype("int32").numpy(),
                                  J.to_tensor([1.5, 2.5]).astype(
                                      "int32").numpy())
    assert P.to_tensor([1.0], dtype="bfloat16").numpy().dtype == np.float32


def test_set_value_and_fill_keep_the_storage():
    t = P.ones([2, 2])
    raw = t.torch()
    t.set_value(np.full((2, 2), 7.0, np.float32))
    assert t.numpy()[0, 0] == 7.0 and t.torch() is raw
    t.fill_(3.0)
    assert t.numpy().sum() == 12.0
    t.zero_()
    assert t.numpy().sum() == 0.0 and t.torch() is raw
    with pytest.raises(ValueError, match="shape mismatch"):
        t.set_value(np.zeros(3))
    p = P.Parameter(np.ones(2, np.float32))
    p.set_value(P.to_tensor([2.0, 3.0]))
    assert not p.stop_gradient and p.torch().is_leaf
    np.testing.assert_array_equal(p.numpy(), [2, 3])


def test_clone_detach():
    t = P.to_tensor([1.0], stop_gradient=False)
    c = t.detach()
    assert c.stop_gradient and not t.stop_gradient
    cl = t.clone()
    np.testing.assert_array_equal(cl.numpy(), t.numpy())
    assert not cl.stop_gradient and not cl.is_leaf
    d = (t * 2.0).detach_()
    assert d.stop_gradient and d.is_leaf


def test_stop_gradient_and_trainable():
    t = P.to_tensor([1.0, 2.0])
    assert t.stop_gradient and not t.trainable
    t.stop_gradient = False
    assert t.torch().requires_grad and t.trainable
    t.trainable = False
    assert not t.torch().requires_grad
    i = P.to_tensor([1, 2])
    i.stop_gradient = False          # kept beside the data: torch gives
    assert not i.stop_gradient       # integer tensors no gradient
    assert not i.torch().requires_grad


def test_parameter():
    for pkg in (P, J):
        p = pkg.Parameter(np.ones((2, 3), np.float32), name="w")
        assert p.name == "w" and p.persistable and p.trainable
        assert not pkg.Parameter(np.ones(2), trainable=False).trainable
        assert repr(p).startswith("Parameter containing:")
    assert P.VarBase is P.Tensor and P.LoDTensor is P.Tensor


def test_creation_ops():
    for pkg in (P, J):
        assert pkg.zeros([2, 3]).shape == [2, 3]
        assert pkg.ones([2]).numpy().sum() == 2.0
        assert pkg.full([2, 2], 3.0).numpy()[0, 0] == 3.0
        np.testing.assert_array_equal(pkg.arange(0, 10, 2).numpy(),
                                      [0, 2, 4, 6, 8])
        np.testing.assert_array_equal(pkg.eye(3).numpy(),
                                      np.eye(3, dtype=np.float32))
        np.testing.assert_allclose(pkg.linspace(0, 1, 5).numpy(),
                                   np.linspace(0, 1, 5), rtol=1e-6)


def test_grad_and_gradient_accessors():
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    assert x.grad is None and x.gradient() is None
    (x * x).sum().backward()
    assert x.grad is x.grad                     # one handle a gradient
    np.testing.assert_array_equal(x.gradient(), [2.0, 4.0])
    x.clear_grad()
    assert x.grad is None
    x.grad = P.to_tensor([5.0, 5.0])
    np.testing.assert_array_equal(x.torch().grad.numpy(), [5, 5])
    x.clear_gradient()
    assert x.torch().grad is None


def test_methods_and_repr():
    t = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert "shape=[2, 3]" in repr(t) and "float32" in str(t)
    assert t.value() is t and t.data is t and t.pin_memory() is t
    assert t.cpu().place == P.CPUPlace()
    assert t.to("float64").dtype == "float64"
    assert t.to("cpu", "int32").dtype == "int32"
    assert t.contiguous().shape == [2, 3]
    assert t.sum().item() == 15.0
    assert t.reshape([3, 2]).shape == [3, 2]
    assert hash(t) == id(t)


def test_top_level_exports_match_jax():
    """Every name the JAX package's top level takes from ``core`` and
    ``ops`` is at the port's top level too."""
    missing = [n for n in dir(J) if not n.startswith("_") and (
        getattr(getattr(J, n), "__module__", None) or "").startswith(
            ("paddle_tpu.core", "paddle_tpu.ops")) and not hasattr(P, n)]
    assert missing == []
    for n in ("bool8", "float32", "int64", "complex128", "linalg", "reverse",
              "crop", "VarBase", "LoDTensor", "tensor", "grad", "seed",
              "get_tensor_from_selected_rows"):
        assert hasattr(P, n), n
    assert P.reverse is P.flip and P.tensor is P.ops


# ---- the weight bridge -------------------------------------------------
def jax_from_record(rec):
    """The JAX package's object for a ``convert.tensor_to_paddle_tpu``
    record."""
    from paddle_tpu.core.selected_rows import SelectedRows
    if rec["kind"] == "SelectedRows":
        return SelectedRows(rec["rows"], rec["values"], rec["height"],
                            name=rec["name"])
    if rec["kind"] == "Parameter":
        out = J.core.tensor.Parameter(rec["value"], name=rec["name"],
                                      trainable=rec["trainable"])
    else:
        out = J.core.tensor.Tensor(rec["value"],
                                   stop_gradient=rec["stop_gradient"],
                                   name=rec["name"])
    out.persistable = rec["persistable"]
    return out


@pytest.mark.parametrize("kind", ["tensor", "grad_tensor", "parameter",
                                  "frozen_parameter", "selected_rows"])
def test_tensor_bridge_both_ways(kind):
    rs = np.random.RandomState(0)
    a = rs.rand(4, 3).astype(np.float32)
    if kind == "tensor":
        jt = J.to_tensor(a)
    elif kind == "grad_tensor":
        jt = J.to_tensor(a, stop_gradient=False)
    elif kind == "parameter":
        jt = J.core.tensor.Parameter(a, name="fc.w")
    elif kind == "frozen_parameter":
        jt = J.core.tensor.Parameter(a, name="fc.b", trainable=False)
    else:
        from paddle_tpu.core.selected_rows import SelectedRows
        jt = SelectedRows(np.array([1, 3, 1]), a[:3], 6, name="g")
    pt = convert.tensor_from_paddle_tpu(jt)
    assert type(pt).__name__ == type(jt).__name__
    assert pt.name == jt.name and pt.stop_gradient == jt.stop_gradient
    np.testing.assert_array_equal(pt.numpy(), jt.numpy())
    back = jax_from_record(convert.tensor_to_paddle_tpu(pt))
    assert type(back).__name__ == type(jt).__name__
    assert back.name == jt.name and back.stop_gradient == jt.stop_gradient
    np.testing.assert_array_equal(back.numpy(), jt.numpy())
    if kind.endswith("parameter"):
        assert pt.trainable == back.trainable == jt.trainable
        assert back.persistable == jt.persistable
    if kind == "selected_rows":
        np.testing.assert_array_equal(np.asarray(pt.rows), [1, 3, 1])
        assert pt.height == 6
