"""The op sweep of the Paddle tensor layer: one table of cases that the
CPU parity tests (``tests/test_torch_ops.py``: the JAX package against
the port) and ``chip_smoke.py`` phase 24 (the port on the card against
the port on the CPU) both run.

A case is ``(id, covers, fn, inputs, tol, grad)``:

* ``fn(pkg, *tensors)`` calls the op through a package's public API
  (``paddle_tpu`` or ``paddle_tpu_torch``, which share it) and returns a
  tensor, a tuple / list of them or a Python value; decompositions with
  sign or order freedom return reconstructions and sorted values;
* ``inputs`` are numpy arrays made from seeds;
* ``tol`` names the tolerance (``TOLS``); integer and bool outputs are
  compared exactly whatever it says;
* ``grad``: the float inputs need a gradient, and the gradients of
  ``sum(out_k * w_k)`` (``w_k`` fixed random weights) are compared too.

``covers`` names the public ops a case exercises; ``uncovered(pkg)``
lists the public functions of the port's ops modules that no case
covers.  This module imports numpy only.
"""
from __future__ import annotations

import numpy as np

# rtol, atol
TOLS = {"f": (1e-5, 1e-6), "t": (1e-4, 1e-5), "la": (1e-4, 1e-4)}

_rs = np.random.RandomState(0)


def f32(*shape, lo=-1.0, hi=1.0):
    return (_rs.rand(*shape) * (hi - lo) + lo).astype(np.float32)


def ints(*shape, lo=0, hi=5):
    return _rs.randint(lo, hi, shape).astype(np.int64)


def distinct(*shape):
    """Distinct floats (no ties for sorts and arg-reductions)."""
    n = int(np.prod(shape))
    return (_rs.permutation(n).astype(np.float32) / n
            + 0.01).reshape(shape)


def spd(n):
    a = f32(n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


CASES = []


def case(id, fn, inputs, tol="f", grad=False, covers=None):
    CASES.append((id, tuple(covers or (id.split("[")[0],)), fn,
                  list(inputs), tol, grad))


# ---- math: unary ----------------------------------------------------------
_POS = f32(3, 4, lo=0.5, hi=1.5)
_UNIT = f32(3, 4, lo=-0.8, hi=0.8)
_ANY = f32(3, 4, lo=-2.0, hi=2.0)
for name, x, tol in [
        ("neg", _ANY, "f"), ("abs", _ANY, "f"), ("sqrt", _POS, "t"),
        ("rsqrt", _POS, "t"), ("square", _ANY, "f"), ("exp", _ANY, "t"),
        ("expm1", _ANY, "t"), ("log", _POS, "t"), ("log2", _POS, "t"),
        ("log10", _POS, "t"), ("log1p", _POS, "t"), ("sin", _ANY, "t"),
        ("cos", _ANY, "t"), ("tan", _UNIT, "t"), ("asin", _UNIT, "t"),
        ("acos", _UNIT, "t"), ("atan", _ANY, "t"), ("sinh", _ANY, "t"),
        ("cosh", _ANY, "t"), ("tanh", _ANY, "t"), ("asinh", _ANY, "t"),
        ("acosh", _POS + 1.0, "t"), ("atanh", _UNIT, "t"),
        ("reciprocal", _POS, "t"), ("erf", _ANY, "t"),
        ("erfinv", _UNIT, "t"), ("sigmoid", _ANY, "t"),
        ("lgamma", _POS, "t"), ("digamma", _POS, "t")]:
    case(name, lambda P, t, name=name: getattr(P, name)(t), [x], tol,
         grad=True)
for name in ("floor", "ceil", "round", "trunc", "sign", "frac"):
    case(name, lambda P, t, name=name: getattr(P, name)(t),
         [_ANY * 3.0 + 0.05])
for name in ("angle", "conj", "real", "imag"):
    case(name, lambda P, t, name=name: getattr(P, name)(t), [_ANY])
_SPECIAL = np.array([1.0, np.nan, np.inf, -np.inf, 0.0], np.float32)
for name in ("isnan", "isinf", "isfinite"):
    case(name, lambda P, t, name=name: getattr(P, name)(t), [_SPECIAL])

# ---- math: binary ---------------------------------------------------------
_A = f32(3, 4, lo=0.5, hi=4.0)
_B = f32(3, 4, lo=0.5, hi=4.0)
for name in ("add", "subtract", "multiply", "divide", "maximum", "minimum",
             "pow", "atan2", "hypot"):
    case(name, lambda P, a, b, name=name: getattr(P, name)(a, b), [_A, _B],
         "t", grad=True, covers=(name, "pow_") if name == "pow" else None)
for name in ("floor_divide", "remainder", "mod", "floor_mod", "fmax",
             "fmin"):
    case(name, lambda P, a, b, name=name: getattr(P, name)(a, b), [_A, _B])
case("add[broadcast]", lambda P, a, b: P.add(a, b), [f32(3, 4), f32(4)],
     grad=True)
case("add[scalar]", lambda P, a: P.add(a, 2.5), [f32(3, 4)], grad=True)
case("multiply[int]", lambda P, a, b: P.multiply(a, b),
     [ints(3, 4), ints(3, 4)])
for name in ("equal", "not_equal", "greater_than", "greater_equal",
             "less_than", "less_equal"):
    case(name, lambda P, a, b, name=name: getattr(P, name)(a, b),
         [ints(4, 5).astype(np.float32), ints(4, 5).astype(np.float32)])
_BA = _rs.rand(4, 5) > 0.5
_BB = _rs.rand(4, 5) > 0.5
for name in ("logical_and", "logical_or", "logical_xor"):
    case(name, lambda P, a, b, name=name: getattr(P, name)(a, b),
         [_BA, _BB])
case("logical_not", lambda P, a: P.logical_not(a), [_BA])
for name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    case(name, lambda P, a, b, name=name: getattr(P, name)(a, b),
         [ints(4, 5, hi=16), ints(4, 5, hi=16)])
case("bitwise_not", lambda P, a: P.bitwise_not(a), [ints(4, 5, hi=16)])

# ---- math: reductions -----------------------------------------------------
_R = f32(2, 3, 4, lo=0.2, hi=1.2)
for name in ("sum", "mean", "prod", "max", "min", "amax", "amin"):
    for axis in (None, 1, [0, 2], -1):
        for keep in (False, True):
            case(f"{name}[{axis},{keep}]",
                 lambda P, t, name=name, axis=axis, keep=keep: getattr(
                     P, name)(t, axis=axis, keepdim=keep),
                 [_R if name not in ("max", "min", "amax", "amin")
                  else distinct(2, 3, 4)], "t", grad=True)
for name in ("all", "any"):
    for axis in (None, 1):
        case(f"{name}[{axis}]", lambda P, t, name=name, axis=axis: getattr(
            P, name)(t, axis=axis), [_rs.rand(3, 4) > 0.3])
case("sum[int]", lambda P, t: P.sum(t, axis=1), [ints(3, 4)])
case("nansum", lambda P, t: P.nansum(t, axis=1),
     [np.where(_rs.rand(3, 4) > 0.7, np.nan, f32(3, 4)).astype(
         np.float32)], "t")
case("logsumexp", lambda P, t: P.logsumexp(t, axis=1), [_ANY], "t",
     grad=True)
case("cumsum", lambda P, t: P.cumsum(t, axis=1), [_ANY], "t", grad=True)
case("cumsum[flat]", lambda P, t: P.cumsum(t), [_ANY], "t", grad=True)
case("cumprod", lambda P, t: P.cumprod(t, dim=1), [_POS], "t", grad=True)
case("var", lambda P, t: P.var(t), [_R], "t", grad=True)
case("var[axis]", lambda P, t: P.var(t, axis=1, unbiased=False,
                                      keepdim=True), [_R], "t", grad=True)
case("std", lambda P, t: P.std(t, axis=[0, 2]), [_R], "t", grad=True)
case("median", lambda P, t: P.median(t), [distinct(4, 6)], "t")
case("median[axis]", lambda P, t: P.median(t, axis=1), [distinct(4, 6)],
     "t")
case("quantile", lambda P, t: P.quantile(t, 0.25), [f32(64)], "t")
case("quantile[axis]", lambda P, t: P.quantile(t, 0.7, axis=0),
     [f32(16, 3)], "t")
case("numel", lambda P, t: P.numel(t), [_R])
case("trace", lambda P, t: P.trace(t, offset=1), [f32(4, 5)], grad=True)

# ---- math: matmul family and the rest -------------------------------------
case("matmul", lambda P, a, b: P.matmul(a, b), [f32(3, 4), f32(4, 5)], "t",
     grad=True)
case("matmul[transpose]", lambda P, a, b: P.matmul(
    a, b, transpose_x=True, transpose_y=True), [f32(4, 3), f32(5, 4)], "t",
     grad=True)
case("matmul[batched]", lambda P, a, b: P.matmul(a, b),
     [f32(2, 3, 4), f32(4, 5)], "t", grad=True)
case("mm", lambda P, a, b: P.mm(a, b), [f32(3, 4), f32(4, 2)], "t")
case("bmm", lambda P, a, b: P.bmm(a, b), [f32(2, 3, 4), f32(2, 4, 5)], "t",
     grad=True)
case("dot", lambda P, a, b: P.dot(a, b), [f32(3, 4), f32(3, 4)], "t",
     grad=True, covers=("dot", "dot_"))
case("addmm", lambda P, i, a, b: P.addmm(i, a, b, beta=0.5, alpha=2.0),
     [f32(3, 5), f32(3, 4), f32(4, 5)], "t", grad=True)
case("outer", lambda P, a, b: P.outer(a, b), [f32(3), f32(4)], grad=True)
case("mv", lambda P, a, b: P.mv(a, b), [f32(3, 4), f32(4)], "t")
case("inner", lambda P, a, b: P.inner(a, b), [f32(3, 4), f32(5, 4)], "t",
     grad=True)
case("clip", lambda P, t: P.clip(t, -0.5, 0.7), [_ANY], grad=True)
case("scale", lambda P, t: P.scale(t, 2.0, 0.5), [_ANY], grad=True)
case("scale[before]", lambda P, t: P.scale(
    t, 2.0, 0.5, bias_after_scale=False), [_ANY], grad=True,
     covers=("scale",))
case("lerp", lambda P, a, b: P.lerp(a, b, 0.3), [f32(3, 3), f32(3, 3)],
     grad=True)
case("stanh", lambda P, t: P.stanh(t), [_ANY], "t", grad=True)
case("equal_all", lambda P, a: (P.equal_all(a, a), P.equal_all(a, a + 1.0)),
     [f32(3, 4)])
case("allclose", lambda P, a, b: (P.allclose(a, a), P.allclose(a, b)),
     [f32(3, 4), f32(3, 4)])
case("isclose", lambda P, a, b: P.isclose(a, b, atol=0.3), [_A, _B])


def _increment(P, t):
    y = P.assign(t)
    P.increment(y, 2.0)
    return y


case("increment", _increment, [f32(3)])
case("multiplex", lambda P, a, b, i: P.multiplex([a, b], i),
     [f32(3, 4), f32(3, 4), np.array([[1], [0], [1]], np.int32)])

# ---- creation ---------------------------------------------------------------
case("zeros", lambda P: P.zeros([2, 3]), [])
case("ones", lambda P: P.ones([2, 3], dtype="int64"), [])
case("full", lambda P: (P.full([2, 2], 3.5), P.full([2], 7)), [])
case("empty", lambda P: P.empty([2, 3]), [])
for name in ("zeros_like", "ones_like", "empty_like"):
    case(name, lambda P, t, name=name: getattr(P, name)(t), [f32(2, 3)])
case("full_like", lambda P, t: P.full_like(t, 2.0), [f32(2, 3)])
case("arange", lambda P: (P.arange(0, 10, 2), P.arange(5),
                          P.arange(0.0, 1.0, 0.25)), [])
case("linspace", lambda P: P.linspace(0, 1, 5), [], "t")
case("logspace", lambda P: P.logspace(0, 2, 5), [], "t")
case("eye", lambda P: (P.eye(3), P.eye(2, 4)), [])
case("tril", lambda P, t: P.tril(t, 1), [f32(4, 4)], grad=True)
case("triu", lambda P, t: P.triu(t, -1), [f32(4, 4)], grad=True)
case("diag", lambda P, v, m: (P.diag(v), P.diag(v, offset=1),
                              P.diag(m), P.diag(v, padding_value=2.0)),
     [f32(3), f32(3, 3)])
case("diagflat", lambda P, t: P.diagflat(t), [f32(2, 2)])
case("meshgrid", lambda P, a, b: P.meshgrid(a, b), [f32(3), f32(4)])
case("assign", lambda P, t: P.assign(t), [f32(2, 3)], grad=True)
case("clone", lambda P, t: P.clone(t), [f32(2, 3)], grad=True)

# ---- manipulation -----------------------------------------------------------
_X = f32(2, 3, 4)
case("cast", lambda P, t: (P.cast(t, "int32"), P.cast(t, "float64")),
     [_ANY * 3])
case("reshape", lambda P, t: P.reshape(t, [4, -1]), [_X], grad=True)


def _reshape_(P, t):
    y = t * 1.0
    P.reshape_(y, [6, 4])
    return y


case("reshape_", _reshape_, [_X], grad=True)
case("transpose", lambda P, t: P.transpose(t, [2, 0, 1]), [_X], grad=True)
case("t", lambda P, t: P.t(t), [f32(3, 4)], grad=True)
case("moveaxis", lambda P, t: P.moveaxis(t, 0, 2), [_X], grad=True)
case("swapaxes", lambda P, t: P.swapaxes(t, 0, 2), [_X], grad=True)
case("squeeze", lambda P, t: (P.squeeze(t), P.squeeze(t, axis=0),
                              P.squeeze(t, axis=[0, 1])),
     [f32(1, 3, 1, 4)], grad=True)
case("unsqueeze", lambda P, t: (P.unsqueeze(t, 0), P.unsqueeze(t, [0, 3])),
     [f32(3, 4)], grad=True)
case("flatten", lambda P, t: (P.flatten(t), P.flatten(t, 1, 2)), [_X],
     grad=True)
case("concat", lambda P, a, b: P.concat([a, b], axis=1),
     [f32(2, 3), f32(2, 2)], grad=True)
case("stack", lambda P, a, b: P.stack([a, b], axis=1),
     [f32(2, 3), f32(2, 3)], grad=True)
case("split[num]", lambda P, t: P.split(t, 3, axis=1), [f32(2, 6)],
     grad=True)
case("split[sections]", lambda P, t: P.split(t, [1, -1, 2], axis=1),
     [f32(2, 6)], grad=True)
case("chunk", lambda P, t: P.chunk(t, 2, axis=0), [f32(4, 3)], grad=True)
case("unbind", lambda P, t: P.unbind(t, axis=1), [f32(2, 3)], grad=True)
case("tile", lambda P, t: P.tile(t, [2, 3]), [f32(1, 2)], grad=True)
case("expand", lambda P, t: (P.expand(t, [4, 2]), P.expand(t, [3, 4, -1])),
     [f32(1, 2)], grad=True)
case("broadcast_to", lambda P, t: P.broadcast_to(t, [3, 2]), [f32(1, 2)],
     grad=True)
case("expand_as", lambda P, t, y: P.expand_as(t, y), [f32(1, 2), f32(3, 2)])
case("broadcast_tensors", lambda P, a, b: P.broadcast_tensors([a, b]),
     [f32(3, 1), f32(1, 4)])
case("flip", lambda P, t: (P.flip(t, [1]), P.flip(t, 0)), [_X], grad=True)
case("roll", lambda P, t: (P.roll(t, 1, axis=0), P.roll(t, 2)), [_X],
     grad=True)
case("rot90", lambda P, t: P.rot90(t), [f32(3, 4)], grad=True)
_IDX = np.array([0, 2, 2], np.int64)
case("gather", lambda P, t, i: P.gather(t, i), [f32(4, 3), _IDX],
     grad=True)
case("gather[N1]", lambda P, t, i: P.gather(t, i, axis=1),
     [f32(4, 3), np.array([[2], [0]], np.int64)], grad=True)
case("gather_nd", lambda P, t, i: P.gather_nd(t, i),
     [_X, np.array([[0, 1], [1, 2]], np.int64)], grad=True)
case("scatter", lambda P, t, i, u: P.scatter(t, i, u),
     [f32(4, 3), np.array([0, 2], np.int64), f32(2, 3)], grad=True)
case("scatter[add]", lambda P, t, i, u: P.scatter(t, i, u, overwrite=False),
     [f32(4, 3), np.array([0, 2, 0], np.int64), f32(3, 3)], grad=True)
case("scatter_nd_add", lambda P, t, i, u: P.scatter_nd_add(t, i, u),
     [f32(4, 3), np.array([[1], [3], [1]], np.int64), f32(3, 3)],
     grad=True)
case("scatter_nd", lambda P, i, u: P.scatter_nd(i, u, [4, 3]),
     [np.array([[1], [3]], np.int64), f32(2, 3)], grad=True)
case("index_select", lambda P, t, i: P.index_select(t, i, axis=1),
     [f32(3, 4), np.array([3, 0], np.int64)], grad=True)
case("index_sample", lambda P, t, i: P.index_sample(t, i),
     [f32(3, 4), ints(3, 2, hi=4)], grad=True)
case("take_along_axis", lambda P, t, i: P.take_along_axis(t, i, 1),
     [f32(3, 4), ints(3, 2, hi=4)], grad=True)
case("put_along_axis", lambda P, t, i, v: P.put_along_axis(t, i, v, 1),
     [f32(3, 4), np.array([[0, 1], [2, 3], [3, 0]], np.int64), f32(3, 2)])
case("where", lambda P, c, a, b: P.where(c, a, b),
     [_rs.rand(3, 4) > 0.5, f32(3, 4), f32(3, 4)], grad=True)
case("where[nonzero]", lambda P, c: P.where(c), [_rs.rand(3, 4) > 0.5],
     covers=("where", "nonzero"))
case("masked_select", lambda P, t: P.masked_select(t, t > 0), [_ANY])
case("masked_fill", lambda P, t: P.masked_fill(t, t > 0, 9.0), [_ANY],
     grad=True)
case("nonzero", lambda P, t: (P.nonzero(t > 0),
                              P.nonzero(t > 0, as_tuple=True)), [_ANY])
_D = distinct(4, 6)
for name in ("argmax", "argmin"):
    case(name, lambda P, t, name=name: (getattr(P, name)(t),
                                        getattr(P, name)(t, axis=1),
                                        getattr(P, name)(t, axis=0,
                                                         keepdim=True)),
         [_D])
case("argsort", lambda P, t: (P.argsort(t, axis=1),
                              P.argsort(t, axis=0, descending=True)), [_D])
case("sort", lambda P, t: (P.sort(t, axis=1), P.sort(t, descending=True)),
     [_D], grad=True)
case("topk", lambda P, t: P.topk(t, 2), [_D], grad=True)
case("topk[axis0,smallest]", lambda P, t: P.topk(t, 3, axis=0,
                                                 largest=False),
     [_D], grad=True)
case("kthvalue", lambda P, t: P.kthvalue(t, 3, axis=1), [_D])
case("kthvalue[ties]", lambda P, t: P.kthvalue(t, 2, axis=1, keepdim=True),
     [np.array([[3, 1, 1, 2], [5, 5, 4, 5]], np.float32)])
case("mode", lambda P, t: P.mode(t, axis=1),
     [np.array([[1, 2, 2, 3, 3], [4, 4, 1, 1, 0]], np.float32)])
_U = np.array([3, 1, 3, 2, 1, 1], np.int64)
case("unique", lambda P, t: (P.unique(t), P.unique(
    t, return_index=True, return_inverse=True, return_counts=True)), [_U])
case("unique_consecutive", lambda P, t: P.unique_consecutive(
    t, return_inverse=True, return_counts=True),
     [np.array([1, 1, 2, 2, 2, 3, 1], np.int64)])
case("unique_consecutive[axis]", lambda P, t: P.unique_consecutive(
    t, return_counts=True, axis=0),
     [np.array([[1, 1], [1, 1], [2, 2], [1, 1]], np.int64)])
case("searchsorted", lambda P, s, v: (
    P.searchsorted(s, v), P.searchsorted(s, v, right=True)),
     [np.array([0.2, 0.5, 0.8], np.float32),
      np.array([0.1, 0.5, 0.7, 0.9], np.float32)])
case("bucketize", lambda P, v, s: P.bucketize(v, s),
     [np.array([0.1, 0.5, 0.7, 0.9], np.float32),
      np.array([0.2, 0.5, 0.8], np.float32)])
case("shard_index", lambda P, t: P.shard_index(t, 12, 3, 1),
     [np.array([[1], [6], [11]], np.int64)])
case("repeat_interleave", lambda P, t: (
    P.repeat_interleave(t, 2, axis=0), P.repeat_interleave(t, 3)),
     [f32(2, 3)], grad=True)
case("as_real", lambda P, t: P.as_real(P.as_complex(t)), [f32(3, 2)],
     covers=("as_real", "as_complex"))
case("tensordot", lambda P, a, b: (P.tensordot(a, b, 1),
                                   P.tensordot(a, b, [[1], [0]])),
     [f32(3, 4), f32(4, 2)], "t", grad=True)
case("einsum", lambda P, a, b: P.einsum("ij,jk->ik", a, b),
     [f32(2, 3), f32(3, 4)], "t", grad=True)
case("one_hot", lambda P, t: P.one_hot(t, 4),
     [np.array([0, 2, 1, 3], np.int64)])
case("diff", lambda P, t: (P.diff(t), P.diff(t, axis=0)), [f32(3, 5)],
     grad=True)

# ---- linalg -------------------------------------------------------------
_M = f32(3, 4)
for p in ("fro", 1, 2, 3, float("inf"), float("-inf"), 0):
    case(f"norm[{p}]", lambda P, t, p=p: (
        P.linalg.norm(t, p=p) if p in ("fro", 2) else
        P.linalg.norm(t, p=p, axis=1)), [_M], "t",
         grad=p not in (0,), covers=("norm",))
case("norm[keepdim]", lambda P, t: P.linalg.norm(t, p=1, axis=[0, 1],
                                                 keepdim=True),
     [_M], "t", grad=True, covers=("norm",))
case("dist", lambda P, a, b: P.linalg.dist(a, b), [f32(3, 4), f32(3, 4)],
     "t", grad=True)
_S = spd(3)
case("cholesky", lambda P, t: (P.linalg.cholesky(t),
                               P.linalg.cholesky(t, upper=True)),
     [_S], "la", grad=True)
case("inverse", lambda P, t: (P.linalg.inverse(t), P.linalg.inv(t)), [_S],
     "la", grad=True, covers=("inverse", "inv"))
case("matrix_power", lambda P, t: P.linalg.matrix_power(t, 3), [f32(3, 3)],
     "la", grad=True)
case("det", lambda P, t: (P.linalg.det(t), P.linalg.slogdet(t)),
     [(np.eye(3) * 2 + f32(3, 3) * 0.1).astype(np.float32)], "la",
     covers=("det", "slogdet"))


def _svd(P, t):
    u, s, vh = P.linalg.svd(t)
    return P.matmul(u * s, vh), s


def _qr(P, t):
    q, r = P.linalg.qr(t)
    return P.matmul(q, r), P.matmul(P.t(q), q)


def _eigh(P, t):
    w, v = P.linalg.eigh(t)
    return P.matmul(v * w, P.t(v)), w, P.linalg.eigvalsh(t)


def _eig(P, t):
    w = P.linalg.eig(t)[0]
    w2 = P.linalg.eigvals(t)
    return (P.sort(P.real(w)), P.sort(P.imag(w)), P.sort(P.real(w2)))


case("svd", _svd, [f32(4, 3)], "la")
case("qr", _qr, [f32(4, 4)], "la")
case("eigh", _eigh, [_S], "la", covers=("eigh", "eigvalsh"))
case("eig", _eig, [(_S + np.triu(f32(3, 3)) * 0.1).astype(np.float32)],
     "la", covers=("eig", "eigvals"))
case("solve", lambda P, a, b: P.linalg.solve(a, b), [_S, f32(3, 2)], "la",
     grad=True)
_TRI = np.triu(f32(3, 3) + 2 * np.eye(3, dtype=np.float32))
case("triangular_solve", lambda P, a, b: (
    P.linalg.triangular_solve(a, b),
    P.linalg.triangular_solve(a, b, transpose=True),
    P.linalg.triangular_solve(P.t(a), b, upper=False,
                              unitriangular=True)),
     [_TRI, f32(3, 2)], "la", grad=True)
case("matrix_rank", lambda P, t: P.linalg.matrix_rank(t),
     [np.array([[1, 2, 3], [2, 4, 6], [0, 1, 0]], np.float32)])
case("pinv", lambda P, t: P.linalg.pinv(t), [f32(4, 3)], "la")
case("cond", lambda P, t: P.linalg.cond(t), [_S], "la")
case("multi_dot", lambda P, a, b, c: P.linalg.multi_dot([a, b, c]),
     [f32(2, 3), f32(3, 4), f32(4, 2)], "t", grad=True)
case("cross", lambda P, a, b: (P.linalg.cross(a, b),
                               P.linalg.cross(a, b, axis=1)),
     [f32(3, 3), f32(3, 3)], "t", grad=True)
case("histogram", lambda P, t: (P.linalg.histogram(t, bins=5),
                                P.linalg.histogram(t, 4, -1, 1)),
     [f32(50)])
case("bincount", lambda P, t, w: (P.linalg.bincount(t),
                                  P.linalg.bincount(t, weights=w,
                                                    minlength=7)),
     [np.array([0, 1, 1, 3, 5], np.int64), f32(5)], "t")


def _lstsq(P, a, b):
    x, res, rank, s = P.linalg.lstsq(a, b)
    return x, res, rank, s


case("lstsq", _lstsq, [f32(5, 3), f32(5, 2)], "la")
case("lstsq[batched]", _lstsq, [f32(2, 4, 3), f32(2, 4, 2)], "la",
     covers=("lstsq",))
case("lu", lambda P, t: P.linalg.lu(t, get_infos=True),
     [(f32(3, 3) + 3 * np.eye(3)).astype(np.float32)], "la")

# ---- compat ops ---------------------------------------------------------
case("add_n", lambda P, a, b, c: P.add_n([a, b, c]),
     [f32(2, 3), f32(2, 3), f32(2, 3)], grad=True)
case("kron", lambda P, a, b: P.kron(a, b), [f32(2, 2), f32(2, 3)],
     grad=True)
case("broadcast_shape", lambda P: P.broadcast_shape([3, 1], [1, 4]), [])
case("rank", lambda P, t: P.rank(t), [_X])
case("shape", lambda P, t: P.shape(t), [_X])
case("is_tensor", lambda P, t: (P.is_tensor(t), P.is_tensor(1.0)), [_X])
case("is_empty", lambda P, t: P.is_empty(t), [_X])
case("unstack", lambda P, t: P.unstack(t, axis=1), [f32(2, 3)], grad=True)
case("slice", lambda P, t: P.slice(t, [0, 2], [0, 1], [1, 3]), [_X],
     grad=True)
case("strided_slice", lambda P, t: P.strided_slice(
    t, [1, 2], [0, 0], [3, 4], [2, 3]), [_X], grad=True)
case("crop_tensor", lambda P, t: (P.crop_tensor(t, [1, 2, 2], [1, 0, 1]),
                                  P.crop([t][0], [2, 2, 2])), [_X],
     covers=("crop_tensor", "crop"))
case("fill_constant", lambda P: P.fill_constant([2, 2], "float32", 1.5), [])
case("create_global_var", lambda P: P.create_global_var(
    [2], 3.0, "float32"), [])
case("has_inf", lambda P, t: (P.has_inf(t), P.has_nan(t)), [_SPECIAL],
     covers=("has_inf", "has_nan"))
for name in ("add", "sub", "mul", "div", "pow", "mod", "floordiv", "max",
             "min"):
    case(f"elementwise_{name}", lambda P, a, b, name=name: getattr(
        P, f"elementwise_{name}")(a, b), [_A, _B], "t")
for act in ("tanh", "relu"):
    case(f"elementwise_add[{act}]", lambda P, a, b, act=act:
         P.elementwise_add(a, b - 2.0, act=act), [_A, _B], "t",
         covers=("elementwise_add",))
for name in ("sum", "mean", "max", "min", "prod"):
    case(f"reduce_{name}", lambda P, t, name=name: getattr(
        P, f"reduce_{name}")(t, dim=1, keep_dim=True), [_R], "t")
for name, x in (("tanh_", _ANY), ("exp_", _ANY), ("sqrt_", _POS),
                ("ceil_", _ANY), ("floor_", _ANY), ("round_", _ANY)):
    def _inplace(P, t, name=name):
        y = t * 1.0
        getattr(P, name)(y)
        return y
    case(name, _inplace, [x], "t", grad=True)


def _inplace_args(P, t, u):
    y = t * 1.0
    P.squeeze_(y, axis=0)
    P.unsqueeze_(y, axis=1)
    P.clip_(y, -0.5, 0.5)
    P.subtract_(y, u)
    P.add_(y, u * 2.0)
    z = t * 1.0
    P.scatter_(z, P.to_tensor(np.array([0], np.int64)), P.t(u))
    return y, z


case("squeeze_", _inplace_args, [f32(1, 3), f32(3, 1)], "t", grad=True,
     covers=("squeeze_", "unsqueeze_", "clip_", "subtract_", "add_",
             "scatter_"))


def _array(P, t):
    arr = P.create_array("float32")
    arr = P.array_write(t, 1, arr)
    return P.array_read(arr, 1), P.array_length(arr)


case("create_array", _array, [f32(2)],
     covers=("create_array", "array_write", "array_read", "array_length"))

# ---- the Tensor dunders and methods -------------------------------------
for name, fn in [
        ("__add__", lambda a, b: a + b), ("__radd__", lambda a, b: 2.0 + a),
        ("__sub__", lambda a, b: a - b), ("__rsub__", lambda a, b: 3.0 - a),
        ("__mul__", lambda a, b: a * b), ("__rmul__", lambda a, b: 2.0 * a),
        ("__truediv__", lambda a, b: a / b),
        ("__rtruediv__", lambda a, b: 1.0 / a),
        ("__floordiv__", lambda a, b: a // b),
        ("__rfloordiv__", lambda a, b: 7.0 // a),
        ("__mod__", lambda a, b: a % b), ("__pow__", lambda a, b: a ** 2),
        ("__rpow__", lambda a, b: 2.0 ** a),
        ("__matmul__", lambda a, b: a @ b.t()),
        ("__neg__", lambda a, b: -a), ("__abs__", lambda a, b: abs(a)),
        ("__eq__", lambda a, b: a == b), ("__ne__", lambda a, b: a != b),
        ("__lt__", lambda a, b: a < b), ("__le__", lambda a, b: a <= b),
        ("__gt__", lambda a, b: a > b), ("__ge__", lambda a, b: a >= b),
        ("__invert__", lambda a, b: ~(a > b))]:
    case(name, lambda P, a, b, fn=fn: fn(a, b),
         [_A, np.round(_B, 1).astype(np.float32)], "t",
         grad=name not in ("__floordiv__", "__rfloordiv__", "__mod__",
                           "__eq__", "__ne__", "__lt__", "__le__",
                           "__gt__", "__ge__", "__invert__"),
         covers=(name,))
_G = f32(4, 6)
for idx_id, idx in [("int", 1), ("slice", (slice(1, 3), slice(2, 4))),
                    ("step", (slice(None, None, 2), slice(1, None, 3))),
                    ("neg_step", (slice(None, None, -1), slice(4, 0, -2))),
                    ("ellipsis", (Ellipsis, 1)),
                    ("none", (None, 1)),
                    ("list", [0, 2]),
                    ("array", np.array([3, 1])),
                    ("pair", (np.array([0, 2]), np.array([1, 5])))]:
    case(f"__getitem__[{idx_id}]", lambda P, t, idx=idx: t[idx], [_G],
         grad=True, covers=("__getitem__",))
case("__getitem__[tensor]", lambda P, t, i: t[i],
     [_G, np.array([2, 0], np.int64)], grad=True, covers=("__getitem__",))
case("__getitem__[mask]", lambda P, t: t[t > 0], [_G], grad=True,
     covers=("__getitem__",))


def _setitem(P, t, v):
    y = t * 3.0
    y[0] = 0.0
    y[1:3, 2] = v[:2]
    y[y > 2.0] = -1.0
    return y


case("__setitem__", _setitem, [_G, f32(4)], grad=True)


def _methods(P, t):
    return (t.sum(axis=1), t.mean(), t.max(axis=0), t.reshape([3, 8]),
            t.transpose([1, 0]), t.astype("int32"), t.flatten(),
            t.unsqueeze(0), t.abs().sqrt(), t.matmul(t.t()),
            t.cumsum(axis=1), t.norm(p=2), t.numel(), t.clip(0.0, 0.5),
            t.topk(2)[0], t.argmax(axis=1), t.tanh(), t.exp())


case("Tensor methods", _methods, [_G], "t", grad=True,
     covers=("Tensor methods",))



def _double_grad(P, xv, wv):
    x = P.to_tensor(xv, stop_gradient=False)
    w = P.to_tensor(wv, stop_gradient=False)
    y = P.sum(P.tanh(P.matmul(x, w)) ** 2)
    (gx,) = P.grad(y, x, create_graph=True)
    (gw,) = P.grad(P.sum(gx * gx), w)
    return gx, gw


case("grad[create_graph]", _double_grad, [f32(4, 3), f32(3, 2)], "t",
     covers=("grad",))

RANDOM_OPS = ("rand", "randn", "uniform", "normal", "standard_normal",
              "randint", "randint_like", "randperm", "bernoulli",
              "multinomial", "poisson")
# held by tests of their own: py_func (tests/test_torch_py_func.py),
# create_parameter (random), set_printoptions (numpy's print state)
NOT_OPS = ("py_func", "create_parameter", "set_printoptions")


def uncovered(pkg):
    """Public functions of the port's ops modules that no case covers."""
    covered = {c for case_ in CASES for c in case_[1]} | set(RANDOM_OPS) \
        | set(NOT_OPS)
    names = set()
    for mod in (pkg.ops.math, pkg.ops.creation, pkg.ops.manipulation,
                pkg.ops.linalg, pkg.ops.compat_ops):
        names |= set(mod.__all__)
    # aliases of a covered function count as covered
    out = []
    for n in sorted(names - covered):
        fn = getattr(pkg.ops, n, None) or getattr(pkg.ops.linalg, n)
        if any(getattr(pkg.ops, c, None) is fn or
               getattr(pkg.ops.linalg, c, None) is fn for c in covered):
            continue
        out.append(n)
    return out


def flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in flat(x)]
    return [out]


def run_case(pkg, case, grad):
    """``(output values, input gradients or None)`` of ``case`` through
    ``pkg`` on its current place."""
    _, _, fn, inputs, _, _ = case
    ts = [pkg.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))
          for a in inputs]
    outs = flat(fn(pkg, *ts))
    vals = [o.numpy() if isinstance(o, pkg.Tensor) else o for o in outs]
    if not grad:
        return vals, None
    loss = None
    for k, o in enumerate(outs):
        if isinstance(o, pkg.Tensor) and not o.stop_gradient and \
                np.asarray(o.numpy()).dtype.kind == "f":
            w = np.asarray(np.random.RandomState(100 + k).rand(*o.shape),
                           np.float32)
            term = pkg.sum(o * pkg.to_tensor(w))
            loss = term if loss is None else loss + term
    if loss is not None:
        loss.backward()
    return vals, [t.grad.numpy() if t.grad is not None else None
                  for t in ts]


def compare(got, want, tol, what):
    """Raise ``AssertionError`` unless ``got`` matches ``want`` (integer
    and bool exactly, floats at ``TOLS[tol]``); returns the largest
    absolute difference."""
    rtol, atol = TOLS[tol]
    if not isinstance(want, np.ndarray) and not isinstance(got, np.ndarray):
        assert got == want, what
        return 0.0
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind in "biu" or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got.astype(np.float64),
                                      want.astype(np.float64), err_msg=what)
        return 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)
    if got.size == 0:
        return 0.0
    d = np.abs(got.astype(np.complex128) - want.astype(np.complex128))
    return float(np.nanmax(np.where(np.isnan(d), 0.0, d)))


def compare_grads(got, want, tol, what):
    """``compare`` over input gradients; a missing gradient equals zeros."""
    err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if g is None and w is None:
            continue
        if g is None or w is None:
            ref = g if w is None else w
            assert not np.any(np.asarray(ref)), (what, k)
            continue
        err = max(err, compare(g, w, tol, f"{what} grad of input {k}"))
    return err


def output_places(pkg, case):
    """The places of ``case``'s tensor outputs through ``pkg``."""
    _, _, fn, inputs, _, _ = case
    outs = flat(fn(pkg, *[pkg.to_tensor(a) for a in inputs]))
    return [o.place for o in outs if isinstance(o, pkg.Tensor)]
