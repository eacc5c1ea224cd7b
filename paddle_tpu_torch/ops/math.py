"""Math ops — counterpart of ``paddle_tpu/ops/math.py``: elementwise
binary and unary ops, reductions, the matmul family, comparisons,
logical and bitwise ops and statistics, each one torch expression
wrapped by ``core.dispatch.primitive`` under the JAX package's op name
(the amp site).
"""
from __future__ import annotations

import builtins

import torch

from ..core.dispatch import primitive, ensure_tensor
from ..core.tensor import Tensor
from ..core import dtype as dtypes


def _binary(name, fn):
    prim = primitive(name=name)(fn)

    def op(x, y, name=None):
        x = ensure_tensor(x, ref=y if isinstance(y, Tensor) else None)
        y = ensure_tensor(y, ref=x)
        return prim(x, y)

    op.__name__ = name
    return op


def _unary(name, fn):
    prim = primitive(name=name)(fn)

    def op(x, name=None):
        return prim(ensure_tensor(x))

    op.__name__ = name
    return op


def _float(a):
    """``a`` in the default floating dtype when it is integer or bool
    (jnp's promotion of an integer input to a float op)."""
    if a.is_floating_point() or a.is_complex():
        return a
    return a.to(dtypes.to_torch(dtypes.get_default_dtype()))


# ---- elementwise binary -------------------------------------------------
add = _binary("elementwise_add", torch.add)
subtract = _binary("elementwise_sub", torch.sub)
multiply = _binary("elementwise_mul", torch.mul)
divide = _binary("elementwise_div", torch.true_divide)
floor_divide = _binary("elementwise_floordiv", torch.floor_divide)
remainder = _binary("elementwise_mod", torch.remainder)
mod = remainder
floor_mod = remainder
pow_ = _binary("elementwise_pow", torch.pow)
maximum = _binary("elementwise_max", torch.maximum)
minimum = _binary("elementwise_min", torch.minimum)
fmax = _binary("elementwise_fmax", torch.fmax)
fmin = _binary("elementwise_fmin", torch.fmin)
atan2 = _binary("atan2", lambda a, b: torch.atan2(_float(a), _float(b)))
hypot = _binary("hypot", lambda a, b: torch.hypot(_float(a), _float(b)))


def pow(x, y, name=None):  # noqa: A001 - paddle API name
    return pow_(x, y)


def _imag(a):
    return torch.imag(a) if a.is_complex() else torch.zeros_like(a)


# ---- elementwise unary --------------------------------------------------
neg = _unary("neg", torch.neg)
abs = _unary("abs", torch.abs)  # noqa: A001
sqrt = _unary("sqrt", lambda a: torch.sqrt(_float(a)))
rsqrt = _unary("rsqrt", lambda a: torch.rsqrt(_float(a)))
square = _unary("square", torch.square)
exp = _unary("exp", lambda a: torch.exp(_float(a)))
expm1 = _unary("expm1", lambda a: torch.expm1(_float(a)))
log = _unary("log", lambda a: torch.log(_float(a)))
log2 = _unary("log2", lambda a: torch.log2(_float(a)))
log10 = _unary("log10", lambda a: torch.log10(_float(a)))
log1p = _unary("log1p", lambda a: torch.log1p(_float(a)))
sin = _unary("sin", lambda a: torch.sin(_float(a)))
cos = _unary("cos", lambda a: torch.cos(_float(a)))
tan = _unary("tan", lambda a: torch.tan(_float(a)))
asin = _unary("asin", lambda a: torch.asin(_float(a)))
acos = _unary("acos", lambda a: torch.acos(_float(a)))
atan = _unary("atan", lambda a: torch.atan(_float(a)))
sinh = _unary("sinh", lambda a: torch.sinh(_float(a)))
cosh = _unary("cosh", lambda a: torch.cosh(_float(a)))
tanh = _unary("tanh", lambda a: torch.tanh(_float(a)))
asinh = _unary("asinh", lambda a: torch.asinh(_float(a)))
acosh = _unary("acosh", lambda a: torch.acosh(_float(a)))
atanh = _unary("atanh", lambda a: torch.atanh(_float(a)))
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)  # noqa: A001
trunc = _unary("trunc", torch.trunc)
sign = _unary("sign", torch.sign)
reciprocal = _unary("reciprocal", lambda a: torch.reciprocal(_float(a)))
erf = _unary("erf", lambda a: torch.erf(_float(a)))
erfinv = _unary("erfinv", lambda a: torch.erfinv(_float(a)))
sigmoid = _unary("sigmoid", lambda a: torch.sigmoid(_float(a)))
lgamma = _unary("lgamma", lambda a: torch.lgamma(_float(a)))
digamma = _unary("digamma", lambda a: torch.digamma(_float(a)))
frac = _unary("frac", lambda a: a - torch.trunc(a))
angle = _unary("angle", torch.angle)
conj = _unary("conj", lambda a: torch.conj(a).resolve_conj())
real = _unary("real", torch.real)
imag = _unary("imag", _imag)

isnan = _unary("isnan", torch.isnan)
isinf = _unary("isinf", torch.isinf)
isfinite = _unary("isfinite", torch.isfinite)


@primitive(name="clip")
def _clip(x, min=None, max=None):
    return torch.clamp(x, min, max)


def clip(x, min=None, max=None, name=None):
    min = float(min) if isinstance(min, Tensor) else min
    max = float(max) if isinstance(max, Tensor) else max
    return _clip(ensure_tensor(x), min=min, max=max)


@primitive(name="scale")
def _scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """reference: operators/scale_op.cc"""
    return _scale(ensure_tensor(x),
                  scale=float(scale) if not isinstance(scale, Tensor)
                  else scale.item(),
                  bias=float(bias), bias_after_scale=bias_after_scale)


@primitive(name="lerp")
def _lerp(x, y, w):
    return x + w * (y - x)


def lerp(x, y, weight, name=None):
    x = ensure_tensor(x)
    weight = ensure_tensor(weight, ref=x) if not isinstance(
        weight, Tensor) else weight
    return _lerp(x, ensure_tensor(y, ref=x), weight)


@primitive(name="stanh")
def _stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _stanh(ensure_tensor(x), scale_a=scale_a, scale_b=scale_b)


# ---- reductions ---------------------------------------------------------
def _dims(a, axis):
    """torch's ``dim`` for a numpy-style ``axis`` (None: every axis)."""
    if axis is None:
        return tuple(range(a.dim()))
    if isinstance(axis, (list, tuple)):
        return tuple(int(d) % builtins.max(a.dim(), 1) for d in axis)
    return (int(axis) % builtins.max(a.dim(), 1),)


def _over(fn):
    """A reduction over any set of axes from one that takes one axis:
    the reduced axes moved last and flattened."""
    def red(a, axis=None, keepdims=False):
        if a.dim() == 0:
            return fn(a.reshape(1), 0)
        dims = _dims(a, axis)
        keep = [d for d in range(a.dim()) if d not in dims]
        moved = a.permute(*keep, *dims).reshape(
            *[a.shape[d] for d in keep], -1)
        out = fn(moved, -1)
        if keepdims:
            out = out.reshape([1 if d in dims else a.shape[d]
                               for d in range(a.dim())])
        return out
    return red


def _sum(a, axis=None, keepdims=False):
    if a.dim() == 0:
        return a.clone() if a.is_floating_point() else a.to(torch.int64)
    return torch.sum(a, dim=_dims(a, axis), keepdim=keepdims)


def _mean(a, axis=None, keepdims=False):
    a = _float(a)
    if a.dim() == 0:
        return a.clone()
    return torch.mean(a, dim=_dims(a, axis), keepdim=keepdims)


def _amax(a, axis=None, keepdims=False):
    if a.dim() == 0:
        return a.clone()
    return torch.amax(a, dim=_dims(a, axis), keepdim=keepdims)


def _amin(a, axis=None, keepdims=False):
    if a.dim() == 0:
        return a.clone()
    return torch.amin(a, dim=_dims(a, axis), keepdim=keepdims)


def _all(a, axis=None, keepdims=False):
    if a.dim() == 0:
        return a.bool()
    return torch.all(a, dim=_dims(a, axis), keepdim=keepdims)


def _any(a, axis=None, keepdims=False):
    if a.dim() == 0:
        return a.bool()
    return torch.any(a, dim=_dims(a, axis), keepdim=keepdims)


def _reduce(name, fn):
    prim = primitive(name=name)(fn)

    def op(x, axis=None, keepdim=False, name=None):
        x = ensure_tensor(x)
        if isinstance(axis, (list, tuple)):
            axis = tuple(int(a) for a in axis)
        elif axis is not None and not isinstance(axis, int):
            axis = int(axis)
        return prim(x, axis=axis, keepdims=keepdim)

    op.__name__ = name
    return op


sum = _reduce("reduce_sum", _sum)  # noqa: A001
mean = _reduce("reduce_mean", _mean)
prod = _reduce("reduce_prod", _over(lambda a, d: torch.prod(a, dim=d)))
max = _reduce("reduce_max", _amax)  # noqa: A001
min = _reduce("reduce_min", _amin)  # noqa: A001
amax = max
amin = min
all = _reduce("reduce_all", _all)  # noqa: A001
any = _reduce("reduce_any", _any)  # noqa: A001


def nansum(x, axis=None, keepdim=False, name=None):
    return primitive(name="nansum")(
        lambda a: torch.nansum(a, dim=_dims(a, axis), keepdim=keepdim))(
        ensure_tensor(x))


@primitive(name="logsumexp")
def _logsumexp(x, axis=None, keepdims=False):
    return torch.logsumexp(_float(x), dim=_dims(x, axis), keepdim=keepdims)


def logsumexp(x, axis=None, keepdim=False, name=None):
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    return _logsumexp(ensure_tensor(x), axis=axis, keepdims=keepdim)


@primitive(name="cumsum")
def _cumsum(x, axis=None):
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0)
    return torch.cumsum(x, int(axis))


def cumsum(x, axis=None, dtype=None, name=None):
    x = ensure_tensor(x)
    if dtype is not None:
        x = x.astype(dtype)
    return _cumsum(x, axis=axis)


@primitive(name="cumprod")
def _cumprod(x, axis=None):
    if axis is None:
        return torch.cumprod(x.reshape(-1), 0)
    return torch.cumprod(x, int(axis))


def cumprod(x, dim=None, dtype=None, name=None):
    x = ensure_tensor(x)
    if dtype is not None:
        x = x.astype(dtype)
    return _cumprod(x, axis=dim)


# ---- matmul family ------------------------------------------------------
@primitive(name="matmul_v2")
def _matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return _matmul(ensure_tensor(x), ensure_tensor(y),
                   transpose_x=transpose_x, transpose_y=transpose_y)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return matmul(x, y)


dot_ = primitive(name="dot")(lambda x, y: torch.sum(x * y, dim=-1))


def dot(x, y, name=None):
    return dot_(ensure_tensor(x), ensure_tensor(y))


@primitive(name="addmm")
def _addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.matmul(x, y)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return _addmm(ensure_tensor(input), ensure_tensor(x), ensure_tensor(y),
                  beta=float(beta), alpha=float(alpha))


@primitive(name="outer")
def _outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


def outer(x, y, name=None):
    return _outer(ensure_tensor(x), ensure_tensor(y))


def mv(x, vec, name=None):
    return matmul(x, vec)


@primitive(name="multiply_sum")
def _inner(x, y):
    return torch.inner(x, y)


def inner(x, y, name=None):
    return _inner(ensure_tensor(x), ensure_tensor(y))


# ---- comparison ---------------------------------------------------------
equal = _binary("equal", torch.eq)
not_equal = _binary("not_equal", torch.ne)
greater_than = _binary("greater_than", torch.gt)
greater_equal = _binary("greater_equal", torch.ge)
less_than = _binary("less_than", torch.lt)
less_equal = _binary("less_equal", torch.le)


def equal_all(x, y, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    if tuple(x.shape) != tuple(y.shape):
        return Tensor._wrap(torch.tensor(False, device=x._data.device))
    return primitive(name="equal_all")(
        lambda a, b: torch.all(a == b))(x, y)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return primitive(name="allclose")(
        lambda a, b: torch.all(torch.isclose(
            a, b.to(a.dtype), rtol=rtol, atol=atol, equal_nan=equal_nan)))(
        ensure_tensor(x), ensure_tensor(y))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return primitive(name="isclose")(
        lambda a, b: torch.isclose(a, b.to(a.dtype), rtol=rtol, atol=atol,
                                   equal_nan=equal_nan))(
        ensure_tensor(x), ensure_tensor(y))


# ---- logical ------------------------------------------------------------
logical_and = _binary("logical_and", torch.logical_and)
logical_or = _binary("logical_or", torch.logical_or)
logical_xor = _binary("logical_xor", torch.logical_xor)
logical_not = _unary("logical_not", torch.logical_not)
bitwise_and = _binary("bitwise_and", torch.bitwise_and)
bitwise_or = _binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary("bitwise_xor", torch.bitwise_xor)
bitwise_not = _unary("bitwise_not", torch.bitwise_not)


# ---- stat ---------------------------------------------------------------
def _correction_reduce(name, fn):
    prim = primitive(name=name)(
        lambda a, axis=None, ddof=1, keepdims=False: fn(
            _float(a), dim=_dims(a, axis), correction=ddof,
            keepdim=keepdims))

    def op(x, axis=None, unbiased=True, keepdim=False, name=None):
        if isinstance(axis, (list, tuple)):
            axis = tuple(axis)
        return prim(ensure_tensor(x), axis=axis,
                    ddof=1 if unbiased else 0, keepdims=keepdim)

    op.__name__ = name
    return op


var = _correction_reduce("reduce_var", torch.var)
std = _correction_reduce("reduce_std", torch.std)


def _quantile_impl(x, q, axis=None, keepdims=False):
    x = _float(x)
    q_t = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = torch.quantile(x.reshape(-1), q_t)
        if keepdims:
            out = out.reshape(tuple(q_t.shape) + (1,) * x.dim())
        return out
    return torch.quantile(x, q_t, dim=int(axis), keepdim=keepdims)


@primitive(name="median")
def _median(x, axis=None, keepdims=False):
    # numpy's median: the mean of the two middle values
    return _quantile_impl(x, 0.5, axis, keepdims)


def median(x, axis=None, keepdim=False, name=None):
    return _median(ensure_tensor(x), axis=axis, keepdims=keepdim)


@primitive(name="quantile")
def _quantile(x, q, axis=None, keepdims=False):
    return _quantile_impl(x, q, axis, keepdims)


def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(ensure_tensor(x), q, axis=axis, keepdims=keepdim)


def numel(x, name=None):
    x = ensure_tensor(x)
    return Tensor._wrap(torch.tensor(x.size, dtype=torch.int64,
                                     device=x._data.device))


@primitive(name="trace")
def _trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return _trace(ensure_tensor(x), offset=offset, axis1=axis1, axis2=axis2)


def increment(x, value=1.0, name=None):
    """reference: operators/increment_op.cc — add a scalar in place, as a
    write of the value (no gradient flows through it, as in the JAX
    package)."""
    a = x._data
    return x._write(a.detach() + torch.tensor(value, dtype=a.dtype,
                                              device=a.device))


def multiplex(inputs, index, name=None):
    """reference: operators/multiplex_op.cc"""
    stacked = torch.stack([ensure_tensor(t)._data for t in inputs])
    idx = ensure_tensor(index)._data.reshape(-1).long()
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return Tensor._wrap(stacked[idx, rows[:idx.shape[0]]])


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]
