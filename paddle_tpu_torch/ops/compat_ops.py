"""Legacy / 1.x-style API names kept at the paddle top level —
counterpart of ``paddle_tpu/ops/compat_ops.py``: ``add_n``,
``elementwise_*`` / ``reduce_*``, ``fill_constant`` /
``create_global_var`` / ``create_parameter``, ``has_inf`` / ``has_nan``,
the in-place ``*_`` variants, ``set_printoptions`` and the tensor-array
helpers.
"""
from __future__ import annotations

import builtins
import math as _pymath

import numpy as np
import torch

from ..core.tensor import Tensor, Parameter
from ..core.dispatch import primitive, ensure_tensor
from ..core import device as device_mod
from ..core import dtype as dtypes
from ..core import rng


# ---- aggregation / shape helpers -----------------------------------------
@primitive(name="add_n")
def _add_n(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def add_n(inputs, name=None):
    """reference: sum_op.cc (paddle.add_n)."""
    if isinstance(inputs, Tensor):
        return inputs
    return _add_n(*[ensure_tensor(x) for x in inputs])


@primitive(name="kron")
def _kron(a, b):
    return torch.kron(a, b)


def kron(x, y, name=None):
    return _kron(ensure_tensor(x), ensure_tensor(y))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def rank(input):
    return ensure_tensor(input).ndim


def shape(input):
    """reference shape_op: the shape as a 1-D int32 tensor."""
    x = ensure_tensor(input)
    return Tensor._wrap(torch.tensor(x.shape, dtype=torch.int32,
                                     device=x._data.device))


def is_tensor(x):
    return isinstance(x, Tensor)


def is_empty(x, name=None):
    x = ensure_tensor(x)
    return Tensor._wrap(torch.tensor(x.size == 0, device=x._data.device))


def unstack(x, axis=0, num=None, name=None):
    from .manipulation import split, squeeze
    x = ensure_tensor(x)
    n = num or x.shape[axis]
    return [squeeze(p, axis=axis) for p in split(x, n, axis=axis)]


def slice(input, axes, starts, ends):
    """reference slice_op.cc."""
    x = ensure_tensor(input)
    idx = [builtins.slice(None)] * x.ndim
    for ax, s, e in zip(axes, starts, ends):
        idx[ax] = builtins.slice(int(s), int(e))
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    x = ensure_tensor(x)
    idx = [builtins.slice(None)] * x.ndim
    for ax, s, e, st in zip(axes, starts, ends, strides):
        idx[ax] = builtins.slice(int(s), int(e), int(st))
    return x[tuple(idx)]


def crop_tensor(x, shape=None, offsets=None, name=None):
    x = ensure_tensor(x)
    offsets = offsets or [0] * x.ndim
    idx = tuple(builtins.slice(int(o), int(o) + int(s))
                for o, s in zip(offsets, shape))
    return x[idx]


# ---- fluid-era creation ---------------------------------------------------
def fill_constant(shape, dtype, value, name=None, out=None):
    from .creation import full
    res = full(shape, value, dtype=dtype)
    if out is not None:
        out.set_value(res)
        return out
    return res


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    place = device_mod.CPUPlace() if force_cpu else None
    t = Tensor(np.full(shape, value), dtype=dtype, place=place, name=name)
    t.persistable = persistable
    return t


def _fans(shape):
    """(fan_in, fan_out) of a weight, as the JAX package's initializers
    count them (a conv kernel is ``[out_c, in_c, *k]``)."""
    shape = list(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A Parameter of ``shape``: ``default_initializer(shape, dtype)``
    when given, else zeros for a bias and Xavier-uniform for a weight
    (the JAX package's defaults), drawn from the tensor layer's
    generator."""
    if default_initializer is not None:
        return Parameter(default_initializer(shape, dtype), name=name)
    dev = device_mod.torch_device()
    tdt = dtypes.to_torch(dtype)
    if is_bias:
        return Parameter(torch.zeros(tuple(shape), dtype=tdt, device=dev),
                         name=name)
    fin, fout = _fans(shape)
    limit = _pymath.sqrt(6.0 / (fin + fout))
    u = torch.rand(tuple(shape), generator=rng.generator(dev), dtype=tdt,
                   device=dev)
    return Parameter(u * (2 * limit) - limit, name=name)


# ---- numeric checks -------------------------------------------------------
@primitive(name="has_inf")
def _has_inf(x):
    return torch.isinf(x).any()


@primitive(name="has_nan")
def _has_nan(x):
    return torch.isnan(x).any()


def has_inf(x):
    return _has_inf(ensure_tensor(x))


def has_nan(x):
    return _has_nan(ensure_tensor(x))


# ---- elementwise_* / reduce_* legacy names -------------------------------
def _act(name):
    """The activation ``name`` over handles: an op of the tensor layer, or
    torch's functional of that name."""
    from . import math as M
    fn = getattr(M, name, None)
    if fn is not None:
        return fn
    return primitive(name=name)(getattr(torch.nn.functional, name))


def _elementwise(op_name):
    def op(x, y, axis=-1, act=None, name=None):
        from . import math as M
        out = getattr(M, op_name)(ensure_tensor(x), ensure_tensor(y))
        if act:
            out = _act(act)(out)
        return out
    op.__name__ = "elementwise_" + op_name
    return op


elementwise_add = _elementwise("add")
elementwise_sub = _elementwise("subtract")
elementwise_mul = _elementwise("multiply")
elementwise_div = _elementwise("divide")
elementwise_pow = _elementwise("pow")
elementwise_mod = _elementwise("mod")
elementwise_floordiv = _elementwise("floor_divide")
elementwise_max = _elementwise("maximum")
elementwise_min = _elementwise("minimum")


def _reduce(op_name):
    def op(input, dim=None, keep_dim=False, name=None):
        from . import math as M
        return getattr(M, op_name)(ensure_tensor(input), axis=dim,
                                   keepdim=keep_dim)
    op.__name__ = "reduce_" + op_name
    return op


reduce_sum = _reduce("sum")
reduce_mean = _reduce("mean")
reduce_max = _reduce("max")
reduce_min = _reduce("min")
reduce_prod = _reduce("prod")


# ---- in-place variants ----------------------------------------------------
def _inplace(fn_name):
    """The in-place variant of the op ``fn_name``: ``x`` rebinds to the
    op's result, so the graph keeps the op (torch refuses an in-place
    write to a leaf that requires grad; the JAX handle rebinds too)."""
    def op(x, *args, **kwargs):
        from .. import ops as O
        x = ensure_tensor(x)
        x._data = getattr(O, fn_name)(x, *args, **kwargs)._data
        return x
    op.__name__ = fn_name + "_"
    return op


tanh_ = _inplace("tanh")
squeeze_ = _inplace("squeeze")
unsqueeze_ = _inplace("unsqueeze")
scatter_ = _inplace("scatter")
exp_ = _inplace("exp")
sqrt_ = _inplace("sqrt")
ceil_ = _inplace("ceil")
floor_ = _inplace("floor")
round_ = _inplace("round")
clip_ = _inplace("clip")
subtract_ = _inplace("subtract")
add_ = _inplace("add")


# ---- printing -------------------------------------------------------------
def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """paddle.set_printoptions -> numpy printoptions (Tensor repr uses
    np.array2string)."""
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


# ---- LoDTensorArray ops ----------------------------------------------------
def create_array(dtype="float32", initialized_list=None):
    """reference: create_array — a plain list."""
    return list(initialized_list or [])


def array_write(x, i, array=None):
    i = int(i)
    if array is None:
        array = []
    while len(array) <= i:
        array.append(None)
    array[i] = ensure_tensor(x)
    return array


def array_read(array, i):
    return array[int(i)]


def array_length(array):
    return Tensor._wrap(torch.tensor(len(array), dtype=torch.int64,
                                     device=device_mod.torch_device()))


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]
