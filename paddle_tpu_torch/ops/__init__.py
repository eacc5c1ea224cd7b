"""Ops of the port: the Paddle tensor layer's op library and the
hand-written CUDA kernels.

The tensor layer (counterpart of ``paddle_tpu/ops/__init__.py``): the
ops of ``math``, ``creation``, ``manipulation``, ``linalg`` and
``compat_ops`` over ``core.Tensor`` handles, and the operator dunders
and method forms this module attaches to ``Tensor``.

The kernels: ``ragged_paged_attn`` and ``flash_attention``, each with
its plain PyTorch version beside it.  ``flash_attention`` is a module;
its function of the same name is not exported here.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import primitive, ensure_tensor

from .math import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .compat_ops import *  # noqa: F401,F403
from .py_func import py_func  # noqa: F401
from . import math as _math
from . import manipulation as _manip
from . import linalg  # noqa: F401
from .ragged_paged_attn import (  # noqa: F401
    ragged_paged_attention, ragged_paged_attention_ref,
)


# ---- indexing -----------------------------------------------------------
def _prep_index(idx, device):
    """A numpy-style index with handles, lists and numpy arrays turned
    into torch tensors on ``device``."""
    if isinstance(idx, tuple):
        return tuple(_prep_index(i, device) for i in idx)
    if isinstance(idx, Tensor):
        idx = idx._data
    elif isinstance(idx, (list, np.ndarray)):
        idx = torch.as_tensor(np.asarray(idx))
    if isinstance(idx, torch.Tensor):
        return idx.to(device)
    return idx


def _backwards(i):
    return isinstance(i, builtins.slice) and i.step is not None and \
        i.step < 0


def _positive_steps(a, idx):
    """``(index, axes)``: ``idx`` with each negative-step slice replaced by
    the ascending slice over the same elements, and the output axes to
    flip after indexing (torch's slices take positive steps only).  Basic
    indices only: ints, slices, None and one Ellipsis."""
    items = idx if isinstance(idx, tuple) else (idx,)
    if not builtins.any(_backwards(i) for i in items):
        return idx, []
    if builtins.any(isinstance(i, torch.Tensor) for i in items):
        raise IndexError("a negative-step slice beside a tensor index is "
                         "not supported")
    if Ellipsis in items:
        k = items.index(Ellipsis)
        fill = a.dim() - builtins.sum(
            1 for i in items if i is not None and i is not Ellipsis)
        items = items[:k] + (builtins.slice(None),) * fill + items[k + 1:]
    out, axes, dim, out_axis = [], [], 0, 0
    for i in items:
        if i is None:
            out.append(i)
            out_axis += 1
            continue
        if _backwards(i):
            start, stop, step = i.indices(a.shape[dim])
            count = len(range(start, stop, step))
            lo = start + (count - 1) * step if count else 0
            out.append(builtins.slice(lo, lo + (count - 1) * -step + 1,
                                      -step))
            axes.append(out_axis)
        else:
            out.append(i)
        if isinstance(i, builtins.slice):
            out_axis += 1
        dim += 1
    return tuple(out), axes


def _getitem(x, idx):
    idx, axes = _positive_steps(x._data, _prep_index(idx, x._data.device))

    def take(a):
        res = a[idx]
        return torch.flip(res, axes) if axes else res

    return primitive(name="slice")(take)(x)


def _setitem(x, idx, value):
    a = x._data
    idx = _prep_index(idx, a.device)
    v = value._data if isinstance(value, Tensor) else torch.as_tensor(
        np.asarray(value) if not isinstance(value, torch.Tensor) else value)
    v = v.to(device=a.device, dtype=a.dtype)
    if a.requires_grad and torch.is_grad_enabled():
        # torch refuses an in-place write into a graph's leaf: rebind to
        # the out-of-place result, as the JAX handle does
        out = a.clone()
        out[idx] = v
        x._data = out
    else:
        with torch.no_grad():
            a[idx] = v
    return x


# ---- operator attachment ------------------------------------------------
def _attach():
    T = Tensor
    T.__getitem__ = _getitem
    T.__setitem__ = _setitem

    T.__add__ = lambda s, o: _math.add(s, o)
    T.__radd__ = lambda s, o: _math.add(o, s)
    T.__sub__ = lambda s, o: _math.subtract(s, o)
    T.__rsub__ = lambda s, o: _math.subtract(ensure_tensor(o, ref=s), s)
    T.__mul__ = lambda s, o: _math.multiply(s, o)
    T.__rmul__ = lambda s, o: _math.multiply(o, s)
    T.__truediv__ = lambda s, o: _math.divide(s, o)
    T.__rtruediv__ = lambda s, o: _math.divide(ensure_tensor(o, ref=s), s)
    T.__floordiv__ = lambda s, o: _math.floor_divide(s, o)
    T.__rfloordiv__ = lambda s, o: _math.floor_divide(
        ensure_tensor(o, ref=s), s)
    T.__mod__ = lambda s, o: _math.remainder(s, o)
    T.__pow__ = lambda s, o: _math.pow_(s, o)
    T.__rpow__ = lambda s, o: _math.pow_(ensure_tensor(o, ref=s), s)
    T.__matmul__ = lambda s, o: _math.matmul(s, o)
    T.__neg__ = lambda s: _math.neg(s)
    T.__abs__ = lambda s: _math.abs(s)
    T.__invert__ = lambda s: _math.logical_not(s)

    T.__eq__ = lambda s, o: _math.equal(s, o)
    T.__ne__ = lambda s, o: _math.not_equal(s, o)
    T.__lt__ = lambda s, o: _math.less_than(s, o)
    T.__le__ = lambda s, o: _math.less_equal(s, o)
    T.__gt__ = lambda s, o: _math.greater_than(s, o)
    T.__ge__ = lambda s, o: _math.greater_equal(s, o)

    method_map = {
        # math
        "add": _math.add, "subtract": _math.subtract,
        "multiply": _math.multiply, "divide": _math.divide,
        "mod": _math.remainder, "remainder": _math.remainder,
        "floor_divide": _math.floor_divide, "pow": _math.pow,
        "matmul": _math.matmul, "mm": _math.mm, "bmm": _math.bmm,
        "dot": _math.dot, "abs": _math.abs, "neg": _math.neg,
        "sqrt": _math.sqrt, "rsqrt": _math.rsqrt, "square": _math.square,
        "exp": _math.exp, "log": _math.log, "log2": _math.log2,
        "log10": _math.log10, "log1p": _math.log1p,
        "sin": _math.sin, "cos": _math.cos, "tan": _math.tan,
        "tanh": _math.tanh, "sigmoid": _math.sigmoid, "erf": _math.erf,
        "floor": _math.floor, "ceil": _math.ceil, "round": _math.round,
        "trunc": _math.trunc, "sign": _math.sign,
        "reciprocal": _math.reciprocal, "clip": _math.clip,
        "scale": _math.scale, "maximum": _math.maximum,
        "minimum": _math.minimum,
        "sum": _math.sum, "mean": _math.mean, "prod": _math.prod,
        "max": _math.max, "min": _math.min, "var": _math.var,
        "std": _math.std, "all": _math.all, "any": _math.any,
        "logsumexp": _math.logsumexp, "cumsum": _math.cumsum,
        "cumprod": _math.cumprod, "isnan": _math.isnan,
        "isinf": _math.isinf, "isfinite": _math.isfinite,
        "equal": _math.equal, "not_equal": _math.not_equal,
        "less_than": _math.less_than, "less_equal": _math.less_equal,
        "greater_than": _math.greater_than,
        "greater_equal": _math.greater_equal,
        "equal_all": _math.equal_all, "allclose": _math.allclose,
        "isclose": _math.isclose,
        "logical_and": _math.logical_and, "logical_or": _math.logical_or,
        "logical_not": _math.logical_not, "logical_xor": _math.logical_xor,
        "trace": _math.trace,
        # manipulation
        "reshape": _manip.reshape, "reshape_": _manip.reshape_,
        "transpose": _manip.transpose, "t": _manip.t,
        "squeeze": _manip.squeeze, "unsqueeze": _manip.unsqueeze,
        "flatten": _manip.flatten, "flip": _manip.flip,
        "roll": _manip.roll, "tile": _manip.tile, "expand": _manip.expand,
        "expand_as": _manip.expand_as,
        "broadcast_to": _manip.broadcast_to, "gather": _manip.gather,
        "gather_nd": _manip.gather_nd, "scatter": _manip.scatter,
        "scatter_nd_add": _manip.scatter_nd_add,
        "index_select": _manip.index_select,
        "masked_select": _manip.masked_select,
        "masked_fill": _manip.masked_fill,
        "where": _manip.where, "nonzero": _manip.nonzero,
        "argmax": _manip.argmax, "argmin": _manip.argmin,
        "argsort": _manip.argsort, "sort": _manip.sort,
        "topk": _manip.topk, "unique": _manip.unique,
        "split": _manip.split, "chunk": _manip.chunk,
        "unbind": _manip.unbind,
        "take_along_axis": _manip.take_along_axis,
        "repeat_interleave": _manip.repeat_interleave,
        "one_hot": _manip.one_hot,
        "norm": linalg.norm, "dist": linalg.dist,
        "numel": _math.numel,
    }
    for name, fn in method_map.items():
        if not hasattr(T, name):
            setattr(T, name, fn)


_attach()

__all__ = (list(_math.__all__) + list(_manip.__all__)
           + list(creation.__all__) + list(compat_ops.__all__)  # noqa: F405
           + ["py_func", "linalg", "primitive", "ensure_tensor"])
