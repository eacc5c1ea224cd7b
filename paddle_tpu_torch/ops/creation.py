"""Tensor creation ops — counterpart of ``paddle_tpu/ops/creation.py``.

Every tensor is created on the current place (``core.device``); the
random ops draw from the generator ``core.rng`` keeps for that device.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import primitive, ensure_tensor
from ..core import device as device_mod
from ..core import dtype as dtypes
from ..core import rng


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        shape = [shape]
    return tuple(int(s) for s in shape)


def _dt(dtype, default=None):
    return dtypes.to_torch(dtype if dtype is not None else
                           (default or dtypes.get_default_dtype()))


def _dev():
    return device_mod.torch_device()


def _scalar(v):
    return v.item() if isinstance(v, Tensor) else v


def zeros(shape, dtype=None, name=None):
    return Tensor._wrap(torch.zeros(_shape(shape), dtype=_dt(dtype),
                                    device=_dev()))


def ones(shape, dtype=None, name=None):
    return Tensor._wrap(torch.ones(_shape(shape), dtype=_dt(dtype),
                                   device=_dev()))


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _scalar(fill_value)
    if dtype is None and isinstance(fill_value, bool):
        dtype = "bool"
    elif dtype is None and isinstance(fill_value, int):
        dtype = "int64"
    return Tensor._wrap(torch.full(_shape(shape), fill_value,
                                   dtype=_dt(dtype), device=_dev()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    x = ensure_tensor(x)
    return Tensor._wrap(torch.zeros_like(x._data, dtype=_dt(dtype, x.dtype)))


def ones_like(x, dtype=None, name=None):
    x = ensure_tensor(x)
    return Tensor._wrap(torch.ones_like(x._data, dtype=_dt(dtype, x.dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    x = ensure_tensor(x)
    return Tensor._wrap(torch.full_like(x._data, _scalar(fill_value),
                                        dtype=_dt(dtype, x.dtype)))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    for v in (start, end, step):
        if isinstance(v, float):
            dtype = dtype or "float32"
    return Tensor._wrap(torch.arange(start, end, step,
                                     dtype=_dt(dtype, "int64"),
                                     device=_dev()))


def linspace(start, stop, num, dtype=None, name=None):
    return Tensor._wrap(torch.linspace(
        float(_scalar(start)), float(_scalar(stop)), int(num),
        dtype=_dt(dtype), device=_dev()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return Tensor._wrap(torch.logspace(
        float(_scalar(start)), float(_scalar(stop)), int(num),
        base=float(base), dtype=_dt(dtype), device=_dev()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = int(num_columns) if num_columns else n
    return Tensor._wrap(torch.eye(n, m, dtype=_dt(dtype), device=_dev()))


@primitive(name="tril")
def _tril(x, diagonal=0):
    return torch.tril(x, diagonal)


def tril(x, diagonal=0, name=None):
    return _tril(ensure_tensor(x), diagonal=int(diagonal))


@primitive(name="triu")
def _triu(x, diagonal=0):
    return torch.triu(x, diagonal)


def triu(x, diagonal=0, name=None):
    return _triu(ensure_tensor(x), diagonal=int(diagonal))


@primitive(name="diag")
def _diag(x, offset=0):
    return torch.diag(x, offset)


def diag(x, offset=0, padding_value=0, name=None):
    x = ensure_tensor(x)
    if x.ndim == 1 and padding_value != 0:
        n = x.shape[0] + builtins.abs(offset)
        a = x._data
        base = torch.full((n, n), padding_value, dtype=a.dtype,
                          device=a.device)
        return Tensor._wrap(base + torch.diag(a - padding_value, offset))
    return _diag(x, offset=int(offset))


def diagflat(x, offset=0, name=None):
    return primitive(name="diagflat")(
        lambda a: torch.diagflat(a, offset))(ensure_tensor(x))


def meshgrid(*args, name=None):
    ts = [ensure_tensor(a) for a in
          (args[0] if len(args) == 1 and isinstance(args[0], (list, tuple))
           else args)]
    outs = primitive(name="meshgrid")(
        lambda *arrs: tuple(torch.meshgrid(*arrs, indexing="ij")))(*ts)
    return list(outs) if isinstance(outs, tuple) else [outs]


def assign(x, output=None):
    """reference: operators/assign_op.cc"""
    x = ensure_tensor(x)
    out = primitive(name="assign")(lambda a: a.clone())(x)
    if output is not None:
        output.set_value(out)
        return output
    return out


def clone(x, name=None):
    return assign(x)


# ---- random -------------------------------------------------------------
def _gen(seed=None):
    dev = _dev()
    return dev, rng.generator_for(seed, dev)


def rand(shape, dtype=None, name=None):
    dev, g = _gen()
    return Tensor._wrap(torch.rand(_shape(shape), generator=g,
                                   dtype=_dt(dtype), device=dev))


def randn(shape, dtype=None, name=None):
    dev, g = _gen()
    return Tensor._wrap(torch.randn(_shape(shape), generator=g,
                                    dtype=_dt(dtype), device=dev))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev, g = _gen(seed)
    u = torch.rand(_shape(shape), generator=g, dtype=_dt(dtype), device=dev)
    return Tensor._wrap(u * (float(max) - float(min)) + float(min))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    dev, g = _gen()
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = mean._data if isinstance(mean, Tensor) else mean
        s = std._data if isinstance(std, Tensor) else std
        out_shape = torch.broadcast_shapes(
            tuple(getattr(m, "shape", ())), tuple(getattr(s, "shape", ())))
        eps = torch.randn(out_shape, generator=g, dtype=_dt(None),
                          device=dev)
        return Tensor._wrap(m + s * eps)
    eps = torch.randn(_shape(shape or [1]), generator=g, dtype=_dt(None),
                      device=dev)
    return Tensor._wrap(mean + std * eps)


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev, g = _gen()
    return Tensor._wrap(torch.randint(int(low), int(high), _shape(shape),
                                      generator=g, dtype=_dt(dtype, "int64"),
                                      device=dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = ensure_tensor(x)
    return randint(low, high, x.shape, dtype or x.dtype)


def randperm(n, dtype="int64", name=None):
    dev, g = _gen()
    return Tensor._wrap(torch.randperm(int(n), generator=g, device=dev).to(
        _dt(dtype, "int64")))


def bernoulli(x, name=None):
    x = ensure_tensor(x)
    a = x._data
    g = rng.generator(a.device)
    u = torch.rand(a.shape, generator=g, dtype=torch.float32,
                   device=a.device)
    return Tensor._wrap((u < a).to(a.dtype))


def multinomial(x, num_samples=1, replacement=False, name=None):
    x = ensure_tensor(x)
    a = x._data
    out = torch.multinomial(a.float(), int(num_samples),
                            replacement=replacement,
                            generator=rng.generator(a.device))
    return Tensor._wrap(out.to(torch.int64))


def poisson(x, name=None):
    x = ensure_tensor(x)
    a = x._data
    return Tensor._wrap(torch.poisson(a.float(),
                                      generator=rng.generator(a.device))
                        .to(a.dtype))


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]
