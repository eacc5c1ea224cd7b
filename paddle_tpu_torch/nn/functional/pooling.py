"""Pooling functionals — counterpart of
``paddle_tpu/nn/functional/pooling.py``.

The JAX package pools with ``lax.reduce_window`` over NC... inputs, with
explicit ``(lo, hi)`` paddings (``-inf`` for max, zeros for avg).  The
port applies the same padding with ``F.pad`` and then torch's pooling
with none, so the windows are the JAX package's exactly:

* ``ceil_mode`` grows the high padding until the last window reaches
  the end (``_ceil_adjust``);
* ``exclusive`` avg pooling divides each window by its count of
  unpadded cells (the pooled ones of a ones tensor), else by the whole
  window, as does a ``"SAME"`` padding, exclusive or not (the JAX
  package counts only explicit paddings out);
* ``"SAME"`` / ``"VALID"`` paddings are lax's;
* adaptive pooling uses the windows ``[floor(i * n / m), ceil((i + 1) *
  n / m))``, one reduction a window when ``m`` does not divide ``n``.

``data_format`` and ``return_mask`` are taken and ignored, as in the
JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from ... import amp
from ._io import api

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _tup(v, nd):
    return (v,) * nd if isinstance(v, int) else tuple(int(x) for x in v)


def _pad_pairs(padding, nd):
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if all(isinstance(p, int) for p in padding):
        if len(padding) == nd:
            return [(p, p) for p in padding]
        if len(padding) == 2 * nd:
            return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    return [tuple(p) for p in padding[-nd:]]


def _window_pads(shape, ksize, strides, padding, ceil_mode):
    """``[(lo, hi)]`` per spatial dim as ``lax.reduce_window`` pads."""
    nd = len(ksize)
    pad = _pad_pairs(padding, nd)
    if pad == "VALID":
        return [(0, 0)] * nd
    if pad == "SAME":
        out = []
        for n, k, s in zip(shape, ksize, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        return out
    if ceil_mode:
        adj = []
        for n, k, s, (lo, hi) in zip(shape, ksize, strides, pad):
            rem = (n + lo + hi - k) % s
            adj.append((lo, hi + (s - rem if rem else 0)))
        pad = adj
    return [tuple(p) for p in pad]


def _pool(kind, nd, x, kernel_size, stride, padding, exclusive, ceil_mode):
    ksize = _tup(kernel_size, nd)
    strides = _tup(stride if stride is not None else kernel_size, nd)
    pads = _window_pads(x.shape[2:], ksize, strides, padding, ceil_mode)
    flat = [v for lo_hi in pads[::-1] for v in lo_hi]
    padded = any(flat)
    if kind == "max":
        fill = float("-inf") if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        xp = F.pad(x, flat, value=fill) if padded else x
        return _MAX[nd](xp, ksize, strides)
    xp = F.pad(x, flat) if padded else x
    summed = _AVG[nd](xp, ksize, strides) * float(np.prod(ksize))
    # a "SAME" / "VALID" string pads for the whole window, as lax does
    if exclusive and padded and not isinstance(padding, str):
        ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                                device=x.device), flat)
        counts = _AVG[nd](ones, ksize, strides) * float(np.prod(ksize))
        return summed / counts
    return summed / float(np.prod(ksize))


def _make_pool(nd, kind):
    op_name = f"{kind}_pool{nd}d"

    def pool(x, kernel_size, stride=None, padding=0, ceil_mode=False,
             exclusive=True, count_include_pad=None, return_mask=False,
             data_format=None, name=None):
        if count_include_pad is not None:
            exclusive = not count_include_pad
        x, = amp.cast_inputs(op_name, x)
        return _pool(kind, nd, x, kernel_size, stride, padding, exclusive,
                     ceil_mode)

    pool.__name__ = pool.__qualname__ = op_name
    return api(pool)


max_pool1d = _make_pool(1, "max")
max_pool2d = _make_pool(2, "max")
max_pool3d = _make_pool(3, "max")
avg_pool1d = _make_pool(1, "avg")
avg_pool2d = _make_pool(2, "avg")
avg_pool3d = _make_pool(3, "avg")


def _adaptive(kind, nd, x, output_size):
    spatial = x.shape[2:]
    out_size = _tup(output_size, nd)
    reduce_ = (lambda t, d: t.mean(dim=d, keepdim=True)) if kind == "avg" \
        else (lambda t, d: t.amax(dim=d, keepdim=True))
    if all(s % o == 0 for s, o in zip(spatial, out_size)):
        shape = list(x.shape[:2])
        red = []
        for i, (s, o) in enumerate(zip(spatial, out_size)):
            shape += [o, s // o]
            red.append(3 + 2 * i)
        y = x.reshape(shape)
        return y.mean(dim=red) if kind == "avg" else y.amax(dim=red)
    for axis in range(nd):
        s, o = spatial[axis], out_size[axis]
        starts = (np.arange(o) * s) // o
        ends = ((np.arange(o) + 1) * s + o - 1) // o
        d = 2 + axis
        x = torch.cat([reduce_(x.narrow(d, int(a), int(b - a)), d)
                       for a, b in zip(starts, ends)], dim=d)
    return x


def _make_adaptive(nd, kind):
    op_name = f"adaptive_{kind}_pool{nd}d"

    def pool(x, output_size, return_mask=False, data_format=None,
             name=None):
        x, = amp.cast_inputs(op_name, x)
        return _adaptive(kind, nd, x, output_size)

    pool.__name__ = pool.__qualname__ = op_name
    return api(pool)


adaptive_avg_pool1d = _make_adaptive(1, "avg")
adaptive_avg_pool2d = _make_adaptive(2, "avg")
adaptive_avg_pool3d = _make_adaptive(3, "avg")
adaptive_max_pool1d = _make_adaptive(1, "max")
adaptive_max_pool2d = _make_adaptive(2, "max")
adaptive_max_pool3d = _make_adaptive(3, "max")
