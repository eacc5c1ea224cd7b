"""Eager op dispatcher — counterpart of ``paddle_tpu/core/dispatch.py``.

An op of the tensor layer is a function over torch tensors (and static
keyword arguments).  ``primitive`` wraps it so that, called with
handles, it

1. unwraps the handles to their torch tensors;
2. runs them through the port's ``amp.cast_inputs`` under the op's name
   (the JAX package's ``amp_input_hook``);
3. runs the op, with ``FLAGS_check_nan_inf`` scanning its floating
   outputs and raising ``FloatingPointError``;
4. wraps the outputs, ``stop_gradient`` being ``not requires_grad``;
   ``has_aux`` outputs get no gradient.

Torch's engine records the graph; ``nondiff`` positions are detached.
"""
from __future__ import annotations

import functools

import torch

from .. import amp
from .flags import flag
from .tensor import Tensor
from . import device as device_mod


def _unwrap(x):
    return x._data if isinstance(x, Tensor) else x


def _check_nan(name, outs):
    for o in outs:
        if (o.is_floating_point() or o.is_complex()) and \
                not bool(torch.isfinite(o).all()):
            raise FloatingPointError(
                f"NaN/Inf detected in output of op '{name}' "
                f"(FLAGS_check_nan_inf) — reference parity: "
                f"framework/details/nan_inf_utils_detail.cc:293")


def _wrap_out(name, out, detach=False):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    if flag("check_nan_inf"):
        _check_nan(name, [o for o in outs if isinstance(o, torch.Tensor)])
    return [Tensor._wrap(o.detach() if detach else o) for o in outs]


def primitive(name=None, nondiff=(), has_aux=False):
    """Wrap a function over torch tensors into an eager op over handles.

    nondiff: positional indices never differentiated.
    has_aux: fn returns (diff_out, aux_out); aux gets no gradient.
    """

    def deco(fn):
        op_name = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            arrays = amp.cast_inputs(op_name, *[_unwrap(a) for a in args])
            arrays = [a.detach() if i in nondiff and
                      isinstance(a, torch.Tensor) else a
                      for i, a in enumerate(arrays)]
            out = fn(*arrays, **kwargs)
            if has_aux:
                out, aux = out
                res = _wrap_out(op_name, out) + _wrap_out(op_name, aux,
                                                          detach=True)
            else:
                res = _wrap_out(op_name, out)
            return tuple(res) if len(res) > 1 else res[0]

        wrapper.op_name = op_name
        wrapper.raw_fn = fn
        return wrapper

    return deco


def ensure_tensor(x, dtype=None, ref=None):
    """Coerce a Python scalar, numpy array, torch tensor or handle into a
    handle.  A Python scalar beside a tensor operand ``ref`` takes its
    dtype and device (paddle semantics); anything else is created on
    ``ref``'s device, or on the current place."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x)
    if isinstance(ref, Tensor):
        if dtype is None and isinstance(x, (int, float, bool)):
            return Tensor._wrap(torch.tensor(x, dtype=ref._data.dtype,
                                             device=ref._data.device))
        return Tensor(x, dtype=dtype, place=device_mod.place_of(ref._data))
    return Tensor(x, dtype=dtype)
