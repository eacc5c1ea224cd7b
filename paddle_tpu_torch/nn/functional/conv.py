"""Convolution functionals — counterpart of
``paddle_tpu/nn/functional/conv.py``.

The JAX package computes these with ``lax.conv_general_dilated`` (no
Pallas kernel), so torch's ``conv{1,2,3}d`` / ``conv_transpose{1,2,3}d``
are the counterpart.  Paddle's weight layouts are torch's own: a conv's
``[out, in / groups, *k]``, a transpose's ``[in, out / groups, *k]``.
Padding takes the JAX package's forms (``_norm_padding``): an int, one
per spatial dim, ``(lo, hi)`` pairs flat or nested, ``"SAME"`` or
``"VALID"``; an asymmetric or ``SAME`` padding is applied by ``F.pad``
before a conv with none.  ``data_format`` ``NLC`` / ``NHWC`` / ``NDHWC``
computes channel-first between two permutes.  Inputs pass the JAX
primitive's amp site (``conv2d`` etc., white-listed: O1 computes in
bf16) and take their common dtype.
"""
from __future__ import annotations


from torch.nn import functional as F

from ... import amp
from ._io import api

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _norm_padding(padding, nd):
    """``[(lo, hi)] * nd``, or ``"SAME"`` / ``"VALID"``."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    return [tuple(p) for p in padding[-nd:]]


def _tup(v, nd):
    return (v,) * nd if isinstance(v, int) else tuple(int(x) for x in v)


def _same_pads(shape, kernel, stride, dilation):
    pads = []
    for n, k, s, d in zip(shape, kernel, stride, dilation):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _channel_first(x, channel_last):
    return x.movedim(-1, 1) if channel_last else x


def _conv_nd(nd, x, weight, bias, stride, padding, dilation, groups,
             data_format, op_name):
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    args = (x, weight) if bias is None else (x, weight, bias)
    x, weight, *b = amp.promote(*amp.cast_inputs(op_name, *args))
    bias = b[0] if b else None
    x = _channel_first(x, channel_last)
    stride, dilation = _tup(stride, nd), _tup(dilation, nd)
    pad = _norm_padding(padding, nd)
    if pad == "VALID":
        pad = [(0, 0)] * nd
    elif pad == "SAME":
        pad = _same_pads(x.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pad):
        out = _CONV[nd](x, weight, bias, stride, [lo for lo, _ in pad],
                        dilation, groups)
    else:
        x = F.pad(x, [v for lo_hi in pad[::-1] for v in lo_hi])
        out = _CONV[nd](x, weight, bias, stride, 0, dilation, groups)
    return out.movedim(1, -1) if channel_last else out


def _make_conv(nd, op_name):
    def conv(x, weight, bias=None, stride=1, padding=0, dilation=1,
             groups=1, data_format=None, name=None):
        return _conv_nd(nd, x, weight, bias, stride, padding, dilation,
                        groups, data_format, op_name)

    conv.__name__ = conv.__qualname__ = op_name
    return api(conv)


conv1d = _make_conv(1, "conv1d")
conv2d = _make_conv(2, "conv2d")
conv3d = _make_conv(3, "conv3d")


def _conv_transpose_nd(nd, x, weight, bias, stride, padding, output_padding,
                       groups, dilation, output_size, data_format, op_name):
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    args = (x, weight) if bias is None else (x, weight, bias)
    x, weight, *b = amp.promote(*amp.cast_inputs(op_name, *args))
    bias = b[0] if b else None
    x = _channel_first(x, channel_last)
    stride, dilation = _tup(stride, nd), _tup(dilation, nd)
    pad = _norm_padding(padding, nd)
    if pad == "SAME":
        raise ValueError("SAME padding unsupported for conv_transpose")
    if pad == "VALID":
        pad = [(0, 0)] * nd
    eff_k = [(weight.shape[2 + i] - 1) * dilation[i] + 1 for i in range(nd)]
    if output_size is not None:
        osz = _tup(output_size, nd)
        output_padding = [
            osz[i] - ((x.shape[2 + i] - 1) * stride[i] - pad[i][0]
                      - pad[i][1] + eff_k[i]) for i in range(nd)]
    output_padding = _tup(output_padding, nd)
    if all(lo == hi for lo, hi in pad) and all(
            op < max(s, d) for op, s, d in
            zip(output_padding, stride, dilation)):
        out = _CONV_T[nd](x, weight, bias, stride, [lo for lo, _ in pad],
                          output_padding, groups, dilation)
    else:
        # the whole transposed conv, then cropped (or zero-extended) to
        # [lo, full - hi + output_padding) along each dim
        out = _CONV_T[nd](x, weight, None, stride, 0, 0, groups, dilation)
        for i, ((lo, hi), op) in enumerate(zip(pad, output_padding)):
            full = out.shape[2 + i]
            end = full - hi + op
            if end > full:
                cfg = [0, 0] * (nd - 1 - i) + [0, end - full]
                out = F.pad(out, cfg)
            out = out.narrow(2 + i, lo, end - lo)
        if bias is not None:
            out = out + bias.reshape((1, -1) + (1,) * nd)
    return out.movedim(1, -1) if channel_last else out


def _make_conv_transpose(nd, op_name):
    def conv_transpose(x, weight, bias=None, stride=1, padding=0,
                       output_padding=0, groups=1, dilation=1,
                       output_size=None, data_format=None, name=None):
        return _conv_transpose_nd(nd, x, weight, bias, stride, padding,
                                  output_padding, groups, dilation,
                                  output_size, data_format, op_name)

    conv_transpose.__name__ = conv_transpose.__qualname__ = op_name
    return api(conv_transpose)


conv1d_transpose = _make_conv_transpose(1, "conv1d_transpose")
conv2d_transpose = _make_conv_transpose(2, "conv2d_transpose")
conv3d_transpose = _make_conv_transpose(3, "conv3d_transpose")

