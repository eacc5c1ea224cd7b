"""Weight quantization of the port: the int8 quantizer and weight-only
int8 Linear layers (``weight_only.py``).

``_quantize_arr`` is the port's copy of
``paddle_tpu/quantization/int8.py::_quantize_arr``, the one quantizer the
JAX package shares between its int8 paths: codes are
``round(clip(x, -s, s) / s * 127)`` in f32, in that order, and
``torch.round`` rounds half to even as ``jnp.round`` does, so the same
f32 inputs give the same codes in both packages.
"""
from __future__ import annotations

import torch


def _quantize_arr(arr, scale, axis=None):
    """int8 codes of the f32 ``arr`` at ``scale`` (a scalar, or one value
    per index of ``axis``)."""
    if axis is not None:
        shape = [1] * arr.dim()
        shape[axis] = -1
        scale = scale.reshape(shape)
    q = torch.round(torch.clamp(arr, -scale, scale) / scale * 127.0)
    return q.to(torch.int8)


from .weight_only import (  # noqa: E402,F401
    WeightOnlyInt8Linear, quantize_weights_int8,
)

__all__ = ["WeightOnlyInt8Linear", "quantize_weights_int8"]
