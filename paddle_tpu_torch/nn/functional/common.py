"""Linear, layer norm, matmul and the activations with the JAX package's
amp sites — counterpart of ``paddle_tpu/nn/functional/common.py``
(``linear``), of ``paddle_tpu/nn/functional/activation.py`` (``gelu``,
``tanh``, ``softmax``) and of the ``layer_norm`` and ``matmul_v2``
primitives.

Each runs its inputs through ``amp.cast_inputs`` under the JAX package's
primitive name, then gives mixed floating operands their common dtype
(``amp.promote``), as jnp promotes them.  Outside ``auto_cast`` with one
dtype the module helpers call the module itself (its hooks run).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ... import amp


def _linear_site(x, weight, bias):
    """x, weight and bias (when there is one: the JAX primitive gets no
    array for a missing bias) through the ``linear`` amp site, promoted
    to their common dtype."""
    args = (x, weight) if bias is None else (x, weight, bias)
    x, weight, *bias = amp.promote(*amp.cast_inputs("linear", *args))
    return x, weight, (bias[0] if bias else None)


def linear(x, weight, bias=None):
    """paddle's linear: ``x @ weight + bias`` with ``weight [in, out]``."""
    x, weight, bias = _linear_site(x, weight, bias)
    return F.linear(x, weight.t(), bias)


def apply_linear(mod, x):
    """``mod(x)`` for a torch ``nn.Linear`` (``weight [out, in]``) through
    the ``linear`` amp site; any other module (a weight-only int8 linear)
    is called as it is."""
    if not isinstance(mod, nn.Linear) or (
            not amp.is_enabled() and x.dtype == mod.weight.dtype):
        return mod(x)
    return F.linear(*_linear_site(x, mod.weight, mod.bias))


def apply_layer_norm(mod, x):
    """``mod(x)`` for an ``nn.LayerNorm`` through the ``layer_norm`` amp
    site."""
    if not amp.is_enabled() and x.dtype == mod.weight.dtype:
        return mod(x)
    x, w, b = amp.promote(*amp.cast_inputs("layer_norm", x, mod.weight,
                                           mod.bias))
    return F.layer_norm(x, mod.normalized_shape, w, b, mod.eps)


def gelu(x, approximate=False):
    """GELU through the ``gelu`` amp site: exact (erf) by default, as the
    JAX package's ``F.gelu``; ``approximate=True`` (or ``"tanh"``) is the
    tanh form the GPT MLP runs."""
    x, = amp.cast_inputs("gelu", x)
    tanh_form = approximate is True or approximate == "tanh"
    return F.gelu(x, approximate="tanh" if tanh_form else "none")


def tanh(x):
    """tanh through the JAX package's ``tanh`` amp site."""
    x, = amp.cast_inputs("tanh", x)
    return torch.tanh(x)


def softmax(x, axis=-1):
    """Softmax over ``axis`` through the ``softmax`` amp site (black-listed:
    O2 computes it in f32)."""
    x, = amp.cast_inputs("softmax", x)
    return torch.softmax(x, dim=axis)


def matmul(x, y, transpose_x=False, transpose_y=False):
    """paddle's matmul through the JAX package's ``matmul_v2`` amp site,
    mixed operands promoted to their common dtype."""
    x, y = amp.promote(*amp.cast_inputs("matmul_v2", x, y))
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)
