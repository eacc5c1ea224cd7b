"""Linear, layer norm and gelu with the JAX package's amp sites —
counterpart of ``paddle_tpu/nn/functional/common.py`` (``linear``) and
of the ``layer_norm`` / ``gelu`` primitives.

Each runs its inputs through ``amp.cast_inputs`` under the JAX package's
primitive name, then gives mixed floating operands their common dtype
(``amp.promote``), as jnp promotes them.  Outside ``auto_cast`` with one
dtype the module helpers call the module itself (its hooks run).
"""
from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from ... import amp


def linear(x, weight, bias=None):
    """paddle's linear: ``x @ weight + bias`` with ``weight [in, out]``."""
    x, weight, bias = amp.promote(*amp.cast_inputs("linear", x, weight,
                                                   bias))
    return F.linear(x, weight.t(), bias)


def apply_linear(mod, x):
    """``mod(x)`` for a torch ``nn.Linear`` (``weight [out, in]``) through
    the ``linear`` amp site; any other module (a weight-only int8 linear)
    is called as it is."""
    if not isinstance(mod, nn.Linear) or (
            not amp.is_enabled() and x.dtype == mod.weight.dtype):
        return mod(x)
    x, w, b = amp.promote(*amp.cast_inputs("linear", x, mod.weight,
                                           mod.bias))
    return F.linear(x, w, b)


def apply_layer_norm(mod, x):
    """``mod(x)`` for an ``nn.LayerNorm`` through the ``layer_norm`` amp
    site."""
    if not amp.is_enabled() and x.dtype == mod.weight.dtype:
        return mod(x)
    x, w, b = amp.promote(*amp.cast_inputs("layer_norm", x, mod.weight,
                                           mod.bias))
    return F.layer_norm(x, mod.normalized_shape, w, b, mod.eps)


def gelu(x, approximate="tanh"):
    """GELU through the ``gelu`` amp site (tanh form by default, the JAX
    package's ``approximate=True``)."""
    x, = amp.cast_inputs("gelu", x)
    return F.gelu(x, approximate=approximate)
