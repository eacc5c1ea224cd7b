"""Activation functionals — counterpart of
``paddle_tpu/nn/functional/activation.py``.

Each takes torch tensors or handles (``_io.api``) and passes its input
through ``amp.cast_inputs`` under the JAX package's primitive name, so
an activation under ``amp.auto_cast`` keeps or casts its dtype as the
JAX package's does.  ``gumbel_softmax`` draws from the tensor layer's
generator of the input's device.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ... import amp
from ._io import api


def _unary(op_name, fn):
    def act(x, name=None):
        x, = amp.cast_inputs(op_name, x)
        return fn(x)

    act.__name__ = act.__qualname__ = op_name
    return api(act)


relu = _unary("relu", torch.relu)
relu6 = _unary("relu6", lambda x: torch.clamp(x, 0.0, 6.0))
sigmoid = _unary("sigmoid", torch.sigmoid)
silu = _unary("silu", F.silu)
mish = _unary("mish", lambda x: x * torch.tanh(F.softplus(x)))
softsign = _unary("softsign", F.softsign)
tanhshrink = _unary("tanhshrink", lambda x: x - torch.tanh(x))
log_sigmoid = _unary("log_sigmoid", F.logsigmoid)
hardswish = _unary("hardswish",
                   lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0)
swish = _unary("swish", F.silu)


@api
def tanh(x, name=None):
    """tanh through the JAX package's ``tanh`` amp site."""
    x, = amp.cast_inputs("tanh", x)
    return torch.tanh(x)


@api
def gelu(x, approximate=False, name=None):
    """GELU through the ``gelu`` amp site: exact (erf) by default, as the
    JAX package's ``F.gelu``; ``approximate=True`` (or ``"tanh"``) is the
    tanh form the GPT MLP runs."""
    x, = amp.cast_inputs("gelu", x)
    tanh_form = approximate is True or approximate == "tanh"
    return F.gelu(x, approximate="tanh" if tanh_form else "none")


@api
def leaky_relu(x, negative_slope=0.01, name=None):
    x, = amp.cast_inputs("leaky_relu", x)
    return F.leaky_relu(x, negative_slope)


@api
def elu(x, alpha=1.0, name=None):
    x, = amp.cast_inputs("elu", x)
    return F.elu(x, alpha)


@api
def celu(x, alpha=1.0, name=None):
    x, = amp.cast_inputs("celu", x)
    return F.celu(x, alpha)


@api
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    x, = amp.cast_inputs("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@api
def hardtanh(x, min=-1.0, max=1.0, name=None):
    x, = amp.cast_inputs("hardtanh", x)
    return torch.clamp(x, min, max)


@api
def hardsigmoid(x, slope=1.0 / 6, offset=0.5, name=None):
    x, = amp.cast_inputs("hardsigmoid", x)
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@api
def hardshrink(x, threshold=0.5, name=None):
    x, = amp.cast_inputs("hardshrink", x)
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


@api
def softshrink(x, threshold=0.5, name=None):
    x, = amp.cast_inputs("softshrink", x)
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


@api
def softplus(x, beta=1.0, threshold=20.0, name=None):
    x, = amp.cast_inputs("softplus", x)
    scaled = beta * x
    return torch.where(scaled > threshold, x,
                       torch.logaddexp(scaled, torch.zeros_like(x)) / beta)


@api
def thresholded_relu(x, threshold=1.0, name=None):
    x, = amp.cast_inputs("thresholded_relu", x)
    return torch.where(x > threshold, x, torch.zeros_like(x))


def _cast(x, dtype):
    from ...core import dtype as dtypes
    return x if dtype is None else x.to(dtypes.to_torch(dtype))


@api
def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis`` through the ``softmax`` amp site (black-listed:
    O2 computes it in f32)."""
    x, = amp.cast_inputs("softmax", _cast(x, dtype))
    return torch.softmax(x, dim=axis)


@api
def log_softmax(x, axis=-1, dtype=None, name=None):
    x, = amp.cast_inputs("log_softmax", _cast(x, dtype))
    return torch.log_softmax(x, dim=axis)


@api
def prelu(x, weight, data_format="NCHW", name=None):
    x, weight = amp.cast_inputs("prelu", x, weight)
    w = weight
    if w.dim() == 1 and w.shape[0] > 1:
        w = w.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x > 0, x, w * x)


@api
def glu(x, axis=-1, name=None):
    x, = amp.cast_inputs("glu", x)
    return F.glu(x, dim=axis)


@api
def maxout(x, groups, axis=1, name=None):
    x, = amp.cast_inputs("maxout", x)
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis] = shape[axis] // groups
    shape.insert(axis + 1, groups)
    return x.reshape(shape).amax(dim=axis + 1)


@api
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g`` from
    the tensor layer's generator; ``hard`` gives the one-hot of the
    argmax with the soft gradient (straight-through)."""
    from ...core import rng
    u = torch.rand(x.shape, generator=rng.generator(x.device),
                   device=x.device).clamp_(1e-20, 1.0)
    g = (-torch.log(-torch.log(u))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if not hard:
        return y
    hard_y = torch.zeros_like(y).scatter_(
        axis, y.argmax(dim=axis, keepdim=True), 1.0)
    return hard_y - y.detach() + y
