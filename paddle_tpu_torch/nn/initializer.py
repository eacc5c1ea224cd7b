"""Parameter initializers — counterpart of ``paddle_tpu/nn/initializer.py``.

Each initializer is a callable ``(shape, dtype="float32", device=None)
-> torch tensor``; ``device`` None is the tensor layer's current place.
The random ones draw from the tensor layer's generator of that device
(``core/rng.py``: seeded by ``paddle_tpu_torch.seed``), or from a
generator of their own when given a nonzero ``seed``, as the JAX
package's ``key_for`` does.  One seed repeats the values on one device;
they are not the JAX package's (Philox and Mersenne Twister against
threefry), only their distribution is.

``set_global_initializer`` / ``global_initializer`` hold the defaults
``Layer.create_parameter`` consults when a ``ParamAttr`` names no
initializer.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import device as device_mod
from ..core import dtype as dtypes
from ..core import rng


def _fans(shape):
    shape = list(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels [out_c, in_c, *k] (paddle layout)
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _dev(device):
    return device_mod.torch_device() if device is None else \
        torch.device(device)


def _uniform(shape, dtype, device, seed, low, high):
    dev = _dev(device)
    u = torch.rand(tuple(shape), generator=rng.generator_for(seed, dev),
                   dtype=torch.float32, device=dev)
    return (low + (high - low) * u).to(dtypes.to_torch(dtype))


def _normal(shape, dtype, device, seed, mean=0.0, std=1.0):
    dev = _dev(device)
    n = torch.randn(tuple(shape), generator=rng.generator_for(seed, dev),
                    dtype=torch.float32, device=dev)
    return (mean + std * n).to(dtypes.to_torch(dtype))


class Initializer:
    def __call__(self, shape, dtype="float32", device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None):
        return torch.full(tuple(shape), self.value,
                          dtype=dtypes.to_torch(dtype), device=_dev(device))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, shape, dtype="float32", device=None):
        return _uniform(shape, dtype, device, self.seed, self.low,
                        self.high)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, seed=0):
        self.mean, self.std, self.seed = mean, std, seed

    def __call__(self, shape, dtype="float32", device=None):
        return _normal(shape, dtype, device, self.seed, self.mean, self.std)


class TruncatedNormal(Initializer):
    """A standard normal truncated to [-2, 2] (inverse CDF of a uniform
    draw), then ``mean + std *`` it, as ``jax.random.truncated_normal``."""

    def __init__(self, mean=0.0, std=1.0, seed=0):
        self.mean, self.std, self.seed = mean, std, seed

    def __call__(self, shape, dtype="float32", device=None):
        lo, hi = (1 + math.erf(-2.0 / math.sqrt(2))) / 2, \
            (1 + math.erf(2.0 / math.sqrt(2))) / 2
        u = _uniform(shape, "float32", device, self.seed, lo, hi)
        z = math.sqrt(2) * torch.erfinv(2 * u - 1)
        return (self.mean + self.std * z.clamp(-2.0, 2.0)).to(
            dtypes.to_torch(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, seed=0):
        self.fan_in, self.fan_out, self.seed = fan_in, fan_out, seed

    def __call__(self, shape, dtype="float32", device=None):
        fin, fout = _fans(shape)
        limit = math.sqrt(6.0 / ((self.fan_in or fin)
                                 + (self.fan_out or fout)))
        return _uniform(shape, dtype, device, self.seed, -limit, limit)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, seed=0):
        self.fan_in, self.fan_out, self.seed = fan_in, fan_out, seed

    def __call__(self, shape, dtype="float32", device=None):
        fin, fout = _fans(shape)
        std = math.sqrt(2.0 / ((self.fan_in or fin) + (self.fan_out or fout)))
        return _normal(shape, dtype, device, self.seed, 0.0, std)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 seed=0):
        self.fan_in, self.seed = fan_in, seed

    def __call__(self, shape, dtype="float32", device=None):
        limit = math.sqrt(6.0 / (self.fan_in or _fans(shape)[0]))
        return _uniform(shape, dtype, device, self.seed, -limit, limit)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 seed=0):
        self.fan_in, self.seed = fan_in, seed

    def __call__(self, shape, dtype="float32", device=None):
        std = math.sqrt(2.0 / (self.fan_in or _fans(shape)[0]))
        return _normal(shape, dtype, device, self.seed, 0.0, std)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None):
        from ..core.tensor import Tensor
        v = self.value
        if isinstance(v, Tensor):
            v = v._data
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v.detach())
        t = t.to(device=_dev(device), dtype=dtypes.to_torch(dtype))
        return t.reshape(tuple(shape)) if tuple(t.shape) != tuple(shape) \
            else t.clone()


class Bilinear(Initializer):
    """The bilinear upsampling kernel (``paddle_tpu`` ``Bilinear``)."""

    def __call__(self, shape, dtype="float32", device=None):
        weight = np.zeros(shape, dtype="float32")
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape[2:]))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[..., y, x] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(weight).to(device=_dev(device),
                                           dtype=dtypes.to_torch(dtype))


def _orthogonal(rows, cols, dev, seed):
    """A ``[rows, cols]`` matrix with orthonormal rows or columns (QR of a
    normal draw, signs fixed by R's diagonal)."""
    a = _normal([max(rows, cols), min(rows, cols)], "float32", dev, seed)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q if rows >= cols else q.t()


class Orthogonal(Initializer):
    """``gain`` times a matrix with orthonormal rows or columns over the
    first dimension and the rest flattened (``jax.nn.initializers.
    orthogonal``)."""

    def __init__(self, gain=1.0, seed=0):
        self.gain, self.seed = gain, seed

    def __call__(self, shape, dtype="float32", device=None):
        rows = int(np.prod(shape[:-1]))
        cols = int(shape[-1])
        q = _orthogonal(rows, cols, _dev(device), self.seed)
        return (self.gain * q).reshape(tuple(shape)).to(
            dtypes.to_torch(dtype))


class Dirac(Initializer):
    """Zeros with an orthogonal ``[shape[-2], shape[-1]]`` matrix at the
    centre of the leading dimensions (``jax.nn.initializers.
    delta_orthogonal``, which the JAX package applies to the shape as it
    is)."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype="float32", device=None):
        dev = _dev(device)
        out = torch.zeros(tuple(shape), dtype=torch.float32, device=dev)
        centre = tuple(s // 2 for s in shape[:-2])
        out[centre] = _orthogonal(shape[-2], shape[-1], dev, 0)
        return out.to(dtypes.to_torch(dtype))


# snake_case aliases matching fluid.initializer
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = XavierNormal
MSRAInitializer = KaimingNormal
NumpyArrayInitializer = Assign


class Xavier(Initializer):
    """fluid's ``XavierInitializer(uniform=...)``."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._impl = (XavierUniform(fan_in, fan_out, seed=seed) if uniform
                      else XavierNormal(fan_in, fan_out, seed=seed))

    def __call__(self, shape, dtype="float32", device=None):
        return self._impl(shape, dtype, device)


class MSRA(Initializer):
    """fluid's ``MSRAInitializer(uniform=...)``."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self._impl = (KaimingUniform(fan_in, seed=seed) if uniform
                      else KaimingNormal(fan_in, seed=seed))

    def __call__(self, shape, dtype="float32", device=None):
        return self._impl(shape, dtype, device)


BilinearInitializer = Bilinear

_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def global_initializer(is_bias):
    return _global_bias_init if is_bias else _global_weight_init
