"""``paddle.nn.utils`` — counterpart of ``paddle_tpu/nn/utils.py``:
``parameters_to_vector``, ``vector_to_parameters``, ``weight_norm`` /
``remove_weight_norm``, ``spectral_norm`` and ``clip_grad_norm_``.

``weight_norm`` reparametrizes a layer's ``weight`` as ``g * v /
||v||`` (the norm over every dim but ``dim``; over all with ``dim``
None): the parameters ``weight_g`` and ``weight_v`` replace ``weight``,
and a forward pre-hook recomputes ``weight`` (a plain attribute, the
graph to ``g`` and ``v``) before each forward, as the JAX package's
hook does.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from .clip import clip_grad_norm_  # noqa: F401


def _raw(p):
    return p._data if isinstance(p, Tensor) else p


def parameters_to_vector(parameters, name=None):
    """The parameters flattened and concatenated (a handle when handles
    were given)."""
    parameters = list(parameters)
    out = torch.cat([_raw(p).reshape(-1) for p in parameters])
    return Tensor._wrap(out) if parameters and isinstance(
        parameters[0], Tensor) else out


def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of ``vec`` into ``parameters`` in place."""
    data = _raw(vec)
    offset = 0
    with torch.no_grad():
        for p in parameters:
            t = _raw(p)
            n = t.numel()
            t.copy_(data[offset:offset + n].reshape(t.shape).to(t.dtype))
            offset += n


def _norm_except(w, dim):
    if dim is None:
        return torch.linalg.vector_norm(w)
    axes = [i for i in range(w.dim()) if i != dim]
    return w.square().sum(dim=axes, keepdim=True).sqrt()


def weight_norm(layer, name="weight", dim=0):
    from torch import nn
    w = _raw(getattr(layer, name)).detach()
    del layer._parameters[name]
    layer.register_parameter(name + "_g", nn.Parameter(_norm_except(w, dim)))
    layer.register_parameter(name + "_v", nn.Parameter(w.clone()))

    def hook(layer_, inputs):
        v = layer_._parameters[name + "_v"]
        g = layer_._parameters[name + "_g"]
        layer_.__dict__[name] = v * (g / _norm_except(v, dim))
        return None

    layer._wn_hook = layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    from torch import nn
    w = layer.__dict__.pop(name, None)
    if w is None:
        return layer
    layer._wn_hook.remove()
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    layer.register_parameter(name, nn.Parameter(_raw(w).detach()))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    raise NotImplementedError(
        "use paddle_tpu_torch.nn.SpectralNorm as a wrapping layer")
