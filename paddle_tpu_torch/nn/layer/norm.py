"""Norm layers — counterpart of ``paddle_tpu/nn/layer/norm.py``.

The batch norms (``BatchNorm``, ``BatchNorm1D/2D/3D``, ``SyncBatchNorm``)
keep Paddle's ``momentum`` (the old statistic's weight, default 0.9) and
``epsilon``, a ``weight`` of ones and a ``bias`` of zeros
(``weight_attr`` / ``bias_attr`` False drops them), and the running
statistics in the buffers ``_mean`` and ``_variance`` under the JAX
layer's names, so a JAX layer's ``state_dict`` loads as it is.  Their
forward is ``nn.functional.norm.batch_norm``: over a mesh that splits
the batch it normalizes by the whole batch's statistics, so
``SyncBatchNorm`` is the same layer.  ``LayerNorm``, ``GroupNorm``, the
instance norms, ``LocalResponseNorm`` and ``SpectralNorm`` call their
functionals.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import Layer, layer_device
from .. import functional as F
from .. import initializer as I
from ..functional._io import api


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = (self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
            if weight_attr is not False else None)
        self.bias = (self.create_parameter([num_features], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)
        dev = layer_device()
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self.momentum, epsilon=self.epsilon,
                            data_format=self.data_format,
                            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return (f"num_features={self.num_features}, "
                f"momentum={self.momentum}, epsilon={self.epsilon}")


class BatchNorm(_BatchNormBase):
    """fluid-style BatchNorm (NCHW by default)."""


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose statistics are the whole batch's across the data
    ranks — what every batch norm of the port computes over a mesh."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm below it a ``SyncBatchNorm``
        holding the same parameters and statistics."""
        for name, sub in list(layer._modules.items()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            with torch.device(layer._mean.torch().device):
                new = SyncBatchNorm(layer.num_features, layer.momentum,
                                    layer.epsilon,
                                    data_format=layer.data_format)
            new.set_state_dict(layer.state_dict())
            return new
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = (self.create_parameter(
            self.normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
            if weight_attr is not False else None)
        self.bias = (self.create_parameter(self.normalized_shape,
                                           attr=bias_attr, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.weight = (self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
            if weight_attr is not False else None)
        self.bias = (self.create_parameter([num_channels], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.epsilon, self.weight,
                            self.bias)


class InstanceNorm1D(Layer):
    """Instance norm; the scale is the parameter ``scale`` (the JAX
    layer's name)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = (self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
            if weight_attr is not False else None)
        self.bias = (self.create_parameter([num_features], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self.epsilon)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """``weight / sigma`` with ``sigma`` the largest singular value of the
    weight (its ``axis`` against the rest flattened) by ``power_iters``
    power iterations from the fixed buffers ``weight_u`` / ``weight_v``
    (numpy's RandomState(0) / (1) normals, the JAX layer's)."""

    def __init__(self, weight_shape, axis=0, power_iters=1, epsilon=1e-12,
                 name=None):
        super().__init__()
        self.axis = axis
        self.power_iters = power_iters
        self.epsilon = epsilon
        h = weight_shape[axis]
        w = int(np.prod(weight_shape)) // h
        dev = layer_device()
        self.register_buffer("weight_u", torch.as_tensor(
            np.random.RandomState(0).normal(size=[h]).astype("float32"),
            device=dev))
        self.register_buffer("weight_v", torch.as_tensor(
            np.random.RandomState(1).normal(size=[w]).astype("float32"),
            device=dev))

    def forward(self, weight):
        return api(self._normalized)(weight)

    def _normalized(self, w):
        axis, eps = self.axis, self.epsilon
        mat = w.movedim(axis, 0).reshape(w.shape[axis], -1)
        u, v = self.weight_u.torch(), self.weight_v.torch()
        for _ in range(max(self.power_iters, 1)):
            v = mat.t() @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
        return w / (u @ mat @ v)
