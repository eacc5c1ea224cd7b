"""Batch-norm layers — counterpart of ``paddle_tpu/nn/layer/norm.py``
``BatchNorm`` / ``BatchNorm1D`` / ``BatchNorm2D`` / ``BatchNorm3D``:
Paddle's ``momentum`` (the old statistic's weight, default 0.9) and
``epsilon``, a ``weight`` of ones and a ``bias`` of zeros (``weight_attr``
/ ``bias_attr`` False drops them), the running statistics in the buffers
``_mean`` and ``_variance`` under the JAX layer's names, so the weight
bridge copies them as they are.  The forward is
``nn.functional.norm.batch_norm``: over a mesh that splits the batch it
normalizes by the whole batch's statistics."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import batch_norm


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = (None if weight_attr is False
                       else nn.Parameter(torch.ones(num_features)))
        self.bias = (None if bias_attr is False
                     else nn.Parameter(torch.zeros(num_features)))
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        return batch_norm(x, self._mean, self._variance, self.weight,
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
