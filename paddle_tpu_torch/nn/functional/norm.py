"""Batch normalization — counterpart of ``paddle_tpu/nn/functional/norm.py``
``batch_norm`` (``_bn_train`` / ``_bn_infer``), with Paddle's conventions:
``momentum`` is the weight of the OLD running statistic
(``running = momentum * running + (1 - momentum) * batch``) and the
running variance takes the batch's biased variance, as the JAX package
keeps it.

Over a mesh whose data axes split the batch (a ``TrainStep(mesh=)`` rank,
``collective.RankContext.batch_split``), the batch statistics are the
whole batch's: each data rank's per-channel count, sum and sum of squared
deviations meet over the data axes (``collective.mesh_all_reduce``,
whose backward is the exact transpose), so every rank normalizes its rows
by the global mean and variance and advances the running statistics once,
from the global batch, as the JAX step's one program over the global
batch does.  ``torch_batch_norm_forward`` gives a torch
``nn.BatchNorm*`` module the same statistics under torch's own
conventions.
"""
from __future__ import annotations

import torch

from ...distributed import collective
from ...distributed.mesh import DATA_AXES


def _channel_axis(x, data_format):
    return 1 if data_format.startswith("NC") else x.dim() - 1


def _over_data_ranks(t):
    """``t`` summed over the data ranks of a split batch (the identity
    elsewhere)."""
    ctx = collective.current_rank()
    if ctx is None or not ctx.batch_split:
        return t
    return collective.mesh_all_reduce(t, DATA_AXES)


def batch_stats(x, axis):
    """Per-channel (mean, biased variance, count) of ``x`` over every dim
    but ``axis``, two-pass as ``jnp.var`` computes it, over the whole
    batch when ``x`` is one data rank's rows of a split batch."""
    red = [d for d in range(x.dim()) if d != axis]
    n = _over_data_ranks(torch.tensor(float(x.numel() // x.shape[axis]),
                                      device=x.device))
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    mean = _over_data_ranks(x.sum(dim=red)) / n
    dev = x - mean.view(shape)
    var = _over_data_ranks((dev * dev).sum(dim=red)) / n
    return mean, var, n


def _normalize(x, mean, var, weight, bias, epsilon, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    out = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + epsilon)
    if weight is not None:
        out = out * weight.view(shape)
    if bias is not None:
        out = out + bias.view(shape)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Batch norm with Paddle's conventions (module docstring).  In
    training (unless ``use_global_stats``) the batch's statistics
    normalize and the running ones advance in place; otherwise the
    running ones normalize."""
    axis = _channel_axis(x, data_format)
    if not training or use_global_stats:
        return _normalize(x, running_mean, running_var, weight, bias,
                          epsilon, axis)
    mean, var, _ = batch_stats(x, axis)
    if running_mean is not None:
        with torch.no_grad():
            running_mean.mul_(momentum).add_((1 - momentum) * mean)
            running_var.mul_(momentum).add_((1 - momentum) * var)
    return _normalize(x, mean, var, weight, bias, epsilon, axis)


def torch_batch_norm_forward(mod, x):
    """A torch ``nn.BatchNorm*`` module's forward with ``batch_stats``:
    torch's conventions (``momentum`` the weight of the NEW statistic,
    None a cumulative average; the running variance unbiased over the
    whole batch's count), the statistics those of the whole split
    batch."""
    if not (mod.training or mod.running_mean is None):
        return _normalize(x, mod.running_mean, mod.running_var, mod.weight,
                          mod.bias, mod.eps, 1)
    mean, var, n = batch_stats(x, 1)
    if mod.training and mod.track_running_stats:
        with torch.no_grad():
            mod.num_batches_tracked.add_(1)
            m = (1.0 / float(mod.num_batches_tracked)
                 if mod.momentum is None else mod.momentum)
            mod.running_mean.mul_(1 - m).add_(m * mean)
            mod.running_var.mul_(1 - m).add_(m * var * n / (n - 1))
    return _normalize(x, mean, var, mod.weight, mod.bias, mod.eps, 1)
