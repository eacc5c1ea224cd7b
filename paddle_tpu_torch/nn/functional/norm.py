"""Normalization functionals — counterpart of
``paddle_tpu/nn/functional/norm.py``: ``layer_norm``, ``instance_norm``,
``group_norm``, ``normalize``, ``local_response_norm`` and ``batch_norm``
(each takes torch tensors or handles, ``_io.api``; ``layer_norm`` passes
the JAX package's amp site).

``batch_norm`` (``_bn_train`` / ``_bn_infer``) has Paddle's conventions:
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

from torch.nn import functional as F

from ... import amp
from ...distributed import collective
from ...distributed.mesh import DATA_AXES
from ._io import api


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


@api
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
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


@api
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Normalize over the trailing ``normalized_shape`` dims, through the
    ``layer_norm`` amp site (black-listed: O2 computes it in f32)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = amp.promote(*amp.cast_inputs("layer_norm", x, weight,
                                                   bias))
    return F.layer_norm(x, list(normalized_shape), weight, bias, epsilon)


@api
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each sample's channels normalized over their spatial dims (the
    running statistics are not used, as in the JAX package)."""
    x, = amp.cast_inputs("instance_norm", x)
    return F.instance_norm(x, weight=weight, bias=bias, eps=eps)


@api
def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    x, = amp.cast_inputs("group_norm", x)
    return F.group_norm(x, num_groups, weight, bias, epsilon)


@api
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x`` over its ``p``-norm along ``axis`` (at least ``epsilon``)."""
    x, = amp.cast_inputs("l2_normalize", x)
    p = float(p)
    if p == 2.0:
        denom = x.square().sum(dim=axis, keepdim=True).sqrt()
    else:
        denom = x.abs().pow(p).sum(dim=axis, keepdim=True).pow(1.0 / p)
    return x / torch.clamp(denom, min=epsilon)


@api
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * s) ** beta`` with ``s`` the sum of squares over
    a window of ``size`` channels (the JAX package's form: ``alpha``
    scales the sum, not the mean)."""
    x, = amp.cast_inputs("local_response_norm", x)
    c, half = x.shape[1], size // 2
    sq = F.pad(x.square().movedim(1, -1), (half, size - 1 - half))
    acc = sum(sq[..., i:i + c] for i in range(size)).movedim(-1, 1)
    return x / (k + alpha * acc).pow(beta)
