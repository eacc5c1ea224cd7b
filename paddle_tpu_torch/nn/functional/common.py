"""Common functionals — counterpart of ``paddle_tpu/nn/functional/common.py``
(``linear``, ``embedding``, the dropouts, ``pad``, ``interpolate``,
``pixel_shuffle``, ``unfold``, ``label_smooth``, ``sequence_mask``,
``cosine_similarity``, ...) and of the ``layer_norm`` and ``matmul_v2``
primitives' amp sites.

Each takes torch tensors or handles (``_io.api``).  ``linear``,
``matmul`` and the layer helpers run their inputs through
``amp.cast_inputs`` under the JAX package's primitive name, then give
mixed floating operands their common dtype (``amp.promote``), as jnp
promotes them.  Outside ``auto_cast`` with one dtype the module helpers
call the module itself (its hooks run).  The dropouts draw from torch's
default generator of the input's device, which ``paddle_tpu_torch.seed``
seeds.  ``interpolate`` is ``jax.image.resize``'s algorithm (half-pixel
sample points, the triangle or Keys cubic kernel, antialiased when
downsampling; ``align_corners`` and ``data_format`` are ignored, as the
JAX package ignores them).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ... import amp
from ._io import api, as_torch


def _linear_site(x, weight, bias):
    """x, weight and bias (when there is one: the JAX primitive gets no
    array for a missing bias) through the ``linear`` amp site, promoted
    to their common dtype."""
    args = (x, weight) if bias is None else (x, weight, bias)
    x, weight, *bias = amp.promote(*amp.cast_inputs("linear", *args))
    return x, weight, (bias[0] if bias else None)


@api
def linear(x, weight, bias=None, name=None):
    """paddle's linear: ``x @ weight + bias`` with ``weight [in, out]``."""
    x, weight, bias = _linear_site(x, weight, bias)
    return F.linear(x, weight.t(), bias)


def apply_linear(mod, x):
    """``mod(x)`` for a torch ``nn.Linear`` (``weight [out, in]``) through
    the ``linear`` amp site; any other module (a Paddle ``Linear``, a
    weight-only int8 linear) is called as it is."""
    if not isinstance(mod, nn.Linear) or (
            not amp.is_enabled() and x.dtype == mod.weight.dtype):
        return mod(x)
    return F.linear(*_linear_site(x, mod.weight, mod.bias))


def apply_layer_norm(mod, x):
    """``mod(x)`` for a torch ``nn.LayerNorm`` through the ``layer_norm``
    amp site; any other module (a Paddle ``LayerNorm``) is called as it
    is."""
    if not isinstance(mod, nn.LayerNorm) or (
            not amp.is_enabled() and x.dtype == mod.weight.dtype):
        return mod(x)
    x, w, b = amp.promote(*amp.cast_inputs("layer_norm", x, mod.weight,
                                           mod.bias))
    return F.layer_norm(x, mod.normalized_shape, w, b, mod.eps)


def matmul(x, y, transpose_x=False, transpose_y=False):
    """paddle's matmul through the JAX package's ``matmul_v2`` amp site,
    mixed operands promoted to their common dtype (torch tensors)."""
    x, y = amp.promote(*amp.cast_inputs("matmul_v2", x, y))
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


# -- dropout ---------------------------------------------------------------
@api
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element (or each slice along ``axis``: the mask spans
    those dims and broadcasts over the rest) with probability ``p``;
    ``upscale_in_train`` scales the kept ones by ``1 / (1 - p)``,
    ``downscale_in_infer`` scales the inference output by ``1 - p``."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if axis is None and mode == "upscale_in_train":
        return F.dropout(x, p=p, training=True)
    if axis is None:
        mask_shape = x.shape
    else:
        axes = [axis] if isinstance(axis, int) else list(axis)
        mask_shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = torch.rand(mask_shape, device=x.device) < (1.0 - p)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


@api
def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = torch.rand(x.shape, device=x.device) < (1.0 - p)
    coef_a = (1.0 - p + p * alpha_p ** 2 * (1.0 - p)) ** -0.5
    coef_b = -coef_a * p * alpha_p
    return coef_a * torch.where(keep, x, torch.full_like(x, alpha_p)) \
        + coef_b


# -- embedding -------------------------------------------------------------
class _SparseEmbedding(torch.autograd.Function):
    """The lookup whose backward leaves a sparse COO gradient: one row of
    values a looked-up id (repeats kept, padding rows zero).  Under
    ``create_graph`` the gradient is the dense scatter-add instead (the
    lookup is linear in the weight, so it is exact and differentiable)."""

    @staticmethod
    def forward(ctx, weight, ids, padding_idx):
        out = F.embedding(ids, weight)
        if padding_idx is not None:
            out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
        ctx.save_for_backward(ids)
        ctx.padding_idx = padding_idx
        ctx.weight_shape = tuple(weight.shape)
        return out

    @staticmethod
    def backward(ctx, ct):
        ids, = ctx.saved_tensors
        rows = ids.reshape(-1)
        vals = ct.reshape((-1,) + ctx.weight_shape[1:])
        if ctx.padding_idx is not None:
            vals = vals.masked_fill((rows == ctx.padding_idx)[:, None], 0.0)
        if torch.is_grad_enabled():
            return (torch.zeros(ctx.weight_shape, dtype=vals.dtype,
                                device=vals.device).index_add(0, rows, vals),
                    None, None)
        return torch.sparse_coo_tensor(rows[None], vals, ctx.weight_shape,
                                       check_invariants=False), None, None


@api
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Embedding lookup (``paddle_tpu/nn/functional/common.py``
    ``embedding``): rows of ``weight [V, D]`` at the ids ``x``; rows at
    ``padding_idx`` are zero and get no gradient.

    ``sparse=True`` on a weight that needs a gradient makes backward
    leave a sparse COO gradient (``SelectedRows`` through a handle's
    ``grad``) holding one row a looked-up id, where the dense gradient
    would be ``[V, D]``; the port's ``SGD``, ``Momentum``, ``Adam`` and
    ``AdamW`` apply it row-wise.  Out-of-range ids raise (torch), where
    the JAX package's gather fills."""
    ids = x.long()
    if padding_idx is not None and padding_idx < 0:
        padding_idx = weight.shape[0] + padding_idx
    if sparse and weight.requires_grad and torch.is_grad_enabled():
        return _SparseEmbedding.apply(weight, ids, padding_idx)
    out = F.embedding(ids, weight)
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return out


def one_hot(x, num_classes, name=None):
    from ...ops import one_hot as _one_hot
    return api(lambda a: _one_hot(a, num_classes)._data)(x)


# -- padding ---------------------------------------------------------------
_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "replicate": "replicate", "circular": "circular"}


def _pad_cfg(nd, pad, data_format):
    """``[(lo, hi)] * nd`` from paddle's pad list (the JAX package's
    reading: a full ``2 * nd`` list pads from the last dim backwards;
    a shorter one pads the spatial dims of ``data_format``, last
    first)."""
    cfg = [(0, 0)] * nd
    n_spatial = len(pad) // 2
    if len(pad) == 2 * nd:
        dims = [nd - 1 - i for i in range(n_spatial)]
    else:
        channel_last = data_format in ("NHWC", "NLC", "NDHWC")
        spatial = (list(range(1, 1 + n_spatial)) if channel_last
                   else list(range(nd - n_spatial, nd)))
        dims = spatial[::-1]
    for i, d in enumerate(dims):
        cfg[d] = (pad[2 * i], pad[2 * i + 1])
    return cfg


def pad_nd(x, cfg, mode="constant", value=0.0):
    """``x`` padded by ``cfg`` (``[(lo, hi)]`` per dim) in ``mode``
    (``constant``, ``reflect``, ``replicate``/``edge``, ``circular``/
    ``wrap``), any dims (torch's reflect / replicate / circular pad up to
    three trailing dims: the padded dims are moved there)."""
    mode = {"edge": "replicate", "wrap": "circular"}.get(mode, mode)
    flat = [int(v) for lo_hi in cfg[::-1] for v in lo_hi]
    if mode == "constant":
        return F.pad(x, flat, mode="constant", value=float(value))
    dims = [d for d, (lo, hi) in enumerate(cfg) if lo or hi]
    if not dims:
        return x
    rest = [d for d in range(x.dim()) if d not in dims]
    perm = rest + dims
    y = x.permute(perm)
    lead = y.shape[:len(rest)]
    y = y.reshape((1, int(np.prod(lead)) if lead else 1)
                  + tuple(y.shape[len(rest):]))
    y = F.pad(y, [int(v) for d in dims[::-1] for v in cfg[d]],
              mode=_PAD_MODES[mode])
    y = y.reshape(tuple(lead) + tuple(y.shape[2:]))
    return y.permute(np.argsort(perm).tolist())


@api
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    if isinstance(pad, torch.Tensor):
        pad = pad.tolist()
    cfg = _pad_cfg(x.dim(), [int(p) for p in pad], data_format)
    return pad_nd(x, cfg, mode, value)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


@api
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return F.pixel_shuffle(x, upscale_factor)


@api
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return F.pixel_unshuffle(x, downscale_factor)


# -- resize (jax.image.resize) ---------------------------------------------
def _triangle(d):
    return torch.clamp(1.0 - d.abs(), min=0.0)


def _keys_cubic(d):
    d = d.abs()
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = torch.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return torch.where(d >= 2.0, torch.zeros_like(d), out)


def _weight_mat(n_in, n_out, kernel, device):
    """``[n_in, n_out]`` resampling weights (``jax.image``'s
    ``compute_weight_mat`` at scale ``n_out / n_in``, translation 0,
    antialiased)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    d = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs() \
        / kernel_scale
    w = kernel(d)
    tot = w.sum(0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@api
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    spatial = list(x.shape[2:])
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(spatial)
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    if isinstance(size, torch.Tensor):
        size = size.tolist()
    size = [int(s) for s in size]
    method = {"nearest": "nearest", "bilinear": "linear",
              "bicubic": "cubic", "trilinear": "linear",
              "linear": "linear", "area": "linear"}[mode]
    for i, (m, n) in enumerate(zip(spatial, size)):
        if m == n:
            continue
        d = 2 + i
        if method == "nearest":
            idx = torch.floor((torch.arange(n, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * m / n).long()
            x = x.index_select(d, idx)
            continue
        w = _weight_mat(m, n, _triangle if method == "linear"
                        else _keys_cubic, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


upsample = interpolate


@api
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """Sliding blocks ``[N, C * kh * kw, L]``; ``paddings`` one int, two
    (per dim) or four (``[(p0, p1), (p2, p3)]`` over H and W)."""
    def _pair(v):
        return [v, v] if isinstance(v, int) else list(v)
    p = _pair(paddings)
    hw = [(p[0], p[1]), (p[2], p[3])] if len(p) == 4 else [(v, v) for v in p]
    x = F.pad(x, [hw[1][0], hw[1][1], hw[0][0], hw[0][1]])
    return F.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations),
                    stride=_pair(strides))


@api
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return label * (1.0 - epsilon) + epsilon * as_torch(prior_dist,
                                                            label)
    return label * (1.0 - epsilon) + epsilon / label.shape[-1]


@api
def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    from ...core import dtype as dtypes
    if maxlen is None:
        maxlen = int(x.max())
    steps = torch.arange(int(maxlen), device=x.device)
    return (steps < x[..., None]).to(dtypes.to_torch(dtype))


@api
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return (x1 * x2).sum(dim=axis) / torch.clamp(
        torch.linalg.vector_norm(x1, dim=axis)
        * torch.linalg.vector_norm(x2, dim=axis), min=eps)


@api
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``common.py``'s form (the package exports ``extension``'s)."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    _, _, h, w = [int(s) for s in out_shape]
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, h, device=theta.device)
        xs = torch.linspace(-1.0, 1.0, w, device=theta.device)
    else:
        ys = (torch.arange(h, device=theta.device) + 0.5) * 2.0 / h - 1.0
        xs = (torch.arange(w, device=theta.device) + 0.5) * 2.0 / w - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,njk->nhwj", base.to(theta.dtype), theta)


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC class-center sampling: every positive class of ``label``
    is kept and uniform negatives (numpy's global generator, as the JAX
    package draws them) fill up to ``num_samples``; the sampled set is
    sorted and the labels remapped to positions in it.  Returns handles
    ``(remapped labels, sampled classes)``."""
    from ...core.dispatch import ensure_tensor
    from ...core.tensor import Tensor
    t = ensure_tensor(label)
    lab = np.asarray(t.numpy(), np.int64).reshape(-1)
    pos = np.unique(lab)
    if pos.size >= int(num_samples):
        sampled = pos
    else:
        neg = np.setdiff1d(np.arange(int(num_classes), dtype=np.int64), pos,
                           assume_unique=True)
        picked = np.random.permutation(neg.size)[:int(num_samples)
                                                 - pos.size]
        sampled = np.sort(np.concatenate([pos, neg[picked]]))
    remap = np.full((int(num_classes),), -1, np.int64)
    remap[sampled] = np.arange(sampled.size)
    dev = t._data.device
    return (Tensor._wrap(torch.as_tensor(remap[lab], device=dev)),
            Tensor._wrap(torch.as_tensor(sampled, device=dev)))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """The one implementation lives in ``extension.py``."""
    from .extension import npair_loss as _impl
    return _impl(anchor, positive, labels, l2_reg=l2_reg)


