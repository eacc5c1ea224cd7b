"""Common layers — counterpart of ``paddle_tpu/nn/layer/common.py``.

``Linear`` keeps the JAX package's weight ``[in, out]`` (so a JAX
layer's ``state_dict`` loads as it is); ``Embedding(padding_idx=)``
zeroes that row at construction.  Both run through the port's ``linear``
and ``embedding`` functionals and their amp sites.
"""
from __future__ import annotations

import torch

from .base import Layer
from .. import functional as F
from .. import initializer as I


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    """``y = x W + b`` with ``W [in, out]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = (self.create_parameter([out_features], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.sparse = sparse
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierNormal())
        if padding_idx is not None:
            idx = padding_idx if padding_idx >= 0 else \
                num_embeddings + padding_idx
            with torch.no_grad():
                self.weight.torch()[idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx,
                           sparse=self.sparse)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis,
                         training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        if isinstance(x, torch.Tensor):
            return torch.flatten(x, self.start_axis, self.stop_axis)
        from ...ops import flatten
        return flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size,
                             scale_factor=self.scale_factor, mode=self.mode,
                             align_corners=self.align_corners,
                             align_mode=self.align_mode,
                             data_format=self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest",
                         data_format=data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", align_corners=True,
                         data_format=data_format)


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Bilinear(Layer):
    """``out[b, o] = x1[b] W[o] x2[b] + bias`` with ``W [out, in1, in2]``
    and ``bias [1, out]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = (self.create_parameter([1, out_features],
                                           attr=bias_attr, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)
