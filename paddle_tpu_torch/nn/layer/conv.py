"""Conv layers — counterpart of ``paddle_tpu/nn/layer/conv.py``: weights
``[out, in / groups, *k]`` (a transpose's ``[in, out / groups, *k]``),
Kaiming-uniform by default, a zero bias."""
from __future__ import annotations

from .base import Layer
from .. import functional as F
from .. import initializer as I


class _ConvNd(Layer):
    def __init__(self, nd, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0):
        super().__init__()
        self._nd = nd
        self.in_channels = in_channels
        self.out_channels = out_channels
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * nd
        self.kernel_size = tuple(kernel_size)
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        self._transpose = transpose
        shape = ([in_channels, out_channels // groups] if transpose
                 else [out_channels, in_channels // groups])
        self.weight = self.create_parameter(
            shape + list(self.kernel_size), attr=weight_attr,
            default_initializer=I.KaimingUniform())
        self.bias = (self.create_parameter([out_channels], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x, output_size=None):
        fn = getattr(F, f"conv{self._nd}d"
                     + ("_transpose" if self._transpose else ""))
        if self._transpose:
            return fn(x, self.weight, self.bias, self.stride, self.padding,
                      self.output_padding, self.groups, self.dilation,
                      output_size, self.data_format)
        return fn(x, self.weight, self.bias, self.stride, self.padding,
                  self.dilation, self.groups, self.data_format)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


def _conv(cls_name, nd, data_format):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=data_format):
        _ConvNd.__init__(self, nd, in_channels, out_channels, kernel_size,
                         stride, padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    return type(cls_name, (_ConvNd,), {"__init__": __init__,
                                       "__module__": __name__})


def _conv_transpose(cls_name, nd, data_format):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format=data_format):
        _ConvNd.__init__(self, nd, in_channels, out_channels, kernel_size,
                         stride, padding, dilation, groups, "zeros",
                         weight_attr, bias_attr, data_format,
                         transpose=True, output_padding=output_padding)

    return type(cls_name, (_ConvNd,), {"__init__": __init__,
                                       "__module__": __name__})


Conv1D = _conv("Conv1D", 1, "NCL")
Conv2D = _conv("Conv2D", 2, "NCHW")
Conv3D = _conv("Conv3D", 3, "NCDHW")
Conv1DTranspose = _conv_transpose("Conv1DTranspose", 1, "NCL")
Conv2DTranspose = _conv_transpose("Conv2DTranspose", 2, "NCHW")
Conv3DTranspose = _conv_transpose("Conv3DTranspose", 3, "NCDHW")
