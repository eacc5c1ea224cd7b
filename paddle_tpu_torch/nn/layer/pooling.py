"""Pooling layers — counterpart of ``paddle_tpu/nn/layer/pooling.py``."""
from __future__ import annotations

from .base import Layer
from .. import functional as F


def _make(cls_name, fn_name):
    fn = getattr(F, fn_name)

    def __init__(self, kernel_size=None, stride=None, padding=0,
                 output_size=None, ceil_mode=False, exclusive=True,
                 return_mask=False, data_format=None, name=None):
        Layer.__init__(self)
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_size = output_size if output_size is not None \
            else kernel_size
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive

    def forward(self, x):
        if fn_name.startswith("avg"):
            return fn(x, self.kernel_size, self.stride, self.padding,
                      ceil_mode=self.ceil_mode, exclusive=self.exclusive)
        return fn(x, self.kernel_size, self.stride, self.padding,
                  ceil_mode=self.ceil_mode)

    return type(cls_name, (Layer,), {"__init__": __init__,
                                     "forward": forward,
                                     "__module__": __name__})


MaxPool1D = _make("MaxPool1D", "max_pool1d")
MaxPool2D = _make("MaxPool2D", "max_pool2d")
MaxPool3D = _make("MaxPool3D", "max_pool3d")
AvgPool1D = _make("AvgPool1D", "avg_pool1d")
AvgPool2D = _make("AvgPool2D", "avg_pool2d")
AvgPool3D = _make("AvgPool3D", "avg_pool3d")


def _adaptive(cls_name, fn_name, base=Layer):
    fn = getattr(F, fn_name)

    def __init__(self, output_size, return_mask=False, name=None):
        Layer.__init__(self)
        self.output_size = output_size

    def forward(self, x):
        return fn(x, self.output_size)

    return type(cls_name, (base,), {"__init__": __init__,
                                    "forward": forward,
                                    "__module__": __name__})


AdaptiveAvgPool1D = _adaptive("AdaptiveAvgPool1D", "adaptive_avg_pool1d")
AdaptiveAvgPool2D = _adaptive("AdaptiveAvgPool2D", "adaptive_avg_pool2d",
                              AdaptiveAvgPool1D)
AdaptiveAvgPool3D = _adaptive("AdaptiveAvgPool3D", "adaptive_avg_pool3d",
                              AdaptiveAvgPool1D)
AdaptiveMaxPool1D = _adaptive("AdaptiveMaxPool1D", "adaptive_max_pool1d",
                              AdaptiveAvgPool1D)
AdaptiveMaxPool2D = _adaptive("AdaptiveMaxPool2D", "adaptive_max_pool2d",
                              AdaptiveMaxPool1D)
AdaptiveMaxPool3D = _adaptive("AdaptiveMaxPool3D", "adaptive_max_pool3d",
                              AdaptiveMaxPool1D)
