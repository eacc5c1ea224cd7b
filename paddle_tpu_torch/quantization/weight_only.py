"""Weight-only int8 Linear layers — counterpart of
``paddle_tpu/quantization/weight_only.py``.

Each weight is stored as int8 codes with one f32 scale per output
channel (abs-max codes, no calibration); activations stay in the compute
dtype.  The layout is torch's ``[out, in]``, so the abs-max runs over
dim 1 where the JAX package's ``[in, out]`` runs it over axis 0: the codes
are the transpose of the JAX codes, bit for bit.  The product is a plain
``F.linear`` with the weight dequantized next to it, as the JAX package
leaves it to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class WeightOnlyInt8Linear(nn.Module):
    """Drop-in Linear with int8-coded weights, dequantized per forward.

    Built from a trained ``nn.Linear``; the bias stays in its dtype.  The
    codes ``weight_int8 [out, in]`` and scales ``weight_scale [out]``
    (``amax / 127``, so the weight is ``codes * scale``) are buffers:
    nothing here trains."""

    def __init__(self, linear, compute_dtype=None):
        super().__init__()
        w = linear.weight
        if w.dim() != 2:
            raise ValueError(
                "WeightOnlyInt8Linear expects a 2-D [out, in] Linear "
                f"weight, got shape {list(w.shape)}")
        from . import _quantize_arr
        self.compute_dtype = compute_dtype or w.dtype
        wf = w.detach().float()
        scale = torch.clamp(wf.abs().amax(dim=1), min=1e-8)      # [out]
        self.register_buffer("weight_int8", _quantize_arr(wf, scale,
                                                          axis=0))
        self.register_buffer("weight_scale",
                             (scale / 127.0).to(torch.float32))
        self.bias = linear.bias
        self.in_features = w.shape[1]
        self.out_features = w.shape[0]

    def _dequantized(self):
        cd = self.compute_dtype
        return self.weight_int8.to(cd) * self.weight_scale[:, None].to(cd)

    @property
    def weight(self):
        """The dequantized ``[out, in]`` matrix, materialized on access
        (for code that reflects on ``.weight``); ``forward`` does not
        call it."""
        return self._dequantized().detach()

    def forward(self, x):
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self._dequantized(), bias)


def quantize_weights_int8(model, layer_types=(nn.Linear,),
                          min_features=0, compute_dtype=None):
    """Swap every matching Linear of ``model`` for its weight-only int8
    form, in place; ``min_features`` skips layers whose smaller side is
    below it.  Returns the model."""
    for parent in list(model.modules()):
        if isinstance(parent, WeightOnlyInt8Linear):
            continue
        for name, child in list(parent.named_children()):
            if isinstance(child, tuple(layer_types)) and \
                    not isinstance(child, WeightOnlyInt8Linear):
                if min(child.weight.shape) < min_features:
                    continue
                setattr(parent, name,
                        WeightOnlyInt8Linear(child, compute_dtype))
    return model
