"""paddle_tpu_torch — the PyTorch + CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its module paths and class names (``models/gpt.py``,
``serving/engine.py``, ``ops/ragged_paged_attn.py``) so each piece has an
obvious counterpart.  It imports ``torch``, ``numpy`` and the standard
library only — never ``jax`` and nothing under ``paddle_tpu``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (the CPU tests do); there is no silent CPU fallback.

The top level is the Paddle tensor layer (``core`` and ``ops``):
``to_tensor``, ``grad``, ``seed``, ``set_device``, the dtypes and every
op, as ``paddle_tpu/__init__.py`` exports them, ``nn`` (with
``Layer`` and ``ParamAttr``) and ``optimizer``, and the data pipeline
and the high-level API: ``io``, ``reader``, ``batch``, ``metric``,
``hapi`` (``Model``, ``callbacks``), ``save`` / ``load``, ``summary``
and ``flops``.  Its tensors live on
the current place, the card unless ``set_device("cpu")`` says
otherwise.  The models, serving and training keep taking plain torch
tensors.
"""
from __future__ import annotations

from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"

# -- core ----------------------------------------------------------------
from .core.tensor import Tensor, Parameter, to_tensor  # noqa: E402,F401
from .core.autograd import no_grad, enable_grad, grad  # noqa: E402,F401
from .core.device import (  # noqa: E402,F401
    set_device, get_device, device_count, CPUPlace, CUDAPlace, TPUPlace,
    is_compiled_with_cuda, is_compiled_with_xpu, is_compiled_with_tpu,
)
from .core.dtype import (  # noqa: E402,F401
    set_default_dtype, get_default_dtype,
    bool_ as bool8, uint8, int8, int16, int32, int64,
    float16, bfloat16, float32, float64, complex64, complex128,
)
from .core.flags import set_flags, get_flags  # noqa: E402,F401
from .core.rng import seed  # noqa: E402,F401
from .core.selected_rows import (  # noqa: E402,F401
    SelectedRows, get_tensor_from_selected_rows)

# -- ops (also attaches the Tensor methods) ------------------------------
from .ops import *  # noqa: E402,F401,F403
from .ops import linalg  # noqa: E402,F401
from . import ops  # noqa: E402,F401
from .ops.manipulation import flip as reverse  # noqa: E402,F401
from .ops.compat_ops import crop_tensor as crop  # noqa: E402,F401
from .ops.linalg import (cholesky, cross, dist, histogram,  # noqa: E402,F401
                         inverse, norm, bincount)
from .core.tensor import Tensor as VarBase  # noqa: E402,F401
from .core.tensor import Tensor as LoDTensor  # noqa: E402,F401
from . import ops as tensor  # noqa: E402,F401  (paddle.tensor alias)

# -- nn (paddle.nn, paddle.ParamAttr, paddle.Layer) ----------------------
from . import nn  # noqa: E402,F401
from . import optimizer  # noqa: E402,F401
from .nn.param_attr import ParamAttr  # noqa: E402,F401
from .nn.layer.base import Layer  # noqa: E402,F401

# -- the data pipeline and the high-level API ----------------------------
from . import io  # noqa: E402,F401
from . import metric  # noqa: E402,F401
from . import hapi  # noqa: E402,F401
from . import reader  # noqa: E402,F401
from . import framework  # noqa: E402,F401
from . import incubate  # noqa: E402,F401
from .framework.io import save, load  # noqa: E402,F401
from .batch import batch  # noqa: E402,F401
from .hapi import callbacks  # noqa: E402,F401
from .hapi.model import Model  # noqa: E402,F401


def summary(net, input_size=None, dtypes=None):
    """paddle.summary (reference: hapi/model_summary.py)."""
    return Model(net).summary(input_size, dtype=dtypes)


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The JAX package's rough FLOPs count: 2 x the parameters of every
    weight of two or more dimensions (``Model.flops`` counts an eval
    forward's matrix products instead)."""
    from .nn.layer.base import torch_named_parameters as _named
    total = 0    # the module's ``sum`` is the tensor op
    for _, p in _named(net):
        if p.dim() >= 2:
            total += 2 * p.numel()
    return total
