"""Linear, embedding, layer norm, matmul and the activations with the JAX
package's amp sites — counterpart of ``paddle_tpu/nn/functional/common.py``
(``linear``, ``embedding``), of ``paddle_tpu/nn/functional/activation.py``
(``gelu``, ``tanh``, ``softmax``) and of the ``layer_norm`` and ``matmul_v2``
primitives.

Each runs its inputs through ``amp.cast_inputs`` under the JAX package's
primitive name, then gives mixed floating operands their common dtype
(``amp.promote``), as jnp promotes them.  Outside ``auto_cast`` with one
dtype the module helpers call the module itself (its hooks run).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ... import amp


def _linear_site(x, weight, bias):
    """x, weight and bias (when there is one: the JAX primitive gets no
    array for a missing bias) through the ``linear`` amp site, promoted
    to their common dtype."""
    args = (x, weight) if bias is None else (x, weight, bias)
    x, weight, *bias = amp.promote(*amp.cast_inputs("linear", *args))
    return x, weight, (bias[0] if bias else None)


def linear(x, weight, bias=None):
    """paddle's linear: ``x @ weight + bias`` with ``weight [in, out]``."""
    x, weight, bias = _linear_site(x, weight, bias)
    return F.linear(x, weight.t(), bias)


def apply_linear(mod, x):
    """``mod(x)`` for a torch ``nn.Linear`` (``weight [out, in]``) through
    the ``linear`` amp site; any other module (a weight-only int8 linear)
    is called as it is."""
    if not isinstance(mod, nn.Linear) or (
            not amp.is_enabled() and x.dtype == mod.weight.dtype):
        return mod(x)
    return F.linear(*_linear_site(x, mod.weight, mod.bias))


def apply_layer_norm(mod, x):
    """``mod(x)`` for an ``nn.LayerNorm`` through the ``layer_norm`` amp
    site."""
    if not amp.is_enabled() and x.dtype == mod.weight.dtype:
        return mod(x)
    x, w, b = amp.promote(*amp.cast_inputs("layer_norm", x, mod.weight,
                                           mod.bias))
    return F.layer_norm(x, mod.normalized_shape, w, b, mod.eps)


def gelu(x, approximate=False):
    """GELU through the ``gelu`` amp site: exact (erf) by default, as the
    JAX package's ``F.gelu``; ``approximate=True`` (or ``"tanh"``) is the
    tanh form the GPT MLP runs."""
    x, = amp.cast_inputs("gelu", x)
    tanh_form = approximate is True or approximate == "tanh"
    return F.gelu(x, approximate="tanh" if tanh_form else "none")


def tanh(x):
    """tanh through the JAX package's ``tanh`` amp site."""
    x, = amp.cast_inputs("tanh", x)
    return torch.tanh(x)


def softmax(x, axis=-1):
    """Softmax over ``axis`` through the ``softmax`` amp site (black-listed:
    O2 computes it in f32)."""
    x, = amp.cast_inputs("softmax", x)
    return torch.softmax(x, dim=axis)


def matmul(x, y, transpose_x=False, transpose_y=False):
    """paddle's matmul through the JAX package's ``matmul_v2`` amp site,
    mixed operands promoted to their common dtype."""
    x, y = amp.promote(*amp.cast_inputs("matmul_v2", x, y))
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


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


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Embedding lookup (``paddle_tpu/nn/functional/common.py``
    ``embedding``): rows of ``weight [V, D]`` at the ids ``x``; rows at
    ``padding_idx`` are zero and get no gradient.

    ``sparse=True`` on a weight that needs a gradient makes backward
    leave a sparse COO gradient (``SelectedRows`` through a handle's
    ``grad``) holding one row a looked-up id, where the dense gradient
    would be ``[V, D]``; the port's ``SGD``, ``Momentum``, ``Adam`` and
    ``AdamW`` apply it row-wise.  Takes torch tensors or tensor-layer
    handles (and then returns a handle).  Out-of-range ids raise (torch),
    where the JAX package's gather fills."""
    from ...core.tensor import Tensor
    handles = isinstance(x, Tensor) or isinstance(weight, Tensor)
    ids = (x._data if isinstance(x, Tensor) else x).long()
    w = weight._data if isinstance(weight, Tensor) else weight
    if padding_idx is not None and padding_idx < 0:
        padding_idx = w.shape[0] + padding_idx
    if sparse and w.requires_grad and torch.is_grad_enabled():
        out = _SparseEmbedding.apply(w, ids, padding_idx)
    else:
        out = F.embedding(ids, w)
        if padding_idx is not None:
            out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return Tensor._wrap(out) if handles else out
