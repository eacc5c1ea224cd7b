"""Gradient clipping — counterpart of ``paddle_tpu/nn/clip.py``
(``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``,
``clip_grad_norm_``, ``ErrorClipByValue``, ``set_gradient_clip`` /
``get_gradient_clip``).

A clip object is called two ways.  Paddle's: ``clip(params_grads)``
with ``(parameter, gradient)`` pairs of handles returns new pairs with
the clipped gradients.  The optimizer's: ``clip(grads)`` with a list of
torch gradient tensors clips them in place (what every optimizer of the
port calls before its update).  A sparse gradient (an embedding looked
up with ``sparse=True``) keeps its rows: ``ClipGradByGlobalNorm`` takes
its norm over the merged rows and scales its values, the others act on
its values.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor


def _values(g):
    """The tensor the clip acts on: a sparse gradient's merged values."""
    return g.coalesce().values() if g.is_sparse else g


class ClipGradBase:
    def __call__(self, grads):
        if grads and isinstance(grads[0], tuple):
            return self._pairs(grads)
        self.clip_(grads)
        return None

    def _pairs(self, params_grads):
        from ..core.selected_rows import SelectedRows
        raw = []
        for _, g in params_grads:
            if g is None:
                raw.append(None)
            elif isinstance(g, SelectedRows):
                raw.append(g.sparse().coalesce().clone())
            else:
                raw.append((g._data if isinstance(g, Tensor) else g).clone())
        self.clip_(raw)
        from ..core.selected_rows import wrap_grad
        return [(p, None if g is None else wrap_grad(g))
                for (p, _), g in zip(params_grads, raw)]

    @torch.no_grad()
    def clip_(self, grads):
        """Clip the torch gradient tensors ``grads`` in place."""
        for g in grads:
            if g is not None:
                v = g._values() if g.is_sparse else g
                v.copy_(self._clip_one(v))

    def _clip_one(self, g):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient element to ``[min, max]`` (``min`` default
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip_one(self, g):
        return torch.clamp(g, self.min, self.max)


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_one(self, g):
        norm = torch.linalg.vector_norm(g)
        return g * torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                               max=1.0)

    @torch.no_grad()
    def clip_(self, grads):
        for g in grads:
            if g is not None:
                v = g._values() if g.is_sparse else g
                norm = torch.linalg.vector_norm(_values(g))
                v.mul_(torch.clamp(
                    self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0))


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``clip_norm / max(global_norm,
    clip_norm)``, the global norm taken in f32 over all gradients."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def clip_(self, grads):
        grads = [g for g in grads if g is not None]
        if not grads:
            return
        sq = torch.stack([_values(g).float().square().sum() for g in grads])
        scale = self.scale(sq.sum().sqrt())
        for g in grads:
            if g.is_sparse:
                g._values().mul_(scale.to(g.dtype))
            else:
                g.copy_((g * scale).to(g.dtype))

    def scale(self, global_norm):
        """The factor every gradient takes at this global norm (a train
        step over a mesh sums the squares over the shards itself)."""
        return self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients of ``parameters`` (handles or torch tensors)
    in place by ``min(max_norm / (total + 1e-6), 1)``, ``total`` their
    ``norm_type``-norm (a sparse gradient's over its merged rows);
    returns the total norm (a handle when handles were given)."""
    if not isinstance(parameters, (list, tuple)):
        parameters = [parameters]
    handles = any(isinstance(p, Tensor) for p in parameters)
    raw = [p._data if isinstance(p, Tensor) else p for p in parameters]
    grads = [p.grad for p in raw if p.grad is not None]
    if not grads:
        total = torch.zeros(())
        return Tensor._wrap(total) if handles else total
    with torch.no_grad():
        vals = [_values(g) for g in grads]
        if norm_type == float("inf"):
            total = torch.stack([v.abs().max() for v in vals]).max()
        else:
            total = sum(v.abs().pow(norm_type).sum()
                        for v in vals) ** (1.0 / norm_type)
        coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
        for g in grads:
            (g._values() if g.is_sparse else g).mul_(coef.to(g.dtype))
    return Tensor._wrap(total) if handles else total


# fluid-era aliases
GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


class ErrorClipByValue:
    """fluid's ``ErrorClipByValue``: clips a gradient's values to ``[min,
    max]`` when called on it."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, grad):
        from ..ops.math import clip
        return clip(grad, self.min, self.max)


_global_gradient_clip = None


def set_gradient_clip(clip, param_list=None, program=None):
    """Register the clip an optimizer made without ``grad_clip`` uses
    (and mark ``param_list``'s parameters with it)."""
    global _global_gradient_clip
    _global_gradient_clip = clip
    for p in param_list or ():
        p.grad_clip = clip
    return clip


def get_gradient_clip():
    return _global_gradient_clip
