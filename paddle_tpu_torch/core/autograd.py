"""Autograd entry points — counterpart of ``paddle_tpu/core/autograd.py``.

The JAX package records a tape of ``jax.vjp`` closures and walks it in
``backward``.  The port has no tape: every op of the tensor layer runs
torch ops on the handles' torch tensors, so torch's engine records the
graph, and ``backward`` / ``grad`` are thin layers over
``torch.autograd``.  Double grad is ``create_graph=True``.

What the JAX engine does and torch's does not, these layers add:

* ``backward`` on a tensor that needs no gradient does nothing (torch
  raises); a non-scalar without ``grad_tensors`` raises the JAX
  package's ``RuntimeError``;
* a second ``backward`` through the same output without
  ``retain_graph`` raises, also where the graph saved no tensor (torch
  raises only where it did);
* ``grad(allow_unused=False)`` gives zeros for an input the outputs do
  not reach, where torch raises; ``retain_graph=None`` means
  ``create_graph``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def grad_enabled() -> bool:
    return torch.is_grad_enabled()


@contextlib.contextmanager
def no_grad():
    """paddle.no_grad — also a decorator (``@no_grad()``)."""
    with torch.no_grad():
        yield


@contextlib.contextmanager
def enable_grad():
    with torch.enable_grad():
        yield


_SECOND_TIME = ("Trying to backward through the graph a second time; "
                "pass retain_graph=True to backward() if needed.")


def _seed(t, g):
    """(output, its seed) as torch tensors; checks the JAX package's
    rules for the output ``t``."""
    d = t._data
    if g is None and d.numel() != 1:
        raise RuntimeError(
            "backward() on a non-scalar tensor requires explicit "
            "grad_tensors (got shape %s)" % (list(d.shape),))
    if t._freed:
        raise RuntimeError(_SECOND_TIME)
    if g is None:
        return d, None
    from .tensor import Tensor
    g = g._data if isinstance(g, Tensor) else torch.as_tensor(
        np.asarray(g) if not isinstance(g, torch.Tensor) else g)
    return d, g.to(device=d.device, dtype=d.dtype)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _mark_freed(tensors):
    for t in tensors:
        if t._data.grad_fn is not None:
            t._freed = True


def backward(tensors, grad_tensors=None, retain_graph=False,
             create_graph=False):
    """Run reverse mode from ``tensors``: leaves that need a gradient
    accumulate it in ``.grad``; an intermediate gets one only after
    ``retain_grads()``."""
    tensors = _as_list(tensors)
    grad_tensors = ([None] * len(tensors) if grad_tensors is None
                    else _as_list(grad_tensors))
    outs, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        d, s = _seed(t, g)
        if d.requires_grad:
            outs.append(d)
            seeds.append(s)
    if not outs:
        return
    retain = bool(retain_graph or create_graph)
    torch.autograd.backward(outs, seeds, retain_graph=retain,
                            create_graph=create_graph)
    if not retain:
        _mark_freed(tensors)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """paddle.grad — the gradients of ``outputs`` with respect to
    ``inputs``, without touching any ``.grad``.  With
    ``create_graph=True`` the returned gradients are differentiable."""
    from .selected_rows import wrap_grad
    from .tensor import Tensor
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    if retain_graph is None:
        retain_graph = create_graph
    grad_outputs = ([None] * len(outputs) if grad_outputs is None
                    else _as_list(grad_outputs))
    outs, seeds = [], []
    for t, g in zip(outputs, grad_outputs):
        d, s = _seed(t, g)
        if d.requires_grad:
            outs.append(d)
            seeds.append(s if s is not None else torch.ones_like(d))
    want = [i for i, t in enumerate(inputs) if t._data.requires_grad]
    got = [None] * len(inputs)
    if outs and want:
        res = torch.autograd.grad(
            outs, [inputs[i]._data for i in want], seeds,
            retain_graph=bool(retain_graph), create_graph=create_graph,
            allow_unused=True)
        for i, g in zip(want, res):
            got[i] = g
    if not retain_graph:
        _mark_freed(outputs)
    result = []
    for t, g in zip(inputs, got):
        if g is not None:
            result.append(wrap_grad(g))
        elif allow_unused:
            result.append(None)
        else:
            result.append(Tensor._wrap(torch.zeros_like(t._data)))
    return result
