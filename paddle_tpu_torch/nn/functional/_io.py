"""Handles in, handles out: how the port's ``nn`` functionals and layers
take both torch tensors and tensor-layer handles (``core.Tensor``).

The models, serving and training call the functionals and layers with
plain torch tensors and get torch tensors back; a Paddle user calls them
with handles and gets handles.  ``api`` wraps a functional written over
torch tensors: the type of its FIRST argument decides (a handle, or
anything not a torch tensor, such as a numpy array, gives handles), and
every handle among the arguments is unwrapped, so a layer passes its
parameter handles to a functional beside a torch input and gets a torch
tensor (a call with a torch tensor first and neither a handle nor a
nest among its arguments, as the models make them, goes straight to
the function).  ``follows_input`` wraps a layer's method the same way, but any
handle among its arguments gives handles.  Lists, tuples (named ones
too) and dicts are looked through.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.tensor import Tensor


def tree_map(fn, *trees):
    """``fn`` over the leaves of equal nests of lists, tuples (named ones
    too) and dicts."""
    first = trees[0]
    if isinstance(first, (list, tuple)):
        out = [tree_map(fn, *parts) for parts in zip(*trees)]
        if isinstance(first, list):
            return out
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def unwrap(x):
    """``x`` with every handle replaced by its torch tensor."""
    return tree_map(lambda v: v._data if isinstance(v, Tensor) else v, x)


def wrap(x):
    """``x`` with every torch tensor in a handle."""
    return tree_map(lambda v: Tensor._wrap(v) if isinstance(
        v, torch.Tensor) else v, x)


def has_handle(x):
    if isinstance(x, Tensor):
        return True
    if isinstance(x, (list, tuple)):
        return any(has_handle(v) for v in x)
    if isinstance(x, dict):
        return any(has_handle(v) for v in x.values())
    return False


def as_torch(x, like=None):
    """A torch tensor for a handle, a numpy array or a Python number
    (created on ``like``'s device, or on the current place)."""
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    from ...core.dispatch import ensure_tensor
    if like is not None and isinstance(x, (int, float, bool)):
        return torch.tensor(x, dtype=like.dtype, device=like.device)
    if like is not None:
        return torch.as_tensor(np.asarray(x), device=like.device)
    return ensure_tensor(x)._data


def _plain(values):
    """No handle among ``values`` and no nest that could hold one."""
    for v in values:
        if isinstance(v, (Tensor, list, tuple, dict)):
            return False
    return True


def api(fn):
    """A functional over torch tensors that also takes handles (module
    docstring: the first argument decides)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if args and isinstance(args[0], torch.Tensor):
            if _plain(args) and _plain(kwargs.values()):
                return fn(*args, **kwargs)
            return fn(*unwrap(args), **unwrap(kwargs))
        if args and not isinstance(args[0], Tensor):
            args = (as_torch(args[0]),) + args[1:]
        out = fn(*unwrap(args), **unwrap(kwargs))
        return wrap(out)

    wrapper.raw_fn = fn
    return wrapper


def follows_input(fn):
    """A layer method over torch tensors whose outputs are handles when
    any argument held one."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if not (has_handle(args) or has_handle(kwargs)):
            return fn(self, *args, **kwargs)
        return wrap(fn(self, *unwrap(args), **unwrap(kwargs)))

    return wrapper
