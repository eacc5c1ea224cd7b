"""Eager Tensor — counterpart of ``paddle_tpu/core/tensor.py``.

``Tensor`` is a mutable handle holding one ``torch.Tensor`` in
``_data``, with the Paddle surface of the JAX package's handle: ``shape``
a list, ``size`` the element count, ``dtype`` the canonical string,
``stop_gradient`` / ``trainable``, ``numpy``, ``item``, ``set_value``,
``gradient()``, ``backward`` and the operators (attached by ``ops``).

It does not subclass ``torch.Tensor``: Paddle's ``size`` attribute,
string ``dtype`` and list ``shape`` collide with torch's own names,
which torch's Python code calls.  ``Tensor.torch()`` (or ``_data``)
hands the raw tensor to the rest of the port, and ``to_tensor`` of a
``torch.Tensor`` wraps it without a copy.

Gradients are torch's: ``stop_gradient`` is the inverse of
``_data.requires_grad`` for floating tensors (integer and bool tensors
keep the flag beside their data, since torch gives them no gradient),
and ``grad`` reads ``_data.grad`` — a sparse one (an embedding looked up
with ``sparse=True``) as ``SelectedRows``.

Writes keep the storage: ``set_value``, ``zero_`` and ``fill_`` copy
into ``_data`` in place, so a model or optimizer holding the raw tensor
sees them.  A write that torch's autograd would refuse (an in-place
write to a tensor that requires grad) rebinds ``_data`` to the
out-of-place result instead, as the JAX handle rebinds its array.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtype as dtypes
from . import device as device_mod


def _from_numpy(arr, dtype, device):
    """A torch tensor holding a copy of the numpy array ``arr``."""
    if dtype is None and arr.dtype == np.float64:
        dtype = dtypes.get_default_dtype()
    t = torch.from_numpy(np.array(arr, order="C", copy=True))
    return t.to(device=device,
                dtype=dtypes.to_torch(dtype) if dtype is not None else None)


def _diff_dtype(t):
    return t.is_floating_point() or t.is_complex()


class Tensor:
    _next_id = [0]

    __slots__ = ("_data", "_sg", "_grad_wrap", "_freed", "name",
                 "persistable", "__weakref__", "__dict__")

    def __init__(self, data, dtype=None, place=None, stop_gradient=True,
                 name=None):
        if isinstance(data, Tensor):
            data = data._data
        if isinstance(data, torch.Tensor):
            if dtype is not None:
                data = data.to(dtypes.to_torch(dtype))
            if place is not None:
                data = data.to(device_mod.torch_device(place))
        else:
            data = _from_numpy(np.asarray(data), dtype,
                               device_mod.torch_device(place))
        self._data = data
        self._init_meta(name)
        self.stop_gradient = stop_gradient

    def _init_meta(self, name=None):
        self._sg = True
        self._grad_wrap = None
        self._freed = False
        Tensor._next_id[0] += 1
        self.name = name or f"tensor_{Tensor._next_id[0]}"
        self.persistable = False

    @classmethod
    def _wrap(cls, data, name=None):
        """A handle over the torch tensor ``data`` as it is: its
        ``requires_grad`` (and graph) untouched."""
        t = Tensor.__new__(Tensor)
        t._data = data
        t._init_meta(name)
        return t

    def torch(self):
        """The raw ``torch.Tensor`` this handle holds."""
        return self._data

    # -- metadata ---------------------------------------------------------
    @property
    def stop_gradient(self):
        if _diff_dtype(self._data):
            return not self._data.requires_grad
        return self._sg

    @stop_gradient.setter
    def stop_gradient(self, value):
        value = bool(value)
        d = self._data
        if not _diff_dtype(d):
            self._sg = value
            return
        if value and d.requires_grad:
            if d.is_leaf:
                d.requires_grad_(False)
            else:
                self._data = d.detach()
        elif not value and not d.requires_grad:
            d.requires_grad_(True)

    @property
    def trainable(self):
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, value):
        self.stop_gradient = not value

    @property
    def data(self):
        return self

    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    def dim(self):
        return self._data.dim()

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def dtype(self):
        return dtypes.canonical_name(self._data.dtype)

    @property
    def place(self):
        return device_mod.place_of(self._data)

    @property
    def is_leaf(self):
        return self._data.is_leaf

    def __len__(self):
        if self._data.dim() == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    # -- value access -----------------------------------------------------
    def numpy(self):
        """A numpy copy (bfloat16 comes back as float32: numpy has no
        bfloat16)."""
        d = self._data.detach()
        if d.dtype == torch.bfloat16:
            d = d.float()
        arr = d.cpu().resolve_conj().resolve_neg().numpy()
        # a CPU tensor's numpy() shares its storage: copy, so that a later
        # in-place update (an optimizer step) does not reach the array
        return arr.copy() if d.device.type == "cpu" and \
            d.dtype == self._data.dtype else arr

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._data.item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype else arr

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        return bool(self.item())

    def __index__(self):
        return int(self.item())

    # -- autograd ---------------------------------------------------------
    @property
    def grad(self):
        d = self._data
        if not (d.is_leaf or d.retains_grad):
            return None
        g = d.grad
        if g is None:
            return None
        if self._grad_wrap is not None and self._grad_wrap[0] is g:
            return self._grad_wrap[1]
        from .selected_rows import wrap_grad
        w = wrap_grad(g)
        self._grad_wrap = (g, w)
        return w

    @grad.setter
    def grad(self, value):
        self._grad_wrap = None
        if value is None:
            self._data.grad = None
            return
        from .selected_rows import SelectedRows
        if isinstance(value, SelectedRows):
            raw = value.sparse()
        elif isinstance(value, Tensor):
            raw = value._data
        else:
            raw = torch.as_tensor(np.asarray(value))
        self._data.grad = raw.to(device=self._data.device,
                                 dtype=self._data.dtype)

    def backward(self, grad_tensor=None, retain_graph=False,
                 create_graph=False):
        from . import autograd
        autograd.backward([self], [grad_tensor], retain_graph=retain_graph,
                          create_graph=create_graph)

    def retain_grads(self):
        if self._data.requires_grad and not self._data.is_leaf:
            self._data.retain_grad()

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    def gradient(self):
        """The gradient as numpy, or None."""
        g = self.grad
        return None if g is None else g.numpy()

    def detach(self):
        return Tensor._wrap(self._data.detach())

    def detach_(self):
        self._data = self._data.detach()
        return self

    # -- mutation ---------------------------------------------------------
    def _write(self, value):
        """Make ``value`` (a torch tensor of this one's shape) the value:
        in place, or by rebinding where torch's autograd forbids an
        in-place write (a tensor in a graph)."""
        d = self._data
        value = value.to(device=d.device, dtype=d.dtype)
        if d.requires_grad and not d.is_leaf:
            self._data = value.detach().clone().requires_grad_(True)
            return self
        with torch.no_grad():
            d.copy_(value)
        return self

    def set_value(self, value):
        if isinstance(value, Tensor):
            value = value._data
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        if tuple(value.shape) != tuple(self._data.shape):
            raise ValueError(
                "set_value shape mismatch: %s vs %s"
                % (tuple(value.shape), tuple(self._data.shape)))
        return self._write(value)

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    def zero_(self):
        return self._write(torch.zeros_like(self._data))

    def fill_(self, v):
        return self._write(torch.full_like(self._data, v))

    # -- conversions ------------------------------------------------------
    def astype(self, dt):
        from .. import ops
        return ops.cast(self, dt)

    def cast(self, dt):
        return self.astype(dt)

    def clone(self):
        from .. import ops
        return ops.assign(self)

    def cpu(self):
        return Tensor._wrap(self._data.cpu())

    def cuda(self, device_id=None, blocking=True):
        return Tensor._wrap(self._data.to(device_mod.torch_device(
            device_mod.CUDAPlace(device_id or 0))))

    def to(self, *args, **kwargs):
        """``to(device)``, ``to(dtype)`` or both; a device is a Place or a
        string (``"gpu"``, ``"gpu:0"``, ``"cpu"``), a dtype a dtype name."""
        args = list(args) + [v for k, v in kwargs.items()
                             if k in ("device", "dtype")]
        out = self._data
        for a in args:
            if isinstance(a, (torch.dtype, np.dtype)) or (
                    isinstance(a, str) and a in dtypes._DTYPE_MAP):
                out = out.to(dtypes.to_torch(a))
            elif a is not None:
                out = out.to(device_mod.torch_device(a))
        return Tensor._wrap(out)

    def pin_memory(self):
        return self

    def value(self):
        return self

    def contiguous(self):
        return Tensor._wrap(self._data.contiguous())

    def __repr__(self):
        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype={self.dtype}, "
                f"place={self.place}{grad_info},\n"
                f"       {np.array2string(self.numpy(), threshold=40)})")

    __str__ = __repr__

    def __hash__(self):
        return id(self)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # Arithmetic / indexing operators are attached by paddle_tpu_torch.ops
    # at import time (see ops/__init__.py), as in the JAX package.


class Parameter(Tensor):
    """Trainable tensor (reference: fluid ParamBase)."""

    def __init__(self, data, dtype=None, name=None, trainable=True):
        super().__init__(data, dtype=dtype, stop_gradient=not trainable,
                         name=name)
        self.persistable = True

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor.  A ``Tensor`` gives a new leaf over the same
    data (cut from the graph, as in the JAX package); a ``torch.Tensor``
    is wrapped without a copy."""
    if isinstance(data, Tensor):
        d = data._data.detach()
        if dtype is not None and data.dtype != dtypes.canonical_name(dtype):
            d = d.to(dtypes.to_torch(dtype))
        return Tensor(d, place=place, stop_gradient=stop_gradient)
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)
