"""``Layer`` — counterpart of ``paddle_tpu/nn/layer/base.py`` (``Layer``,
``LayerList``, ``Sequential``, ``ParameterList``, ``HookRemoveHelper``).

A ``Layer`` is a ``torch.nn.Module``.  Its parameters are torch leaf
tensors (``nn.Parameter``) registered in torch's own tables, on the
layer's device, so ``.to()``, ``copy.deepcopy``, torch's hooks,
``torch.func.functional_call`` and the port's ``TrainStep`` work on a
Layer as on any module, and a Layer can sit inside a torch model (the
BERT encoder, the GPT scan blocks) and the reverse.

The Paddle surface gives tensor-layer handles (``core.Tensor``):

* an attribute that names a parameter or a buffer (``layer.weight``,
  ``bn._mean``) is a ``Parameter`` / ``Tensor`` handle over the torch
  tensor, one handle a tensor for as long as the tensor is the one
  registered, so ``layer.weight.shape == [in, out]``,
  ``layer.weight.numpy()`` and ``layer.weight.grad`` read as in the JAX
  package; assigning a handle registers its torch tensor;
* ``parameters()``, ``named_parameters()``, ``buffers()``,
  ``named_buffers()`` and ``state_dict()`` give handles, with
  ``include_sublayers`` and ``structured_name_prefix`` as the JAX
  package names them; ``set_state_dict`` takes handles, torch tensors
  or numpy arrays (a JAX layer's ``state_dict()`` carried across) and
  copies them in place.

That Paddle ``parameters()`` collides with torch's.  Paddle's returns a
list of handles, which users index, count and read (``p.numpy()``,
``p.name``); torch's yields torch tensors.  One name cannot serve both,
so a call decides by its keywords: torch's keyword arguments
(``recurse=``, ``remove_duplicate=``; ``prefix=`` / ``keep_vars=`` for
``state_dict``) mark a call from torch code, which gets torch's form.
The torch code that relies on this rule, each held by
``tests/test_torch_nn_layer.py::test_torch_code_over_a_layer``:

* a torch parent's ``state_dict()``, which calls each child's
  ``state_dict(destination, prefix=, keep_vars=)``, and so
  ``torch.save`` of it and ``load_state_dict`` back;
* ``nn.Module.parameters(layer)`` / ``nn.Module.buffers(layer)``, which
  call ``named_parameters(recurse=)`` / ``named_buffers(recurse=)``;
* ``torch.func.functional_call(layer, ...)``, which reads
  ``named_parameters(remove_duplicate=False)`` and
  ``named_buffers(remove_duplicate=False)``;
* ``parametrize.register_parametrization``, which reads the parameter
  by ``getattr``: it runs under ``torch_attributes()``, within which a
  Layer's attributes are the torch tensors (in that thread only).

Torch code that calls ``layer.parameters()`` with no keyword
(``torch.optim.SGD(layer.parameters())``, ``clip_grad_norm_``) gets
handles.  The rest of the port (``TrainStep``, the pipeline, the
checkpoints, the weight bridge, serving) therefore reads any module
through ``torch_named_parameters(module)`` and its siblings below,
torch's own iteration, which gives torch tensors for any module,
Layer or not.

A Layer's forward takes what its caller gives: called with torch
tensors it returns torch tensors (the models, serving and training
keep calling layers with torch tensors), called with handles it returns
handles (``nn.functional._io``).

``create_parameter`` draws on the layer's device: the device of an
active ``with torch.device(...)`` block (the models build under one),
else the tensor layer's current place, which is the card unless
``set_device("cpu")`` was called, and raises without one.  Its
initializer is the ``ParamAttr``'s, else the global one
(``initializer.set_global_initializer``), else the layer's default.
Forward pre-hooks and post-hooks are torch's (``hook(layer, inputs)``,
``hook(layer, inputs, outputs)``, a non-None result replacing the
inputs or outputs), returned as a ``HookRemoveHelper``.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading

import numpy as np
import torch
from torch import nn
from torch.overrides import _get_current_function_mode_stack
from torch.utils._device import DeviceContext

from ...core import device as device_mod
from ...core import dtype as dtypes
from ...core.tensor import Parameter, Tensor
from .. import initializer as I

_raw = threading.local()
_names = collections.defaultdict(itertools.count)


@contextlib.contextmanager
def torch_attributes():
    """Within the block a Layer's parameter and buffer attributes read in
    this thread are the torch tensors themselves."""
    _raw.depth = getattr(_raw, "depth", 0) + 1
    try:
        yield
    finally:
        _raw.depth -= 1


def torch_named_parameters(module, prefix="", recurse=True,
                           remove_duplicate=True):
    """torch's ``named_parameters`` of any module (torch tensors)."""
    return nn.Module.named_parameters(module, prefix=prefix, recurse=recurse,
                                      remove_duplicate=remove_duplicate)


def torch_parameters(module, recurse=True):
    return [p for _, p in torch_named_parameters(module, recurse=recurse)]


def torch_named_buffers(module, prefix="", recurse=True):
    return nn.Module.named_buffers(module, prefix=prefix, recurse=recurse)


def torch_buffers(module, recurse=True):
    return [b for _, b in torch_named_buffers(module, recurse=recurse)]


def torch_state_dict(module):
    """torch's ``state_dict`` of any module (torch tensors)."""
    return nn.Module.state_dict(module)


def layer_device():
    """The device a layer creates its tensors on (module docstring)."""
    if any(isinstance(m, DeviceContext)
           for m in _get_current_function_mode_stack()):
        return torch.get_default_device()
    return device_mod.torch_device()


def _handle(t, param):
    """The handle of the torch tensor ``t``: made once and kept on a leaf
    (a registered parameter or buffer), made anew for a tensor that
    ``functional_call`` or a parametrization put in its place (keeping
    it would tie the two in a reference cycle)."""
    h = t.__dict__.get("_pd_handle")
    if h is not None and h._data is t:
        return h
    cls = Parameter if param else Tensor
    h = cls.__new__(cls)
    h._data = t
    h._init_meta(t.__dict__.get("_pd_name"))
    h.persistable = param
    if t.is_leaf:
        t.__dict__["_pd_handle"] = h
    return h


def _as_torch_param(value):
    """The ``nn.Parameter`` a handle's tensor becomes when a layer
    registers it (the handle is rebound to it)."""
    t = value._data
    if not isinstance(t, nn.Parameter):
        name = t.__dict__.get("_pd_name", value.name)
        t = nn.Parameter(t.detach(), requires_grad=t.requires_grad
                         or not value.stop_gradient)
        t._pd_name = name
        value._data = t
    t.__dict__["_pd_handle"] = value
    return t


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._name_scope = name_scope or type(self).__name__.lower()

    # -- construction -----------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        from ..param_attr import ParamAttr
        dtype = dtype or self._dtype
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer if attr is not None else None
        if init is None:
            init = I.global_initializer(is_bias)
        if init is None:
            init = default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        trainable = attr.trainable if attr is not None else True
        t = nn.Parameter(init(shape, dtype, layer_device()),
                         requires_grad=trainable)
        t._pd_name = (attr.name if attr is not None and attr.name else
                      "%s_%d.%s" % (self._name_scope,
                                    next(_names[self._name_scope]),
                                    "b_0" if is_bias else "w_0"))
        if attr is not None and attr.learning_rate != 1.0:
            t.optimize_attr = {"learning_rate": attr.learning_rate}
        if attr is not None and attr.regularizer is not None:
            t.regularizer = attr.regularizer
        return _handle(t, True)

    def create_tensor(self, name=None, dtype=None):
        t = Tensor._wrap(torch.zeros(
            [0], dtype=dtypes.to_torch(dtype or self._dtype),
            device=layer_device()))
        if name:
            t.name = name
        return t

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(
                parameter, (Parameter, nn.Parameter)):
            raise TypeError("add_parameter expects Parameter or None")
        if isinstance(parameter, Parameter):
            parameter = _as_torch_param(parameter)
        self.register_parameter(name, parameter)
        return getattr(self, name)

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        if persistent is not None:
            persistable = persistent
        if tensor is not None:
            if isinstance(tensor, Tensor):
                tensor = tensor._data
            elif not isinstance(tensor, torch.Tensor):
                tensor = torch.as_tensor(np.asarray(tensor),
                                         device=layer_device())
            tensor = tensor.detach()
        super().register_buffer(name, tensor, persistent=persistable)
        return None if tensor is None else getattr(self, name)

    # -- attribute protocol ----------------------------------------------
    def __getattr__(self, name):
        d = self.__dict__
        for store, param in (("_parameters", True), ("_buffers", False)):
            table = d.get(store)
            if table is not None and name in table:
                t = table[name]
                if t is None or getattr(_raw, "depth", 0):
                    return t
                return _handle(t, param)
        return super().__getattr__(name)

    def __setattr__(self, name, value):
        if isinstance(value, Tensor):
            params = self.__dict__.get("_parameters")
            buffers = self.__dict__.get("_buffers")
            if isinstance(value, Parameter) or (params and name in params):
                if params is None:
                    raise RuntimeError("call Layer.__init__ first")
                nn.Module.__setattr__(self, name, _as_torch_param(value))
                return
            if buffers is not None and name in buffers:
                buffers[name] = value._data
                value._data.__dict__["_pd_handle"] = value
                return
        elif isinstance(value, np.ndarray) and name in self.__dict__.get(
                "_buffers", ()):
            value = torch.as_tensor(value, device=layer_device())
        nn.Module.__setattr__(self, name, value)

    # -- iteration (handles) ----------------------------------------------
    # torch's keyword arguments (``recurse``, ``remove_duplicate``) mark a
    # call from torch code: it gets torch's form, torch tensors
    def parameters(self, include_sublayers=True, recurse=None):
        if recurse is not None:
            return iter(torch_parameters(self, recurse))
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         include_self=True, recurse=None,
                         remove_duplicate=None):
        if recurse is not None or remove_duplicate is not None:
            return torch_named_parameters(
                self, prefix, recurse is not False,
                remove_duplicate is not False)
        return ((name, _handle(t, True)) for name, t in
                torch_named_parameters(self, prefix=prefix,
                                       recurse=include_sublayers))

    def buffers(self, include_sublayers=True, recurse=None):
        if recurse is not None:
            return iter(torch_buffers(self, recurse))
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True,
                      recurse=None, remove_duplicate=None):
        if recurse is not None or remove_duplicate is not None:
            return nn.Module.named_buffers(
                self, prefix, recurse is not False,
                remove_duplicate is not False)
        return ((name, _handle(t, False)) for name, t in
                torch_named_buffers(self, prefix=prefix,
                                    recurse=include_sublayers))

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        for name, layer in self.named_modules(prefix=prefix):
            if layer is self and not include_self:
                continue
            yield name, layer

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    # -- state ------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *,
                   prefix=None, keep_vars=None):
        """The parameters, then the persistable buffers, as handles by
        structured name.  A torch parent module's ``state_dict`` calls
        its children with ``prefix`` / ``keep_vars``: that call gets
        torch's form."""
        if prefix is not None or keep_vars is not None:
            return nn.Module.state_dict(
                self, destination=destination, prefix=prefix or "",
                keep_vars=bool(keep_vars))
        dest = destination if destination is not None else \
            collections.OrderedDict()
        dest.update(self.named_parameters(
            prefix=structured_name_prefix,
            include_sublayers=include_sublayers))
        persistent = {id(t) for t in
                      nn.Module.state_dict(self, keep_vars=True).values()}
        for name, b in self.named_buffers(
                prefix=structured_name_prefix,
                include_sublayers=include_sublayers):
            if id(b._data) in persistent:
                dest[name] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict`` (name -> handle, torch tensor or numpy
        array) into this layer's parameters and persistable buffers in
        place, cast to their dtypes.  Returns ``(missing,
        unexpected)``; a shape mismatch raises before anything is
        copied."""
        own = self.state_dict()
        values = {}
        for name, target in own.items():
            if name not in state_dict:
                continue
            v = state_dict[name]
            v = v._data if isinstance(v, Tensor) else v
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v))
            if list(v.shape) != target.shape:
                raise ValueError(
                    f"shape mismatch for {name}: checkpoint "
                    f"{list(v.shape)} vs layer {target.shape}")
            values[name] = v
        with torch.no_grad():
            for name, v in values.items():
                t = own[name]._data
                t.copy_(v.to(device=t.device, dtype=t.dtype))
        missing = [n for n in own if n not in values]
        unexpected = [n for n in state_dict if n not in own]
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- mode / utils -----------------------------------------------------
    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def to(self, *args, **kwargs):
        """``to(device=None, dtype=None, blocking=None)`` with Paddle's
        names (a Place, ``"gpu"``, ``"cpu"``, a dtype name), or torch's
        arguments."""
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        kwargs.pop("blocking", None)
        rest = []
        for a in args:
            if isinstance(a, (str, np.dtype)) and a in dtypes._DTYPE_MAP:
                dtype = a
            elif isinstance(a, (device_mod.Place, str)):
                device = a
            else:
                rest.append(a)
        if isinstance(device, (device_mod.Place, str)):
            device = device_mod.torch_device(device)
        if isinstance(dtype, (str, np.dtype)):
            dtype = dtypes.to_torch(dtype)
        if device is not None:
            kwargs["device"] = device
        if dtype is not None:
            kwargs["dtype"] = dtype
        return super().to(*rest, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def clear_gradients(self):
        for p in torch_parameters(self):
            p.grad = None

    def zero_grad(self, set_to_none=True):
        for p in torch_parameters(self):
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.detach_().zero_()

    def requires_grad_(self, requires_grad=True):
        for p in torch_parameters(self):
            p.requires_grad_(requires_grad)
        return self

    # -- hooks ------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        return HookRemoveHelper(super().register_forward_pre_hook(hook))

    def register_forward_post_hook(self, hook):
        return HookRemoveHelper(self.register_forward_hook(hook))

    def full_name(self):
        return self._name_scope


class HookRemoveHelper:
    """The handle of a registered hook: ``remove()`` unregisters it."""

    def __init__(self, handle):
        self._handle = handle
        self.id = handle.id

    def remove(self):
        self._handle.remove()


class LayerList(Layer):
    """paddle.nn.LayerList."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[str(idx % len(self) if idx < 0 else idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, item in enumerate(layers):
            self.add_sublayer(str(i), item)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class Sequential(Layer):
    """paddle.nn.Sequential: ``Sequential(l1, l2)``, ``Sequential(
    OrderedDict(...))`` or ``Sequential(("name", layer), ...)``."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            items = layers[0].items()
        elif layers and isinstance(layers[0], (list, tuple)):
            items = layers
        else:
            items = ((str(i), layer) for i, layer in enumerate(layers))
        for name, layer in items:
            self.add_sublayer(name, layer)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __len__(self):
        return len(self._parameters)

    def __getitem__(self, idx):
        return getattr(self, str(idx))

    def __iter__(self):
        return (getattr(self, k) for k in self._parameters)

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self
