"""Checkpoint I/O: ``save`` / ``load`` — counterpart of
``paddle_tpu/framework/io.py``.

The file format is the JAX package's: a pickle of the (nested) object
in which every tensor became ``{"__tensor__": True, "data": ndarray,
"stop_gradient": bool, "name": str}``.  A file written by
``paddle_tpu.save`` therefore loads here, and the other way round,
which carries weights and optimizer state across the packages.

``save`` takes the port's ``Tensor`` handles and ``Parameter``\\ s and
plain ``torch.Tensor``\\ s, on any device, and writes their host copy
(a bfloat16 tensor as float32: numpy has no bfloat16).  ``load`` gives
handles on the current place, or numpy arrays with
``return_numpy=True``.  Nothing is transposed: a torch ``nn.Linear``
weight is saved ``[out, in]`` as it is held (``convert.py`` maps a
checkpoint between the packages' model layouts).
"""
from __future__ import annotations

import os
import pickle

import torch


def _host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().resolve_conj().resolve_neg().numpy()


def _to_saveable(obj):
    from ..core.tensor import Tensor
    if isinstance(obj, Tensor):
        return {"__tensor__": True, "data": obj.numpy(),
                "stop_gradient": obj.stop_gradient, "name": obj.name}
    if isinstance(obj, torch.Tensor):
        return {"__tensor__": True, "data": _host(obj),
                "stop_gradient": not obj.requires_grad}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _from_saved(obj, return_numpy=False):
    from ..core.tensor import Tensor
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            if return_numpy:
                return obj["data"]
            t = Tensor(obj["data"], stop_gradient=obj.get(
                "stop_gradient", True))
            t.name = obj.get("name") or t.name
            return t
        return {k: _from_saved(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saved(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """paddle.save — pickle a (nested) state structure to ``path``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """paddle.load"""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_saved(obj, return_numpy=return_numpy)

