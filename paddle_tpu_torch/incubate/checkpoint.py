"""Job-level auto-checkpoint (recover an interrupted training job) —
counterpart of ``paddle_tpu/incubate/checkpoint.py``.

Reference parity: ``fluid/incubate/checkpoint/auto_checkpoint.py`` —
env-gated (``PADDLE_RUNNING_ENV=PADDLE_EDL_AUTO_CHECKPOINT``),
``train_epoch_range`` wraps the epoch loop, snapshots the training state
+ the epoch cursor after each epoch (reference: TrainEpochRange :265),
and resumes from the last snapshot on relaunch.  HDFS in the reference;
a local/NFS path here (``PADDLE_CHECKPOINT_DIR``, default
``./auto_checkpoint``).

The snapshot is the JAX package's file, ``<dir>/<name>/ckpt.pkl``: a
pickle of ``{"epoch", "static", "layers", "optimizers"}`` with numpy
arrays — each attached layer's ``state_dict`` and each attached
optimizer's state in the JAX package's format (``paddle_state_dict``).
The port has no static-graph program, so ``static`` is empty.  A
snapshot the JAX package wrote holds that package's ``Tensor`` objects
over jax arrays in its optimizer state; the port reads them as numpy
arrays without importing either (``_Unpickler``), so a job snapshotted
by either package resumes in the other (parameter names, which key the
optimizer state, set with ``ParamAttr(name=...)`` in both).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def _enabled():
    return os.environ.get("PADDLE_RUNNING_ENV") == \
        "PADDLE_EDL_AUTO_CHECKPOINT"


def _ckpt_dir():
    return os.environ.get("PADDLE_CHECKPOINT_DIR", "./auto_checkpoint")


_current = [None]


def _host(v):
    """``v`` (a tensor, a tensor-layer handle, or a nest of them) as
    numpy."""
    if isinstance(v, dict):
        return {k: _host(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_host(x) for x in v)
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return v


def _jax_array(fun, args, arr_state, aval_state):
    """A pickled jax array (``jax.Array.__reduce__``) as the numpy array
    it was built from."""
    a = fun(*args)
    a.__setstate__(arr_state)
    return a


class _SavedTensor:
    """A JAX package ``Tensor`` read from a snapshot: its value only."""

    def __setstate__(self, state):
        # ``(dict, slots)`` for a class with ``__slots__``
        parts = state if isinstance(state, tuple) else (state,)
        self._data = next(d["_data"] for d in parts if d and "_data" in d)

    def numpy(self):
        return np.asarray(self._data)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("jax._src.array", "_reconstruct_array"):
            return _jax_array
        if module.split(".")[0] == "paddle_tpu":
            return _SavedTensor
        return super().find_class(module, name)


class TrainEpochRange:
    """Iterate epochs with automatic snapshot/restore of training state:
    the state_dicts of the layers and optimizers registered via
    ``attach``."""

    def __init__(self, max_epoch_num, name="default", save_inter=None):
        self.max_epoch_num = int(max_epoch_num)
        self.name = name
        self._layers = []
        self._optimizers = []
        self._start = 0
        self._dir = os.path.join(_ckpt_dir(), name)
        if _enabled():
            self._start = self._restore()

    # -- dygraph attachments -------------------------------------------
    def attach(self, layer=None, optimizer=None):
        if layer is not None:
            self._layers.append(layer)
        if optimizer is not None:
            self._optimizers.append(optimizer)
        if _enabled() and self._start > 0:
            self._load_attachments()
        return self

    # -- iteration ------------------------------------------------------
    def get(self):
        for epoch in range(self._start, self.max_epoch_num):
            _current[0] = self
            yield epoch
            if _enabled():
                self._save(epoch)
        _current[0] = None

    __iter__ = get

    # -- snapshot machinery ---------------------------------------------
    def _state(self):
        return {"epoch": None, "static": {},
                "layers": [_host(dict(layer.state_dict()))
                           for layer in self._layers],
                "optimizers": [_host(getattr(opt, "paddle_state_dict",
                                             opt.state_dict)())
                               for opt in self._optimizers]}

    def _save(self, epoch):
        os.makedirs(self._dir, exist_ok=True)
        state = self._state()
        state["epoch"] = epoch
        tmp = os.path.join(self._dir, "ckpt.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(state, f, protocol=4)
        os.replace(tmp, os.path.join(self._dir, "ckpt.pkl"))

    def _load(self):
        path = os.path.join(self._dir, "ckpt.pkl")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return _Unpickler(f).load()

    def _restore(self):
        state = self._load()
        if state is None:
            return 0
        self._saved_state = state
        return int(state["epoch"]) + 1

    def _load_attachments(self):
        state = getattr(self, "_saved_state", None) or self._load()
        if state is None:
            return
        state = _host(state)
        for layer, sd in zip(self._layers, state.get("layers", [])):
            setter = getattr(layer, "set_state_dict", None)
            if setter is not None:
                setter(sd)
            else:
                layer.load_state_dict({k: torch.as_tensor(v)
                                       for k, v in sd.items()})
        for opt, sd in zip(self._optimizers, state.get("optimizers", [])):
            opt.set_state_dict(sd)


def train_epoch_range(max_epoch_num, save_checkpoint_inter=None,
                      name="default"):
    """reference auto_checkpoint.py:_get_train_epoch_range generator API."""
    return TrainEpochRange(max_epoch_num, name=name,
                           save_inter=save_checkpoint_inter).get()


auto_checkpoint = TrainEpochRange  # module-style alias
