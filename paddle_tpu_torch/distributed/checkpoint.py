"""Train-state checkpoints — counterpart of
``paddle_tpu/distributed/checkpoint.py`` (``save_sharded``,
``load_sharded``, ``save_train_state``, ``load_train_state``).

The port's own format: one pickle (protocol 4) of a tree of dicts whose
leaves are numpy arrays (floating tensors as float32, numpy has no
bfloat16), at ``path + ".ptckpt"``.  A train step's state is the
logical (unsharded) arrays under the JAX state's keys: ``params`` and
``opt_state`` by parameter name (``{name: {state key: array}}``),
``step_count``, ``buffers`` when the model has any, and DGC's
``dgc_state``; a meta-optimizer step's per-rank ``params`` /
``opt_state`` / ``dgc_state`` stack the ranks on a leading ``[dp]``
axis, as the JAX package's do.  ``load_train_state`` re-shards onto the
step's own mesh, so a state saved over one mesh loads over another.
Reading the JAX package's ``.pdckpt`` needs jax's treedef and is not
supported.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..nn.layer.base import torch_named_buffers, torch_named_parameters

SUFFIX = ".ptckpt"


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()
    return tree


def save_sharded(state, path):
    """Save a (nested) state tree of tensors / arrays as numpy leaves."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path + SUFFIX, "wb") as f:
        pickle.dump(_to_numpy(state), f, protocol=4)


def load_sharded(path, template=None, device=None):
    """Restore a tree saved by ``save_sharded``: numpy leaves, or tensors
    on ``device`` when one is given (or when ``template`` is a dict of
    tensors, on each one's device and in its dtype)."""
    with open(path + SUFFIX, "rb") as f:
        tree = pickle.load(f)
    if isinstance(template, dict) and template and all(
            isinstance(v, torch.Tensor) for v in template.values()):
        return {k: torch.as_tensor(tree[k]).to(template[k].device,
                                               template[k].dtype)
                for k in template}
    if device is not None:
        def put(t):
            if isinstance(t, dict):
                return {k: put(v) for k, v in t.items()}
            return torch.as_tensor(np.asarray(t), device=device)
        return put(tree)
    return tree


def _engine(step):
    return getattr(step, "engine", None)


def save_train_state(step, path):
    """Persist a ``TrainStep``'s (over a mesh or one device) or a
    meta-optimizer step's full state (module docstring)."""
    opt = step.optimizer
    eng = _engine(step)
    if hasattr(step, "_state_tree"):
        state = step._state_tree()
    elif eng is not None:
        state = {"params": eng.full_params(),
                 "opt_state": eng.full_opt_state()}
        bufs = eng.full_buffers()
        if bufs:
            state["buffers"] = bufs
    else:
        model = step.model
        state = {"params": dict(torch_named_parameters(model)),
                 "opt_state": {n: dict(opt.state.get(p, {}))
                               for n, p in torch_named_parameters(model)}}
        bufs = {k: v for k, v in torch_named_buffers(model) if v is not None}
        if bufs:
            state["buffers"] = bufs
    state["step_count"] = np.asarray(opt._step_count)
    save_sharded(state, path)


@torch.no_grad()
def load_train_state(step, path):
    """Restore a step's state in place, re-sharding onto its mesh."""
    restored = load_sharded(path)
    opt = step.optimizer
    eng = _engine(step)
    if hasattr(step, "_load_state_tree"):
        step._load_state_tree(restored)
    elif eng is not None:
        eng.load_full(restored["params"], restored["opt_state"],
                      restored.get("buffers"))
    else:
        model = step.model
        named = dict(torch_named_parameters(model))
        for k, v in restored["params"].items():
            named[k].copy_(torch.as_tensor(v))
        for k, sub in restored["opt_state"].items():
            p = named[k]
            if not sub:
                continue
            template = opt._init_state(p)
            opt.state[p] = {sk: torch.as_tensor(v).to(
                template[sk].device, template[sk].dtype)
                for sk, v in sub.items()}
        named_b = dict(torch_named_buffers(model))
        for k, v in restored.get("buffers", {}).items():
            named_b[k].copy_(torch.as_tensor(v))
    opt._step_count = int(restored["step_count"])
