"""Weight bridge: ``paddle_tpu`` GPT parameters into the torch model.

``load_paddle_tpu_state(model, arrays)`` takes a dict of parameter name
-> numpy array, as ``paddle_tpu``'s ``GPTModel.named_parameters()`` names
them, and copies it into a ``paddle_tpu_torch`` ``GPTModel``:

* ``embeddings.{word,position}_embeddings.weight``
* ``blocks.{i}.{ln1,ln2}.{weight,bias}``
* ``blocks.{i}.attn.{qkv_proj,out_proj}.{weight,bias}``
* ``blocks.{i}.mlp.{fc1,fc2}.{weight,bias}``
* ``head.ln_f.{weight,bias}``, ``head.lm_head.weight``

``paddle_tpu``'s ``nn.Linear`` stores its weight ``[in, out]`` and
torch's ``[out, in]``, so every linear weight is transposed on the way
in.  Missing names, unexpected names and shape mismatches are refused
before anything is copied.  ``export_paddle_tpu_state(model)`` is the
reverse: the model's parameters as numpy arrays in ``paddle_tpu``'s
layout and names.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _linear_weights(model):
    return {f"{name}.weight" for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def load_paddle_tpu_state(model, arrays):
    """Copy ``arrays`` (name -> numpy array in ``paddle_tpu`` layout)
    into ``model``'s parameters, in place, on the model's device and in
    its dtype.  Returns the model."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    unexpected = sorted(set(arrays) - set(params))
    if missing or unexpected:
        raise ValueError(
            f"load_paddle_tpu_state: missing {missing[:8]}"
            f"{' ...' if len(missing) > 8 else ''}, unexpected "
            f"{unexpected[:8]}{' ...' if len(unexpected) > 8 else ''}")
    linear = _linear_weights(model)
    staged = {}
    for name, p in params.items():
        arr = np.asarray(arrays[name])
        if name in linear:
            arr = arr.T
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(
                f"load_paddle_tpu_state: {name} has shape "
                f"{tuple(np.asarray(arrays[name]).shape)} "
                f"({'transposed to ' + str(tuple(arr.shape)) if name in linear else 'as given'}), "
                f"the model expects {tuple(p.shape)}")
        staged[name] = arr
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.from_numpy(np.array(staged[name], copy=True)))
    return model


def export_paddle_tpu_state(model):
    """The model's parameters as ``{name: numpy array}`` in
    ``paddle_tpu``'s layout (linear weights transposed back to
    ``[in, out]``), as float32 (numpy has no bfloat16)."""
    linear = _linear_weights(model)
    out = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            arr = p.detach().float().cpu().numpy()
            out[name] = np.ascontiguousarray(arr.T if name in linear
                                             else arr)
    return out
