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
in.  The tensor-parallel form (``use_mp=True``, ``to_tensor_parallel()``)
keeps the JAX layouts and names — ``blocks.{i}.attn.qkv_weight [E, 3, H,
hd]``, ``qkv_bias [3, 1, H, hd]``, ``out_weight [H, hd, E]``,
``out_bias [E]``, the column/row-parallel ``mlp.fc{1,2}.weight [in,
out]``, the vocab-parallel ``embeddings.word_embeddings.weight [V, E]``
and the column-parallel ``head.lm_head.weight [E, V]`` — so its weights
are copied as they are.  A model whose block Linears were relayouted to weight-only int8
(``serving.quant.relayout_weights_int8`` in either package) carries
``{...}.weight_int8`` codes (``[in, out]`` in ``paddle_tpu``, transposed
here too) and ``{...}.weight_scale`` ``[out]`` in place of the weight;
both are loaded into the port's buffers of those names, and the bias is
kept.  Missing names, unexpected names, shape and dtype mismatches are
refused before anything is copied.  ``export_paddle_tpu_state(model)`` is
the reverse: the model's state as numpy arrays in ``paddle_tpu``'s layout
and names.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


from .quantization.weight_only import WeightOnlyInt8Linear


def _linear_weights(model):
    """Names stored ``[in, out]`` by ``paddle_tpu`` and ``[out, in]``
    here: Linear weights and weight-only int8 codes (the parallel layers
    of the tensor-parallel form store ``[in, out]`` in both)."""
    names = set()
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            names.add(f"{name}.weight")
        elif isinstance(mod, WeightOnlyInt8Linear):
            names.add(f"{name}.weight_int8")
    return names


def _state(model):
    """The parameters and the int8 weight buffers, by name."""
    state = dict(model.named_parameters())
    for name, mod in model.named_modules():
        if isinstance(mod, WeightOnlyInt8Linear):
            state[f"{name}.weight_int8"] = mod.weight_int8
            state[f"{name}.weight_scale"] = mod.weight_scale
    return state


def load_paddle_tpu_state(model, arrays):
    """Copy ``arrays`` (name -> numpy array in ``paddle_tpu`` layout)
    into ``model``'s parameters and int8 weight buffers, in place, on the
    model's device and in its dtype.  Returns the model."""
    params = _state(model)
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
        if (p.dtype == torch.int8) != (arr.dtype == np.int8):
            raise ValueError(
                f"load_paddle_tpu_state: {name} is {arr.dtype}, the model "
                f"holds {p.dtype} (int8 codes load only into int8 codes)")
        staged[name] = arr
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.from_numpy(np.array(staged[name], copy=True)))
    return model


def export_paddle_tpu_state(model):
    """The model's parameters and int8 weight buffers as
    ``{name: numpy array}`` in ``paddle_tpu``'s layout (linear weights and
    codes transposed back to ``[in, out]``); floating tensors as float32
    (numpy has no bfloat16), codes as int8."""
    linear = _linear_weights(model)
    out = {}
    with torch.no_grad():
        for name, p in _state(model).items():
            p = p.detach()
            arr = (p if p.dtype == torch.int8 else p.float()).cpu().numpy()
            out[name] = np.ascontiguousarray(arr.T if name in linear
                                             else arr)
    return out
