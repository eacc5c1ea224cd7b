"""Weight bridge: ``paddle_tpu`` model parameters into the torch models.

``load_paddle_tpu_state(model, arrays)`` takes a dict of parameter name
-> numpy array, as ``paddle_tpu``'s ``named_parameters()`` names them, and
copies it into the ``paddle_tpu_torch`` model of the same structure.  For
a ``GPTModel``:

* ``embeddings.{word,position}_embeddings.weight``
* ``blocks.{i}.{ln1,ln2}.{weight,bias}``
* ``blocks.{i}.attn.{qkv_proj,out_proj}.{weight,bias}``
* ``blocks.{i}.mlp.{fc1,fc2}.{weight,bias}``, or in an MoE block the
  router ``blocks.{i}.mlp.gate [D, E]`` and the expert stacks
  ``blocks.{i}.mlp.experts.{w1 [E, D, H], b1, w2 [E, H, D], b2}``
* ``head.ln_f.{weight,bias}``, ``head.lm_head.weight``

and for BERT (``models/bert.py``) the three embeddings and their
``layer_norm``, each encoder layer's ``self_attn.{q,k,v,out}_proj``,
``linear1``, ``linear2``, ``norm1``, ``norm2``, the ``pooler.dense`` and
the heads' linears and norm.

``paddle_tpu``'s ``nn.Linear`` stores its weight ``[in, out]`` and
torch's ``[out, in]``, so every torch ``nn.Linear`` weight is transposed
on the way in; every other parameter (embeddings, norms, the MoE router
and expert stacks, which are parameters of their own in both packages,
and the port's own Paddle ``nn.Linear`` layers — BERT's encoder layers —
which keep ``[in, out]``) is copied as it is.  The tensor-parallel form (``use_mp=True``, ``to_tensor_parallel()``)
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

A ``scan_layers`` model stacks its blocks as the JAX package does:
``blocks.ln1.weight [L, E]``, ``blocks.attn.qkv_proj.weight [L, E, 3E]``
in ``paddle_tpu`` (``[L, 3E, E]`` here: the transposes swap the last two
axes).  ``load_paddle_tpu_state`` takes either layout for either form —
unrolled arrays are stacked into a scan model, stacked ones sliced into
an unrolled model — and ``export_paddle_tpu_state`` gives the model's
own.

``export_optimizer_state(optimizer, model)`` /
``load_optimizer_state(optimizer, model, state)`` carry an optimizer's
state in the JAX package's ``state_dict`` format — ``__step__``,
``LR_Scheduler`` and ``{name}__{state key}`` numpy arrays, each moment
of a linear weight transposed like the weight — so a run begun in one
package resumes in the other.  ``names`` maps the port's parameter names
to the names the JAX state keys carry (its parameters' ``.name``:
``{n: p.name for n, p in jax_model.named_parameters()}``).

``load_layer_state(layer, state)`` / ``export_layer_state(layer)`` carry
any ``nn.Layer``'s ``state_dict`` (parameters and persistable buffers,
names and layouts the JAX package's) across as numpy.

``tensor_from_paddle_tpu(t)`` / ``tensor_to_paddle_tpu(t)`` carry one
tensor-layer object (``Tensor``, ``Parameter`` or ``SelectedRows``, with
its ``stop_gradient`` / ``trainable`` and ``name``) between the packages
as numpy: the first reads a ``paddle_tpu`` object through its public
surface, the second returns the record its constructors take.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from .nn.layer import ScanLayers
from .quantization.weight_only import WeightOnlyInt8Linear
from .nn.layer.base import torch_named_parameters


def _flip(a):
    """Swap the last two axes (``[in, out]`` <-> ``[out, in]``, under
    any stacked leading axis)."""
    return a.swapaxes(-1, -2)


_LAYER = re.compile(r"(.+)\.(\d+)\.(.+)")   # prefix.{i}.rest


def _to_model_layout(model, arrays):
    """``arrays`` with their blocks stacked or sliced to the layout of
    ``model`` (see the module docstring); other names untouched."""
    out = dict(arrays)
    for prefix, mod in model.named_modules():
        if not isinstance(mod, ScanLayers):
            continue
        for rest in mod._stack_names:
            parts = [f"{prefix}.{i}.{rest}" for i in range(mod.num_layers)]
            if f"{prefix}.{rest}" not in out and all(k in out
                                                     for k in parts):
                out[f"{prefix}.{rest}"] = np.stack(
                    [np.asarray(out.pop(k)) for k in parts])
    sliced = set()
    for name in _state(model):
        m = _LAYER.fullmatch(name)
        stacked = m and f"{m.group(1)}.{m.group(3)}"
        if name not in out and stacked in out:
            out[name] = np.asarray(out[stacked])[int(m.group(2))]
            sliced.add(stacked)
    for k in sliced:
        del out[k]
    return out


def _linear_weights(model):
    """Names stored ``[in, out]`` by ``paddle_tpu`` and ``[out, in]``
    here: Linear weights and weight-only int8 codes (the parallel layers
    of the tensor-parallel form store ``[in, out]`` in both); a stacked
    block's are ``[L, ...]`` of the same."""
    names = set()
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, nn.Linear):
            names.add(f"{prefix}weight")
        elif isinstance(mod, WeightOnlyInt8Linear):
            names.add(f"{prefix}weight_int8")
    return names


def _state(model):
    """The parameters and the int8 weight buffers, by name."""
    state = dict(torch_named_parameters(model))
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
    arrays = _to_model_layout(model, arrays)
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
            arr = _flip(arr)
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
            out[name] = np.ascontiguousarray(_flip(arr) if name in linear
                                             else arr)
    return out


def _as_array(v):
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def load_layer_state(layer, state):
    """Copy a ``paddle_tpu`` Layer's ``state_dict()`` (name -> array, or
    anything with ``numpy()``) into the port's ``nn.Layer`` ``layer`` of
    the same structure, in place.  The port's layers keep the JAX
    package's names and layouts, so nothing is transposed: ``Linear``
    ``weight [in, out]`` / ``bias``, a conv's ``weight [out, in / groups,
    *k]`` (a transpose's ``[in, out / groups, *k]``), the RNNs'
    ``weight_ih_l{k}[_reverse] [gates * H, in]``, ``weight_hh_l{k}``,
    ``bias_ih_l{k}``, ``bias_hh_l{k}`` and the cells' ``weight_ih`` ...,
    ``Embedding`` ``weight [V, D]``, the norms' ``weight`` / ``bias``
    (``scale`` in an instance norm) and the batch norms' buffers
    ``_mean`` / ``_variance``, each under its structured name
    (``encoder.layers.0.self_attn.q_proj.weight``).  Missing or
    unexpected names and shape mismatches raise before anything is
    copied.  Returns the layer."""
    arrays = {k: _as_array(v) for k, v in state.items()}
    own = layer.state_dict()
    missing = sorted(set(own) - set(arrays))
    unexpected = sorted(set(arrays) - set(own))
    if missing or unexpected:
        raise ValueError(f"load_layer_state: missing {missing[:8]}, "
                         f"unexpected {unexpected[:8]}")
    layer.set_state_dict(arrays)
    return layer


def export_layer_state(layer):
    """``layer.state_dict()`` as ``{name: numpy array}`` (floats as
    float32), the names and layouts ``load_layer_state`` and the JAX
    package's ``set_state_dict`` take."""
    return {k: _state_array(v.torch()) for k, v in layer.state_dict().items()}


def _state_array(v):
    """A state value as numpy: floats as float32 (numpy has no bf16),
    integer counters as they are."""
    if not torch.is_tensor(v):
        return np.asarray(v)
    v = v.detach().cpu()
    return (v.float() if v.is_floating_point() else v).numpy()


def export_optimizer_state(optimizer, model, names=None):
    """``optimizer``'s state in the JAX package's ``state_dict`` format,
    as numpy arrays keyed ``{names.get(n, n)}__{key}`` for each parameter
    ``n`` of ``model`` that has state (moments of linear weights in
    ``paddle_tpu``'s ``[in, out]`` layout), plus ``__step__`` and the
    scheduler's ``LR_Scheduler``."""
    names = names or {}
    linear = _linear_weights(model)
    paddle = optimizer.paddle_state_dict()
    out = {k: paddle[k] for k in ("__step__", "LR_Scheduler")
           if k in paddle}
    for name, p in torch_named_parameters(model):
        for key, v in optimizer.state.get(p, {}).items():
            arr = _state_array(v)
            if name in linear and arr.ndim >= 2:
                arr = _flip(arr)
            out[f"{names.get(name, name)}__{key}"] = \
                np.ascontiguousarray(arr)
    return out


def load_optimizer_state(optimizer, model, state, names=None):
    """Load ``state`` (the JAX package's ``state_dict`` format: tensors,
    jax arrays or numpy, keyed as ``export_optimizer_state`` keys them)
    into ``optimizer`` over ``model``'s parameters; each state tensor
    takes the dtype and device the optimizer gives it."""
    names = names or {}
    linear = _linear_weights(model)
    own = {id(p): n for n, p in optimizer._state_names()}
    staged = {k: state[k] for k in ("__step__", "LR_Scheduler")
              if k in state}
    for name, p in torch_named_parameters(model):
        prefix = f"{names.get(name, name)}__"
        for k, v in state.items():
            if not (isinstance(k, str) and k.startswith(prefix)):
                continue
            arr = (_state_array(v) if torch.is_tensor(v) else
                   np.asarray(v.numpy() if hasattr(v, "numpy") else v))
            if name in linear and arr.ndim >= 2:
                arr = _flip(arr)
            staged[f"{own[id(p)]}__{k[len(prefix):]}"] = \
                torch.from_numpy(np.array(arr, copy=True))
    optimizer.set_state_dict(staged)
    return optimizer


def tensor_from_paddle_tpu(t, device=None):
    """The port's handle for a ``paddle_tpu`` ``Tensor``, ``Parameter`` or
    ``SelectedRows`` ``t``: its value as numpy, its ``stop_gradient`` /
    ``trainable``, ``name`` and ``persistable``, on ``device`` (the
    current place by default).  ``t`` is read through its public surface
    (``numpy()``, ``rows``, ``values``, ``height``), so the port imports
    nothing of the JAX package."""
    from .core import device as core_device
    from .core.selected_rows import SelectedRows
    from .core.tensor import Parameter, Tensor
    dev = core_device.torch_device(device)

    def on_dev(a):
        return torch.from_numpy(np.array(np.asarray(a), copy=True)).to(dev)

    kind = type(t).__name__
    if kind == "SelectedRows":
        return SelectedRows(on_dev(t.rows), on_dev(t.values), t.height,
                            name=t.name)
    data = on_dev(t.numpy())
    if kind == "Parameter":
        out = Parameter(data, name=t.name, trainable=t.trainable)
    else:
        out = Tensor(data, stop_gradient=t.stop_gradient, name=t.name)
    out.persistable = bool(getattr(t, "persistable", False))
    return out


def tensor_to_paddle_tpu(t):
    """The reverse of ``tensor_from_paddle_tpu``: the port's handle ``t``
    as the record a ``paddle_tpu`` constructor takes — ``kind``
    (``"Tensor"``, ``"Parameter"`` or ``"SelectedRows"``), the value as
    numpy (``value``, or ``rows`` / ``values`` / ``height``), and
    ``stop_gradient``, ``trainable``, ``name``, ``persistable``.  The
    caller builds the JAX package's object from it."""
    from .core.selected_rows import SelectedRows
    from .core.tensor import Parameter
    if isinstance(t, SelectedRows):
        return dict(kind="SelectedRows", rows=t.rows.cpu().numpy(),
                    values=t.values.detach().cpu().numpy(),
                    height=t.height, name=t.name)
    return dict(kind="Parameter" if isinstance(t, Parameter) else "Tensor",
                value=t.numpy(), stop_gradient=t.stop_gradient,
                trainable=t.trainable, name=t.name,
                persistable=t.persistable)
