"""Scan-over-layers: a homogeneous layer stack with stacked parameters —
counterpart of ``paddle_tpu/nn/layer/scan.py``.

A ``Layer`` (so the BERT and GPT models keep building on it), whose
layers may be Paddle Layers or torch modules.  The JAX package runs the
stack as one ``lax.scan`` so XLA compiles the body once.  Torch has no
scan: the port keeps the JAX package's layout and names (every parameter
stacked ``[L, ...]``, named as the layer names it: ``ln1.weight``,
``attn.qkv_proj.weight``) and runs the forward as a loop over the
layers' slices.  Decay masks written against the dotted names select the
same parameters in both packages.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from .base import Layer, torch_named_buffers, torch_named_parameters


def owner_of(module, dotted):
    """``(submodule, leaf name)`` of ``module``'s parameter named
    ``dotted``; KeyError when there is none."""
    prefix, _, leaf = dotted.rpartition(".")
    owner = module.get_submodule(prefix) if prefix else module
    if leaf not in owner._parameters:
        raise KeyError(dotted)
    return owner, leaf


class ScanLayers(Layer):
    """``num_layers`` structurally identical layers, their parameters
    stacked into ``[L, ...]`` tensors.

    ``layer_factory`` builds ONE layer a call; the layers are built in
    turn and dropped once their parameters are taken, so the draws of the
    default generator (and so the initialization) are those of the
    unrolled ``ModuleList`` built the same way.  The first layer stays as
    the structure: its submodules become this module's, holding the
    stacked parameters, so ``named_parameters`` gives ``ln1.weight``
    ``[L, E]`` and ``attn.qkv_proj.weight`` ``[L, 3E, E]`` (torch's
    ``[out, in]`` linear layout under each index).

    ``forward(x, *extra)`` runs layer ``i`` as the structure layer with
    the ``i``-th slices (``torch.func.functional_call``), ``extra``
    passed to every layer unchanged; the slices come from one ``unbind``
    a parameter, so backward writes each stacked gradient once.  Layers
    must map x to x and hold no buffers (running stats would have to be
    threaded through the loop: unroll such stacks).  ``use_recompute``
    wraps each layer's body in ``fleet.utils.recompute`` with
    ``recompute_policy``.  Each layer draws its own dropout masks in
    turn, as the unrolled form does (the JAX package folds the layer
    index into one step key instead, so its two forms draw different
    masks; they agree at dropout 0)."""

    def __init__(self, layer_factory, num_layers, use_recompute=False,
                 recompute_policy=None):
        super().__init__()
        self.num_layers = int(num_layers)
        self.use_recompute = use_recompute
        self.recompute_policy = recompute_policy
        per_leaf = {}
        template = None
        for _ in range(self.num_layers):
            lyr = layer_factory()
            if template is None:
                template = lyr
                if any(True for _ in torch_named_buffers(lyr)):
                    raise ValueError(
                        "ScanLayers requires buffer-free layers (e.g. no "
                        "BatchNorm): running stats cannot live in the "
                        "stacked form — use an unrolled ModuleList")
                self._stack_names = [
                    n for n, _ in torch_named_parameters(lyr)]
            for name, p in torch_named_parameters(lyr):
                per_leaf.setdefault(name, []).append(p.detach())
            del lyr
        with torch.no_grad():
            for name in self._stack_names:
                owner, leaf = owner_of(template, name)
                setattr(owner, leaf,
                        nn.Parameter(torch.stack(per_leaf.pop(name))))
        # the structure layer is not registered (its parameters would be
        # named twice); its children are, under their own names
        object.__setattr__(self, "_template", template)
        for cname, child in template.named_children():
            self.add_module(cname, child)
        for pname, p in torch_named_parameters(template, recurse=False):
            self.register_parameter(pname, p)

    def train(self, mode=True):
        self._template.training = mode
        return super().train(mode)

    def forward(self, x, *extra):
        names = self._stack_names
        slices = [owner._parameters[leaf].unbind(0) for owner, leaf in
                  (owner_of(self, n) for n in names)]
        tmpl = self._template

        def body(h, *layer):
            return functional_call(tmpl, dict(zip(names, layer)),
                                   (h, *extra))

        for i in range(self.num_layers):
            layer = [s[i] for s in slices]
            if self.use_recompute:
                from ...distributed.fleet.utils import recompute
                x = recompute(body, x, *layer,
                              policy=self.recompute_policy)
            else:
                x = body(x, *layer)
        return x
