"""fleet.meta_parallel — counterpart of
``paddle_tpu/distributed/fleet/meta_parallel.py``: the tensor-parallel
layers and ``PipelineLayer``.

A pipelined model is ``pre`` (the embedding end, replicated) + N
identical ``blocks`` (split over ``pp`` in order, ``N / pp`` a stage) +
``post`` (the head end, replicated); ``parallel/pipeline.py`` runs the
schedules over a mesh, and ``forward`` is the eager one-device
reference: the three in sequence.  The attribute names (``pre``,
``blocks.{i}``, ``post``) are the JAX package's, so the weight bridge
(``convert.py``) loads a JAX ``PipelineLayer``'s state by name.
"""
from __future__ import annotations

from torch import nn

from ..sharding import (ColumnParallelLinear, RowParallelLinear,  # noqa: F401
                        VocabParallelEmbedding)
from ...nn.layer.base import torch_named_parameters


class LayerDesc:
    """Declarative layer description (built lazily)."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.key = key


class PipelineLayer(nn.Module):
    """``pre`` + identical ``blocks`` + ``post`` (module docstring).  A
    reference-style flat ``layers`` list (``LayerDesc``\\ s or modules)
    takes its first entry as ``pre``, its last as ``post`` and the rest
    as the blocks, as the JAX package's does."""

    def __init__(self, pre=None, blocks=None, post=None, loss_fn=None,
                 num_stages=None, seg_method="uniform", layers=None,
                 **kwargs):
        super().__init__()
        if layers is not None and blocks is None:
            built = [l.build() if isinstance(l, LayerDesc) else l
                     for l in layers]
            pre, blocks, post = built[0], built[1:-1], built[-1]
        self.pre = pre
        self.blocks = nn.ModuleList(list(blocks or []))
        self.post = post
        self.loss_fn = loss_fn
        self.num_stages = num_stages

    def forward(self, x, *args, **kwargs):
        """Eager one-device semantics: plain sequential."""
        if self.pre is not None:
            x = self.pre(x)
        for blk in self.blocks:
            x = blk(x)
        if self.post is not None:
            x = self.post(x)
        return x

    def block_structure(self):
        """(parameter names of a block, block count)."""
        if not len(self.blocks):
            return [], 0
        names = [n for n, _ in torch_named_parameters(self.blocks[0])]
        return names, len(self.blocks)
