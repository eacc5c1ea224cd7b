"""Loss layers — counterpart of ``paddle_tpu/nn/layer/loss.py``
(``CrossEntropyLoss`` through ``NCELoss``): each calls its functional;
``PairwiseDistance``, ``HSigmoidLoss`` and ``NCELoss`` compute their
own.  ``NCELoss`` draws its negative classes from the tensor layer's
generator of the input's device."""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as TF

from .base import Layer
from .. import functional as F
from .. import initializer as I
from ..functional._io import api


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax,
                               label_smoothing=self.label_smoothing)


def _reduction_loss(cls_name, fn_name):
    fn = getattr(F, fn_name)

    def __init__(self, reduction="mean", name=None):
        Layer.__init__(self)
        self.reduction = reduction

    def forward(self, input, label):
        return fn(input, label, reduction=self.reduction)

    return type(cls_name, (Layer,), {"__init__": __init__,
                                     "forward": forward,
                                     "__module__": __name__})


MSELoss = _reduction_loss("MSELoss", "mse_loss")
L1Loss = _reduction_loss("L1Loss", "l1_loss")
KLDivLoss = _reduction_loss("KLDivLoss", "kl_div")


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, weight=self.weight,
                          ignore_index=self.ignore_index,
                          reduction=self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, weight=self.weight,
                                      reduction=self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, weight=self.weight, reduction=self.reduction,
            pos_weight=self.pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, reduction=self.reduction,
                                delta=self.delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, *self.args)


class PairwiseDistance(Layer):
    """The ``p``-norm of ``x - y + epsilon`` over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return api(self._dist)(x, y)

    def _dist(self, a, b):
        d = a - b + self.epsilon
        return d.abs().pow(self.p).sum(-1, keepdim=self.keepdim) \
            .pow(1.0 / self.p)


def _tree(num_classes):
    """Complete-binary-tree paths of each class: internal node ids,
    left/right codes and the valid-level mask, ``[C, depth]`` each."""
    d = int(np.ceil(np.log2(max(num_classes, 2))))
    paths = np.zeros((num_classes, d), np.int64)
    codes = np.zeros((num_classes, d), np.float32)
    mask = np.zeros((num_classes, d), np.float32)
    for c in range(num_classes):
        node, lvl = c + num_classes, 0
        while node > 1 and lvl < d:
            parent = node // 2
            paths[c, lvl] = parent - 1
            codes[c, lvl] = float(node % 2)
            mask[c, lvl] = 1.0
            node, lvl = parent, lvl + 1
    return paths, codes, mask


@api
def hsigmoid(x, label, num_classes, weight, bias=None):
    """The hierarchical sigmoid loss ``[B, 1]`` over the default tree:
    a binary cross entropy at each internal node of the label's path."""
    paths, codes, mask = (torch.as_tensor(a, device=x.device)
                          for a in _tree(num_classes))
    y = label.reshape(-1).long()
    node_ids = paths[y]
    logits = torch.einsum("bdf,bf->bd", weight[node_ids], x)
    if bias is not None:
        logits = logits + bias[node_ids]
    losses = mask[y] * (TF.softplus(logits) - codes[y] * logits)
    return losses.sum(-1, keepdim=True)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over a complete binary tree (custom trees are
    not supported)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if is_custom:
            raise NotImplementedError(
                "HSigmoidLoss custom trees: supply your own path codes via "
                "the functional form")
        self.num_classes = num_classes
        self.depth = int(np.ceil(np.log2(max(num_classes, 2))))
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr,
            default_initializer=I.Uniform(-0.5 / feature_size,
                                          0.5 / feature_size))
        self.bias = self.create_parameter(
            [num_classes - 1], attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))

    def forward(self, input, label):
        return hsigmoid(input, label, self.num_classes, self.weight,
                        self.bias)


class NCELoss(Layer):
    """Noise-contrastive estimation with ``num_neg_samples`` uniform
    negatives a row (only the uniform sampler)."""

    def __init__(self, feature_size, num_classes, num_neg_samples=10,
                 sampler="uniform", weight_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        if sampler != "uniform":
            raise NotImplementedError(
                "NCELoss: only the uniform sampler is implemented "
                "(reference custom_dist/log_uniform samplers)")
        self.num_classes = num_classes
        self.num_neg = num_neg_samples
        self.weight = self.create_parameter(
            [num_classes, feature_size], attr=weight_attr,
            default_initializer=I.Uniform(-0.01, 0.01))
        self.bias = self.create_parameter(
            [num_classes], attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))

    def forward(self, input, label, sample_weight=None):
        return api(self._nce)(input, label, self.weight, self.bias)

    def _nce(self, x, label, w, b):
        from ...core import rng
        y = label.reshape(-1).long()
        neg = torch.randint(0, self.num_classes, (x.shape[0], self.num_neg),
                            generator=rng.generator(x.device),
                            device=x.device)
        pos_logit = (x * w[y]).sum(-1) + b[y]
        neg_logit = torch.einsum("bf,bnf->bn", x, w[neg]) + b[neg]
        log_q = float(np.log(self.num_neg / self.num_classes))
        loss = TF.softplus(-(pos_logit - log_q)) \
            + TF.softplus(neg_logit - log_q).sum(-1)
        return loss.reshape(-1, 1)
