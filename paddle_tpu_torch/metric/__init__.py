"""Metrics — counterpart of ``paddle_tpu/metric/__init__.py`` (reference:
python/paddle/metric/metrics.py — Metric base, Accuracy, Precision,
Recall, Auc; kernels operators/metrics/*).

``Accuracy.compute`` runs on the output's device (inside
``TrainStep.step``, on the card): a descending argsort that is stable,
so ties rank the lower class index first as the JAX package's
``jnp.argsort(-pred)`` does (``torch.topk`` promises no order among
ties).  Given torch tensors it returns a torch tensor, given handles or
arrays a ``Tensor`` handle.  ``update`` / ``accumulate`` run in numpy on
the host, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor


def _host(x):
    """A numpy copy of a handle, a torch tensor or an array."""
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x).numpy()
    return np.asarray(x)


def _torch(x):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        p = _torch(pred)
        lab = _torch(label).to(p.device)
        order = torch.argsort(-p, dim=-1, stable=True)[..., :self.maxk]
        if lab.dim() == p.dim():
            lab = lab.squeeze(-1)
        correct = (order == lab[..., None]).to(torch.float32)
        return correct if isinstance(pred, torch.Tensor) \
            else Tensor._wrap(correct)

    def update(self, correct, *args):
        arr = _host(correct)
        accs = []
        for k in self.topk:
            c = arr[..., :k].sum(-1).mean()
            accs.append(float(c))
        self.total[0] += float(arr[..., :self.maxk].any(-1).sum())
        self.count[0] += int(np.prod(arr.shape[:-1]))
        for i, k in enumerate(self.topk):
            self._correct_k[i] += float(arr[..., :k].sum())
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0]
        self.count = [0]
        self._correct_k = [0.0 for _ in self.topk]

    def accumulate(self):
        res = [ck / self.count[0] if self.count[0] else 0.0
               for ck in self._correct_k]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _host(preds)
        labels = _host(labels).reshape(preds.shape)
        pred_pos = (preds > 0.5)
        self.tp += int(np.sum(pred_pos & (labels > 0.5)))
        self.fp += int(np.sum(pred_pos & (labels <= 0.5)))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _host(preds)
        labels = _host(labels).reshape(preds.shape)
        pred_pos = (preds > 0.5)
        self.tp += int(np.sum(pred_pos & (labels > 0.5)))
        self.fn += int(np.sum(~pred_pos & (labels > 0.5)))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Threshold-bucketed AUC (reference: operators/metrics/auc_op.cc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _host(preds)
        labels = _host(labels).reshape(-1)
        if preds.ndim == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        buckets = np.clip(
            (preds * self.num_thresholds).astype(np.int64), 0,
            self.num_thresholds)
        pos = labels > 0.5
        np.add.at(self._stat_pos, buckets[pos], 1)
        np.add.at(self._stat_neg, buckets[~pos], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return auc / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """functional paddle.metric.accuracy: the top-``k`` hit rate, a
    float32 scalar handle on the current place."""
    pred = _host(input)
    lab = _host(label)
    order = np.argsort(-pred, axis=-1, kind="stable")[..., :k]
    if lab.ndim == pred.ndim:
        lab = lab.squeeze(-1)
    correct_any = (order == lab[..., None]).any(-1)
    return Tensor(np.asarray(correct_any.mean(), np.float32))


import sys as _sys  # noqa: E402
metrics = _sys.modules[__name__]  # reference: paddle.metric.metrics alias
