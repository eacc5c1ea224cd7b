"""Fleet utility belt + distributed metrics — counterpart of
``paddle_tpu/distributed/fleet/util.py``.

Reference parity: ``fleet/base/util_factory.py`` (UtilBase:
all_reduce/all_gather/barrier over gloo, get_file_shard, print_on_rank)
and ``fleet/metrics/metric.py`` (numpy metrics aggregated across workers).
Cross-worker aggregation rides the process transport
(``distributed/process.py``); a one-process run reduces to the identity,
matching the reference's worker_num()==1 behavior.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import process


def _world():
    return process.count()


def _rank():
    return process.index()


class UtilBase:
    """reference: fleet/base/util_factory.py:43."""

    def __init__(self):
        self.role_maker = None

    def _set_role_maker(self, role_maker):
        self.role_maker = role_maker

    # -- collectives over host scalars/arrays ----------------------------
    def all_reduce(self, input, mode="sum", comm_world="worker"):
        arr = np.asarray(input)
        if _world() == 1:
            return arr
        out = process.all_reduce(torch.as_tensor(arr), op=mode,
                                 key=("util",), name=f"util[{mode}]")
        return out.numpy()

    def all_gather(self, input, comm_world="worker"):
        if _world() == 1:
            return [input]
        return process.all_gather_object(input, key=("util",),
                                         name="util.all_gather")

    def barrier(self, comm_world="worker"):
        if _world() == 1:
            return
        process.barrier(key=("util",))

    # -- file sharding (reference :206) ----------------------------------
    def get_file_shard(self, files):
        if not isinstance(files, list):
            raise TypeError("files should be a list of file paths")
        n = _world()
        i = _rank()
        blocks = len(files) // n
        remainder = len(files) % n
        if i < remainder:
            begin = i * (blocks + 1)
            end = begin + blocks + 1
        else:
            begin = remainder * (blocks + 1) + (i - remainder) * blocks
            end = begin + blocks
        return files[begin:end]

    def print_on_rank(self, message, rank_id):
        if _rank() == rank_id:
            print(message)


# -- distributed metrics (reference: fleet/metrics/metric.py) -------------
def _reduce_np(value, mode):
    return UtilBase().all_reduce(np.asarray(value, np.float64), mode)


def sum(input, scope=None, util=None):  # noqa: A001
    return _reduce_np(np.asarray(input).sum(), "sum")


def max(input, scope=None, util=None):  # noqa: A001
    return _reduce_np(np.asarray(input).max(), "max")


def min(input, scope=None, util=None):  # noqa: A001
    return _reduce_np(np.asarray(input).min(), "min")


def acc(correct, total, scope=None, util=None):
    c = _reduce_np(correct, "sum")
    t = _reduce_np(total, "sum")
    return float(c) / float(np.maximum(t, 1))


def mae(abserr, total_ins_num, scope=None, util=None):
    e = _reduce_np(np.asarray(abserr).sum(), "sum")
    n = _reduce_np(total_ins_num, "sum")
    return float(e) / float(np.maximum(n, 1))


def rmse(sqrerr, total_ins_num, scope=None, util=None):
    e = _reduce_np(np.asarray(sqrerr).sum(), "sum")
    n = _reduce_np(total_ins_num, "sum")
    return float(np.sqrt(e / np.maximum(n, 1)))


def mse(sqrerr, total_ins_num, scope=None, util=None):
    e = _reduce_np(np.asarray(sqrerr).sum(), "sum")
    n = _reduce_np(total_ins_num, "sum")
    return float(e) / float(np.maximum(n, 1))


def auc(stat_pos, stat_neg, scope=None, util=None):
    """Distributed AUC from per-bucket positive/negative counts
    (reference: fleet/metrics/metric.py auc)."""
    pos = _reduce_np(np.asarray(stat_pos, np.float64), "sum")
    neg = _reduce_np(np.asarray(stat_neg, np.float64), "sum")
    # walk buckets from high score to low accumulating the ROC integral
    area = 0.0
    tp = fp = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_tp = tp + pos[i]
        new_fp = fp + neg[i]
        area += (new_fp - fp) * (tp + new_tp) / 2.0
        tp, fp = new_tp, new_fp
    if tp == 0 or fp == 0:
        return 0.5
    return float(area / (tp * fp))
