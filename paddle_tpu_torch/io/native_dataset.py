"""File-based Dataset engine (InMemoryDataset / QueueDataset) —
counterpart of ``paddle_tpu/io/native_dataset.py``.

Reference parity: ``paddle.fluid.DatasetFactory`` over the C++ dataset
machinery — ``framework/data_set.cc`` (LoadIntoMemory / LocalShuffle /
GlobalShuffle / ReleaseMemory), ``framework/data_feed.cc``
(MultiSlotDataFeed text parsing).  The parsing, shuffle and batch gather
run in the native engine (``csrc/dataset.cc``, the JAX package's source)
off the GIL.  The pure-Python engine of the JAX package stays as an
engine the caller names (``InMemoryDataset(engine="python")``), never a
fallback: a host library that does not build raises.  The native
engine's shuffle is ``std::shuffle`` over ``mt19937_64``, the Python
engine's numpy's, so the two shuffle differently; they agree on the
records as a multiset, and unshuffled in order.

``global_shuffle`` shards by the data-parallel rank and world of
``distributed.parallel``.  The port runs in one process: a
``torch.distributed`` world of more than one process raises, naming
ROADMAP Queue A 12d (the multi-process forms).

Schema: ``set_use_var([...])`` declares the slots; each text line holds the
concatenated values of all slots for one record (label slots included),
exactly like a MultiSlot schema with fixed dims.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import csrc


def _slot_dim(shape):
    d = 1
    for s in shape[1:]:  # batch dim excluded
        d *= int(s)
    return d


class _PyEngine:
    """Pure-Python engine mirroring dataset.cc semantics."""

    def __init__(self):
        self.files = []
        self.data = None
        self.order = None
        self.dim = 0

    def load(self, dim, nthreads):
        rows = []
        for path in self.files:
            with open(path) as f:
                for line in f:
                    vals = line.split()
                    if not vals:
                        continue
                    row = np.zeros(dim, np.float32)
                    got = np.array(vals[:dim], np.float32)
                    row[:len(got)] = got
                    rows.append(row)
        self.dim = dim
        self.data = np.stack(rows) if rows else np.zeros((0, dim),
                                                         np.float32)
        self.order = np.arange(len(self.data))
        return len(self.data)

    def shuffle(self, seed):
        np.random.RandomState(seed & 0xffffffff).shuffle(self.order)

    def shard(self, rank, world):
        if world > 1:
            self.order = self.order[rank::world]

    def reset_order(self):
        self.order = np.arange(0 if self.data is None else len(self.data))

    def num(self):
        return 0 if self.order is None else len(self.order)

    def batch(self, start, count):
        idx = self.order[start:start + count]
        return self.data[idx]

    def release(self):
        self.data = self.order = None


class _NativeEngine:
    def __init__(self, lib):
        self.lib = lib
        self.h = ctypes.c_void_p(lib.ptds_new())
        self.files = []
        self.dim = 0

    def load(self, dim, nthreads):
        arr = (ctypes.c_char_p * len(self.files))(
            *[f.encode() for f in self.files])
        self.lib.ptds_set_filelist(self.h, arr, len(self.files))
        self.dim = dim
        return int(self.lib.ptds_load_into_memory(self.h, dim, nthreads))

    def shuffle(self, seed):
        self.lib.ptds_local_shuffle(self.h, seed)

    def shard(self, rank, world):
        self.lib.ptds_shard(self.h, rank, world)

    def reset_order(self):
        self.lib.ptds_reset_order(self.h)

    def num(self):
        return int(self.lib.ptds_num_records(self.h))

    def batch(self, start, count):
        out = np.empty((count, self.dim), np.float32)
        got = self.lib.ptds_get_batch(
            self.h, start, count,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out[:got]

    def release(self):
        self.lib.ptds_release_memory(self.h)

    def __del__(self):
        try:
            self.lib.ptds_free(self.h)
        except Exception:
            pass


class InMemoryDataset:
    """reference: fluid/dataset.py InMemoryDataset over data_set.cc.
    ``engine`` is ``"native"`` (the host library, built at first use) or
    ``"python"`` (the JAX package's pure-Python engine)."""

    def __init__(self, engine="native"):
        if engine == "native":
            self._engine = _NativeEngine(csrc.load())
        elif engine == "python":
            self._engine = _PyEngine()
        else:
            raise ValueError(f"engine must be 'native' or 'python', got "
                             f"{engine!r}")
        self._use_vars = []
        self._batch_size = 1
        self._thread_num = max((os.cpu_count() or 2) // 2, 1)
        self._seed = 0
        self._gs_epoch = 0
        self._loaded = False

    # -- configuration (reference Dataset API names) --------------------
    def set_filelist(self, files):
        self._engine.files = list(files)

    def set_use_var(self, var_list):
        self._use_vars = list(var_list)

    def set_batch_size(self, bs):
        self._batch_size = int(bs)

    def set_thread(self, n):
        self._thread_num = int(n)

    def _record_dim(self):
        if not self._use_vars:
            raise ValueError("call set_use_var first (defines the schema)")
        return sum(_slot_dim(v.shape) for v in self._use_vars)

    # -- lifecycle ------------------------------------------------------
    def load_into_memory(self):
        n = self._engine.load(self._record_dim(), self._thread_num)
        self._loaded = True
        return n

    def local_shuffle(self):
        self._engine.shuffle(self._seed)
        self._seed += 1

    def global_shuffle(self, fleet=None, thread_num=None):
        """Shared-seed shuffle + per-rank sharding (the reference moves
        records between nodes via the fleet — ``data_set.cc``
        GlobalShuffle; with a shared seed every rank derives the same
        permutation so sharding replaces data motion).  Re-derives from
        the full record set each call, so per-epoch calls produce fresh
        partitions instead of shrinking the shard.

        CONTRACT: every rank must have loaded the IDENTICAL record set in
        identical order (same ``set_filelist`` on all ranks) — the shared
        permutation only partitions correctly when all ranks agree on the
        full set.  Ranks with unequal local data need the reference's
        record-exchange semantics, which this redesign deliberately
        replaces.  The JAX package enforces it across hosts with a record
        digest; the port runs in one process (module docstring)."""
        from ..distributed import parallel as dist_parallel
        rank = dist_parallel.get_rank()
        world = dist_parallel.get_world_size()
        self._engine.reset_order()
        self._check_identical_records()
        self._engine.shuffle(12345 + self._gs_epoch)
        self._gs_epoch += 1
        self._engine.shard(rank, world)

    def _check_identical_records(self):
        """The JAX package all-gathers a record digest over its hosts
        here; the port has one process, and refuses more."""
        import torch.distributed as tdist
        if tdist.is_available() and tdist.is_initialized() and \
                tdist.get_world_size() > 1:
            raise NotImplementedError(
                "InMemoryDataset.global_shuffle over several processes is "
                "not ported yet (ROADMAP Queue A 12d, the multi-process "
                "forms)")

    def release_memory(self):
        self._engine.release()
        self._loaded = False

    def get_memory_data_size(self, fleet=None):
        return self._engine.num()

    get_shuffle_data_size = get_memory_data_size

    # -- iteration ------------------------------------------------------
    def _split_slots(self, flat):
        outs, off = [], 0
        for v in self._use_vars:
            d = _slot_dim(v.shape)
            sl = flat[:, off:off + d]
            off += d
            shape = [len(flat)] + [int(s) for s in v.shape[1:]]
            arr = sl.reshape(shape)
            dt = getattr(v, "dtype", "float32")
            dt = str(dt)
            if "int" in dt:
                arr = arr.astype(dt)
            outs.append(arr)
        return outs

    def __iter__(self):
        if not self._loaded:
            self.load_into_memory()
        n = self._engine.num()
        bs = self._batch_size
        for start in range(0, n - n % bs, bs):
            yield self._split_slots(self._engine.batch(start, bs))


class QueueDataset(InMemoryDataset):
    """Streaming flavor: no shuffle, loads lazily on first iteration
    (reference QueueDataset streams through channels without the in-memory
    store; on one host the distinction is laziness, kept here)."""

    def local_shuffle(self):
        raise RuntimeError("QueueDataset does not support local_shuffle "
                           "(reference: dataset.py QueueDataset)")

    def global_shuffle(self, fleet=None, thread_num=None):
        raise RuntimeError("QueueDataset does not support global_shuffle")


class DatasetFactory:
    """reference: fluid/dataset.py DatasetFactory."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError(f"unknown dataset class {datafeed_class!r}")
