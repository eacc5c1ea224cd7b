"""Data pipeline — counterpart of ``paddle_tpu/io/__init__.py``.

The datasets, the samplers, ``BatchSampler``, ``DistributedBatchSampler``,
``default_collate_fn``, ``DataLoader`` and ``DataFeeder`` keep the JAX
package's names and semantics.  The samplers draw from
``np.random.RandomState(get_seed() + ...)`` as the JAX package's do, and
the port's ``core.rng.get_seed`` is the integer ``paddle.seed`` set, so
one seed gives the same batch order in both packages.

Batches are assembled as numpy arrays on the host: in the calling
thread (``num_workers=0``), in worker processes (``io/worker.py``, the
default for ``num_workers > 0``) or in worker threads
(``PADDLE_TPU_THREAD_WORKERS=1``, ``_PrefetchIter``).  Both worker forms
hand batches out in sampler order through the native ordered queue
(``csrc.NativeOrderedQueue``).  Iterating a ``DataLoader`` wraps each
batch as ``Tensor`` handles on the current place, a synchronous copy
from pageable memory; ``host_batches()`` yields the numpy batches
themselves, which ``DeviceLoader`` (``io/prefetch.py``) pins and
uploads on a stream of its own while the step computes, as
``hapi.Model.fit`` feeds them.
"""
from __future__ import annotations

import math
import queue
import threading

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core import rng as rng_mod


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of equal-length arrays.  ``tensors`` may be handles, torch
    tensors or numpy arrays; each is kept as a host numpy array, so a
    sample never touches the card (workers read it after a fork)."""

    def __init__(self, tensors):
        self.tensors = [_host_array(t) for t in tensors]
        assert all(t.shape[0] == self.tensors[0].shape[0]
                   for t in self.tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (tuple, list))
                       else [sample])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds_idx == 0 else self.cum[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if all(isinstance(l, float) for l in lengths):
        lengths = [int(math.floor(total * l)) for l in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    if sum(lengths) != total:
        raise ValueError("sum of lengths != dataset size")
    perm = np.random.RandomState(rng_mod.get_seed()).permutation(total)
    out, offset = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l].tolist()))
        offset += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)
        self._epoch = 0

    def __iter__(self):
        n = len(self.data_source)
        # deterministic under paddle.seed, fresh permutation per epoch
        # (an id(self)-based seed would change between runs)
        rs = np.random.RandomState(
            (rng_mod.get_seed() + self._epoch * 1315423911) % (2 ** 31))
        self._epoch += 1
        if self.replacement:
            return iter(rs.randint(0, n, self.num_samples).tolist())
        return iter(rs.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        rs = np.random.RandomState(rng_mod.get_seed() % (2 ** 31))
        idx = rs.choice(len(self.weights), self.num_samples,
                        replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """reference: fluid/dataloader/batch_sampler.py"""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """reference: fluid/dataloader/batch_sampler.py DistributedBatchSampler —
    pads/partitions indices across ranks.  On TPU, "rank" is the data-shard
    index of the global mesh ('dp' axis); with a single-process global view
    (pjit path) the loader usually runs with num_replicas=1 and the global
    batch is sharded by the step function instead."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed import get_world_size, get_rank
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else \
            get_world_size()
        self.local_rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rs = np.random.RandomState(self.epoch + rng_mod.get_seed())
            rs.shuffle(indices)
        indices = np.concatenate(
            [indices, indices[:self.total_size - n]])
        local = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in local.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def _host_array(t):
    if isinstance(t, Tensor):
        return t.numpy()
    if isinstance(t, torch.Tensor):
        return Tensor._wrap(t).numpy()
    return np.asarray(t)


def default_collate_fn(batch):
    """Stack a list of samples into numpy batch arrays."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch)
    if isinstance(sample, (Tensor, torch.Tensor)):
        return np.stack([_host_array(s) for s in batch])
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, float):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return [default_collate_fn(list(fields)) for fields in transposed]
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch])
                for k in sample}
    return np.asarray(batch)


class _PrefetchIter:
    """Worker threads fill the native ordered queue (reference: the
    blocking-queue + buffered_reader double-buffer pipeline): the queue
    re-orders batches by sequence number and hands them over outside the
    GIL.  ``convert`` maps each host batch on its way out."""

    def __init__(self, loader, batches, convert):
        from ..csrc import NativeOrderedQueue
        self.loader = loader
        self.convert = convert
        capacity = max(2, loader.prefetch_factor * max(
            loader.num_workers, 1))
        self._native = NativeOrderedQueue(capacity)
        self._stop = threading.Event()
        self._index_q = queue.Queue()
        for i, b in enumerate(batches):
            self._index_q.put((i, b))
        self._total = len(batches)
        self._next_emit = 0
        self._threads = []
        for _ in range(loader.num_workers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self):
        while not self._stop.is_set():
            try:
                i, idx_batch = self._index_q.get_nowait()
            except queue.Empty:
                return
            try:
                samples = [self.loader.dataset[i2] for i2 in idx_batch]
                data = self.loader.collate_fn(samples)
            except Exception as e:  # propagate to the consumer
                data = e
            try:
                self._native.put(i, data)
            except RuntimeError:
                return

    def __iter__(self):
        return self

    def __next__(self):
        if self._next_emit >= self._total:
            self._stop.set()
            self._native.close()
            raise StopIteration
        try:
            _, data = self._native.get(
                int(self.loader.timeout * 1000) if self.loader.timeout
                else -1)
        except TimeoutError:
            self._stop.set()
            self._native.close()
            raise RuntimeError(
                f"DataLoader timed out after {self.loader.timeout}s "
                f"waiting for batch {self._next_emit}") from None
        self._next_emit += 1
        if isinstance(data, Exception):
            self._stop.set()
            self._native.close()
            raise data
        return self.convert(data)

    def __del__(self):
        try:
            self._stop.set()
            self._native.close()
        except Exception:
            pass


def _to_tensors(data, return_list):
    if isinstance(data, np.ndarray):
        return Tensor(data)
    if isinstance(data, (list, tuple)):
        return [_to_tensors(d, return_list) for d in data]
    if isinstance(data, dict):
        return {k: _to_tensors(v, return_list) for k, v in data.items()}
    return data


class DataLoader:
    """paddle.io.DataLoader (reference: fluid/reader.py:149)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        import os as _os
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, num_workers)
        self.prefetch_factor = prefetch_factor
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        # process workers are the default (reference: dataloader_iter.py
        # _DataLoaderIterMultiProcess); threads remain as an opt-out for
        # unpicklable/fork-hostile setups
        self._use_threads = _os.environ.get(
            "PADDLE_TPU_THREAD_WORKERS", "0") == "1"
        self._pool = None
        self._live_pools = []  # every pool ever spawned and not yet closed
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        elif self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
            self.batch_size = batch_size

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("DataLoader over IterableDataset has no len()")
        return len(self.batch_sampler)

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not getattr(self, "drop_last", False):
            yield self.collate_fn(batch)

    def _get_pool(self):
        from .worker import WorkerPool
        # reuse ANY idle live pool (not just self._pool): with
        # persistent_workers, the extra pools spawned for concurrent
        # iterators must be recycled, not accumulate one per epoch
        self._live_pools = [p for p in self._live_pools if not p._closed]
        for pool in self._live_pools:
            if not pool.busy:
                return pool
        # all pools busy: a second concurrent iterator gets its OWN pool —
        # sharing one result queue across generations would drop/unlink
        # each other's batches and deadlock both iterators
        pool = WorkerPool(self)
        self._live_pools.append(pool)
        if self._pool is None or self._pool._closed:
            self._pool = pool
        return pool

    def __iter__(self):
        return self._iter(lambda d: _to_tensors(d, self.return_list))

    def host_batches(self):
        """An iterator over the batches as collated on the host (numpy
        arrays, nested as ``collate_fn`` returns them): what
        ``DeviceLoader`` pins and uploads."""
        return self._iter(lambda d: d)

    def _iter(self, convert):
        from .worker import MultiprocessMapIter, MultiprocessIterableIter
        if self._iterable_mode:
            if self.num_workers > 0 and not self._use_threads:
                return (convert(d) for d in MultiprocessIterableIter(self))
            return (convert(d) for d in self._iter_iterable())
        batches = list(self.batch_sampler)
        if self.num_workers > 0:
            if self._use_threads:
                return _PrefetchIter(self, batches, convert)
            pool = self._get_pool()
            mp_it = MultiprocessMapIter(self, batches, pool)
            return _MPIterGuard(self, mp_it, pool, convert)
        return (convert(d) for d in self._iter_sync(batches))

    def __del__(self):
        # close EVERY pool this loader ever spawned — extra pools created
        # for concurrent iterators must not outlive the loader
        for pool in list(getattr(self, "_live_pools", ())):
            try:
                pool.close()
            except Exception:
                pass

    def _iter_sync(self, batches):
        for idx_batch in batches:
            samples = [self.dataset[i] for i in idx_batch]
            yield self.collate_fn(samples)


class _MPIterGuard:
    """Deterministic WorkerPool release for a multiprocess iterator.

    A plain generator's ``finally`` only runs once the generator has
    STARTED — an iterator obtained and then abandoned before the first
    ``next()`` would leave ``pool.busy`` stuck True, so every later epoch
    spawned (and leaked) a fresh pool of worker processes.  This wrapper
    releases the pool on exhaustion AND on garbage collection, started or
    not."""

    def __init__(self, loader, mp_it, pool, convert):
        self.loader = loader
        self.mp_it = mp_it
        self.pool = pool
        self.convert = convert
        self._released = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._released:
            # the pool may already be claimed by another iterator;
            # touching mp_it after release would make both drain the
            # same result queue (matches the old generator wrapper,
            # which was dead after its finally ran)
            raise StopIteration
        try:
            return self.convert(next(self.mp_it))
        except BaseException:
            self._release()
            raise

    def _release(self):
        if self._released:
            return
        self._released = True
        loader, pool = self.loader, self.pool
        pool.busy = False
        if not loader.persistent_workers:
            try:
                pool.close()
            finally:
                if loader._pool is pool:
                    loader._pool = None
                if pool in loader._live_pools:
                    loader._live_pools.remove(pool)

    def __del__(self):
        try:
            self._release()
        except Exception:
            pass


from .worker import get_worker_info, WorkerInfo  # noqa: E402
from .prefetch import DeviceLoader  # noqa: E402

from .native_dataset import (InMemoryDataset, QueueDataset,  # noqa: E402
                             DatasetFactory)


class DataFeeder:
    """Legacy feeder (reference: fluid/data_feeder.py) — converts a list of
    per-sample tuples into the feed dict a static program expects."""

    def __init__(self, feed_list, place=None, program=None):
        self.feed_names = [v if isinstance(v, str) else v.name
                           for v in feed_list]

    def feed(self, iterable):
        columns = list(zip(*iterable))
        if len(columns) != len(self.feed_names):
            raise ValueError(
                f"DataFeeder: each sample has {len(columns)} fields but "
                f"{len(self.feed_names)} feed names were declared "
                f"({self.feed_names})")
        out = {}
        for name, col in zip(self.feed_names, columns):
            out[name] = np.stack([np.asarray(s) for s in col])
        return out


from .bucketing import (  # noqa: E402
    BucketedBatchSampler, bucketed_collate, pad_to_bucket, bucket_for,
    DEFAULT_BUCKETS,
)
