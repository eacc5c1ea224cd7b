"""Process-based DataLoader workers with shared-memory batch hand-off —
counterpart of ``paddle_tpu/io/worker.py``.

Reference parity: ``fluid/dataloader/dataloader_iter.py:464``
(_DataLoaderIterMultiProcess — worker processes + index/result queues) and
``paddle/fluid/memory/allocation/mmap_allocator.cc`` (shared-memory tensor
transport between workers and the trainer process).

Workers are forked numpy producers.  The parent may hold a CUDA context
(the port's default place is the card), and CUDA cannot be initialised
in a forked child: ``_init_worker`` therefore sets the tensor layer's
place to the CPU in each worker, so a dataset that calls ``to_tensor``
builds CPU handles, which ``default_collate_fn`` turns into numpy, and
pins torch to one intra-op thread there.  Each collated batch array is
written into a POSIX shared-memory segment and only its metadata crosses
the result queue; the parent copies the arrays out, unlinks the
segments, and re-orders batches by sequence number through the native
ordered queue (``csrc.NativeOrderedQueue``), keeping at most
``prefetch_factor * num_workers`` batches ahead of the consumer.
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import queue as queue_mod
import traceback
from multiprocessing import shared_memory

import numpy as np

# the result queue is polled in slices of this many seconds, so that a
# dead worker is noticed instead of waited on for ever
POLL_S = 5.0


class WorkerInfo:
    """reference: fluid/dataloader/worker.py WorkerInfo"""

    def __init__(self, id, num_workers, seed, dataset):
        self.id = id
        self.num_workers = num_workers
        self.seed = seed
        self.dataset = dataset

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, "
                f"num_workers={self.num_workers}, seed={self.seed})")


_worker_info = None


def get_worker_info():
    """Inside a worker process: that worker's info; None in the parent."""
    return _worker_info


class _ExceptionWrapper:
    def __init__(self, exc):
        self.exc_type_name = type(exc).__name__
        self.text = "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))

    def reraise(self):
        raise RuntimeError(
            f"DataLoader worker raised {self.exc_type_name}:\n{self.text}")


# ---------------------------------------------------------------------------
# batch <-> shared memory
#
# A collated batch is a pytree of numpy arrays (list/tuple/dict nesting).
# Flatten it, ship each array through its own shm segment, and rebuild the
# nesting in the parent.

def _flatten(data, arrays):
    if isinstance(data, np.ndarray):
        arrays.append(data)
        return ("a", len(arrays) - 1)
    if isinstance(data, (list, tuple)):
        return ("l" if isinstance(data, list) else "t",
                [_flatten(d, arrays) for d in data])
    if isinstance(data, dict):
        return ("d", {k: _flatten(v, arrays) for k, v in data.items()})
    return ("v", data)  # scalars etc: pass by value


def _unflatten(spec, arrays):
    tag, payload = spec
    if tag == "a":
        return arrays[payload]
    if tag in ("l", "t"):
        seq = [_unflatten(s, arrays) for s in payload]
        return seq if tag == "l" else tuple(seq)
    if tag == "d":
        return {k: _unflatten(v, arrays) for k, v in payload.items()}
    return payload


_shm_names = None    # in a worker: the names its segments take, in turn


def _arrays_to_shm(arrays):
    """Write each array into a fresh shm segment; return metadata list.

    The worker unregisters the segments from its resource tracker — the
    PARENT owns their lifetime and unlinks after the batch is consumed
    (otherwise the worker-side tracker reaps them at worker exit while the
    parent may still be reading).  A segment's name starts with its
    pool's prefix, so that the pool can reclaim the segments of a batch
    whose message a dying worker never sent.
    """
    metas = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        shm = shared_memory.SharedMemory(
            create=True, size=max(a.nbytes, 1),
            name=next(_shm_names) if _shm_names is not None else None)
        dst = np.ndarray(a.shape, a.dtype, buffer=shm.buf)
        dst[...] = a
        metas.append((shm.name, a.shape, a.dtype.str))
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
        shm.close()
    return metas


class _ShmBatch:
    """Parent-side view of a shm-transported batch; unlink on release."""

    def __init__(self, metas):
        self.segments = []
        self.arrays = []
        for name, shape, dtype in metas:
            shm = shared_memory.SharedMemory(name=name)
            self.segments.append(shm)
            self.arrays.append(np.ndarray(shape, np.dtype(dtype),
                                          buffer=shm.buf))

    def release(self):
        for shm in self.segments:
            try:
                shm.close()
                shm.unlink()
            except Exception:
                pass
        self.segments = []

    @staticmethod
    def unlink_prefixed(prefix):
        """Reclaim every segment left under ``prefix`` (a pool's, once
        its workers are gone)."""
        if os.path.isdir("/dev/shm"):
            _ShmBatch.unlink_unseen([(n, None, None)
                                     for n in os.listdir("/dev/shm")
                                     if n.startswith(prefix)])

    @staticmethod
    def unlink_unseen(metas):
        """Reclaim segments the parent will never map (shutdown path)."""
        for name, _, _ in metas:
            try:
                shm = shared_memory.SharedMemory(name=name)
                shm.close()
                shm.unlink()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# worker loops

def _init_worker(dataset, worker_id, num_workers, worker_init_fn, seed,
                 shm_prefix):
    global _worker_info, _shm_names
    _worker_info = WorkerInfo(worker_id, num_workers, seed, dataset)
    _shm_names = (f"{shm_prefix}{worker_id}_{n}" for n in itertools.count())
    np.random.seed((seed + worker_id) % (2 ** 31))
    # a forked child cannot initialise CUDA: the tensor layer creates on
    # the CPU here, and torch keeps to one thread beside its siblings
    import torch
    from ..core import device as core_device
    core_device.set_device("cpu")
    torch.set_num_threads(1)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)


def _map_worker_loop(dataset, index_q, result_q, collate_fn,
                     use_shared_memory, worker_id, num_workers,
                     worker_init_fn, seed, shm_prefix):
    """Map-style dataset: consume (gen, seq, indices), emit batches."""
    try:
        _init_worker(dataset, worker_id, num_workers, worker_init_fn, seed,
                     shm_prefix)
    except Exception as e:
        result_q.put((None, None, _ExceptionWrapper(e), False))
        return
    while True:
        job = index_q.get()
        if job is None:
            return
        gen, seq, indices = job
        try:
            data = collate_fn([dataset[i] for i in indices])
            spec_arrays = []
            spec = _flatten(data, spec_arrays)
            if use_shared_memory:
                payload = (spec, _arrays_to_shm(spec_arrays))
                result_q.put((gen, seq, payload, True))
            else:
                result_q.put((gen, seq, (spec, spec_arrays), False))
        except Exception as e:
            result_q.put((gen, seq, _ExceptionWrapper(e), False))


def _iterable_worker_loop(dataset, result_q, collate_fn, use_shared_memory,
                          batch_size, drop_last, worker_id, num_workers,
                          worker_init_fn, seed, shm_prefix):
    """IterableDataset: each worker iterates its own copy; samples are
    sharded by the user via get_worker_info() (reference behavior)."""
    try:
        _init_worker(dataset, worker_id, num_workers, worker_init_fn, seed,
                     shm_prefix)
        batch = []
        for sample in dataset:
            batch.append(sample)
            if len(batch) == batch_size:
                _emit_iterable(result_q, collate_fn(batch),
                               use_shared_memory)
                batch = []
        if batch and not drop_last:
            _emit_iterable(result_q, collate_fn(batch), use_shared_memory)
    except Exception as e:
        result_q.put((worker_id, None, _ExceptionWrapper(e), False))
    finally:
        result_q.put((worker_id, None, None, False))  # done marker


def _emit_iterable(result_q, data, use_shared_memory):
    spec_arrays = []
    spec = _flatten(data, spec_arrays)
    if use_shared_memory:
        result_q.put((0, -1, (spec, _arrays_to_shm(spec_arrays)), True))
    else:
        result_q.put((0, -1, (spec, spec_arrays), False))


# ---------------------------------------------------------------------------
# parent-side pool

def _mp_context():
    # fork: workers inherit the dataset for free and start in ~ms.  Safe
    # because workers never touch the card (_init_worker); glibc makes
    # malloc fork-safe.
    try:
        return mp.get_context("fork")
    except ValueError:  # pragma: no cover - non-posix
        return mp.get_context("spawn")


class WorkerPool:
    """A set of worker processes + queues, reusable across epochs when
    ``persistent_workers`` (generation tags drop stale results)."""

    def __init__(self, loader):
        self.loader = loader
        self.ctx = _mp_context()
        self.index_q = self.ctx.Queue()
        self.result_q = self.ctx.Queue()
        self.procs = []
        self.gen = 0
        self._closed = False
        self.busy = False  # an iterator is actively consuming this pool
        self.shm_prefix = _shm_prefix()
        ds = loader.dataset
        for wid in range(loader.num_workers):
            p = self.ctx.Process(
                target=_map_worker_loop,
                args=(ds, self.index_q, self.result_q, loader.collate_fn,
                      loader.use_shared_memory, wid, loader.num_workers,
                      loader.worker_init_fn, _base_seed(), self.shm_prefix),
                daemon=True)
            p.start()
            self.procs.append(p)

    def next_generation(self):
        self.gen += 1
        return self.gen

    def close(self):
        if self._closed:
            return
        self._closed = True
        for _ in self.procs:
            try:
                self.index_q.put(None)
            except Exception:
                pass
        for p in self.procs:
            p.join(timeout=2.0)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        # reclaim any shm the workers shipped but nobody mapped
        try:
            while True:
                _, _, payload, is_shm = self.result_q.get_nowait()
                if is_shm and payload is not None and \
                        not isinstance(payload, _ExceptionWrapper):
                    _ShmBatch.unlink_unseen(payload[1])
        except Exception:
            pass
        # and what a worker wrote but never announced (it died first)
        _ShmBatch.unlink_prefixed(self.shm_prefix)
        for q in (self.index_q, self.result_q):
            try:
                q.close()
            except Exception:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_pool_seq = itertools.count()
_prefix_seq = itertools.count()


def _shm_prefix():
    """A prefix for one pool's segment names, unique on the host."""
    return f"ptq{os.getpid()}x{next(_prefix_seq)}_"


def _base_seed():
    """Distinct per pool instance: a fresh (non-persistent) pool per
    epoch must NOT replay the previous epoch's augmentation randomness
    (the classic identical-worker-seed bug); deterministic under
    paddle.seed because the counter ticks deterministically."""
    from ..core import rng as rng_mod
    try:
        base = int(rng_mod.get_seed())
    except Exception:
        base = 0
    return base + 7919 * next(_pool_seq)


class MultiprocessMapIter:
    """Ordered iterator over a map-style dataset through a WorkerPool.

    Keeps at most ``prefetch_factor * num_workers`` batches submitted
    ahead of the consumer; results go through the native ordered queue,
    which hands them out in sequence order, so the stream is
    deterministic.
    """

    def __init__(self, loader, batches, pool):
        from ..csrc import NativeOrderedQueue
        self.loader = loader
        self.pool = pool
        pool.busy = True
        self.gen = pool.next_generation()
        self.batches = batches
        self.total = len(batches)
        self.next_submit = 0
        self.next_emit = 0
        self.max_inflight = max(
            2, loader.prefetch_factor * loader.num_workers)
        self.order = NativeOrderedQueue(self.max_inflight + 1)
        self._held = {}      # seq -> shm metas of a batch in the queue
        self.timeout = loader.timeout or None
        from .. import monitor
        self._batch_counter = monitor.counter(
            "io.batches", "batches consumed from worker pools")
        self._top_up()

    def _top_up(self):
        while self.next_submit < self.total and \
                self.next_submit - self.next_emit < self.max_inflight:
            self.pool.index_q.put(
                (self.gen, self.next_submit,
                 self.batches[self.next_submit]))
            self.next_submit += 1

    def __iter__(self):
        return self

    def _receive(self):
        """Move one of this generation's results from the workers into
        the ordered queue (raising a worker's exception, or when a worker
        died or the loader's timeout passed)."""
        waited = 0.0
        while True:
            # poll in short slices so a crashed worker (OOM-kill,
            # segfault) raises instead of hanging result_q.get forever
            slice_t = min(self.timeout, POLL_S) if self.timeout \
                else POLL_S
            try:
                gen, seq, payload, is_shm = self.pool.result_q.get(
                    timeout=slice_t)
            except queue_mod.Empty:
                waited += slice_t
                alive = sum(p.is_alive() for p in self.pool.procs)
                if alive < len(self.pool.procs):
                    raise RuntimeError(
                        f"DataLoader worker died (alive {alive}/"
                        f"{len(self.pool.procs)}) while waiting for batch "
                        f"{self.next_emit} — check for OOM kills or "
                        "exceptions in the dataset __getitem__")
                if self.timeout and waited >= self.timeout:
                    raise RuntimeError(
                        f"DataLoader timed out after {waited:.0f}s "
                        f"waiting for batch {self.next_emit}")
                continue
            if isinstance(payload, _ExceptionWrapper):
                # gen=None: worker init failure (always fatal); otherwise
                # only this generation's exceptions propagate — a stale
                # failure from an abandoned epoch must not kill this one
                if gen is None or gen == self.gen:
                    payload.reraise()
                continue
            if gen != self.gen:  # stale result from an abandoned epoch
                if is_shm:
                    _ShmBatch.unlink_unseen(payload[1])
                continue
            if is_shm:
                self._held[seq] = payload[1]
            self.order.put(seq, (payload, is_shm))
            return

    def __next__(self):
        if self.next_emit >= self.total:
            raise StopIteration
        while True:
            try:
                _, (payload, is_shm) = self.order.get(0)
                break
            except TimeoutError:
                self._receive()
        self.next_emit += 1
        self._held.pop(self.next_emit - 1, None)
        self._top_up()
        spec, arrays = payload
        if is_shm:
            batch = _ShmBatch(arrays)
            # copy-out: the arrays outlive the segment in user hands
            data = _unflatten(spec, [np.array(a) for a in batch.arrays])
            batch.release()
        else:
            data = _unflatten(spec, arrays)
        self._batch_counter.inc()
        return data

    def __del__(self):
        # the batches still in the ordered queue own shm segments
        try:
            for metas in self._held.values():
                _ShmBatch.unlink_unseen(metas)
            self._held.clear()
        except Exception:
            pass


class MultiprocessIterableIter:
    """Unordered iterator over an IterableDataset via per-worker streams."""

    def __init__(self, loader):
        self.loader = loader
        self.ctx = _mp_context()
        self.result_q = self.ctx.Queue(
            maxsize=max(2, loader.prefetch_factor * loader.num_workers))
        self.procs = []
        self.done_ids = set()
        self.timeout = loader.timeout or None
        self.shm_prefix = _shm_prefix()
        from .. import monitor
        self._batch_counter = monitor.counter(
            "io.batches", "batches consumed from worker pools")
        for wid in range(loader.num_workers):
            p = self.ctx.Process(
                target=_iterable_worker_loop,
                args=(loader.dataset, self.result_q, loader.collate_fn,
                      loader.use_shared_memory, loader.batch_size,
                      getattr(loader, "drop_last", False), wid,
                      loader.num_workers, loader.worker_init_fn,
                      _base_seed(), self.shm_prefix),
                daemon=True)
            p.start()
            self.procs.append(p)

    def __iter__(self):
        return self

    def __next__(self):
        waited = 0.0
        while True:
            if len(self.done_ids) >= len(self.procs):
                self._shutdown()
                raise StopIteration
            slice_t = min(self.timeout, POLL_S) if self.timeout \
                else POLL_S
            try:
                wid, _, payload, is_shm = self.result_q.get(
                    timeout=slice_t)
            except queue_mod.Empty:
                waited += slice_t
                # a SIGKILLed worker never sends its done marker: only
                # workers that are dead AND never finished count as lost
                # (a normally-exited worker is both dead and done)
                lost = [w for w, p in enumerate(self.procs)
                        if not p.is_alive() and w not in self.done_ids]
                if lost and self.result_q.empty():
                    self._shutdown()
                    raise RuntimeError(
                        f"DataLoader (iterable) worker(s) {lost} died "
                        "before finishing their stream")
                if self.timeout and waited >= self.timeout:
                    self._shutdown()
                    raise RuntimeError(
                        "DataLoader (iterable) timed out waiting for "
                        "workers")
                continue
            if payload is None:
                self.done_ids.add(wid)
                continue
            if isinstance(payload, _ExceptionWrapper):
                self._shutdown()
                payload.reraise()
            spec, arrays = payload
            if is_shm:
                batch = _ShmBatch(arrays)
                data = _unflatten(spec,
                                  [np.array(a) for a in batch.arrays])
                batch.release()
            else:
                data = _unflatten(spec, arrays)
            self._batch_counter.inc()
            return data

    def _shutdown(self):
        for p in self.procs:
            p.join(timeout=2.0)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        _ShmBatch.unlink_prefixed(self.shm_prefix)

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass
