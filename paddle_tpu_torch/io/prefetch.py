"""Device prefetch — counterpart of ``paddle_tpu/io/prefetch.py``, the
reference's double-buffered reader (``paddle/fluid/operators/reader/
buffered_reader.cc``: asynchronous host-to-device copies on a stream of
their own, a buffer ahead of compute).

On the card an upload overlaps the step only from page-locked memory and
on another stream than the step's.  ``DeviceLoader`` therefore copies
each host batch once into pinned host buffers (reused: a few per batch
shape and dtype, each taken again only once its last upload finished),
uploads them with ``non_blocking=True`` on a dedicated
``torch.cuda.Stream`` and records an event there.  When a batch is
handed out, the consumer's stream waits on its event and each tensor
gets ``record_stream`` for that stream, so ``buffer_size`` uploads are
in flight while the step computes.  On the CPU the batch is wrapped as
it is.

The loader it wraps is a ``DataLoader`` (its ``host_batches()``: the
numpy batches, never uploaded by the loader itself) or any iterable of
numpy arrays, torch tensors or handles, nested in lists, tuples and
dicts.  ``sharding_fn(shape)`` names the device of each array (a torch
device, a device string, or None for the current place); over a port mesh a
``TrainStep`` takes its inputs on its first device (``step.device``).
``wrap`` is the reference's option (``paddle_tpu/io/prefetch.py``):
``True`` yields ``Tensor`` handles, ``False`` the torch tensors.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core import device as core_device


class _PinnedPool:
    """Pinned host buffers by (shape, dtype), each reused once the upload
    that read it last has finished.  A slot is ``[buffer, event of its
    last upload, upload number]``."""

    def __init__(self, per_key):
        self.per_key = per_key
        self.bufs = {}

    def take(self, shape, dtype):
        slots = self.bufs.setdefault((tuple(shape), dtype), [])
        for slot in slots:
            if slot[1] is None or slot[1].query():
                return slot
        if len(slots) < self.per_key:
            slot = [torch.empty(shape, dtype=dtype, pin_memory=True), None,
                    0]
            slots.append(slot)
            return slot
        slot = min(slots, key=lambda s: s[2])
        slot[1].synchronize()
        return slot


class DeviceLoader:
    """Wrap a host-batch iterable; keep ``buffer_size`` batches en route
    to the device so the uploads overlap compute."""

    def __init__(self, loader, buffer_size=2, sharding_fn=None, wrap=True):
        self.loader = loader
        self.buffer_size = max(1, int(buffer_size))
        self.sharding_fn = sharding_fn
        self.wrap = wrap
        self._stream = None
        self._pool = _PinnedPool(self.buffer_size + 2)
        self._tick = 0

    def __len__(self):
        return len(self.loader)

    # DataLoader surface passthroughs used by Model.fit
    @property
    def batch_sampler(self):
        return getattr(self.loader, "batch_sampler", None)

    def _target(self, shape):
        dst = self.sharding_fn(shape) if self.sharding_fn else None
        return core_device.torch_device() if dst is None \
            else torch.device(dst)

    def _put(self, data, events):
        if isinstance(data, Tensor):
            data = data._data
        if isinstance(data, (np.ndarray, np.generic)):
            data = torch.as_tensor(np.asarray(data, order="C"))
        if isinstance(data, torch.Tensor):
            dev = self._target(tuple(data.shape))
            if dev.type != "cuda" or data.device.type == "cuda":
                return data.to(dev)
            return self._upload(data, dev, events)
        if isinstance(data, (list, tuple)):
            out = [self._put(d, events) for d in data]
            return out if isinstance(data, list) else tuple(out)
        if isinstance(data, dict):
            return {k: self._put(v, events) for k, v in data.items()}
        return data

    def _upload(self, host, dev, events):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        slot = self._pool.take(host.shape, host.dtype)
        slot[0].copy_(host)
        with torch.cuda.stream(self._stream):
            out = slot[0].to(dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._tick += 1
        slot[1:] = [ev, self._tick]
        events.append(ev)
        return out

    def _hand_out(self, data, events):
        if events:
            stream = torch.cuda.current_stream()
            for ev in events:
                stream.wait_event(ev)
            _record(data, stream)
        return _tree_wrap(data) if self.wrap else data

    def __iter__(self):
        src = self.loader
        it = iter(src.host_batches() if hasattr(src, "host_batches")
                  else src)
        buf = deque()

        def pump():
            while len(buf) < self.buffer_size:
                try:
                    host = next(it)
                except StopIteration:
                    return
                events = []
                buf.append((self._put(host, events), events))

        pump()
        while buf:
            out, events = buf.popleft()
            pump()  # start the next upload before compute consumes out
            yield self._hand_out(out, events)


def _record(data, stream):
    if isinstance(data, torch.Tensor):
        if data.device.type == "cuda":
            data.record_stream(stream)
    elif isinstance(data, (list, tuple)):
        for d in data:
            _record(d, stream)
    elif isinstance(data, dict):
        for d in data.values():
            _record(d, stream)


def _tree_wrap(data):
    if isinstance(data, torch.Tensor):
        return Tensor._wrap(data)
    if isinstance(data, (list, tuple)):
        t = [_tree_wrap(d) for d in data]
        return t if isinstance(data, list) else tuple(t)
    if isinstance(data, dict):
        return {k: _tree_wrap(v) for k, v in data.items()}
    return data
