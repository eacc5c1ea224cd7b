"""paddle.reader — generator-composition utilities for 1.x data code;
counterpart of ``paddle_tpu/reader/__init__.py``, pure Python.

Reference parity: ``python/paddle/reader/decorator.py`` (cache,
map_readers, shuffle, chain, compose, buffered, firstn, xmap_readers,
multiprocess_reader).  These are pure-Python reader combinators; the
modern path is ``paddle.io.DataLoader`` (process workers + device
prefetch), but 1.x scripts compose readers with these decorators and
feed them through ``paddle.batch`` / ``DataFeeder``.
"""
from __future__ import annotations

import itertools
import queue as queue_mod
import random
import threading

__all__ = [
    "cache", "map_readers", "buffered", "compose", "chain", "shuffle",
    "firstn", "xmap_readers", "multiprocess_reader",
]


def cache(reader):
    """Cache the wrapped reader's full output in memory on first read."""
    all_data = tuple(reader())

    def cached_reader():
        return iter(all_data)

    return cached_reader


def map_readers(func, *readers):
    """Yield func(*items) over readers zipped together."""

    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return reader


def shuffle(reader, buf_size):
    """Buffered shuffle: fill ``buf_size`` samples, emit shuffled."""

    def shuffled_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            random.shuffle(buf)
            yield from buf

    return shuffled_reader


def chain(*readers):
    """Concatenate readers back to back."""

    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers, **kwargs):
    """Zip readers into flattened tuples; check_alignment (default True)
    raises if they end at different lengths (reference ComposeNotAligned)."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for items in zip(*rs):
                yield sum((make_tuple(i) for i in items), ())
            return
        for items in itertools.zip_longest(*rs):
            if any(i is None for i in items):
                raise ComposeNotAligned(
                    "outputs of readers are not aligned")
            yield sum((make_tuple(i) for i in items), ())

    return reader


class ComposeNotAligned(ValueError):
    pass


def buffered(reader, size):
    """Read ahead up to ``size`` items on a daemon thread."""

    class _End:
        pass

    class _Err:
        def __init__(self, e):
            self.e = e

    def buffered_reader():
        q = queue_mod.Queue(maxsize=size)

        def fill():
            try:
                for item in reader():
                    q.put(item)
            except Exception as e:  # surface in the consumer, not the
                q.put(_Err(e))      # daemon thread (silent truncation)
                return
            q.put(_End)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _End:
                return
            if isinstance(item, _Err):
                raise item.e
            yield item

    return buffered_reader


def firstn(reader, n):
    """Only the first ``n`` items."""

    def firstn_reader():
        return itertools.islice(reader(), n)

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with ``process_num`` worker THREADS
    (the reference also uses threads here despite the name), optionally
    order-preserving."""

    def xreader():
        in_q = queue_mod.Queue(buffer_size)
        out_q = queue_mod.Queue(buffer_size)
        END = object()

        ERR = []

        def feed():
            try:
                for i, item in enumerate(reader()):
                    in_q.put((i, item))
            except Exception as e:
                ERR.append(e)
            for _ in range(process_num):
                in_q.put(END)

        def work():
            while True:
                job = in_q.get()
                if job is END:
                    out_q.put(END)
                    return
                i, item = job
                try:
                    out_q.put((i, mapper(item)))
                except Exception as e:
                    ERR.append(e)
                    out_q.put(END)
                    return

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()
        finished = 0
        if not order:
            while finished < process_num:
                res = out_q.get()
                if res is END:
                    finished += 1
                    continue
                yield res[1]
            if ERR:
                raise ERR[0]
            return
        pending = {}
        next_i = 0
        # drain until every worker ENDed — never block on results a dead
        # worker can no longer produce
        while finished < process_num:
            res = out_q.get()
            if res is END:
                finished += 1
                continue
            pending[res[0]] = res[1]
            while next_i in pending:
                yield pending.pop(next_i)
                next_i += 1
        while next_i in pending:
            yield pending.pop(next_i)
            next_i += 1
        if ERR:
            raise ERR[0]

    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave several readers concurrently (thread-backed here: the
    payloads are numpy batches that the GIL releases on copy; the modern
    process path is paddle.io.DataLoader's worker pool)."""

    def merged_reader():
        q = queue_mod.Queue(queue_size)
        END = object()

        errors = []

        def pump(r):
            try:
                for item in r():
                    q.put(item)
            except Exception as e:
                errors.append(e)
            q.put(END)

        for r in readers:
            threading.Thread(target=pump, args=(r,), daemon=True).start()
        finished = 0
        while finished < len(readers):
            item = q.get()
            if item is END:
                finished += 1
                continue
            yield item
        if errors:
            raise errors[0]

    return merged_reader
