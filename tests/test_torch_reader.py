"""The port's ``reader`` combinators and ``batch`` held to the JAX
package's: ``test_reader.py``'s cases through the port (the reference's
``python/paddle/reader/decorator.py``), and the same readers through both
packages giving the same items in the same order (``shuffle`` after the
same ``random.seed``)."""
import random

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as paddle
from paddle_tpu_torch import reader


def _r(n=10):
    def rd():
        return iter(range(n))
    return rd


def test_cache_and_firstn():
    calls = []

    def rd():
        calls.append(1)
        return iter(range(5))

    c = reader.cache(rd)
    assert list(c()) == list(range(5))
    assert list(c()) == list(range(5))
    assert len(calls) == 1
    assert list(reader.firstn(_r(), 3)()) == [0, 1, 2]


def test_map_chain_compose():
    assert list(reader.map_readers(lambda a, b: a + b, _r(3), _r(3))()) \
        == [0, 2, 4]
    assert list(reader.chain(_r(2), _r(2))()) == [0, 1, 0, 1]
    out = list(reader.compose(_r(2), _r(2))())
    assert out == [(0, 0), (1, 1)]
    with pytest.raises(reader.ComposeNotAligned):
        list(reader.compose(_r(2), _r(3))())
    # misaligned OK when check_alignment=False
    assert list(reader.compose(_r(2), _r(3),
                               check_alignment=False)()) == [(0, 0),
                                                             (1, 1)]


def test_shuffle_buffered_complete():
    random.seed(0)
    out = sorted(reader.shuffle(_r(20), 7)())
    assert out == list(range(20))
    assert sorted(reader.buffered(_r(20), 4)()) == list(range(20))


def test_xmap_ordered_and_unordered():
    sq = reader.xmap_readers(lambda x: x * x, _r(16), 4, 8, order=True)
    assert list(sq()) == [i * i for i in range(16)]
    sq2 = reader.xmap_readers(lambda x: x * x, _r(16), 4, 8, order=False)
    assert sorted(sq2()) == sorted(i * i for i in range(16))


def test_multiprocess_reader_merges():
    out = sorted(reader.multiprocess_reader([_r(5), _r(5)])())
    assert out == sorted(list(range(5)) * 2)


def test_batch_with_reader_pipeline():
    batched = paddle.batch(reader.shuffle(_r(10), 10), batch_size=4)
    sizes = [len(b) for b in batched()]
    assert sizes == [4, 4, 2]


def test_worker_exceptions_propagate():
    def bad():
        yield 1
        raise ValueError("reader boom")

    with pytest.raises(ValueError, match="reader boom"):
        list(reader.buffered(bad, 4)())
    with pytest.raises(ValueError, match="reader boom"):
        list(reader.multiprocess_reader([bad])())

    def bad_mapper(x):
        if x == 5:
            raise ValueError("mapper boom")
        return x

    with pytest.raises(ValueError, match="mapper boom"):
        list(reader.xmap_readers(bad_mapper, _r(10), 2, 4, order=True)())
    with pytest.raises(ValueError, match="mapper boom"):
        list(reader.xmap_readers(bad_mapper, _r(10), 2, 4,
                                 order=False)())


def _items(r):
    return [np.asarray(x).tolist() for x in r()]


@pytest.mark.parametrize("kind", ["shuffle", "batch", "compose", "chain",
                                  "map", "firstn", "xmap_ordered",
                                  "cache"])
def test_same_items_as_jax(kind):
    def make(pkg):
        rd = pkg.reader
        if kind == "shuffle":
            return rd.shuffle(_r(25), 6)
        if kind == "batch":
            return pkg.batch(rd.shuffle(_r(11), 11), batch_size=4,
                             drop_last=True)
        if kind == "compose":
            return rd.compose(_r(4), rd.map_readers(lambda a: (a, -a),
                                                    _r(4)))
        if kind == "chain":
            return rd.chain(_r(3), rd.firstn(_r(9), 2))
        if kind == "map":
            return rd.map_readers(lambda a, b: a * b, _r(5), _r(5))
        if kind == "firstn":
            return rd.firstn(rd.buffered(_r(30), 3), 7)
        if kind == "xmap_ordered":
            return rd.xmap_readers(lambda x: x + 1, _r(12), 3, 4,
                                   order=True)
        if kind == "cache":
            return rd.cache(_r(6))
        raise AssertionError(kind)

    random.seed(4)
    want = _items(make(J))
    random.seed(4)
    got = _items(make(paddle))
    assert got == want


def test_batch_rejects_nonpositive_size():
    with pytest.raises(ValueError, match="positive"):
        paddle.batch(_r(3), 0)
