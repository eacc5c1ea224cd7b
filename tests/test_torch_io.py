"""The port's ``io`` (datasets, samplers, ``DataLoader``, ``DataFeeder``)
held to the JAX package's on the CPU: ``test_io_amp_jit.py``'s
``TestDataLoader`` and ``TestShuffleDeterminism`` cases through the port,
and the same seeded loaders through both packages, batch for batch
byte-equal (the samplers draw from ``RandomState(get_seed() + ...)`` in
both, and ``paddle.seed`` sets the same integer)."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch import io
from paddle_tpu_torch.core import device as core_device

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


def _seed(s):
    J.seed(s)
    P.seed(s)


def _numpy(batch):
    if isinstance(batch, (list, tuple)):
        return [_numpy(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _numpy(v) for k, v in batch.items()}
    return np.asarray(batch.numpy())


def _byte_equal(a, b):
    """``a`` (the port's) equals ``b`` byte for byte; the JAX package's
    handles hold int64 batches as int32 (x64 off), widened here."""
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _byte_equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _byte_equal(a[k], b[k])
    else:
        if a.dtype == np.int64 and b.dtype == np.int32:
            b = b.astype(np.int64)
        assert a.shape == b.shape and a.dtype == b.dtype, (a, b)
        assert a.tobytes() == b.tobytes()


class DS:
    """The same map-style dataset for both packages (duck-typed)."""

    def __init__(self, n=23):
        self.n = n

    def __getitem__(self, i):
        return (np.full((3,), i, np.float32) * 0.5, np.int64(i % 4))

    def __len__(self):
        return self.n


# -- test_io_amp_jit.py TestDataLoader --------------------------------------

class TestDataLoader:
    def test_basic_batching(self):
        class D(io.Dataset):
            def __getitem__(self, i):
                return np.full((3,), i, np.float32), np.int64(i % 2)

            def __len__(self):
                return 10

        batches = list(io.DataLoader(D(), batch_size=4))
        assert len(batches) == 3
        x, y = batches[0]
        assert x.shape == [4, 3]
        assert y.shape == [4]
        assert batches[-1][0].shape == [2, 3]
        assert isinstance(x, P.Tensor) and x.place.is_cpu_place()

    def test_drop_last_and_shuffle(self):
        class D(io.Dataset):
            def __getitem__(self, i):
                return np.float32(i)

            def __len__(self):
                return 10

        batches = list(io.DataLoader(D(), batch_size=4, drop_last=True,
                                     shuffle=True))
        assert len(batches) == 2
        vals = np.concatenate([b.numpy() for b in batches])
        assert len(set(vals.tolist())) == 8

    def test_num_workers_prefetch(self):
        class D(io.Dataset):
            def __getitem__(self, i):
                return np.full((2,), i, np.float32)

            def __len__(self):
                return 20

        batches = list(io.DataLoader(D(), batch_size=5, num_workers=2,
                                     timeout=60))
        assert len(batches) == 4
        np.testing.assert_array_equal(batches[0].numpy()[:, 0],
                                      [0, 1, 2, 3, 4])

    def test_tensor_dataset_and_random_split(self):
        xs = np.arange(20, dtype=np.float32).reshape(10, 2)
        ds = io.TensorDataset([xs, np.arange(10)])
        a, b = io.random_split(ds, [7, 3])
        assert len(a) == 7 and len(b) == 3
        ds2 = io.TensorDataset([P.to_tensor(xs), torch.arange(10)])
        np.testing.assert_array_equal(ds2[3][0], xs[3])
        assert int(ds2[3][1]) == 3

    def test_batch_sampler(self):
        bs = io.BatchSampler(dataset=list(range(10)), batch_size=3,
                             drop_last=False)
        assert len(bs) == 4

    def test_distributed_batch_sampler_partitions(self):
        s0 = io.DistributedBatchSampler(DS(8), batch_size=2,
                                        num_replicas=2, rank=0)
        s1 = io.DistributedBatchSampler(DS(8), batch_size=2,
                                        num_replicas=2, rank=1)
        i0 = [i for b in s0 for i in b]
        i1 = [i for b in s1 for i in b]
        assert sorted(i0 + i1) == list(range(8))

    def test_iterable_dataset(self):
        class IDS(io.IterableDataset):
            def __iter__(self):
                for i in range(7):
                    yield np.float32(i)

        assert len(list(io.DataLoader(IDS(), batch_size=3))) == 3

    def test_host_batches_stay_numpy(self):
        loader = io.DataLoader(DS(10), batch_size=4)
        for x, y in loader.host_batches():
            assert isinstance(x, np.ndarray) and isinstance(y, np.ndarray)


# -- test_io_amp_jit.py TestShuffleDeterminism --------------------------------

class TestShuffleDeterminism:
    def test_random_sampler_deterministic_across_runs(self):
        def orders():
            P.seed(99)
            s = io.RandomSampler(list(range(32)))
            return list(iter(s)), list(iter(s))

        a1, a2 = orders()
        b1, b2 = orders()
        assert a1 == b1 and a2 == b2
        assert a1 != a2

    def test_dataloader_shuffle_deterministic(self):
        def first_batch():
            P.seed(5)
            loader = io.DataLoader(DS(16), batch_size=4, shuffle=True)
            return next(iter(loader))[0].numpy().tolist()

        assert first_batch() == first_batch()


# -- the same seed, the same batches in both packages ------------------------

def _both(make_loader, epochs=2):
    """``make_loader(io module)`` in each package after the same seed;
    every batch of ``epochs`` epochs as numpy."""
    out = []
    for pkg in (J, P):
        _seed(7)
        loader = make_loader(pkg.io)
        out.append([_numpy(b) for _ in range(epochs) for b in loader])
    return out


@pytest.mark.parametrize("kind", [
    "sequential", "shuffle", "shuffle_drop_last", "workers", "weighted",
    "replacement", "distributed_shuffle", "dict_batches", "iterable",
    "subset_concat", "compose_chain"])
def test_batches_byte_equal_to_jax(kind):
    def make(m):
        if kind == "sequential":
            return m.DataLoader(DS(), batch_size=5)
        if kind == "shuffle":
            return m.DataLoader(DS(), batch_size=5, shuffle=True)
        if kind == "shuffle_drop_last":
            return m.DataLoader(DS(), batch_size=4, shuffle=True,
                                drop_last=True)
        if kind == "workers":
            return m.DataLoader(DS(), batch_size=5, shuffle=True,
                                num_workers=2, timeout=60)
        if kind == "weighted":
            s = m.WeightedRandomSampler(np.arange(1, 24), 17)
            return m.DataLoader(DS(), batch_sampler=m.BatchSampler(
                sampler=s, batch_size=4))
        if kind == "replacement":
            s = m.RandomSampler(DS(), replacement=True, num_samples=11)
            return m.DataLoader(DS(), batch_sampler=m.BatchSampler(
                sampler=s, batch_size=3))
        if kind == "distributed_shuffle":
            s = m.DistributedBatchSampler(DS(), batch_size=3,
                                          num_replicas=3, rank=1,
                                          shuffle=True)
            return m.DataLoader(DS(), batch_sampler=s)
        if kind == "dict_batches":
            class D(m.Dataset):
                def __getitem__(self, i):
                    return {"x": np.full((2,), i, np.float32),
                            "meta": {"idx": np.asarray(i, np.int64)}}

                def __len__(self):
                    return 9
            return m.DataLoader(D(), batch_size=4, shuffle=True)
        if kind == "iterable":
            class I(m.IterableDataset):
                def __iter__(self):
                    for i in range(10):
                        yield np.float32(i), np.int64(i)
            return m.DataLoader(I(), batch_size=4)
        if kind == "subset_concat":
            parts = m.random_split(DS(), [13, 10])
            return m.DataLoader(m.ConcatDataset(parts), batch_size=6)
        if kind == "compose_chain":
            return m.DataLoader(m.ComposeDataset([DS(), DS()]),
                                batch_size=7)
        raise AssertionError(kind)

    j, p = _both(make)
    _byte_equal(p, j)


def test_distributed_batch_sampler_set_epoch_matches_jax():
    orders = []
    for pkg in (J, P):
        _seed(3)
        s = pkg.io.DistributedBatchSampler(DS(), batch_size=4,
                                           num_replicas=2, rank=0,
                                           shuffle=True)
        got = []
        for epoch in range(3):
            s.set_epoch(epoch)
            got.append(list(s))
        orders.append(got)
    assert orders[0] == orders[1]
    assert orders[1][0] != orders[1][1]


def test_default_collate_matches_jax():
    samples = [(np.float32(i), i, float(i), np.arange(3) * i,
                {"a": np.int64(i)}) for i in range(4)]
    _byte_equal(_numpy_tree(P.io.default_collate_fn(samples)),
                _numpy_tree(J.io.default_collate_fn(samples)))
    handles = [P.to_tensor(np.arange(2, dtype=np.float32) + i)
               for i in range(3)]
    np.testing.assert_array_equal(P.io.default_collate_fn(handles),
                                  np.stack([h.numpy() for h in handles]))


def _numpy_tree(x):
    if isinstance(x, (list, tuple)):
        return [_numpy_tree(v) for v in x]
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    return np.asarray(x)


def test_data_feeder_matches_jax():
    rows = [(np.arange(3, dtype=np.float32) + i, np.int64(i))
            for i in range(5)]
    got = P.io.DataFeeder(["x", "y"]).feed(rows)
    want = J.io.DataFeeder(["x", "y"]).feed(rows)
    _byte_equal(_numpy_tree(got), _numpy_tree(want))
    with pytest.raises(ValueError, match="fields"):
        P.io.DataFeeder(["x"]).feed(rows)


def test_thread_workers_use_the_native_queue(monkeypatch):
    from paddle_tpu_torch import csrc
    from paddle_tpu_torch.io import _PrefetchIter
    monkeypatch.setenv("PADDLE_TPU_THREAD_WORKERS", "1")
    loader = io.DataLoader(DS(), batch_size=4, shuffle=True,
                           num_workers=3, timeout=60)
    P.seed(1)
    it = iter(loader)
    assert isinstance(it, _PrefetchIter)
    assert isinstance(it._native, csrc.NativeOrderedQueue)
    threaded = [_numpy(b) for b in it]
    P.seed(1)
    plain = [_numpy(b) for b in io.DataLoader(DS(), batch_size=4,
                                               shuffle=True)]
    _byte_equal(threaded, plain)


def test_thread_worker_exception_propagates(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_THREAD_WORKERS", "1")

    class Bad(io.Dataset):
        def __getitem__(self, i):
            if i == 5:
                raise ValueError("thread boom")
            return np.float32(i)

        def __len__(self):
            return 12

    with pytest.raises(ValueError, match="thread boom"):
        list(io.DataLoader(Bad(), batch_size=2, num_workers=2,
                           timeout=60))
