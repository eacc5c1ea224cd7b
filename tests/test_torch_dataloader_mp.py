"""The port's process workers (``io/worker.py``) and device prefetch
(``io/prefetch.py``) held to the JAX package's: ``test_dataloader_mp.py``'s
cases through the port (its ``slow`` ones too, with the result queue
polled every 0.5 s instead of 5 s, ``worker.POLL_S``), a dataset that
makes tensor-layer handles in its workers, and batches byte-equal to the
JAX package's loader with workers.  The ``cuda`` case uploads through
pinned memory on the card and skips here; the file imports jax only
inside its JAX case, so the card runs it with ``pytest --noconftest
-m cuda``."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import io
from paddle_tpu_torch.core import device as core_device
from paddle_tpu_torch.io import worker as worker_mod

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The CPU place, a 0.5 s poll slice, and a 60 s limit on every wait
    for a batch (a hung worker fails the test instead of hanging it)."""
    prev = core_device._current
    paddle.set_device("cpu")
    monkeypatch.setattr(worker_mod, "POLL_S", 0.5)
    init = io.DataLoader.__init__

    def with_timeout(self, *args, timeout=60, **kwargs):
        init(self, *args, timeout=timeout, **kwargs)

    monkeypatch.setattr(io.DataLoader, "__init__", with_timeout)
    yield
    core_device._current = prev


class SquareDataset(io.Dataset):
    def __init__(self, n=64):
        self.n = n

    def __getitem__(self, i):
        return (np.full((3, 4), i, np.float32),
                np.asarray(i * i, np.int64))

    def __len__(self):
        return self.n


class FailingDataset(io.Dataset):
    def __getitem__(self, i):
        if i == 7:
            raise ValueError("boom at 7")
        return np.zeros((2,), np.float32)

    def __len__(self):
        return 16


class CountingIterable(io.IterableDataset):
    """Shards itself across workers via get_worker_info (reference
    worker.py WorkerInfo contract)."""

    def __init__(self, n=32):
        self.n = n

    def __iter__(self):
        info = io.get_worker_info()
        if info is None:
            ids = range(self.n)
        else:
            ids = range(info.id, self.n, info.num_workers)
        for i in ids:
            yield np.asarray([i], np.int64)


def _collect(loader):
    xs, ys = [], []
    for bx, by in loader:
        xs.append(bx.numpy())
        ys.append(by.numpy())
    return np.concatenate(xs), np.concatenate(ys)


class TestMultiprocessDataLoader:
    @pytest.mark.parametrize("use_shared_memory", [True, False])
    def test_ordered_and_complete(self, use_shared_memory):
        ds = SquareDataset(50)
        loader = io.DataLoader(ds, batch_size=8, num_workers=2,
                               use_shared_memory=use_shared_memory)
        xs, ys = _collect(loader)
        assert xs.shape == (50, 3, 4)
        np.testing.assert_array_equal(xs[:, 0, 0],
                                      np.arange(50, dtype=np.float32))
        np.testing.assert_array_equal(ys, np.arange(50) ** 2)

    def test_matches_single_process(self):
        ds = SquareDataset(33)
        a = _collect(io.DataLoader(ds, batch_size=5, num_workers=0))
        b = _collect(io.DataLoader(ds, batch_size=5, num_workers=3))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])

    def test_worker_exception_propagates(self):
        loader = io.DataLoader(FailingDataset(), batch_size=4,
                               num_workers=2)
        with pytest.raises(RuntimeError, match="boom at 7"):
            for _ in loader:
                pass

    def test_persistent_workers_two_epochs(self):
        ds = SquareDataset(24)
        loader = io.DataLoader(ds, batch_size=6, num_workers=2,
                               persistent_workers=True)
        for _ in range(2):
            xs, ys = _collect(loader)
            np.testing.assert_array_equal(
                xs[:, 0, 0], np.arange(24, dtype=np.float32))
        assert loader._pool is not None and not loader._pool._closed
        procs = loader._pool.procs
        assert all(p.is_alive() for p in procs)
        loader._pool.close()

    def test_early_break_cleans_up(self):
        ds = SquareDataset(64)
        loader = io.DataLoader(ds, batch_size=4, num_workers=2)
        it = iter(loader)
        next(it)
        next(it)
        del it  # generator finalizer must close the pool
        assert loader._pool is None or loader._pool._closed

    def test_worker_init_fn_and_info(self):
        seen = []

        class ProbeDataset(io.Dataset):
            def __getitem__(self, i):
                info = io.get_worker_info()
                assert info is not None and 0 <= info.id < 2
                return np.asarray([info.id], np.int64)

            def __len__(self):
                return 8

        loader = io.DataLoader(ProbeDataset(), batch_size=2, num_workers=2,
                               worker_init_fn=lambda wid: seen.append(wid))
        ids = np.concatenate([b.numpy() for b in loader]).ravel()
        assert set(ids.tolist()) <= {0, 1}
        # worker_init_fn ran in the workers, not here
        assert seen == []

    def test_iterable_dataset_workers_cover_all(self):
        loader = io.DataLoader(CountingIterable(32), batch_size=4,
                               num_workers=2)
        got = sorted(
            int(v) for b in loader for v in np.asarray(b.numpy()).ravel())
        assert got == list(range(32))

    def test_get_worker_info_none_in_parent(self):
        assert io.get_worker_info() is None

    def test_nested_dict_batches(self):
        class DictDataset(io.Dataset):
            def __getitem__(self, i):
                return {"x": np.full((2,), i, np.float32),
                        "meta": {"idx": np.asarray(i, np.int64)}}

            def __len__(self):
                return 10

        loader = io.DataLoader(DictDataset(), batch_size=5, num_workers=2)
        out = list(loader)
        assert len(out) == 2
        np.testing.assert_array_equal(
            np.asarray(out[0]["meta"]["idx"].numpy()), np.arange(5))


class TestDeviceLoader:
    def test_device_prefetch_values(self):
        ds = SquareDataset(20)
        loader = io.DataLoader(ds, batch_size=5, num_workers=2)
        dev = io.DeviceLoader(loader, buffer_size=2)
        xs = np.concatenate([bx.numpy() for bx, _ in dev])
        np.testing.assert_array_equal(
            xs[:, 0, 0], np.arange(20, dtype=np.float32))

    def test_device_prefetch_sharded(self):
        """``sharding_fn`` names each array's device (the port's
        devices, not JAX shardings); ``wrap=False`` gives torch
        tensors."""
        ds = SquareDataset(16)
        loader = io.DataLoader(ds, batch_size=8, num_workers=0)
        seen = []

        def sharding_fn(shape):
            seen.append(shape)
            return torch.device("cpu")

        dev = io.DeviceLoader(loader, sharding_fn=sharding_fn, wrap=False)
        batches = list(dev)
        assert all(isinstance(b[0], torch.Tensor) for b in batches)
        assert seen[:2] == [(8, 3, 4), (8,)]
        np.testing.assert_array_equal(batches[1][1].numpy(),
                                      np.arange(8, 16) ** 2)

    def test_fit_uses_prefetcher(self):
        from paddle_tpu_torch import nn
        from paddle_tpu_torch.io import TensorDataset

        x = np.random.RandomState(0).randn(32, 4).astype("float32")
        y = (x.sum(1) > 0).astype("int64")
        ds = TensorDataset([x, y])
        net = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
        model = paddle.Model(net)
        model.prepare(
            paddle.optimizer.Adam(learning_rate=1e-2,
                                  parameters=net.parameters()),
            nn.CrossEntropyLoss())
        model.fit(ds, batch_size=8, epochs=2, verbose=0, num_workers=2)


class TestReviewRegressions:
    def test_concurrent_iterators_same_loader(self):
        ds = SquareDataset(12)
        loader = io.DataLoader(ds, batch_size=4, num_workers=2,
                               persistent_workers=True)
        outer = iter(loader)
        o1 = next(outer)
        inner_vals = [bx.numpy()[:, 0, 0] for bx, _ in loader]
        rest = [bx.numpy()[:, 0, 0] for bx, _ in outer]
        got_outer = np.concatenate([o1[0].numpy()[:, 0, 0]] + rest)
        np.testing.assert_array_equal(got_outer,
                                      np.arange(12, dtype=np.float32))
        np.testing.assert_array_equal(np.concatenate(inner_vals),
                                      np.arange(12, dtype=np.float32))
        if loader._pool is not None:
            loader._pool.close()

    def test_dead_worker_raises_not_hangs(self):
        import os as _os

        class KillerDataset(io.Dataset):
            def __getitem__(self, i):
                if i == 3:
                    _os._exit(1)  # simulate OOM-kill/segfault
                return np.zeros((2,), np.float32)

            def __len__(self):
                return 16

        loader = io.DataLoader(KillerDataset(), batch_size=2,
                               num_workers=1)
        with pytest.raises(RuntimeError, match="died"):
            for _ in loader:
                pass

    def test_stale_exception_does_not_kill_next_epoch(self):
        class LateFail(io.Dataset):
            def __getitem__(self, i):
                if i == 10:
                    raise ValueError("late boom")
                return np.zeros((2,), np.float32)

            def __len__(self):
                return 12

        loader = io.DataLoader(LateFail(), batch_size=2, num_workers=2,
                               persistent_workers=True)
        it = iter(loader)
        next(it)  # batch 0; batch with idx 10 may fail in-flight
        del it    # abandon epoch, stale exception may sit in result_q
        import time
        time.sleep(0.3)
        # next epoch over only-good indices must not see the stale error
        good = io.DataLoader(
            LateFail(), batch_sampler=io.BatchSampler(
                sampler=io.SequenceSampler(list(range(8))), batch_size=2),
        )
        # reuse the SAME pool: manual generation bump over the same loader
        from paddle_tpu_torch.io.worker import MultiprocessMapIter
        batches = [[0, 1], [2, 3], [4, 5]]
        out = list(MultiprocessMapIter(loader, batches,
                                       loader._get_pool()))
        assert len(out) == 3
        loader._pool.close()

    def test_iterable_dead_worker_raises(self):
        import os as _os

        class KillerIterable(io.IterableDataset):
            def __iter__(self):
                info = io.get_worker_info()
                if info is not None and info.id == 0:
                    _os._exit(1)
                for i in range(4):
                    yield np.zeros((2,), np.float32)

        loader = io.DataLoader(KillerIterable(), batch_size=2,
                               num_workers=1)
        with pytest.raises(RuntimeError, match="died|dead"):
            for _ in loader:
                pass

    def test_fresh_pools_get_fresh_augmentation_seeds(self):
        class AugDataset(io.Dataset):
            def __getitem__(self, i):
                return np.random.rand(3).astype(np.float32)

            def __len__(self):
                return 4

        loader = io.DataLoader(AugDataset(), batch_size=4, num_workers=1)
        e1 = next(iter(loader)).numpy()
        e2 = next(iter(loader)).numpy()
        assert not np.allclose(e1, e2), "epochs replayed identical RNG"

    def test_iterable_early_finisher_not_flagged_dead(self):
        import time as _t

        class Uneven(io.IterableDataset):
            def __iter__(self):
                info = io.get_worker_info()
                if info.id == 0:
                    return iter(())  # finishes instantly
                for i in range(2):
                    _t.sleep(0.8)  # slower than the 0.5 s poll slice
                    yield np.asarray([i], np.int64)

        loader = io.DataLoader(Uneven(), batch_size=1, num_workers=2,
                               use_shared_memory=False)
        got = [int(b.numpy().ravel()[0]) for b in loader]
        assert sorted(got) == [0, 1]


class TestPoolLifecycle:
    def test_abandoned_unstarted_iterator_releases_pool(self):
        """An iterator obtained but never advanced must release its
        claim on GC — previously pool.busy stayed True forever and each
        epoch leaked a fresh worker pool (advisor round-2 finding)."""
        import gc
        loader = io.DataLoader(SquareDataset(16), batch_size=4,
                               num_workers=2, persistent_workers=True)
        it = iter(loader)          # claims the pool, never started
        pool = loader._pool
        assert pool is not None and pool.busy
        del it
        gc.collect()
        assert not pool.busy       # released on GC
        # next epoch reuses the SAME pool — no leak
        n = sum(1 for _ in loader)
        assert n == 4
        assert loader._pool is pool
        assert len(loader._live_pools) == 1
        loader._pool.close()

    def test_abandoned_mid_iteration_releases_pool(self):
        import gc
        loader = io.DataLoader(SquareDataset(32), batch_size=4,
                               num_workers=2, persistent_workers=True)
        it = iter(loader)
        next(it)                   # started, then abandoned
        pool = loader._pool
        del it
        gc.collect()
        assert not pool.busy
        assert sum(1 for _ in loader) == 8
        loader._pool.close()

    def test_del_closes_every_spawned_pool(self):
        import gc
        loader = io.DataLoader(SquareDataset(16), batch_size=4,
                               num_workers=2, persistent_workers=True)
        it1 = iter(loader)
        it2 = iter(loader)         # concurrent: second pool
        pools = list(loader._live_pools)
        assert len(pools) == 2
        del it1, it2
        gc.collect()
        loader.__del__()
        assert all(p._closed for p in pools)

    def test_persistent_concurrent_pools_recycled(self):
        """With persistent_workers, the extra pool spawned for a second
        concurrent iterator must be REUSED by later epochs, not leak one
        pool per epoch (review finding)."""
        import gc
        loader = io.DataLoader(SquareDataset(16), batch_size=4,
                               num_workers=2, persistent_workers=True)
        for _ in range(3):
            it1, it2 = iter(loader), iter(loader)
            next(it1), next(it2)
            del it1, it2
            gc.collect()
        assert len(loader._live_pools) == 2, len(loader._live_pools)
        for p in list(loader._live_pools):
            p.close()


class MakesHandles(io.Dataset):
    """A dataset whose samples are tensor-layer handles, made in the
    worker: the worker's place is the CPU, whatever the parent's."""

    def __getitem__(self, i):
        return (paddle.to_tensor(np.full((2,), i, np.float32)),
                paddle.to_tensor(np.int64(i)))

    def __len__(self):
        return 12


def test_workers_make_handles_on_the_cpu():
    core_device._current = None          # the parent's place: the card
    try:
        loader = io.DataLoader(MakesHandles(), batch_size=4, num_workers=2)
        xs = [x for x, _ in loader.host_batches()]
    finally:
        paddle.set_device("cpu")
    np.testing.assert_array_equal(np.concatenate(xs)[:, 0], np.arange(12))


def test_workers_reorder_through_the_native_queue():
    from paddle_tpu_torch import csrc
    loader = io.DataLoader(SquareDataset(40), batch_size=3, num_workers=3,
                           prefetch_factor=1)
    it = iter(loader)
    assert isinstance(it.mp_it.order, csrc.NativeOrderedQueue)
    xs = np.concatenate([b[0].numpy()[:, 0, 0] for b in it])
    np.testing.assert_array_equal(xs, np.arange(40, dtype=np.float32))


def test_worker_batches_byte_equal_to_jax():
    import paddle_tpu as J   # here, so that the card (no jax) runs the rest
    got = []
    for pkg in (J, paddle):
        pkg.seed(13)
        loader = pkg.io.DataLoader(SquareDataset(30), batch_size=4,
                                   shuffle=True, num_workers=2)
        got.append([(np.asarray(x.numpy()), np.asarray(y.numpy()))
                    for x, y in loader])
    assert len(got[0]) == len(got[1])
    for (px, py), (jx, jy) in zip(got[1], got[0]):
        assert px.tobytes() == jx.tobytes()
        np.testing.assert_array_equal(py, jy)


def test_abandoned_iterator_stops_its_workers():
    import gc
    loader = io.DataLoader(SquareDataset(24), batch_size=4, num_workers=2)
    it = iter(loader)
    next(it)
    pool = loader._pool
    del it
    gc.collect()
    assert pool._closed and not any(p.is_alive() for p in pool.procs)


def _own_segments():
    import os
    return {n for n in os.listdir("/dev/shm")
            if n.startswith(f"ptq{os.getpid()}x")}


@pytest.mark.parametrize("case", ["worker_exception", "dead_worker",
                                  "abandoned_persistent", "iterable"])
def test_failing_paths_leave_no_segment(case):
    """Every segment a pool's workers write is unlinked: after a worker's
    exception (batches received out of order wait in the ordered queue),
    after a worker dies between writing a batch and announcing it, when
    a persistent pool's iterator is abandoned, and after an iterable
    epoch."""
    import gc
    import os as _os
    before = _own_segments()

    class Dies(io.Dataset):
        def __getitem__(self, i):
            if i == 5:
                _os._exit(1)
            return np.zeros((2,), np.float32)

        def __len__(self):
            return 16

    if case == "worker_exception":
        with pytest.raises(RuntimeError, match="boom at 7"):
            list(io.DataLoader(FailingDataset(), batch_size=4,
                               num_workers=2))
    elif case == "dead_worker":
        with pytest.raises(RuntimeError, match="died"):
            list(io.DataLoader(Dies(), batch_size=2, num_workers=1))
    elif case == "abandoned_persistent":
        loader = io.DataLoader(SquareDataset(64), batch_size=4,
                               num_workers=2, persistent_workers=True)
        it = iter(loader)
        next(it)
        del it
        gc.collect()
        loader._pool.close()
    else:
        assert len(list(io.DataLoader(CountingIterable(32), batch_size=4,
                                      num_workers=2))) == 8
    gc.collect()
    assert _own_segments() <= before


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA card: pinned, non-blocking uploads")
def test_device_loader_pinned_uploads_on_the_card():
    """On the card each batch crosses from a reused pinned buffer on
    the DeviceLoader's own stream; the consumer's stream waits on it."""
    ds = SquareDataset(64)
    loader = io.DataLoader(ds, batch_size=8, num_workers=2)
    dev = io.DeviceLoader(loader, buffer_size=2,
                          sharding_fn=lambda shape: "cuda:0", wrap=False)
    xs = []
    for x, y in dev:
        assert x.is_cuda and y.is_cuda
        xs.append((x * 2).cpu())
    np.testing.assert_array_equal(torch.cat(xs)[:, 0, 0].numpy(),
                                  2 * np.arange(64, dtype=np.float32))
    assert dev._stream is not None
    assert dev._stream != torch.cuda.current_stream()
    pinned = [slot[0] for slots in dev._pool.bufs.values()
              for slot in slots]
    assert pinned and all(b.is_pinned() for b in pinned)
    assert len(pinned) <= 2 * (dev.buffer_size + 2)
