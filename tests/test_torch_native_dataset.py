"""The port's dataset engine (``io/native_dataset.py`` over the host
library ``csrc/dataset.cc``) held to the JAX package's:
``test_native_dataset.py``'s cases through the port but
``test_train_from_dataset`` (the static ``Executor``, ROADMAP Queue A
12f), the port's native engine giving the same batches as the JAX
package's native engine byte for byte (one source, one compiler), and
the pure-Python engine the same records as a multiset."""
import os

import numpy as np
import pytest

import paddle_tpu_torch as paddle
from paddle_tpu_torch.io import InMemoryDataset, DatasetFactory
from paddle_tpu_torch import csrc
from paddle_tpu_torch.distributed import parallel as dp


class _Var:
    def __init__(self, name, shape, dtype="float32"):
        self.name = name
        self.shape = shape
        self.dtype = dtype


@pytest.fixture()
def data_files(tmp_path):
    rng = np.random.RandomState(0)
    files = []
    for i in range(3):
        path = tmp_path / f"part-{i}.txt"
        rows = []
        for _ in range(40):
            x = rng.rand(4)
            label = float(x.sum() > 2.0)
            rows.append(" ".join(f"{v:.6f}" for v in x) + f" {label}")
        path.write_text("\n".join(rows) + "\n")
        files.append(str(path))
    return files


def test_native_engine_available():
    assert csrc.available(), "the host library should build here"
    path = csrc.load().path
    build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(paddle.__file__))), "build", "paddle_tpu_torch")
    assert os.path.dirname(path) == build
    assert not [f for f in os.listdir(os.path.dirname(csrc.__file__))
                if f.endswith(".so")]


def test_load_shuffle_iterate(data_files):
    ds = InMemoryDataset()
    ds.set_filelist(data_files)
    ds.set_use_var([_Var("x", [-1, 4]), _Var("y", [-1, 1])])
    ds.set_batch_size(16)
    n = ds.load_into_memory()
    assert n == 120
    assert ds.get_memory_data_size() == 120
    first = next(iter(ds))
    assert first[0].shape == (16, 4)
    assert first[1].shape == (16, 1)
    before = first[0].copy()
    ds.local_shuffle()
    after = next(iter(ds))[0]
    assert not np.array_equal(before, after)
    # all records still present across one epoch
    total = sum(len(b[0]) for b in ds)
    assert total == 112  # 120 - remainder(8) with bs 16


def test_global_shuffle_shards_disjoint(data_files, monkeypatch):
    from paddle_tpu_torch.distributed import parallel as dp
    sets = []
    for rank in range(2):
        ds = InMemoryDataset()
        ds.set_filelist(data_files)
        ds.set_use_var([_Var("x", [-1, 4]), _Var("y", [-1, 1])])
        ds.set_batch_size(10)
        ds.load_into_memory()
        monkeypatch.setattr(dp, "get_rank", lambda group=None, r=rank: r)
        monkeypatch.setattr(dp, "get_world_size", lambda group=None: 2)
        ds.global_shuffle()
        assert ds.get_shuffle_data_size() == 60
        rows = np.concatenate([b[0] for b in ds])
        sets.append({tuple(np.round(r, 5)) for r in rows})
    assert not (sets[0] & sets[1])  # disjoint shards


def test_queue_dataset_no_shuffle(data_files):
    ds = DatasetFactory().create_dataset("QueueDataset")
    ds.set_filelist(data_files)
    ds.set_use_var([_Var("x", [-1, 4]), _Var("y", [-1, 1])])
    ds.set_batch_size(8)
    with pytest.raises(RuntimeError):
        ds.local_shuffle()
    batches = list(ds)
    assert len(batches) == 15


def test_release_memory(data_files):
    ds = InMemoryDataset()
    ds.set_filelist(data_files)
    ds.set_use_var([_Var("x", [-1, 4]), _Var("y", [-1, 1])])
    ds.load_into_memory()
    assert ds.get_memory_data_size() == 120
    ds.release_memory()
    assert ds.get_memory_data_size() == 0


# ---- regressions from code review ----------------------------------------

def test_record_order_deterministic_across_threads(data_files):
    orders = []
    for threads in (1, 4):
        ds = InMemoryDataset()
        ds.set_filelist(data_files)
        ds.set_use_var([_Var("x", [-1, 4]), _Var("y", [-1, 1])])
        ds.set_thread(threads)
        ds.set_batch_size(120)
        ds.load_into_memory()
        orders.append(next(iter(ds))[0])
    np.testing.assert_array_equal(orders[0], orders[1])


def test_long_lines_single_record(tmp_path):
    # a >64KiB line must stay ONE (truncated) record, not split into many
    path = tmp_path / "wide.txt"
    vals = " ".join("1.5" for _ in range(20000))  # ~100KB line
    path.write_text(vals + "\n" + "2.0 2.0 2.0 2.0\n")
    ds = InMemoryDataset()
    ds.set_filelist([str(path)])
    ds.set_use_var([_Var("x", [-1, 4])])
    n = ds.load_into_memory()
    assert n == 2
    ds.set_batch_size(2)
    batch = next(iter(ds))[0]
    np.testing.assert_allclose(batch[0], [1.5] * 4)
    np.testing.assert_allclose(batch[1], [2.0] * 4)


def test_global_shuffle_idempotent_per_epoch(data_files, monkeypatch):
    from paddle_tpu_torch.distributed import parallel as dp
    ds = InMemoryDataset()
    ds.set_filelist(data_files)
    ds.set_use_var([_Var("x", [-1, 4]), _Var("y", [-1, 1])])
    ds.load_into_memory()
    monkeypatch.setattr(dp, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dp, "get_world_size", lambda group=None: 2)
    ds.global_shuffle()
    assert ds.get_shuffle_data_size() == 60
    first_epoch = {tuple(np.round(r, 5))
                   for b in ds for r in b[0]}
    ds.global_shuffle()  # second epoch: re-derives, does NOT shrink
    assert ds.get_shuffle_data_size() == 60
    second_epoch = {tuple(np.round(r, 5))
                    for b in ds for r in b[0]}
    assert first_epoch != second_epoch  # fresh partition per epoch


def _all(ds):
    return [np.concatenate([np.asarray(a).reshape(len(a), -1) for a in b],
                           axis=1) for b in ds]


def _set_up(mod, files, bs, **kw):
    ds = mod.InMemoryDataset(**kw)
    ds.set_filelist(files)
    ds.set_use_var([_Var("x", [-1, 4]), _Var("y", [-1, 1], "int64")])
    ds.set_batch_size(bs)
    ds.set_thread(3)
    ds.load_into_memory()
    return ds


def test_native_engine_matches_jax(data_files, monkeypatch):
    """The JAX package's ``InMemoryDataset`` over the same native code:
    the port's sources are byte-for-byte copies of the JAX package's, so
    its library stands in for the JAX one (which this test does not
    build)."""
    from paddle_tpu import csrc as jcsrc
    from paddle_tpu import io as jio
    from paddle_tpu.distributed import parallel as jdp
    for name in csrc.SOURCES:
        with open(os.path.join(os.path.dirname(jcsrc.__file__), name),
                  "rb") as a, open(os.path.join(os.path.dirname(
                      csrc.__file__), name), "rb") as b:
            ours = b.read()
            ref = a.read()
        # the port's copy differs only in its build comment
        strip = [ln for ln in ours.splitlines() if b"Build:" not in ln
                 and b"dataset.cc with c++" not in ln]
        assert strip == [ln for ln in ref.splitlines()
                         if b"Build:" not in ln], name
    monkeypatch.setattr(jcsrc, "load", lambda *a, **k: csrc.load())
    got = []
    for mod, par in ((jio, jdp), (paddle.io, dp)):
        ds = _set_up(mod, data_files, 16)
        batches = _all(ds)
        ds.local_shuffle()
        batches += _all(ds)
        ds.local_shuffle()
        batches += _all(ds)
        monkeypatch.setattr(par, "get_rank", lambda group=None: 1)
        monkeypatch.setattr(par, "get_world_size", lambda group=None: 3)
        ds.global_shuffle()
        batches += _all(ds)
        got.append(batches)
    assert len(got[0]) == len(got[1])
    for a, b in zip(got[1], got[0]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_python_engine_same_records(data_files):
    nat = _set_up(paddle.io, data_files, 8)
    py = _set_up(paddle.io, data_files, 8, engine="python")
    np.testing.assert_array_equal(np.concatenate(_all(nat)),
                                  np.concatenate(_all(py)))
    nat.local_shuffle()
    py.local_shuffle()
    a, b = np.concatenate(_all(nat)), np.concatenate(_all(py))
    assert not np.array_equal(a, b)      # two shuffles, one multiset
    key = lambda m: m[np.lexsort(m.T[::-1])]
    np.testing.assert_array_equal(key(a), key(b))
    with pytest.raises(ValueError, match="engine"):
        InMemoryDataset(engine="fast")


def test_global_shuffle_refuses_several_processes(data_files,
                                                  monkeypatch):
    import torch.distributed as tdist
    ds = _set_up(paddle.io, data_files, 8)
    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="12d"):
        ds.global_shuffle()


def test_build_failure_raises_with_stderr(tmp_path, monkeypatch):
    from paddle_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building the host library"):
        csrc.build()
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]
