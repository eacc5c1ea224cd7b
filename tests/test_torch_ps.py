"""The port's sparse tables (``paddle_tpu_torch.distributed.ps``) held to
the JAX package's, case for case of ``tests/test_ps.py``: both packages'
tables start from the same rows (``torch_ps_cases.Init``) on a
``dp=4, sharding=2`` mesh and run the same pulls and pushes — SGD and
Adam with duplicate ids, growth, shrink, ``max_rows``, save and load —
and every result agrees (rtol 1e-5).  Files saved by either package load
into the other, and a push allocates nothing the size of the table."""
import os
import pickle

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu import distributed as jdist
from paddle_tpu.distributed import ps as jps
from paddle_tpu_torch.distributed import build_mesh
from paddle_tpu_torch.distributed import ps as tps

import torch_ps_cases as cases

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def meshes():
    return (jdist.build_mesh(dp=4, sharding=2),
            build_mesh(dp=4, sharding=2, devices=["cpu"] * 8))


@pytest.mark.parametrize("case", cases.PS_CASES, ids=lambda c: c.__name__)
def test_case_matches_jax(case, meshes, tmp_path):
    ref = case(cases.namespace(jps, meshes[0], tmp_path / "jax"))
    got = case(cases.namespace(tps, meshes[1], tmp_path / "port"))
    cases.assert_same(got, ref)


def test_rows_split_over_sharding_ranks(meshes):
    mesh = build_mesh(dp=2, sharding=2,
                      devices=[torch.device("cpu")] * 4)
    t = tps.SparseTable("split", rows=16, dim=4, mesh=mesh)
    assert t.sharded and [(lo, hi) for lo, hi, _, _ in t._shards] == [
        (0, 8), (8, 16)]
    # a count that does not divide replicates: one copy a distinct device
    r = tps.SparseTable("whole", rows=15, dim=4, mesh=mesh)
    assert not r.sharded and len(r._shards) == 1


class _Sizes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.seen.append((func.__name__, t.numel()))
        return out


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_push_allocates_nothing_table_sized(optimizer):
    """``test_push_cost_independent_of_table_size`` without the clock:
    every op a push runs returns a tensor of O(batch) elements, save the
    in-place updates of the table itself."""
    mesh = build_mesh(dp=2, sharding=2, devices=["cpu"] * 4)
    t = tps.SparseTable("big", rows=200_000, dim=32, optimizer=optimizer,
                        mesh=mesh)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 200_000, (128,)).astype(np.int32)
    g = np.ones((128, 32), np.float32)
    t.push(ids, g)
    with _Sizes() as rec:
        t.push(ids, g)
    table = 200_000 * 32 // 2          # a shard's elements
    big = [(n, k) for n, k in rec.seen if k >= table // 8]
    assert big and all(n.split(".")[0].endswith("_") for n, _ in big), big
    assert max(k for n, k in rec.seen
               if not n.split(".")[0].endswith("_")) <= 128 * 32


def _push_both(jt, tt, seed):
    rs = np.random.RandomState(seed)
    for _ in range(3):
        ids = rs.randint(0, 10, (7,)).astype(np.int64)
        g = rs.randn(7, 3).astype(np.float32)
        jt.push(ids, g)
        tt.push(ids, g)


@pytest.mark.parametrize("kind", ["sgd", "adam", "hashed", "geo"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_files_load_across_packages(kind, direction, meshes, tmp_path):
    def make(pkg, mesh, name, seed):
        init = cases.Init(seed)
        if kind in ("sgd", "adam"):
            return pkg.SparseTable(name, rows=10, dim=3, optimizer=kind,
                                   lr=0.1, initializer=init, mesh=mesh)
        if kind == "hashed":
            return pkg.HashedSparseTable(name, dim=3, initial_rows=4,
                                         optimizer="adam", lr=0.1,
                                         initializer=init, mesh=mesh)
        return pkg.GeoSparseTable(name, dim=3, trainer_num=2, lr=0.1,
                                  initializer=init, mesh=mesh)

    src_pkg, dst_pkg = (jps, tps) if direction == "jax_to_port" else (tps, jps)
    src_mesh, dst_mesh = meshes if direction == "jax_to_port" else \
        meshes[::-1]
    src = make(src_pkg, src_mesh, "t", 0)
    if kind == "geo":
        w = src_pkg.GeoWorkerTable(src, 0, geo_need_push_nums=2)
        for i in range(4):
            w.push(np.array([i, 2**40], np.int64),
                   np.ones((2, 3), np.float32) * (i + 1))
    else:
        ids = np.array([1, 3, 3, 9, 2**35 if kind == "hashed" else 0],
                       np.int64)
        src.push(ids, np.ones((5, 3), np.float32))
    src.save(str(tmp_path))
    dst = make(dst_pkg, dst_mesh, "t", 1)
    dst.load(str(tmp_path))
    np.testing.assert_allclose(np.asarray(dst.weight), np.asarray(
        src.weight), rtol=1e-6)
    for k, v in src.state.items():
        np.testing.assert_array_equal(np.asarray(dst.state[k]),
                                      np.asarray(v))
    if kind in ("hashed", "geo"):
        assert dst._slot_of == src._slot_of and dst.rows == src.rows
    if kind == "geo":
        assert dst._pending == src._pending


def test_legacy_table_file_loads_in_both(meshes, tmp_path):
    rs = np.random.RandomState(0)
    w = rs.rand(8, 2).astype(np.float32)
    with open(tmp_path / "old.table", "wb") as f:
        pickle.dump({"weight": w, "state": {
            "m": np.ones((8, 2), np.float32), "v": np.ones((8, 2),
                                                             np.float32),
            "t": np.asarray(3, np.int32)}}, f)
    out = []
    for pkg, mesh in ((jps, meshes[0]), (tps, meshes[1])):
        t = pkg.SparseTable("old", rows=8, dim=2, optimizer="adam",
                            mesh=mesh)
        t.load(str(tmp_path))
        out.append((np.asarray(t.weight), np.asarray(t.state["t"])))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert os.path.exists(tmp_path / "old.table")
