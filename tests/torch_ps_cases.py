"""The cases of ``tests/test_ps.py`` and ``tests/test_ps_geo.py`` written
once over a package namespace, so that the JAX package's tables and the
port's run the same calls from the same rows (``test_torch_ps.py``,
``test_torch_ps_geo.py``).  A case takes ``ns`` — the package's
``SparseTable``, ``HashedSparseTable``, ``GeoSparseTable``,
``GeoWorkerTable``, ``DistributedEmbedding``, ``TheOnePS``, its ``mesh``
(``dp=4, sharding=2``) and a scratch ``tmp`` directory — and returns
``{name: numpy array or value}``, which the tests compare between the
packages.  Rows come from ``Init``, a seeded numpy initializer both
packages call in the same order."""
import os
import types

import numpy as np


class Init:
    """A table initializer drawing from one numpy stream: the same calls
    give the same rows in either package."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)

    def __call__(self, shape, dtype):
        return self.rs.uniform(-0.5, 0.5, shape).astype(dtype)


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") and not
                      isinstance(x, np.ndarray) else x)


def _state(t):
    return {k: np.asarray(_np(v)) for k, v in t.state.items()}


def pull_push_sgd_cycle(ns):
    t = ns.SparseTable("emb", rows=16, dim=4, optimizer="sgd", lr=0.5,
                       initializer=Init(0), mesh=ns.mesh)
    before = _np(t.pull(np.array([1, 3], np.int32)))
    t.push(np.array([1, 3, 3], np.int32), np.ones((3, 4), np.float32))
    after = _np(t.pull(np.array([1, 3], np.int32)))
    other = _np(t.pull(np.array([0], np.int32)))
    t.push(np.array([1], np.int32), np.ones((1, 4), np.float32))
    return {"before": before, "after": after, "other": other,
            "other_after": _np(t.pull(np.array([0], np.int32))),
            "weight": np.asarray(_np(t.weight))}


def adam_rows_only_touched(ns):
    t = ns.SparseTable("emb2", rows=8, dim=4, optimizer="adam", lr=0.1,
                       initializer=Init(1), mesh=ns.mesh)
    w0 = np.asarray(_np(t.weight)).copy()
    t.push(np.array([2], np.int32), np.ones((1, 4), np.float32))
    return {"w0": w0, "w1": np.asarray(_np(t.weight)), **_state(t)}


def embedding_trains_regression(ns):
    t = ns.SparseTable("emb3", rows=8, dim=2, optimizer="sgd", lr=0.3,
                       initializer=Init(2), mesh=ns.mesh)
    emb = ns.DistributedEmbedding(t)
    ids = np.array([0, 1, 2, 3], np.int32)
    target = np.array([[1, 0], [0, 1], [1, 1], [-1, -1]], np.float32)
    losses = []
    for _ in range(60):
        diff = _np(emb(ids)) - target
        losses.append(float((diff ** 2).mean()))
        emb.apply_gradients(2 * diff / diff.size)
    return {"losses": np.asarray(losses)}


def table_save_load_roundtrip(ns):
    runtime = ns.TheOnePS()
    t = runtime.create_table("emb4", rows=8, dim=4, initializer=Init(3),
                             mesh=ns.mesh)
    t.push(np.array([1, 2], np.int32), np.ones((2, 4), np.float32))
    ref = np.asarray(_np(t.weight)).copy()
    d = os.path.join(ns.tmp, "rt")
    runtime.save_persistables(dirname=d)
    runtime2 = ns.TheOnePS()
    runtime2.create_table("emb4", rows=8, dim=4, initializer=Init(99),
                          mesh=ns.mesh)
    runtime2.init_server(dirname=d)
    return {"ref": ref, "loaded": np.asarray(_np(runtime2.tables["emb4"]
                                                 .weight))}


def push_matches_adam_with_dups(ns):
    t = ns.SparseTable("emb6", rows=12, dim=3, optimizer="adam", lr=0.05,
                       initializer=Init(4), mesh=ns.mesh)
    rs = np.random.RandomState(0)
    out = {}
    for i in range(3):
        t.push(rs.randint(0, 12, (6,)).astype(np.int32),
               rs.randn(6, 3).astype(np.float32))
        out[f"w{i}"] = np.asarray(_np(t.weight)).copy()
    out.update(_state(t))
    return out


def sharded_save_load_multiple_files(ns):
    t = ns.SparseTable("emb7", rows=20, dim=4, optimizer="adam", lr=0.1,
                       initializer=Init(5), mesh=ns.mesh)
    t.push(np.arange(10, dtype=np.int32), np.ones((10, 4), np.float32))
    d = os.path.join(ns.tmp, "multi")
    t.save(d, num_shards=4)
    t2 = ns.SparseTable("emb7", rows=20, dim=4, optimizer="adam", lr=0.1,
                        initializer=Init(6), mesh=ns.mesh)
    t2.load(d)
    return {"files": sum(f.startswith("emb7.shard")
                         for f in os.listdir(d)),
            "weight": np.asarray(_np(t2.weight)),
            **{k: v for k, v in _state(t2).items()}}


def hashed_unbounded_ids_and_growth(ns):
    t = ns.HashedSparseTable("h1", dim=4, initial_rows=4, optimizer="sgd",
                             lr=0.5, initializer=Init(7), mesh=ns.mesh)
    ids = np.array([2**62 + 7, 123456789012345, 2**40, 17, 2**62 + 7],
                   np.int64)
    v1 = _np(t.pull(ids))
    size1 = t.size
    more = _np(t.pull(np.arange(100, 112, dtype=np.int64)))
    return {"v1": v1, "size1": size1, "more": more, "size": t.size,
            "rows": t.rows, "slots": sorted(t._slot_of.items())}


def hashed_push_updates_only_touched(ns):
    t = ns.HashedSparseTable("h2", dim=3, initial_rows=4, optimizer="sgd",
                             lr=1.0, initializer=Init(8), mesh=ns.mesh)
    ids = np.array([10**15, 5], np.int64)
    before = _np(t.pull(ids))
    other = _np(t.pull(np.array([777], np.int64)))
    t.push(ids, np.ones((2, 3), np.float32))
    return {"before": before, "after": _np(t.pull(ids)), "other": other,
            "other_after": _np(t.pull(np.array([777], np.int64)))}


def hashed_adam_matches_fixed_table(ns):
    rs = np.random.RandomState(0)
    init = lambda shape, dtype: np.zeros(shape, dtype)  # noqa: E731
    t_fix = ns.SparseTable("f3", rows=8, dim=3, optimizer="adam", lr=0.1,
                           initializer=init, mesh=ns.mesh)
    t_h = ns.HashedSparseTable("h3", dim=3, initial_rows=2,
                               optimizer="adam", lr=0.1, initializer=init,
                               mesh=ns.mesh)
    big_ids = np.array([2**50, 3, 2**61, 40, 2**50], np.int64)
    fix_ids = np.array([0, 1, 2, 3, 0], np.int64)
    for _ in range(3):
        g = rs.rand(5, 3).astype(np.float32)
        t_fix.push(fix_ids, g)
        t_h.push(big_ids, g)
    return {"hashed": _np(t_h.pull(big_ids)),
            "fixed": _np(t_fix.pull(fix_ids))}


def hashed_shrink_evicts_stale(ns):
    t = ns.HashedSparseTable("h4", dim=2, initial_rows=4, optimizer="adam",
                             lr=0.5, initializer=Init(9), mesh=ns.mesh)
    t.push(np.array([1, 2], np.int64), np.ones((2, 2), np.float32))
    for i in range(5):
        t.push(np.array([100 + i], np.int64), np.ones((1, 2), np.float32))
    n = t.shrink(ttl=4)
    out = {"evicted": n, "size": t.size, "rows": t.rows,
           "slots": sorted(t._slot_of.items()), "free": sorted(t._free),
           "weight": np.asarray(_np(t.weight)), **_state(t)}
    out["fresh"] = _np(t.pull(np.array([1, 2], np.int64)))
    return out


def hashed_save_load_roundtrip(ns):
    t = ns.HashedSparseTable("h5", dim=3, initial_rows=2, optimizer="adam",
                             lr=0.1, initializer=Init(10), mesh=ns.mesh)
    ids = np.array([2**55, 9, 2**44, 123], np.int64)
    t.push(ids, np.ones((4, 3), np.float32))
    want = _np(t.pull(ids))
    d = os.path.join(ns.tmp, "h5")
    t.save(d)
    t2 = ns.HashedSparseTable("h5", dim=3, initial_rows=2,
                              optimizer="adam", lr=0.1,
                              initializer=Init(11), mesh=ns.mesh)
    t2.load(d)
    return {"want": want, "got": _np(t2.pull(ids)), "size": t2.size}


def hashed_max_rows_exhaustion(ns):
    t = ns.HashedSparseTable("h6", dim=2, initial_rows=2, max_rows=4,
                             optimizer="sgd", initializer=Init(12),
                             mesh=ns.mesh)
    try:
        t.pull(np.arange(5, dtype=np.int64))
        return {"raised": None}
    except RuntimeError as e:
        return {"raised": "max_rows" in str(e)}


def runtime_facade_creates_hashed(ns):
    t = ns.TheOnePS().create_table("h7", rows=None, dim=2, initial_rows=2,
                                   initializer=Init(13), mesh=ns.mesh)
    return {"hashed": isinstance(t, ns.HashedSparseTable)}


def hashed_pull_preserves_ids_shape(ns):
    t = ns.HashedSparseTable("h8", dim=3, initial_rows=2,
                             initializer=Init(14), mesh=ns.mesh)
    out = _np(t.pull(np.array([[2**50, 5], [7, 2**50]], np.int64)))
    return {"shape": list(out.shape), "out": out}


def hashed_clamped_growth(ns):
    t = ns.HashedSparseTable("h9", dim=2, initial_rows=4, max_rows=6,
                             optimizer="sgd", initializer=Init(15),
                             mesh=ns.mesh)
    t.pull(np.arange(6, dtype=np.int64))
    t.push(np.arange(6, dtype=np.int64), np.ones((6, 2), np.float32))
    return {"rows": t.rows, "weight": np.asarray(_np(t.weight))}


def hashed_load_into_default_capacity(ns):
    t = ns.HashedSparseTable("h10", dim=2, initial_rows=2, max_rows=6,
                             initializer=Init(16), mesh=ns.mesh)
    ids = np.arange(6, dtype=np.int64) + 2**33
    t.push(ids, np.ones((6, 2), np.float32))
    want = _np(t.pull(ids))
    d = os.path.join(ns.tmp, "h10")
    t.save(d)
    t2 = ns.HashedSparseTable("h10", dim=2, initializer=Init(17),
                              mesh=ns.mesh)
    t2.load(d)
    return {"want": want, "got": _np(t2.pull(ids)), "rows": t2.rows,
            "max_rows": t2.max_rows}


PS_CASES = (pull_push_sgd_cycle, adam_rows_only_touched,
            embedding_trains_regression, table_save_load_roundtrip,
            push_matches_adam_with_dups, sharded_save_load_multiple_files,
            hashed_unbounded_ids_and_growth,
            hashed_push_updates_only_touched,
            hashed_adam_matches_fixed_table, hashed_shrink_evicts_stale,
            hashed_save_load_roundtrip, hashed_max_rows_exhaustion,
            runtime_facade_creates_hashed, hashed_pull_preserves_ids_shape,
            hashed_clamped_growth, hashed_load_into_default_capacity)


# -- geo (tests/test_ps_geo.py) ----------------------------------------
def geo_deltas_merge_and_refresh(ns):
    t = ns.GeoSparseTable("geo0", dim=4, trainer_num=2, lr=1.0,
                          initializer=Init(20), mesh=ns.mesh)
    w0 = ns.GeoWorkerTable(t, 0, geo_need_push_nums=1)
    w1 = ns.GeoWorkerTable(t, 1, geo_need_push_nums=1)
    ids = np.array([5], np.int64)
    base = _np(w1.pull(ids)).copy()
    w0.push(ids, np.ones((1, 4), np.float32))
    stale = _np(w1.pull(ids)).copy()
    w1.push(ids, np.zeros((1, 4), np.float32))
    return {"base": base, "stale": stale, "got": _np(w1.pull(ids))}


def _geo_problem():
    rs = np.random.RandomState(0)
    return np.arange(8, dtype=np.int64), rs.randn(8, 4).astype(np.float32)


def geo_matches_sync_convergence(ns):
    ids, target = _geo_problem()
    sync = ns.SparseTable("geo_sync", rows=8, dim=4, optimizer="sgd",
                          lr=0.2, initializer=Init(21), mesh=ns.mesh)
    sync_losses = []
    for _ in range(120):
        rows = _np(sync.pull(ids))
        sync_losses.append(float(((rows - target) ** 2).mean()))
        sync.push(ids, rows - target)
    t = ns.GeoSparseTable("geo1", dim=4, trainer_num=2, lr=0.2,
                          initializer=Init(21), mesh=ns.mesh)
    workers = [ns.GeoWorkerTable(t, i, geo_need_push_nums=10)
               for i in range(2)]
    geo_losses = []
    for step in range(120):
        w = workers[step % 2]
        rows = _np(w.pull(ids))
        geo_losses.append(float(((rows - target) ** 2).mean()))
        w.push(ids, rows - target)
    for w in workers:
        w.flush()
    final = _np(t.pull(ids))
    return {"sync": np.asarray(sync_losses), "geo": np.asarray(geo_losses),
            "final": final,
            "geo_final": float(((final - target) ** 2).mean())}


def geo_unflushed_not_visible(ns):
    t = ns.GeoSparseTable("geo2", dim=4, trainer_num=1, lr=1.0,
                          initializer=Init(22), mesh=ns.mesh)
    w = ns.GeoWorkerTable(t, 0, geo_need_push_nums=100)
    ids = np.array([3], np.int64)
    before = _np(t.pull(ids)).copy()
    w.push(ids, np.ones((1, 4), np.float32))
    unflushed = _np(t.pull(ids)).copy()
    w.flush()
    return {"before": before, "unflushed": unflushed,
            "flushed": _np(t.pull(ids))}


def hashed_churn_under_shifting_ids(ns):
    """``test_hashed_table_churn_under_shifting_ids`` at a tenth of its
    window and batch: grow + shrink(ttl) cycles under a sliding id
    window."""
    t = ns.HashedSparseTable("churn", dim=4, initial_rows=64,
                             optimizer="sgd", lr=0.1, initializer=Init(23),
                             mesh=ns.mesh)
    rs = np.random.RandomState(0)
    window, batch = 5_000, 410
    evicted, books = [], []
    for e in range(8):
        lo = e * window // 2
        ids = rs.randint(lo, lo + window, size=batch).astype(np.int64)
        t.push(ids, np.ones((ids.size, 4), np.float32))
        evicted.append(t.shrink(ttl=2))
        books.append((t.size + len(t._free) == t.rows,
                      len(set(t._slot_of.values())) == t.size))
    free_before = len(t._free)
    rows_before = t.rows
    fresh = np.arange(10**9, 10**9 + min(free_before, 100), dtype=np.int64)
    t.push(fresh, np.ones((fresh.size, 4), np.float32))
    return {"evicted": evicted, "books": books, "size": t.size,
            "rows": t.rows, "rows_before": rows_before,
            "slots": sorted(t._slot_of.items()),
            "weight": np.asarray(_np(t.weight))}


GEO_CASES = (geo_deltas_merge_and_refresh, geo_matches_sync_convergence,
             geo_unflushed_not_visible, hashed_churn_under_shifting_ids)


def namespace(pkg, mesh, tmp):
    """``ns`` over a package's ``distributed.ps`` names."""
    return types.SimpleNamespace(
        SparseTable=pkg.SparseTable, HashedSparseTable=pkg.HashedSparseTable,
        GeoSparseTable=pkg.GeoSparseTable, GeoWorkerTable=pkg.GeoWorkerTable,
        DistributedEmbedding=pkg.DistributedEmbedding,
        TheOnePS=pkg.TheOnePS, mesh=mesh, tmp=str(tmp))


def assert_same(port, ref, rtol=1e-5, atol=1e-6):
    assert sorted(port) == sorted(ref)
    for k in ref:
        a, b = port[k], ref[k]
        if isinstance(b, np.ndarray) and b.dtype.kind == "f":
            np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                                       atol=atol, err_msg=k)
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=k)
        else:
            assert a == b, (k, a, b)
