"""The port's fleet facade, meta-optimizers and collectives held to the
JAX package's.

* ``DistributedStrategy`` is a copy of the JAX package's (same fields
  and defaults; a strategy file saved by one loads in the other);
  ``fleet.init`` builds the mesh ``hybrid_configs`` asks for, as JAX's
  does, and sets it as the process mesh; ``build_train_step`` picks each
  meta-optimizer and otherwise ``TrainStep``; ``distributed_model``
  wraps in ``DataParallel``, which ``TrainStep`` unwraps.
* The meta-optimizers over ``dp=8`` against the JAX package's steps on
  the same weights and batch (SGD, fp32): LocalSGD k=2, adaptive
  LocalSGD, DGC and fp16 allreduce — losses at rtol 1e-4, parameters at
  atol 1e-5 / rtol 1e-4 — and LocalSGD k=1 equal to the synchronous
  ``TrainStep``.  Every rank holds its own parameter copy and state.
  Beside ``mp=2`` or ``pp=2`` (at ``dp=2``) the four hold one state a
  data rank, as JAX's do, and every mesh rank reads its data rank's
  parameters, equal to JAX's per-rank ones.
* The paddle collective API inside ``parallel_region`` over dp=8 against
  JAX's ``shard_map`` region (``p2p_shift``, ``all_reduce``), and the
  rest against their definitions; the training collectives'
  backward is the exact transpose.
* The parallel environment of one controller process; what stays
  unported raises naming its ROADMAP item.
* ``run_ranks`` runs one rank thread at a time in a fixed order (a
  stress test with more threads than cores), re-raises a rank's error
  and refuses a collective no other rank joins.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet import meta_optimizers as jmeta
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import (DataParallel, build_mesh,
                                          collective, fleet, get_mesh,
                                          get_rank, get_world_size,
                                          is_initialized, set_mesh, spawn)
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.fleet import meta_optimizers as tmeta
from paddle_tpu_torch.parallel import TrainStep

from torch_mesh_helpers import assert_params_close, bridge

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def process_meshes():
    prev, tprev = jmesh.get_mesh(), tmesh.get_mesh()
    yield
    jmesh.set_mesh(prev)
    tmesh.set_mesh(tprev)


def _problem(seed=0, n=64, din=8):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, din).astype("float32")
    w = rng.rand(din, 1).astype("float32")
    return x, x @ w + 0.01 * rng.randn(n, 1).astype("float32")


class _JaxMSE(jnn.Layer):
    def forward(self, pred, label):
        return paddle.mean((pred - label) ** 2)


def _pair(seed, din=8):
    paddle.seed(seed)
    jm = jnn.Linear(din, 1)
    return jm, bridge(jm, torch.nn.Linear(din, 1))


def _dp8():
    return (jdist.build_mesh(dp=8, devices=jax.devices()[:8]),
            build_mesh(dp=8, devices=["cpu"] * 8))


def test_strategy_is_the_jax_packages(tmp_path):
    ours, theirs = fleet.DistributedStrategy(), jfleet.DistributedStrategy()
    assert ours.__dict__ == theirs.__dict__
    theirs.sharding = True
    theirs.hybrid_configs["mp_degree"] = 2
    theirs.save_to_prototxt(str(tmp_path / "s.json"))
    ours.load_from_prototxt(str(tmp_path / "s.json"))
    assert ours.__dict__ == theirs.__dict__


def test_fleet_init_builds_the_hybrid_mesh():
    for hybrid in (dict(mp_degree=2, pp_degree=2),
                   dict(dp_degree=2, sharding_degree=4),
                   dict(sep_degree=2, mp_degree=2)):
        js, ts = jfleet.DistributedStrategy(), fleet.DistributedStrategy()
        js.hybrid_configs.update(hybrid)
        ts.hybrid_configs.update(hybrid)
        jfleet.init(is_collective=True, strategy=js)
        mesh = fleet.init(is_collective=True, strategy=ts,
                          devices=["cpu"] * 8)
        assert mesh is get_mesh() and is_initialized()
        assert mesh.shape == dict(jmesh.get_mesh().shape), hybrid
        assert fleet.worker_index() == 0 and fleet.is_first_worker()
        assert fleet.worker_num() == mesh.shape["dp"] * mesh.shape[
            "sharding"] == get_world_size()
        hcg = fleet.get_hybrid_communicate_group()
        assert hcg.get_model_parallel_world_size() == mesh.shape["mp"]
        assert hcg.get_pipe_parallel_world_size() == mesh.shape["pp"]
        assert fleet.get_strategy() is ts
    net = torch.nn.Linear(4, 1)
    with pytest.raises(ValueError, match="PipelineLayer"):
        ts = fleet.DistributedStrategy()
        ts.hybrid_configs["pp_degree"] = 2
        fleet.init(strategy=ts, devices=["cpu"] * 8)
        fleet.distributed_model(net)


def test_build_train_step_picks_each_meta_optimizer():
    _, mesh = _dp8()
    picks = {"adaptive_localsgd": tmeta.AdaptiveLocalSGDStep,
             "localsgd": tmeta.LocalSGDStep, "dgc": tmeta.DGCStep,
             "fp16_allreduce": tmeta.FP16AllReduceStep, None: TrainStep}
    for flag, cls in picks.items():
        s = fleet.DistributedStrategy()
        if flag:
            setattr(s, flag, True)
        net = torch.nn.Linear(8, 1)
        opt = fleet.distributed_optimizer(
            topt.SGD(learning_rate=0.1, parameters=net.parameters(),
                     device="cpu"), s)
        step = fleet.build_train_step(net, opt, loss_fn=torch.nn.MSELoss(),
                                      strategy=s, mesh=mesh)
        assert type(step) is cls, flag
    # distributed_model's DataParallel is unwrapped by TrainStep
    set_mesh(None)
    fleet._fleet_state["strategy"] = fleet.DistributedStrategy()
    net = torch.nn.Linear(8, 1)
    dp = fleet.distributed_model(net)
    assert isinstance(dp, DataParallel)
    st = TrainStep(dp, topt.SGD(learning_rate=0.1,
                                parameters=net.parameters(), device="cpu"),
                   loss_fn=torch.nn.MSELoss(), mesh=mesh)
    assert st.model is net
    before = net.weight.detach().clone()
    x, y = _problem()
    st.step([x], [y])
    st.sync_to_layer()
    assert not torch.equal(net.weight, before)


def test_localsgd_k1_equals_synchronous_sgd():
    x, y = _problem(1)
    _, mesh = _dp8()
    _, a_net = _pair(3)
    _, b_net = _pair(3)
    a = tmeta.LocalSGDStep(a_net, topt.SGD(
        learning_rate=0.05, parameters=a_net.parameters(), device="cpu"),
        loss_fn=torch.nn.MSELoss(), mesh=mesh, k_steps=1)
    b = TrainStep(b_net, topt.SGD(learning_rate=0.05,
                                  parameters=b_net.parameters(),
                                  device="cpu"),
                  loss_fn=torch.nn.MSELoss(), mesh=mesh)
    for _ in range(5):
        a.step([x], [y])
        b.step([x], [y])
    a.sync_to_layer()
    b.sync_to_layer()
    torch.testing.assert_close(a_net.weight, b_net.weight, rtol=1e-4,
                               atol=1e-5)
    # each rank holds its own copy
    ptrs = {a.params[r]["weight"].data_ptr() for r in range(8)}
    assert len(ptrs) == 8


@pytest.mark.parametrize("kind", ["localsgd", "adaptive", "dgc", "fp16"])
def test_meta_optimizer_matches_jax(kind):
    _meta_case(kind, *_dp8())


MESHES = {"dp2_mp2": dict(dp=2, mp=2), "dp2_pp2": dict(dp=2, pp=2)}


@pytest.mark.parametrize("kind", ["localsgd", "adaptive", "dgc", "fp16"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_meta_optimizer_beside_non_data_axes_matches_jax(mesh, kind):
    """Over dp=2 beside mp=2 or pp=2: one state a data rank (JAX's
    ``dp`` is the data axes' product), and every rank of the mesh reads
    its data rank's parameters, which equal JAX's per-rank ones."""
    shape = MESHES[mesh]

    def replicas(js, ts):
        assert ts.dp == 2 and ts.data_ranks == [0, 2]
        for r in range(4):
            for k, t in ts.rank_params(r).items():
                want = np.asarray(js.params[k])
                if js.stack_params:
                    want = want[ts.mesh.index_in(r, ("dp", "sharding"))]
                np.testing.assert_allclose(t.detach().numpy(), want.T,
                                           atol=1e-5, rtol=1e-4, err_msg=k)

    _meta_case(kind, jdist.build_mesh(devices=jax.devices()[:4], **shape),
               build_mesh(devices=["cpu"] * 4, **shape), replicas)


def _meta_case(kind, jmesh_, tmesh_, before_sync=None):
    """Both packages' ``kind`` meta-optimizer on the same weights and
    batch: losses at rtol 1e-4, parameters after ``sync_to_layer`` at
    atol 1e-5 / rtol 1e-4; ``before_sync(js, ts)`` checks the steps
    before it."""
    din = 16 if kind == "dgc" else 8
    x, y = _problem(2, din=din)
    jm, tm = _pair(4, din=din)
    jo = jopt.SGD(learning_rate=0.1, parameters=jm.parameters())
    to = topt.SGD(learning_rate=0.1, parameters=tm.parameters(),
                  device="cpu")
    jl, tl = _JaxMSE(), torch.nn.MSELoss()
    if kind == "localsgd":
        js = jmeta.LocalSGDStep(jm, jo, loss_fn=jl, mesh=jmesh_, k_steps=2)
        ts = tmeta.LocalSGDStep(tm, to, loss_fn=tl, mesh=tmesh_, k_steps=2)
    elif kind == "adaptive":
        js = jmeta.AdaptiveLocalSGDStep(jm, jo, loss_fn=jl, mesh=jmesh_,
                                        init_k_steps=2)
        ts = tmeta.AdaptiveLocalSGDStep(tm, to, loss_fn=tl, mesh=tmesh_,
                                        init_k_steps=2)
    elif kind == "dgc":
        js = jmeta.DGCStep(jm, jo, loss_fn=jl, mesh=jmesh_, sparsity=0.75)
        ts = tmeta.DGCStep(tm, to, loss_fn=tl, mesh=tmesh_, sparsity=0.75)
    else:
        js = jmeta.FP16AllReduceStep(jm, jo, loss_fn=jl, mesh=jmesh_)
        ts = tmeta.FP16AllReduceStep(tm, to, loss_fn=tl, mesh=tmesh_)
    steps = 6 if kind == "adaptive" else 3
    jloss = [float(js.step([x], [y]).numpy()) for _ in range(steps)]
    tloss = [float(ts.step([x], [y])) for _ in range(steps)]
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    if kind == "adaptive":
        assert ts.k_steps == js.k_steps and ts._last_sync == js._last_sync
    if kind == "dgc":
        v = np.stack([ts.dgc_state[r]["weight"]["v"].numpy()
                      for r in range(ts.dp)])
        np.testing.assert_allclose(
            v, np.asarray(js.dgc_state["weight"]["v"]).transpose(0, 2, 1),
            atol=1e-5, rtol=1e-4)
    if before_sync is not None:
        before_sync(js, ts)
    js.sync_to_layer()
    ts.sync_to_layer()
    assert_params_close(jm, tm)


def test_collectives_in_a_parallel_region_match_jax():
    jm, tm = _dp8()
    jmesh.set_mesh(jm)
    xs = np.arange(8, dtype=np.float32)

    def jax_region(fn):
        return np.asarray(jax.jit(jdist.parallel_region(fn, axis="dp"))(xs))

    want_shift = jax_region(lambda x: jdist.p2p_shift(
        paddle.Tensor(x), axis="dp", shift=1)._data)

    def jax_sum(x):
        t = paddle.Tensor(x)
        jdist.all_reduce(t)
        return t._data

    want_sum = jax_region(jax_sum)
    region = lambda fn: collective.parallel_region(  # noqa: E731
        fn, axis="dp", mesh=tm)(torch.tensor(xs)).numpy()
    np.testing.assert_array_equal(region(
        lambda x: collective.p2p_shift(x, axis="dp", shift=1)), want_shift)
    np.testing.assert_array_equal(region(
        lambda x: collective.all_reduce(x.clone())), want_sum)
    np.testing.assert_array_equal(region(
        lambda x: collective.all_reduce(x.clone(), op="max")),
        np.full(8, 7.0))
    np.testing.assert_array_equal(region(
        lambda x: collective.broadcast(x.clone(), src=3)), np.full(8, 3.0))
    np.testing.assert_array_equal(region(
        lambda x: collective.reduce(x.clone(), dst=0)),
        np.r_[28.0, np.arange(1, 8)])
    np.testing.assert_array_equal(region(
        lambda x: torch.stack(collective.all_gather([], x)).sum(0)),
        np.full(8, 28.0))
    np.testing.assert_array_equal(region(
        lambda x: collective.scatter(x.clone(), [torch.full((1,), 10.0 + i)
                                                 for i in range(8)], src=0)),
        10.0 + np.arange(8))
    np.testing.assert_array_equal(region(
        lambda x: collective.reduce_scatter(
            x.clone(), [x * (i + 1) for i in range(8)])),
        28.0 * (np.arange(8) + 1))
    np.testing.assert_array_equal(region(
        lambda x: torch.cat(collective.alltoall(
            [x + 10 * i for i in range(8)], []))[:1]),
        np.arange(8) * 10.0)


def test_training_collectives_backward_is_the_transpose():
    """all-gather's backward reduce-scatters, all-reduce's sums the
    cotangents, reduce-scatter's all-gathers: each against autograd of
    the same function written with plain ops."""
    parts = [torch.randn(2, 3, dtype=torch.float64, requires_grad=True)
             for _ in range(4)]
    outs = collective.gather_parts(parts, 1)
    ws = [torch.randn(2, 12, dtype=torch.float64) for _ in range(4)]
    sum(float(r + 1) * (o * w).sum() for r, (o, w) in
        enumerate(zip(outs, ws))).backward()
    full = torch.cat([p.detach() for p in parts], 1).requires_grad_()
    sum(float(r + 1) * (full * w).sum() for r, w in enumerate(ws)).backward()
    for i, p in enumerate(parts):
        torch.testing.assert_close(p.grad, full.grad[:, 3 * i:3 * i + 3])
    for fn in (lambda ps: collective.reduce_parts(ps),
               lambda ps: collective.scatter_reduce_parts(ps, 1)):
        for p in parts:
            p.grad = None
        outs = fn(parts)
        gs = [torch.randn_like(o) for o in outs]
        torch.autograd.backward(outs, gs)
        ref = [p.detach().clone().requires_grad_() for p in parts]
        tot = sum(ref)
        refs = [tot] * 4 if outs[0].shape == tot.shape else list(
            tot.chunk(4, 1))
        torch.autograd.backward(refs, gs)
        for p, q in zip(parts, ref):
            torch.testing.assert_close(p.grad, q.grad)


def test_parallel_env_and_what_stays_unported():
    """One process: rank 0 of a world of one; ``spawn`` calls ``func``
    here, ``host_local_to_global`` is a no-op and
    ``global_from_replicated`` cuts each rank's rows, as the JAX
    package's do in one process.  (Across processes:
    ``test_torch_multiprocess.py``.)"""
    set_mesh(None)
    assert get_rank() == 0 and get_world_size() == 1
    assert not is_initialized()
    called = []
    spawn(called.append, args=(5,))
    assert called == [5]
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    assert tmesh.host_local_to_global(x) is x
    mesh = build_mesh(dp=2, mp=2, devices=["cpu"] * 4)
    g = tmesh.global_from_replicated(x, mesh)
    assert g.shape == (4, 2) and sorted(g.pieces) == [0, 1, 2, 3]
    for r, t in g.pieces.items():
        np.testing.assert_array_equal(t.numpy(), x[2 * (r // 2):
                                                   2 * (r // 2) + 2])
    set_mesh(build_mesh(dp=2, sharding=2, devices=["cpu"] * 4))
    assert get_world_size() == 4 and is_initialized()
    assert tmesh.batch_partition_spec((8, 3)) == (("dp", "sharding"), None)
    assert tmesh.batch_partition_spec((6, 3)) == ()


def test_save_persistables_round_trip(tmp_path):
    from paddle_tpu_torch.distributed.checkpoint import load_sharded
    net = torch.nn.Linear(3, 2)
    fleet.save_persistables(net, str(tmp_path))
    got = load_sharded(str(tmp_path / "persistables"),
                       template=net.state_dict())
    for k, v in net.state_dict().items():
        assert torch.equal(got[k], v)


def test_lockstep_runs_one_rank_at_a_time_in_a_fixed_order():
    """More rank threads than cores, a switch interval of 1 us: a shared
    read-modify-write loses no update (one rank runs at a time), the
    ranks take their turns in the same order on every run, an error in
    one rank reaches the caller, and a collective no other rank joins
    raises instead of hanging."""
    import sys
    import threading
    mesh = build_mesh(dp=16, devices=["cpu"] * 16)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runs = []
        for _ in range(2):
            shared = {"n": 0}
            order = []

            def body(r):
                def fn():
                    for i in range(50):
                        v = shared["n"]
                        for _ in range(10):
                            pass
                        shared["n"] = v + 1
                        if i % 10 == 0:
                            order.append(r)
                            collective.mesh_all_reduce(torch.ones(1), "dp")
                    return r
                return fn

            out = collective.run_ranks(mesh, {r: body(r) for r in range(16)})
            assert out == {r: r for r in range(16)}
            assert shared["n"] == 16 * 50
            runs.append(order)
        assert runs[0] == runs[1]

        def bad():
            raise KeyError("rank 3")

        fns = {r: (bad if r == 3 else body(r)) for r in range(16)}
        with pytest.raises(KeyError, match="rank 3"):
            collective.run_ranks(mesh, fns)
        lone = {r: (lambda: collective.mesh_all_reduce(torch.ones(1), "dp"))
                if r == 0 else (lambda: None) for r in range(16)}
        with pytest.raises(RuntimeError, match="no other rank joins"):
            collective.run_ranks(mesh, lone)
        assert threading.active_count() < 16
    finally:
        sys.setswitchinterval(old)
