"""The port's multi-process forms on the CPU, held to the JAX package:
one launch of two processes of two CPU ranks each over gloo
(``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2
--devices_per_proc 2 tests/torch_mp_worker.py``), whose every training
layout spans the processes — dp=4, ZeRO-2 over ``sharding=4``, Megatron
mp=4, and the pipeline's ``pp`` ring across the two processes under GPipe
and 1F1B — and whose losses equal the JAX package's ``TrainStep`` on a
4-device mesh of the same weights and global batch (the tolerance of
``test_multiprocess.py::test_launcher_fsdp_tp_parity``).  Beside them:
the cross-process ``parallel_region`` sum, ``p2p_shift`` forward and
backward, broadcast, scatter and alltoall, the multi-process feed, the
pipeline's digest check, ``fleet.util`` and its metrics, ``global_shuffle``,
a collective order that differs between processes, ``spawn``, and the
launcher's abort-all."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet import DistributedStrategy
from paddle_tpu.distributed.fleet.meta_parallel import PipelineLayer
from paddle_tpu.distributed.sharding import (ColumnParallelLinear,
                                             RowParallelLinear)
from paddle_tpu.parallel.train_step import TrainStep

import torch_mp_worker as worker

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RECORDS = 12


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["PADDLE_DIST_TIMEOUT_S"] = "60"
    env.update(extra)
    return env


def _results(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("RESULT "):
            _, tag, rank, value = line.split(" ", 3)
            out[tag] = json.loads(value)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One launch: ``{process: {tag: result}}``."""
    tmp = tmp_path_factory.mktemp("mp")
    shuffle = tmp / "records.txt"
    shuffle.write_text("".join(f"{i}\n" for i in range(RECORDS)))
    logs = tmp / "logs"
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--devices_per_proc", "2",
         "--log_dir", str(logs), os.path.join(HERE, "torch_mp_worker.py"),
         "--size", "small", "--shuffle-file", str(shuffle)],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=180)
    texts = [(logs / f"workerlog.{r}").read_text() for r in range(2)]
    assert proc.returncode == 0, (proc.stderr[-2000:], texts[0][-3000:],
                                  texts[1][-3000:])
    res = [_results(t) for t in texts]
    for r in range(2):
        assert res[r].get("done") is True, texts[r][-3000:]
        assert res[r]["world"] == {"processes": 2, "backend": "gloo",
                                   "ranks": 4}
    return res


@pytest.fixture()
def jax_process_mesh():
    prev = jmesh.get_mesh()
    yield
    jmesh.set_mesh(prev)


class _MSE(jnn.Layer):
    def forward(self, p, label):
        return paddle.mean((p - label) ** 2)


def _jax_losses(kind):
    """The layout's losses from the JAX package's ``TrainStep`` on a
    4-device mesh, the same weights and global batch, one process."""
    if kind.startswith("pp"):
        blocks = [jnn.Sequential(jnn.Linear(8, 8), jnn.Tanh())
                  for _ in range(2)]
        net = PipelineLayer(pre=jnn.Linear(8, 8), blocks=blocks,
                            post=jnn.Linear(8, 1))
        shape = dict(dp=2, pp=2)
    elif kind == "dp":
        net, shape = jnn.Linear(8, 1), dict(dp=4)
    elif kind == "zero2":
        net = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(),
                             jnn.Linear(16, 1))
        shape = dict(sharding=4)
    else:
        net = jnn.Sequential(
            ColumnParallelLinear(8, 16, gather_output=False), jnn.Tanh(),
            RowParallelLinear(16, 1, input_is_parallel=True))
        shape = dict(mp=4)
    net.set_state_dict(worker.small_weights(kind[:2] if kind.startswith("pp")
                                            else kind))
    mesh = jmesh.set_mesh(jmesh.build_mesh(devices=jax.devices()[:4],
                                           **shape))
    strategy = DistributedStrategy()
    if kind == "zero2":
        strategy.sharding = True
        strategy.sharding_configs.update({"stage": 2})
        opt = jopt.Adam(learning_rate=0.05, parameters=net.parameters())
    else:
        opt = jopt.SGD(learning_rate=0.05 if kind.startswith("pp") else 0.1,
                       parameters=net.parameters())
    if kind.startswith("pp"):
        strategy.pipeline = True
        strategy.pipeline_configs["accumulate_steps"] = 2
        strategy.pipeline_configs["schedule_mode"] = (
            "1F1B" if kind.endswith("1f1b") else "F-then-B")
    step = TrainStep(net, opt, loss_fn=_MSE(), strategy=strategy, mesh=mesh,
                     donate=False)
    x, y = worker.small_data()
    return [float(step.step([x], [y]).numpy())
            for _ in range(worker.SMALL_STEPS[kind])]


@pytest.mark.parametrize("kind", worker.SMALL_LAYOUTS)
def test_layout_spanning_processes_matches_jax(run, kind, jax_process_mesh):
    l0, l1 = run[0][kind]["losses"], run[1][kind]["losses"]
    np.testing.assert_allclose(l0, l1, rtol=1e-6)
    np.testing.assert_allclose(l0, _jax_losses(kind), rtol=1e-4, atol=1e-6)
    assert l0[-1] < l0[0]


def test_parallel_region_sums_across_processes(run):
    # ranks contribute 1 + 1 + 2 + 2 over the 4 shards
    assert run[0]["psum"] == [6.0, 6.0] and run[1]["psum"] == [6.0, 6.0]


def test_collectives_across_processes_match_jax(run, jax_process_mesh):
    """``p2p_shift`` forward and backward (the opposite shift) and the
    exchanges that cross as gathered parts, over dp=4 spanning the two
    processes, against the JAX package's ``shard_map`` on 4 devices."""
    from paddle_tpu.distributed import collective as jdist
    import jax.numpy as jnp
    jm = jmesh.set_mesh(jmesh.build_mesh(devices=jax.devices()[:4], dp=4))
    xs = np.arange(4, dtype=np.float32)

    def jax_region(fn):
        return jax.jit(jdist.parallel_region(fn, axis="dp", mesh=jm))

    shift = jax_region(lambda x: jdist.p2p_shift(
        paddle.Tensor(x), axis="dp", shift=1)._data)
    w = np.arange(1, 5, dtype=np.float32)
    want = {
        "shift": np.asarray(shift(xs)),
        "shift_grad": np.asarray(jax.grad(
            lambda x: jnp.sum(w * shift(x)))(xs)),
        "broadcast": np.asarray(jax_region(lambda x: jdist.broadcast(
            paddle.Tensor(x), src=3)._data)(xs)),
        "scatter": np.asarray(jax_region(lambda x: jdist.scatter(
            paddle.Tensor(x), [paddle.Tensor(jnp.full((1,), 10.0 + i))
                               for i in range(4)], src=0)._data)(xs)),
        "alltoall": np.asarray(jax_region(lambda x: jnp.concatenate(
            [t._data for t in jdist.alltoall(
                [paddle.Tensor(x + 10 * i) for i in range(4)], [])]))(xs)),
    }
    got = {k: {} for k in want}
    for p in range(2):
        for k, by_rank in run[p]["collectives"].items():
            assert sorted(by_rank) == [str(2 * p), str(2 * p + 1)], k
            got[k].update({int(r): v for r, v in by_rank.items()})
    for k, v in want.items():
        np.testing.assert_array_equal(
            np.concatenate([got[k][r] for r in range(4)]), v, err_msg=k)


def test_multi_process_feed(run):
    x, _ = worker.small_data()
    rows = np.split(x, 4)
    for p in range(2):
        feed = run[p]["feed"]
        assert feed["shape"] == [16, 8] and feed["ranks"] == [2 * p,
                                                             2 * p + 1]
        for r in (2 * p, 2 * p + 1):
            np.testing.assert_array_equal(feed["host_local"][str(r)],
                                          rows[r])
            np.testing.assert_array_equal(feed["replicated"][str(r)],
                                          rows[r])
        assert "does not divide" in run[p]["feed_odd"]


def test_pipeline_refuses_different_batches(run):
    for p in range(2):
        assert "DIFFERENT batches" in run[p]["digest"], run[p]["digest"]


def test_fleet_util_and_metrics_across_processes(run):
    vals = [np.arange(3, dtype=np.float64) + 10 * r for r in range(2)]
    for p in range(2):
        u = run[p]["util"]
        np.testing.assert_allclose(u["sum"], vals[0] + vals[1])
        np.testing.assert_allclose(u["max"], np.maximum(*vals))
        np.testing.assert_allclose(u["min"], np.minimum(*vals))
        assert u["gather"] == [{"r": 0}, {"r": 1}]
        assert u["shard"] == (["f0", "f1", "f2"] if p == 0
                              else ["f3", "f4"])
        assert u["metric_sum"] == pytest.approx(vals[0].sum()
                                                + vals[1].sum())
        assert u["acc"] == pytest.approx((3 + 4) / 20)
        assert u["mae"] == pytest.approx((0.5 + 1.0 + 0.5 + 2.0) / 8)
        assert u["rmse"] == pytest.approx(np.sqrt((1 + 0 + 1 + 2) / 8))
        pos = np.array([2.0, 4.0, 7.0])
        neg = np.array([5.0, 4.0, 2.0])
        area, tp, fp = 0.0, 0.0, 0.0
        for i in range(2, -1, -1):
            area += neg[i] * (2 * tp + pos[i]) / 2
            tp, fp = tp + pos[i], fp + neg[i]
        assert u["auc"] == pytest.approx(area / (tp * fp))


def test_global_shuffle_partitions_records(run):
    a, b = run[0]["shuffle"], run[1]["shuffle"]
    assert not set(a) & set(b)
    assert sorted(a + b) == list(range(RECORDS))


def test_collective_order_mismatch_raises(run):
    for p in range(2):
        msg = run[p]["order"]
        assert "out of order" in msg, msg
        assert "all_reduce" in msg and "all_gather" in msg


def test_rank_streams_do_not_depend_on_the_process(run):
    """Each rank draws what the same rank draws when one process runs all
    four (the seeds come from the mesh's first process)."""
    from paddle_tpu_torch.distributed import build_mesh, run_ranks
    torch.manual_seed(123)
    one = run_ranks(build_mesh(dp=4, devices=["cpu"] * 4),
                    {r: (lambda: float(torch.rand(1))) for r in range(4)})
    got = {**run[0]["rng"], **run[1]["rng"]}
    assert {int(r): v for r, v in got.items()} == one


def test_spawn_calls_func(run):
    assert run[0]["spawn"] == [0] and run[1]["spawn"] == [1]


def test_launcher_aborts_all_workers():
    """Reference launch_utils.py:526 watch loop: one failed worker aborts
    the rest; the launcher exits promptly with the failing worker's
    code."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--devices_per_proc", "1",
         os.path.join(HERE, "multiprocess_worker_abort.py")],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=90)
    elapsed = time.monotonic() - t0
    assert proc.returncode == 7, (proc.returncode, proc.stderr[-1000:])
    assert "aborting all workers" in proc.stderr
    assert elapsed < 60, elapsed


def test_metric_inputs_gather_across_processes(monkeypatch):
    """``hapi.Model``'s metric inputs over a mesh spanning processes are
    every process's, joined along the batch (0-d ones kept), where the
    JAX package's ``_metric_to_host`` all-gathers a multi-host array."""
    from paddle_tpu_torch.distributed import process
    from paddle_tpu_torch.hapi.model import _metric_to_host
    other = [[np.full((2, 1), 9.0, np.float32), np.float32(1.0)]]
    monkeypatch.setattr(process, "all_gather_object",
                        lambda obj, **kw: [obj, other])
    got = _metric_to_host([[torch.zeros(3, 1), torch.tensor(1.0)]],
                          across=True)
    np.testing.assert_array_equal(got[0][0], [[0.0], [0.0], [0.0], [9.0],
                                              [9.0]])
    assert got[0][1] == 1.0


def test_backend_follows_the_topology():
    """gloo where processes share a card or run on the CPU, NCCL where
    every process's cards are its own (that branch is not run here: the
    CPU has no NCCL, and the card machine one card)."""
    from paddle_tpu_torch.distributed.process import choose_backend
    assert choose_backend([["GPU-a"], ["GPU-b"]]) == "nccl"
    assert choose_backend([["GPU-a", "GPU-b"], ["GPU-c"]]) == "nccl"
    assert choose_backend([["GPU-a"], ["GPU-a"]]) == "gloo"
    assert choose_backend([[], []]) == "gloo"
    assert choose_backend([["GPU-a"], []]) == "gloo"
