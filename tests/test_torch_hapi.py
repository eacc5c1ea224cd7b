"""The port's ``hapi.Model``, callbacks, ``metric`` and
``TrainStep(metrics=...)`` held to the JAX package's on the CPU:
``test_hapi_metrics.py``'s cases through the port (GPipe metrics and the
1F1B warning included), and the same fit through both packages from the
same weights without dropout — per-step losses within 1e-5 relative,
metrics equal, evaluation and prediction equal; ``Model`` checkpoints
crossing between the packages; ``flops`` exactly 2 x the matrix
products' multiply-adds and at most the JAX package's XLA count."""
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as paddle
from paddle_tpu_torch import metric, nn
from paddle_tpu_torch.core import device as core_device
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.parallel.train_step import TrainStep

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    paddle.set_device("cpu")
    yield
    core_device._current = prev


def _problem(n=128):
    rs = np.random.RandomState(0)
    x = rs.randn(n, 8).astype("float32")
    y = (x[:, :4].sum(1) > x[:, 4:].sum(1)).astype("int64")
    return x, y


def _net(pkg):
    return pkg.nn.Sequential(pkg.nn.Linear(8, 32), pkg.nn.ReLU(),
                             pkg.nn.Linear(32, 2))


def _model(pkg=paddle, net=None, lr=5e-3):
    pkg.seed(0)
    net = net or _net(pkg)
    m = pkg.Model(net)
    m.prepare(pkg.optimizer.Adam(learning_rate=lr,
                                 parameters=net.parameters()),
              pkg.nn.CrossEntropyLoss(), metrics=pkg.metric.Accuracy())
    return m


def _pair(lr=5e-3):
    """The same MLP in both packages, the port's carrying the JAX
    weights."""
    jm = _model(J, lr=lr)
    pnet = _net(paddle)
    pnet.set_state_dict({k: v.numpy() for k, v in
                         jm.network.state_dict().items()})
    return jm, _model(paddle, net=pnet, lr=lr)


# -- test_hapi_metrics.py ---------------------------------------------------

class TestTrainMetrics:
    def test_train_batch_returns_metrics(self):
        m = _model()
        x, y = _problem()
        out = m.train_batch([x[:32]], [y[:32]])
        assert len(out) == 2
        assert 0.0 <= out[1] <= 1.0

    def test_fit_accumulates_train_accuracy(self):
        m = _model()
        x, y = _problem()
        ds = TensorDataset([x, y])
        seen = []

        class Probe(paddle.hapi.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                if logs and "acc" in logs:
                    seen.append(logs["acc"])

        m.fit(ds, batch_size=32, epochs=6, verbose=0, callbacks=[Probe()])
        assert seen and seen[-1] > 0.7, seen[-5:]
        logs = m.evaluate(ds, batch_size=32, verbose=0)
        assert abs(logs["acc"] - seen[-1]) < 0.15, (logs, seen[-1])

    def test_metrics_reset_per_epoch(self):
        m = _model()
        x, y = _problem(64)
        m.fit(TensorDataset([x, y]), batch_size=32, epochs=2, verbose=0)
        assert m._metrics[0].total[0] <= 64


class TestFlops:
    def test_flops_counts_matmuls(self):
        m = _model()
        flops = m.flops(input_size=[1, 8])
        # exactly the products' 2 x multiply-adds; XLA's count (the JAX
        # package's) adds the elementwise work
        assert flops == 2 * (8 * 32 + 32 * 2), flops
        assert flops <= _model(J).flops(input_size=[1, 8])

    def test_flops_scales_with_batch(self):
        m = _model()
        f1 = m.flops(input_size=[1, 8])
        f8 = m.flops(input_size=[8, 8])
        assert f8 == 8 * f1, (f1, f8)


def _pipe_step(schedule):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer
    mesh = dist.build_mesh(dp=2, pp=4, devices=["cpu"] * 8)
    paddle.seed(0)
    blocks = [nn.Sequential(nn.Linear(8, 8), nn.Tanh()) for _ in range(4)]
    pipe = PipelineLayer(pre=nn.Linear(8, 8), blocks=blocks,
                         post=nn.Linear(8, 2))
    s = DistributedStrategy()
    s.pipeline = True
    s.pipeline_configs.update({"accumulate_steps": 2,
                               "schedule_mode": schedule})
    acc = metric.Accuracy()
    opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                parameters=pipe.parameters(), device="cpu")
    st = TrainStep(pipe, opt, loss_fn=nn.CrossEntropyLoss(), strategy=s,
                   mesh=mesh, donate=False, metrics=[acc])
    rs = np.random.RandomState(0)
    xb = rs.rand(8, 8).astype("float32")
    yb = rs.randint(0, 2, (8,)).astype("int64")
    return pipe, st, acc, xb, yb


class TestPipelineMetrics:
    def test_gpipe_train_metrics(self):
        pipe, st, acc, xb, yb = _pipe_step("F-then-B")
        with torch.no_grad():
            want = acc.compute(pipe(torch.from_numpy(xb)),
                               torch.from_numpy(yb))
        st.step([xb], [yb])
        assert st.last_metric_outs, "pipeline metrics dropped"
        (got,), = st.last_metric_outs
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        acc.update(*[np.asarray(v) for v in st.last_metric_outs[0]])
        assert 0.0 <= acc.accumulate() <= 1.0

    def test_1f1b_metrics_warns(self):
        _, st, _, xb, yb = _pipe_step("1F1B")
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            st.step([xb], [yb])
        assert any("1F1B" in str(r.message) for r in rec)
        assert st.last_metric_outs == []


# -- TrainStep(metrics=...) on one device, merged and over a mesh -----------

def _step(net, **kw):
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=net.parameters())
    return TrainStep(net, opt, loss_fn=nn.CrossEntropyLoss(),
                     metrics=[metric.Accuracy(topk=(1, 2))], **kw)


@pytest.mark.parametrize("how", ["gradient_merge", "mesh_dp2"])
def test_train_step_metrics_cover_the_batch(how):
    import types
    x, y = _problem(16)
    base = _net(paddle)
    state = {k: v.numpy() for k, v in base.state_dict().items()}
    one = _step(base, device="cpu")
    one.step([x], [y])
    net = _net(paddle)
    net.set_state_dict(state)
    if how == "gradient_merge":
        s = types.SimpleNamespace(gradient_merge=True,
                                  gradient_merge_configs={"k_steps": 2})
        other = _step(net, device="cpu", strategy=s)
    else:
        from paddle_tpu_torch import distributed as dist
        other = _step(net, mesh=dist.build_mesh(dp=2,
                                                devices=["cpu"] * 2))
    other.step([x], [y])
    (a,), = one.last_metric_outs
    (b,), = other.last_metric_outs
    assert tuple(a.shape) == (16, 2)
    np.testing.assert_array_equal(b.numpy(), a.numpy())


def test_accuracy_ties_rank_the_lower_index_first():
    pred = np.array([[0.5, 0.5, 0.1], [0.2, 0.7, 0.7]], np.float32)
    lab = np.array([[1], [2]], np.int64)
    got = metric.Accuracy(topk=(1, 2)).compute(torch.from_numpy(pred),
                                               torch.from_numpy(lab))
    want = J.metric.Accuracy(topk=(1, 2)).compute(J.to_tensor(pred),
                                                  J.to_tensor(lab))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), [[0, 1], [0, 1]])


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc",
                                  "accuracy"])
def test_host_metrics_equal_jax(name):
    rs = np.random.RandomState(4)
    preds = rs.rand(50, 2).astype(np.float32)
    labels = rs.randint(0, 2, (50, 1)).astype(np.int64)
    if name == "accuracy":
        got = metric.accuracy(paddle.to_tensor(preds),
                              paddle.to_tensor(labels), k=1)
        want = J.metric.accuracy(J.to_tensor(preds), J.to_tensor(labels))
        assert float(got) == float(want.numpy())
        return
    p = preds[:, 1] if name != "Auc" else preds
    mp, mj = getattr(metric, name)(), getattr(J.metric, name)()
    for lo in (0, 25):
        mp.update(p[lo:lo + 25], labels[lo:lo + 25])
        mj.update(p[lo:lo + 25], labels[lo:lo + 25])
    assert mp.accumulate() == mj.accumulate()
    assert mp.name() == mj.name()


# -- the same fit in both packages -------------------------------------------

class _Log(paddle.hapi.callbacks.Callback):
    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, step, logs=None):
        self.rows.append((logs["loss"], logs["acc"]))


class _JLog(J.hapi.callbacks.Callback):
    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, step, logs=None):
        self.rows.append((logs["loss"], logs["acc"]))


def test_fit_evaluate_predict_match_jax():
    x, y = _problem(96)
    jm, pm = _pair()
    jlog, plog = _JLog(), _Log()
    J.seed(21)
    jm.fit(J.io.TensorDataset([x, y]), batch_size=16, epochs=2,
           verbose=0, shuffle=True, callbacks=[jlog])
    paddle.seed(21)
    pm.fit(TensorDataset([x, y]), batch_size=16, epochs=2, verbose=0,
           shuffle=True, callbacks=[plog])
    assert len(plog.rows) == len(jlog.rows) == 12
    np.testing.assert_allclose([r[0] for r in plog.rows],
                               [r[0] for r in jlog.rows], rtol=1e-5)
    assert [r[1] for r in plog.rows] == [r[1] for r in jlog.rows]
    jl = jm.evaluate(J.io.TensorDataset([x, y]), batch_size=32, verbose=0)
    pl = pm.evaluate(TensorDataset([x, y]), batch_size=32, verbose=0)
    np.testing.assert_allclose(pl["loss"], jl["loss"], rtol=1e-5)
    assert pl["acc"] == jl["acc"]
    jp = jm.predict(J.io.TensorDataset([x]), batch_size=32,
                    stack_outputs=True)[0]
    pp = pm.predict(TensorDataset([x]), batch_size=32,
                    stack_outputs=True)[0]
    np.testing.assert_allclose(pp, jp, rtol=1e-5, atol=1e-6)


def test_fit_with_workers_equals_fit_without():
    x, y = _problem(64)
    losses = []
    for workers in (0, 2):
        m = _model()
        log = _Log()
        paddle.seed(5)
        m.fit(TensorDataset([x, y]), batch_size=16, epochs=1, verbose=0,
              num_workers=workers, callbacks=[log])
        losses.append([r[0] for r in log.rows])
        assert len(m.fit_wait_ms) == len(m.fit_step_ms) == 4
    assert losses[0] == losses[1]


# -- checkpoints --------------------------------------------------------------

def test_save_load_resumes_training(tmp_path):
    x, y = _problem(64)
    m = _model()
    for lo in (0, 32):
        m.train_batch([x[lo:lo + 32]], [y[lo:lo + 32]])
    path = str(tmp_path / "ck" / "m")
    m.save(path)
    assert os.path.exists(path + ".pdparams")
    assert os.path.exists(path + ".pdopt")
    fresh = _model(net=_net(paddle))
    fresh.load(path)
    want = m.predict_batch([x[:8]]).numpy()
    np.testing.assert_array_equal(fresh.predict_batch([x[:8]]).numpy(),
                                  want)
    a = m.train_batch([x[:32]], [y[:32]])[0]
    b = fresh.train_batch([x[:32]], [y[:32]])[0]
    np.testing.assert_allclose(b, a, rtol=1e-6)
    assert fresh._optimizer._step_count == m._optimizer._step_count


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_model_checkpoints_cross(tmp_path, direction):
    x, _ = _problem(16)
    path = str(tmp_path / "m")
    jm, pm = _model(J), _model(paddle)
    if direction == "jax_to_port":
        jm.save(path)
        pm.load(path, reset_optimizer=True)
    else:
        pm.save(path)
        jm.load(path, reset_optimizer=True)
    np.testing.assert_allclose(pm.predict_batch([x]).numpy(),
                               jm.predict_batch([x]).numpy(), rtol=1e-6,
                               atol=1e-7)


# -- summary, top-level helpers, callbacks -----------------------------------

def test_summary_and_top_level_match_jax(capsys):
    net_p, net_j = _net(paddle), _net(J)
    sp = paddle.summary(net_p, (1, 8))
    sj = J.summary(net_j, (1, 8))
    assert sp == sj
    out = capsys.readouterr().out
    assert "Linear" in out and "[1, 32]" in out
    assert paddle.flops(net_p, (1, 8)) == J.flops(net_j, (1, 8))
    assert _model().summary() == sp


def test_callbacks(tmp_path):
    x, y = _problem(64)
    ds = TensorDataset([x, y])
    cb = paddle.callbacks
    m = _model(lr=1e-3)
    sched = paddle.optimizer.lr.StepDecay(0.5, step_size=1, gamma=0.5)
    m._optimizer._learning_rate = sched
    vdl = cb.VisualDL(log_dir=str(tmp_path / "vdl"))
    m.fit(ds, batch_size=16, epochs=3, verbose=0,
          save_dir=str(tmp_path / "ck"),
          callbacks=[vdl, cb.LRScheduler(by_step=True)])
    assert os.path.exists(str(tmp_path / "ck" / "final.pdparams"))
    assert os.path.exists(str(tmp_path / "ck" / "0.pdparams"))
    assert sched.last_epoch == 12 and sched() == 0.5 * 0.5 ** 12
    with open(str(tmp_path / "vdl" / "scalars.jsonl")) as f:
        assert '"tag": "train"' in f.read()

    m2 = _model()
    m2.prepare(paddle.optimizer.SGD(learning_rate=1.0,
                                    parameters=m2.network.parameters()),
               nn.CrossEntropyLoss())
    plateau = cb.ReduceLROnPlateau(monitor="loss", patience=1, factor=0.5,
                                   verbose=0, min_delta=10.0)
    m2.fit(ds, batch_size=16, epochs=3, verbose=0, callbacks=[plateau])
    assert m2._optimizer.get_lr() < 1.0

    m3 = _model()
    stop = cb.EarlyStopping(monitor="loss", patience=0, min_delta=10.0)
    ends = []

    class Count(cb.Callback):
        def on_epoch_end(self, epoch, logs=None):
            ends.append(epoch)

    m3.fit(ds, eval_data=ds, batch_size=16, epochs=5, verbose=0,
           callbacks=[stop, Count()])
    assert ends == [0, 1]
