"""Job-level fault recovery through the port's
``incubate.checkpoint.TrainEpochRange`` (the counterpart of
``tests/test_fault_recovery.py``): a training process dies hard after
epoch 3's steps, before its snapshot, is relaunched, resumes at epoch 3
from the last snapshot and finishes with the weights of an uninterrupted
run; the snapshot is the JAX package's file, and a job snapshotted by
either package resumes in the other."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(__file__),
                      "torch_fault_recovery_worker.py")


def _run(tmp, ckpt_name, out_name, kill_after=-1):
    env = dict(os.environ, DEVICE="cpu",
               PADDLE_RUNNING_ENV="PADDLE_EDL_AUTO_CHECKPOINT",
               PADDLE_CHECKPOINT_DIR=str(tmp / ckpt_name),
               OUT_PATH=str(tmp / out_name),
               KILL_AFTER_EPOCH=str(kill_after), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, WORKER], env=env,
                          capture_output=True, text=True, timeout=120)


def test_kill_and_resume_matches_clean_run(tmp_path):
    clean = _run(tmp_path, "ck_clean", "clean.npz")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "DONE" in clean.stdout

    killed = _run(tmp_path, "ck_fault", "fault.npz", kill_after=3)
    assert killed.returncode == 137
    assert "EPOCH 3" in killed.stdout
    assert not (tmp_path / "fault.npz").exists()
    with open(tmp_path / "ck_fault" / "faultjob" / "ckpt.pkl", "rb") as f:
        snap = pickle.load(f)
    assert snap["epoch"] == 2 and sorted(snap) == [
        "epoch", "layers", "optimizers", "static"]
    assert all(isinstance(v, np.ndarray) for v in snap["layers"][0].values())

    resumed = _run(tmp_path, "ck_fault", "fault.npz")
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert resumed.stdout.splitlines()[0].startswith("EPOCH 3"), \
        resumed.stdout

    a = np.load(tmp_path / "clean.npz")
    b = np.load(tmp_path / "fault.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def _net(pkg):
    """The worker's model, its parameters named as a checkpoint that
    crosses packages needs (``ParamAttr(name=...)``): the optimizer's
    state is keyed by parameter name, and each package counts its
    default names on its own."""
    attr = lambda n: pkg.ParamAttr(name=n)  # noqa: E731
    return pkg.nn.Sequential(
        pkg.nn.Linear(6, 16, weight_attr=attr("fc0.w"),
                      bias_attr=attr("fc0.b")),
        pkg.nn.Tanh(),
        pkg.nn.Linear(16, 2, weight_attr=attr("fc1.w"),
                      bias_attr=attr("fc1.b")))


def _train(pkg, net, opt, epochs, stop_at=None):
    """The worker's loop under ``pkg.incubate.checkpoint.TrainEpochRange``
    (3 Momentum steps an epoch); ``stop_at`` ends the job after that
    epoch's steps, before its snapshot.  Returns the epochs run."""
    import importlib
    ckpt = importlib.import_module(pkg.__name__ + ".incubate.checkpoint")
    rs = np.random.RandomState(0)
    x = pkg.to_tensor(rs.rand(8, 6).astype("float32"))
    y = pkg.to_tensor(rs.randint(0, 2, (8,)).astype("int64"))
    lossf = pkg.nn.CrossEntropyLoss()
    ran = []
    for epoch in ckpt.TrainEpochRange(epochs, name="crossjob").attach(
            net, opt).get():
        for _ in range(3):
            lossf(net(x), y).backward()
            opt.step()
            opt.clear_grad()
        ran.append(epoch)
        if epoch == stop_at:
            break
    return ran


def _arrays(state):
    return {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
            for k, v in state.items() if k != "__step__"}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_resumes_in_the_other_package(tmp_path, monkeypatch,
                                               direction):
    """A job snapshotted by one package's ``TrainEpochRange`` (stopped
    after epoch 3's steps, before its snapshot) resumes in the other's at
    epoch 3 with the snapshot's weights and optimizer state, and finishes
    with the weights of an uninterrupted run of the first package; the
    starting weights cross with ``convert.load_layer_state``."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu as J
    import paddle_tpu_torch as P
    from paddle_tpu_torch.convert import export_layer_state, load_layer_state
    from paddle_tpu_torch.core import device as core_device
    monkeypatch.setattr(core_device, "_current", core_device._current)
    P.set_device("cpu")
    monkeypatch.setenv("PADDLE_RUNNING_ENV", "PADDLE_EDL_AUTO_CHECKPOINT")
    J.seed(7)
    jnets = [_net(J) for _ in range(2)]
    start = {k: v.numpy() for k, v in jnets[0].state_dict().items()}
    jnets[1].set_state_dict(start)
    pnets = [load_layer_state(_net(P), start) for _ in range(2)]
    writer, reader = (J, P) if direction == "jax_to_port" else (P, J)
    wnets, rnets = (jnets, pnets) if writer is J else (pnets, jnets)

    def opt(pkg, net):
        return pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                      parameters=net.parameters())

    monkeypatch.setenv("PADDLE_CHECKPOINT_DIR", str(tmp_path / "clean"))
    assert _train(writer, wnets[0], opt(writer, wnets[0]), 6) == list(
        range(6))
    monkeypatch.setenv("PADDLE_CHECKPOINT_DIR", str(tmp_path / "fault"))
    wopt = opt(writer, wnets[1])
    assert _train(writer, wnets[1], wopt, 6, stop_at=3) == [0, 1, 2, 3]
    with open(tmp_path / "fault" / "crossjob" / "ckpt.pkl", "rb") as f:
        snap = pickle.load(f)
    assert snap["epoch"] == 2

    # the reader restores the snapshot as it attaches
    from importlib import import_module
    rnet = rnets[1]
    ropt = opt(reader, rnet)
    r = import_module(reader.__name__ + ".incubate.checkpoint") \
        .TrainEpochRange(6, name="crossjob").attach(rnet, ropt)
    assert r._start == 3
    got = (export_layer_state(rnet) if reader is P else
           {k: v.numpy() for k, v in rnet.state_dict().items()})
    want = {k: np.asarray(v) for k, v in snap["layers"][0].items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rstate = (ropt.paddle_state_dict() if reader is P else
              ropt.state_dict())
    assert rstate["__step__"] == snap["optimizers"][0]["__step__"] == 9
    got, want = _arrays(rstate), _arrays(snap["optimizers"][0])
    assert sorted(got) == sorted(want) == [
        f"fc{i}.{w}__velocity" for i in (0, 1) for w in "bw"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # ... and finishes as the uninterrupted run did
    assert _train(reader, rnet, ropt, 6) == [3, 4, 5]
    clean = (export_layer_state(wnets[0]) if writer is P else
             {k: v.numpy() for k, v in wnets[0].state_dict().items()})
    done = (export_layer_state(rnet) if reader is P else
            {k: v.numpy() for k, v in rnet.state_dict().items()})
    for k in clean:
        np.testing.assert_allclose(done[k], clean[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_disabled_without_the_env_gate(tmp_path, monkeypatch):
    from paddle_tpu_torch.incubate.checkpoint import train_epoch_range
    monkeypatch.delenv("PADDLE_RUNNING_ENV", raising=False)
    monkeypatch.setenv("PADDLE_CHECKPOINT_DIR", str(tmp_path))
    assert list(train_epoch_range(3, name="off")) == [0, 1, 2]
    assert not (tmp_path / "off").exists()
