"""The port's ``save`` / ``load`` (``framework/io.py``) against the JAX
package's: ``test_io_amp_jit.py``'s ``TestSaveLoad`` cases through the
port, and files crossing between the packages in both directions — a
state dict written by ``paddle_tpu.save`` loads into the port's layer and
gives equal eval outputs (rtol 1e-6), and the other way round; the
optimizer's ``__step__`` and moments cross too."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.core import device as core_device

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


def _mlp(pkg):
    return pkg.nn.Sequential(pkg.nn.Linear(3, 4), pkg.nn.Tanh(),
                             pkg.nn.Linear(4, 2))


# -- test_io_amp_jit.py TestSaveLoad ----------------------------------------

class TestSaveLoad:
    def test_state_dict_roundtrip(self, tmp_path):
        net = nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 2))
        path = str(tmp_path / "model.pdparams")
        P.save(net.state_dict(), path)
        loaded = P.load(path)
        net2 = nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 2))
        net2.set_state_dict(loaded)
        np.testing.assert_array_equal(net2[0].weight.numpy(),
                                      net[0].weight.numpy())

    def test_save_nested_structures(self, tmp_path):
        obj = {"a": P.ones([2]), "b": [1, 2, {"c": "x"}],
               "t": (torch.arange(3), np.arange(2))}
        path = str(tmp_path / "obj.pd")
        P.save(obj, path)
        loaded = P.load(path)
        np.testing.assert_array_equal(loaded["a"].numpy(), [1, 1])
        assert loaded["b"][2]["c"] == "x"
        assert isinstance(loaded["t"], tuple)
        np.testing.assert_array_equal(loaded["t"][0].numpy(), [0, 1, 2])
        np.testing.assert_array_equal(loaded["t"][1], [0, 1])
        raw = P.load(path, return_numpy=True)
        assert isinstance(raw["a"], np.ndarray)

    def test_optimizer_checkpoint(self, tmp_path):
        net = nn.Linear(2, 2)
        opt = optimizer.Adam(learning_rate=0.01,
                             parameters=net.parameters())
        net(P.ones([1, 2])).sum().backward()
        opt.step()
        P.save(opt.paddle_state_dict(), str(tmp_path / "opt.pdopt"))
        loaded = P.load(str(tmp_path / "opt.pdopt"))
        assert loaded["__step__"] == 1


def test_handle_metadata_and_bf16(tmp_path):
    p = P.Parameter(np.ones((2, 2), np.float32), name="w_kept")
    b = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    P.save({"p": p, "b": b}, str(tmp_path / "x.pd"))
    got = P.load(str(tmp_path / "x.pd"))
    assert got["p"].name == "w_kept" and not got["p"].stop_gradient
    assert got["b"].dtype == "float32" and not got["b"].stop_gradient
    raw = J.load(str(tmp_path / "x.pd"))
    assert raw["p"].name == "w_kept"


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_files_cross_between_packages(tmp_path, direction):
    x = np.random.RandomState(0).rand(5, 3).astype(np.float32)
    path = str(tmp_path / "net.pdparams")
    J.seed(1)
    P.seed(2)
    jnet, pnet = _mlp(J), _mlp(P)
    if direction == "jax_to_port":
        J.save(jnet.state_dict(), path)
        pnet.set_state_dict(P.load(path))
    else:
        P.save(pnet.state_dict(), path)
        jnet.set_state_dict(J.load(path))
    jnet.eval()
    pnet.eval()
    np.testing.assert_allclose(pnet(P.to_tensor(x)).numpy(),
                               jnet(J.to_tensor(x)).numpy(), rtol=1e-6,
                               atol=1e-7)


def test_optimizer_state_crosses(tmp_path):
    """One Adam step in each package from the same weights and gradient;
    the JAX state saved by ``paddle_tpu.save`` loads into the port's
    optimizer (names mapped) and equals the port's own."""
    J.seed(1)
    jnet = J.nn.Linear(3, 2)
    pnet = P.nn.Linear(3, 2)
    pnet.set_state_dict({k: v.numpy() for k, v in
                         jnet.state_dict().items()})
    x = np.random.RandomState(3).rand(4, 3).astype(np.float32)
    jopt = J.optimizer.Adam(learning_rate=0.1,
                            parameters=jnet.parameters())
    popt = P.optimizer.Adam(learning_rate=0.1,
                            parameters=pnet.parameters())
    (jnet(J.to_tensor(x)) ** 2).sum().backward()
    jopt.step()
    (pnet(P.to_tensor(x)) ** 2).sum().backward()
    popt.step()
    J.save(jopt.state_dict(), str(tmp_path / "opt.pdopt"))
    state = P.load(str(tmp_path / "opt.pdopt"), return_numpy=True)
    assert state["__step__"] == 1
    jnames = [p.name for p in jnet.parameters()]
    pnames = [p.name for p in pnet.parameters()]
    moved = {k.replace(jn, pn, 1): v for k, v in state.items()
             for jn, pn in zip(jnames, pnames) if str(k).startswith(jn)}
    moved["__step__"] = state["__step__"]
    fresh = P.optimizer.Adam(learning_rate=0.1,
                             parameters=pnet.parameters())
    fresh.set_state_dict(moved)
    want = popt.paddle_state_dict()
    got = fresh.paddle_state_dict()
    assert got["__step__"] == want["__step__"] == 1
    for k, v in want.items():
        if k != "__step__":
            np.testing.assert_allclose(got[k].cpu().numpy(),
                                       v.cpu().numpy(), rtol=1e-6,
                                       atol=1e-8)
