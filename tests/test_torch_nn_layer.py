"""The port's ``nn.Layer`` system held to the JAX package's on the CPU.

* ``test_nn.py``'s ``TestLayerSystem`` and the rest of the Layer surface:
  parameters and buffers as handles, structured ``state_dict`` names,
  ``set_state_dict``, train / eval, ``apply``, forward hooks and their
  removal, the containers, ``create_parameter`` with ``ParamAttr``,
  ``to`` / ``astype``, ``deepcopy``.
* A network of many layer kinds carried from a JAX network by
  ``set_state_dict`` of its ``state_dict()`` computes the JAX network's
  function (rtol/atol 1e-4), both ways through ``convert``.
* The initializers: bounds and moments of every random one, exact
  values of the deterministic ones against the JAX package's, the same
  values twice under one seed, ``ParamAttr`` over
  ``set_global_initializer`` over the layer's default.
* An MLP trained eagerly (``Adam(parameters=net.parameters())``,
  ``loss.backward()``) and through ``TrainStep`` tracks the JAX
  package's losses for 3 steps (rtol 1e-4); the WGAN-GP critic of
  ``test_double_grad.py`` as an ``nn.Sequential`` (the ``test_autograd``
  case slice 17 deferred) gives the JAX package's gradients (1e-4).
* The torch code that ``nn/layer/base.py`` says relies on the Layer's
  keyword rule (a torch parent's ``state_dict``, ``nn.Module.parameters``,
  ``functional_call``, ``register_parametrization``) gets torch tensors
  from a Layer; calls without torch's keywords get handles.
* The port's ``nn`` exports every name of ``paddle_tpu.nn``, each Paddle
  class once, and neither ``paddle_tpu_torch`` nor ``chip_smoke.py``
  imports jax or the JAX package.
"""
import copy
import os
import re

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu.parallel.train_step import TrainStep as JaxTrainStep
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import device as core_device

import torch_nn_cases as C
import torch_nn_jax as R

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


LAYER_CASES = [c for c in C.CASES if c[0].startswith("nn.")
               and c[5] != "attention"]


@pytest.mark.parametrize("case", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_forward_matches_jax(case):
    """The ``nn.`` cases of ``torch_nn_cases.py``, the JAX side traced
    whole (their gradients are in the section files)."""
    C.parity(P, lambda c: R.reference(c, False), case, grad=False)


# ---- the Layer surface ----------------------------------------------------
class _Net(P.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = P.nn.Linear(4, 8)
        self.fc2 = P.nn.Linear(8, 2)

    def forward(self, x):
        return self.fc2(P.nn.functional.relu(self.fc1(x)))


def test_layer_system():
    nn = P.nn
    layer = nn.Linear(4, 3)
    assert len(layer.parameters()) == 2
    assert [n for n, _ in layer.named_parameters()] == ["weight", "bias"]
    assert layer.weight.shape == [4, 3] and isinstance(layer.weight,
                                                       P.Parameter)
    assert layer.weight is layer.weight and not layer.weight.stop_gradient
    net = _Net()
    sd = net.state_dict()
    assert list(sd) == ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]
    net2 = _Net()
    assert net2.set_state_dict(sd) == ([], [])
    np.testing.assert_array_equal(net2.fc1.weight.numpy(),
                                  net.fc1.weight.numpy())
    with pytest.raises(ValueError, match="shape mismatch"):
        net2.set_state_dict({"fc1.weight": np.zeros((3, 3), np.float32)})
    seq = nn.Sequential(nn.Linear(2, 2), nn.Dropout(0.5))
    seq.eval()
    assert not seq[1].training
    seq.train()
    assert seq[1].training
    seen = []
    nn.Sequential(nn.Linear(2, 2), nn.ReLU()).apply(
        lambda m: seen.append(type(m).__name__))
    assert seen == ["Sequential", "Linear", "ReLU"]
    bn = nn.BatchNorm1D(4)
    assert set(dict(bn.named_buffers())) == {"_mean", "_variance"}
    assert "_mean" in bn.state_dict() and isinstance(bn._mean, P.Tensor)
    bn.register_buffer("scratch", np.zeros(2, np.float32),
                       persistable=False)
    assert "scratch" not in bn.state_dict()
    calls = []
    h = layer.register_forward_post_hook(lambda m, i, o: calls.append(1))
    layer(P.ones([1, 4]))
    h.remove()
    layer(P.ones([1, 4]))
    assert calls == [1]
    pre = layer.register_forward_pre_hook(lambda m, i: (i[0] * 0.0,))
    np.testing.assert_allclose(layer(P.ones([1, 4])).numpy(),
                               layer.bias.numpy()[None], rtol=1e-6)
    pre.remove()
    ll = nn.LayerList([nn.Linear(2, 2) for _ in range(3)])
    ll.append(nn.Linear(2, 2))
    assert len(ll) == 4 and len(ll.parameters()) == 8
    assert isinstance(ll[-1], nn.Linear) and len(ll[1:]) == 3
    pl = nn.ParameterList([layer.weight])
    assert len(pl) == 1 and pl[0].shape == [4, 3]
    assert net.full_name() == "_net" and "fc1" in repr(net)
    assert [n for n, _ in net.named_sublayers()] == ["fc1", "fc2"]


def test_create_parameter_and_param_attr():
    nn, I = P.nn, P.nn.initializer
    frozen = nn.Linear(3, 2, weight_attr=P.ParamAttr(
        name="w0", initializer=I.Constant(0.5), trainable=False,
        learning_rate=0.1), bias_attr=False)
    assert frozen.bias is None and frozen.weight.name == "w0"
    assert frozen.weight.stop_gradient
    assert frozen.weight.torch().optimize_attr == {"learning_rate": 0.1}
    np.testing.assert_array_equal(frozen.weight.numpy(), 0.5)
    I.set_global_initializer(I.Constant(2.0), I.Constant(3.0))
    try:
        lin = nn.Linear(2, 2)
        np.testing.assert_array_equal(lin.weight.numpy(), 2.0)
        np.testing.assert_array_equal(lin.bias.numpy(), 3.0)
        lin = nn.Linear(2, 2, weight_attr=I.Constant(4.0))
        np.testing.assert_array_equal(lin.weight.numpy(), 4.0)
    finally:
        I.set_global_initializer(None, None)
    lay = nn.Layer()
    p = lay.create_parameter([2, 3], is_bias=True)
    lay.extra = p
    assert dict(lay.named_parameters())["extra"] is p
    lay.extra = None
    assert lay.extra is None and not lay.parameters()
    emb = nn.Embedding(5, 3, padding_idx=-1)
    np.testing.assert_array_equal(emb.weight.numpy()[4], 0.0)


def test_to_astype_deepcopy_and_clear_gradients():
    net = _Net()
    out = net(P.ones([2, 4]))
    out.sum().backward()
    assert net.fc1.weight.grad is not None
    net.clear_gradients()
    assert net.fc1.weight.grad is None
    twin = copy.deepcopy(net)
    assert twin.fc1.weight is not net.fc1.weight
    np.testing.assert_array_equal(twin.fc1.weight.numpy(),
                                  net.fc1.weight.numpy())
    net.astype("float64")
    assert net.fc1.weight.dtype == "float64"
    net.to(dtype="float32", device="cpu")
    assert net.fc2.bias.dtype == "float32"


def test_layers_build_on_the_current_place():
    """Without ``set_device`` a Layer builds on the card (raising without
    one); a ``with torch.device(...)`` block names another device."""
    core_device._current = None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="set_device"):
            P.nn.Linear(2, 2)
    with torch.device("cpu"):
        assert P.nn.Linear(2, 2).weight.place.is_cpu_place()


def test_torch_in_torch_out_handles_in_handles_out():
    model = P.nn.Transformer(16, 2, 1, 1, 32, dropout=0.0)
    rs = np.random.RandomState(0)
    src, tgt = (rs.rand(2, 5, 16).astype(np.float32),
                rs.rand(2, 3, 16).astype(np.float32))
    out_t = model(torch.tensor(src), torch.tensor(tgt))
    out_h = model(P.to_tensor(src), P.to_tensor(tgt))
    assert type(out_t) is torch.Tensor and isinstance(out_h, P.Tensor)
    np.testing.assert_array_equal(out_t.detach().numpy(), out_h.numpy())


def _torch_parent_state(net):
    parent = torch.nn.Sequential(net, torch.nn.Linear(2, 3))
    sd = parent.state_dict()
    assert list(sd) == ["0.fc1.weight", "0.fc1.bias", "0.fc2.weight",
                        "0.fc2.bias", "1.weight", "1.bias"]
    assert all(type(v) is torch.Tensor for v in sd.values())
    with torch.no_grad():
        for v in sd.values():
            v.add_(1.0)
    twin = torch.nn.Sequential(_Net(), torch.nn.Linear(2, 3))
    twin.load_state_dict(sd)
    np.testing.assert_array_equal(twin[0].fc1.weight.numpy(),
                                  net.fc1.weight.numpy())


def _module_iteration(net):
    params = list(torch.nn.Module.parameters(net))
    assert len(params) == 4
    assert all(isinstance(p, torch.nn.Parameter) for p in params)
    bn = P.nn.BatchNorm1D(3)
    assert all(type(b) is torch.Tensor
               for b in torch.nn.Module.buffers(bn))


def _functional_call(net):
    x = torch.ones(2, 4)
    zeros = {n: torch.zeros_like(t) for n, t in
             P.nn.layer.torch_named_parameters(net)}
    out = torch.func.functional_call(net, zeros, (x,))
    assert type(out) is torch.Tensor and not out.any()
    assert net.fc1.weight.numpy().any()


def _parametrization(net):
    class Double(torch.nn.Module):
        def forward(self, w):
            return 2.0 * w

    with P.nn.layer.torch_attributes():
        torch.nn.utils.parametrize.register_parametrization(
            net.fc1, "weight", Double())
    w = net.fc1.parametrizations.weight.original
    assert isinstance(w, torch.nn.Parameter)
    x = torch.ones(1, 4)
    b1, w2, b2 = (t.torch() for t in (net.fc1.bias, net.fc2.weight,
                                      net.fc2.bias))
    torch.testing.assert_close(
        net(x), torch.relu(x @ (2.0 * w) + b1) @ w2 + b2)


def _keywordless_calls_get_handles(net):
    assert all(isinstance(p, P.Parameter) for p in net.parameters())
    assert all(isinstance(v, P.Tensor) for v in net.state_dict().values())
    assert isinstance(net.fc1.weight, P.Parameter)


@pytest.mark.parametrize("use", [
    _torch_parent_state, _module_iteration, _functional_call,
    _parametrization, _keywordless_calls_get_handles],
    ids=lambda f: f.__name__.strip("_"))
def test_torch_code_over_a_layer(use):
    """Each piece of torch code that ``nn/layer/base.py``'s docstring
    says relies on the keyword rule gets torch tensors from a Layer;
    calls without torch's keywords get handles."""
    use(_Net())


# ---- carried weights --------------------------------------------------
def _zoo(pkg):
    nn = pkg.nn

    class Zoo(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 4, 3, padding=1)
            self.bn = nn.BatchNorm2D(4)
            self.pool = nn.MaxPool2D(2)
            self.gn = nn.GroupNorm(2, 4)
            self.lstm = nn.LSTM(12, 6, direction="bidirect")
            self.ln = nn.LayerNorm(12)
            self.head = nn.Linear(12, 5)

        def forward(self, x):
            h = self.gn(self.pool(nn.functional.relu(self.bn(self.conv(x)))))
            h = pkg.reshape(pkg.transpose(h, [0, 2, 1, 3]), [2, 3, 12])
            seq, _ = self.lstm(h)
            return self.head(self.ln(seq))

    return Zoo()


def test_state_dict_carried_from_a_jax_network():
    """A conv / batch-norm / pool / group-norm / BiLSTM / layer-norm /
    linear network built in both packages: the port's ``set_state_dict``
    of the JAX network's ``state_dict()`` (numpy) computes the JAX
    network's function, in training (batch statistics, and the running
    ones advanced alike) and in eval; ``convert.export_layer_state`` /
    ``load_layer_state`` carry it back."""
    J.seed(1)
    jm, pm = _zoo(J), _zoo(P)
    names = list(jm.state_dict())
    assert list(pm.state_dict()) == names
    convert.load_layer_state(pm, jm.state_dict())
    x = np.random.RandomState(2).rand(2, 3, 6, 6).astype(np.float32)
    for train in (True, False):
        jm.train() if train else jm.eval()
        pm.train() if train else pm.eval()
        np.testing.assert_allclose(pm(P.to_tensor(x)).numpy(),
                                   jm(J.to_tensor(x)).numpy(),
                                   rtol=1e-4, atol=1e-4)
    back = convert.export_layer_state(pm)
    for n, v in jm.state_dict().items():
        np.testing.assert_allclose(back[n], v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    with pytest.raises(ValueError, match="missing"):
        convert.load_layer_state(pm, {"head.weight": back["head.weight"]})


# ---- initializers -----------------------------------------------------
def test_initializers_distribution_and_seed():
    I = P.nn.initializer
    shape = [64, 32, 3, 3]
    fan_in, fan_out = 32 * 9, 64 * 9
    for init, lo, hi, std in [
            (I.Uniform(-0.3, 0.2), -0.3, 0.2, 0.5 / np.sqrt(12)),
            (I.Normal(0.5, 0.1), None, None, 0.1),
            (I.TruncatedNormal(0.0, 1.0), -2.0, 2.0, 0.8796),
            (I.XavierUniform(), -np.sqrt(6 / (fan_in + fan_out)),
             np.sqrt(6 / (fan_in + fan_out)),
             np.sqrt(2 / (fan_in + fan_out))),
            (I.XavierNormal(), None, None, np.sqrt(2 / (fan_in + fan_out))),
            (I.KaimingUniform(), -np.sqrt(6 / fan_in), np.sqrt(6 / fan_in),
             np.sqrt(2 / fan_in)),
            (I.KaimingNormal(), None, None, np.sqrt(2 / fan_in)),
            (I.MSRA(uniform=False), None, None, np.sqrt(2 / fan_in))]:
        P.seed(3)
        a = init(shape).numpy()
        P.seed(3)
        np.testing.assert_array_equal(init(shape).numpy(), a)
        assert a.std() == pytest.approx(std, rel=0.05), type(init)
        if lo is not None:
            assert a.min() >= lo - 1e-6 and a.max() <= hi + 1e-6
    seeded = I.Normal(seed=5)
    np.testing.assert_array_equal(seeded([8]).numpy(), seeded([8]).numpy())
    q = I.Orthogonal(gain=2.0)([6, 4]).numpy()
    np.testing.assert_allclose(q.T @ q, 4.0 * np.eye(4), atol=1e-5)
    d = I.Dirac()([3, 3, 4, 4]).numpy()
    np.testing.assert_allclose(d[1, 1].T @ d[1, 1], np.eye(4), atol=1e-5)
    for make in (lambda m: m.Constant(0.7), lambda m: m.Bilinear(),
                 lambda m: m.Assign(np.arange(24.0).reshape(2, 3, 2, 2))):
        np.testing.assert_allclose(
            make(I)([2, 3, 2, 2]).numpy(),
            np.asarray(make(J.nn.initializer)([2, 3, 2, 2])), rtol=1e-6)


# ---- training -----------------------------------------------------------
def _mlp(pkg, jm=None):
    nn = pkg.nn
    net = nn.Sequential(nn.Linear(6, 16), nn.Tanh(), nn.Linear(16, 3))
    if jm is not None:
        net.set_state_dict({k: v.numpy() for k, v in
                            jm.state_dict().items()})
    return net


def _data():
    rs = np.random.RandomState(4)
    return (rs.rand(8, 6).astype(np.float32),
            rs.rand(8, 3).astype(np.float32))


def test_train_step_over_sequential_matches_jax():
    """``Sequential`` trained 3 steps by the port's ``TrainStep`` (torch
    tensors through the Layer) against the JAX ``TrainStep``."""
    from paddle_tpu_torch.parallel import TrainStep
    J.seed(5)
    jm = _mlp(J)
    pm = _mlp(P, jm)
    jst = JaxTrainStep(jm, J.optimizer.Momentum(
        learning_rate=0.1, parameters=jm.parameters()),
        loss_fn=J.nn.MSELoss())
    pst = TrainStep(pm, P.optimizer.Momentum(
        learning_rate=0.1, parameters=pm.parameters(), device="cpu"),
        loss_fn=P.nn.MSELoss(), device="cpu")
    x, y = _data()
    jl = [float(np.asarray(jst.step([x], [y]))) for _ in range(3)]
    pl = [float(pst.step([torch.tensor(x)], [torch.tensor(y)]))
          for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    jst.sync_to_layer()
    for (n, a), (_, b) in zip(pm.state_dict().items(),
                              jm.state_dict().items()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_gradient_penalty_backprops_into_an_nn_critic():
    """The WGAN-GP loss of ``test_double_grad.py`` over its
    ``nn.Sequential`` critic: every parameter's gradient equals the JAX
    package's (rtol/atol 1e-4)."""
    grads = {}
    rs = np.random.RandomState(7)
    xv = rs.randn(5, 4).astype(np.float32)
    J.seed(7)
    jd = J.nn.Sequential(J.nn.Linear(4, 8), J.nn.Tanh(), J.nn.Linear(8, 1))
    pd = P.nn.Sequential(P.nn.Linear(4, 8), P.nn.Tanh(), P.nn.Linear(8, 1))
    pd.set_state_dict({k: v.numpy() for k, v in jd.state_dict().items()})
    for pkg, D in ((J, jd), (P, pd)):
        x = pkg.to_tensor(xv, stop_gradient=False)
        (gx,) = pkg.grad(pkg.sum(D(x)), x, create_graph=True)
        norm = pkg.sqrt(pkg.sum(gx * gx, axis=1) + 1e-12)
        pkg.mean((norm - 1.0) ** 2).backward()
        grads[pkg] = [None if p.grad is None else p.grad.numpy()
                      for p in D.parameters()]
    C.compare_grads(grads[P], grads[J], "t", "critic")


# ---- the namespace ------------------------------------------------------
def test_nn_exports_every_jax_name_once():
    """Every public class, function and submodule of ``paddle_tpu.nn`` is
    in the port's ``nn`` (nothing of it is deferred), and no Paddle class
    name is defined twice in the port."""
    import types
    missing = []
    for n in dir(J.nn):
        v = getattr(J.nn, n)
        if n.startswith("_") or not (callable(v) or isinstance(
                v, types.ModuleType)):
            continue
        if not hasattr(P.nn, n):
            missing.append(n)
    assert missing == []
    seen = {}
    pkg_root = os.path.join(ROOT, "paddle_tpu_torch")
    for dirpath, _, files in os.walk(pkg_root):
        for f in files:
            if not f.endswith(".py"):
                continue
            for m in re.finditer(r"^class (\w+)", open(os.path.join(
                    dirpath, f)).read(), re.M):
                seen.setdefault(m.group(1), []).append(f)
    for name in ("MultiHeadAttention", "TransformerEncoderLayer",
                 "TransformerEncoder", "BatchNorm", "BatchNorm1D",
                 "BatchNorm2D", "BatchNorm3D", "ClipGradByGlobalNorm",
                 "ScanLayers", "Linear", "LayerNorm", "Layer"):
        assert len(seen.get(name, [])) == 1, (name, seen.get(name))
    assert P.optimizer.ClipGradByGlobalNorm is P.nn.ClipGradByGlobalNorm
    from paddle_tpu_torch.models import bert
    assert isinstance(bert.BertModel.__init__, types.FunctionType)


def test_the_port_imports_no_jax():
    """No module of ``paddle_tpu_torch`` and not ``chip_smoke.py`` imports
    jax or anything of the JAX package."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|paddle_tpu)(\.|\s|$)",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "paddle_tpu_torch")):
        files += [os.path.join(dirpath, f) for f in names
                  if f.endswith(".py")]
    hits = [f for f in files if bad.search(open(f).read())]
    assert hits == []
