"""The port's RNN layers held to the JAX package's on the CPU, with the JAX
layers' weights carried by ``set_state_dict`` of their ``state_dict()``:
the multi-layer and bidirectional ``LSTM``, ``GRU`` and ``SimpleRNN``
(batch- and time-major, with and without initial states), the three
cells, the generic ``RNN`` and ``BiRNN`` over cells with
``sequence_length`` (outputs zero and states held past each length), and
a BiLSTM (``BiRNN`` of two ``LSTMCell``) with ``sequence_length``.
Outputs and final states at rtol/atol 1e-5, gradients (inputs and every
weight) at 1e-4: the recurrences sum the same products in another order.

Two gradients are held to another reference, since the JAX package gives
none: its ``RNN`` over a cell with ``sequence_length`` rebuilds each
step's tensors outside its tape, and its ``LSTM`` / ``GRU`` take the
initial states as constants.  The port's masked gradients equal the JAX
package's gradients of each sequence's valid prefix run on its own,
summed; its initial states' gradients are not compared.  Also
``test_nn.py``'s ``TestRNN`` and ``test_nn_extras.py``'s RNN cases.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as core_device

torch.set_num_threads(1)
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


def _pair(make):
    """The same layer in both packages, the port's carrying the JAX one's
    weights."""
    J.seed(0)
    jl, pl = make(J.nn), make(P.nn)
    pl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    return jl, pl


def _run(pkg, layer, arrays, call, n_grad=1):
    """Outputs (flattened) and the gradients of ``sum(out_k * w_k)``: of
    the first ``n_grad`` inputs, then of every parameter."""
    ts = [pkg.to_tensor(a, stop_gradient=k >= n_grad)
          for k, a in enumerate(arrays)]
    outs = call(layer, *ts)
    flat = []

    def walk(o):
        if isinstance(o, (tuple, list)):
            for x in o:
                walk(x)
        elif o is not None:
            flat.append(o)
    walk(outs)
    loss = None
    for k, o in enumerate(flat):
        w = np.random.RandomState(10 + k).rand(*o.shape).astype(np.float32)
        term = pkg.sum(o * pkg.to_tensor(w))
        loss = term if loss is None else loss + term
    loss.backward()
    grads = [t.grad.numpy() for t in ts if t.grad is not None]
    grads += [p.grad.numpy() for p in layer.parameters()]
    return [o.numpy() for o in flat], grads


def _check(make, arrays, call=lambda m, x: m(x), n_grad=1):
    jl, pl = _pair(make)
    got, gg = _run(P, pl, arrays, call, n_grad)
    want, wg = _run(J, jl, arrays, call, n_grad)
    assert len(got) == len(want) and len(gg) == len(wg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **FWD)
    for g, w in zip(gg, wg):
        np.testing.assert_allclose(g, w, **GRAD)
    return got


rs = np.random.RandomState(3)
X = rs.rand(3, 5, 4).astype(np.float32) - 0.5
H0 = rs.rand(4, 3, 6).astype(np.float32) - 0.5
C0 = rs.rand(4, 3, 6).astype(np.float32) - 0.5
LENS = np.array([5, 2, 4], np.int64)


@pytest.mark.parametrize("mode,kw", [
    ("LSTM", dict(num_layers=2, direction="bidirect")),
    ("GRU", dict(num_layers=2, direction="bidirect")),
    ("SimpleRNN", dict(num_layers=2, activation="relu", time_major=True)),
], ids=["lstm2_bi", "gru2_bi", "rnn2_relu_time_major"])
def test_rnn_layers_match_jax(mode, kw):
    outs = _check(lambda nn: getattr(nn, mode)(4, 6, **kw), [X])
    d = 2 if kw.get("direction") else 1
    assert outs[0].shape == (3, 5, 6 * d) or kw.get("time_major")


def test_rnn_initial_states_match_jax():
    _check(lambda nn: nn.LSTM(4, 6, 2, direction="bidirect"),
           [X, H0, C0], lambda m, x, h, c: m(x, (h, c)))


@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
def test_cells_match_jax(cell):
    x, h = X[:, 0], H0[0]
    if cell == "LSTMCell":
        _check(lambda nn: nn.LSTMCell(4, 6), [x, h, C0[0]],
               lambda m, x, h, c: m(x, (h, c)), n_grad=3)
    else:
        _check(lambda nn: getattr(nn, cell)(4, 6), [x, h],
               lambda m, x, h: m(x, h), n_grad=2)


def _masked(pkg, layer, x, lens):
    """Outputs and final states of ``layer`` over ``x`` with
    ``sequence_length``, and the gradients of their weighted sum."""
    t = pkg.to_tensor(x, stop_gradient=False)
    out, st = layer(t, sequence_length=pkg.to_tensor(lens))
    flat = [out] + (list(st) if isinstance(st, (tuple, list)) else [st])
    flat = [f for part in flat for f in (part if isinstance(
        part, (tuple, list)) else [part])]
    w = [np.random.RandomState(20 + k).rand(*f.shape).astype(np.float32)
         for k, f in enumerate(flat)]
    sum(pkg.sum(f * pkg.to_tensor(wk)) for f, wk in zip(flat, w)).backward()
    grads = [t.grad.numpy()] + [p.grad.numpy() for p in layer.parameters()]
    return [f.numpy() for f in flat], w, grads


def _prefix_grads(pkg, layer, x, lens, w):
    """The same gradients from each sequence's valid prefix run alone
    (no ``sequence_length``): the weights of its outputs cut to the
    prefix, of its states as they are."""
    gx = np.zeros_like(x)
    for b, n in enumerate(lens):
        t = pkg.to_tensor(x[b:b + 1, :n], stop_gradient=False)
        out, st = layer(t)
        flat = [out] + (list(st) if isinstance(st, (tuple, list)) else [st])
        flat = [f for part in flat for f in (part if isinstance(
            part, (tuple, list)) else [part])]
        cut = [w[0][b:b + 1, :n]] + [wk[b:b + 1] for wk in w[1:]]
        sum(pkg.sum(f * pkg.to_tensor(c)) for f, c in
            zip(flat, cut)).backward()
        gx[b, :n] = t.grad.numpy()[0]
    return [gx] + [p.grad.numpy() for p in layer.parameters()]


@pytest.mark.parametrize("kind", ["gru_reverse", "bilstm"])
def test_rnn_over_cells_with_sequence_length(kind):
    """``RNN`` (forward and reverse) over a ``GRUCell`` and a BiLSTM
    (``BiRNN`` of two ``LSTMCell``) with ``sequence_length``: outputs and
    final states equal the JAX package's, outputs past each length are
    zero, and the gradients equal the JAX package's prefix runs'."""
    def make(nn):
        if kind == "bilstm":
            return nn.BiRNN(nn.LSTMCell(4, 6), nn.LSTMCell(4, 6))
        return nn.RNN(nn.GRUCell(4, 6), is_reverse=kind == "gru_reverse")
    jl, pl = _pair(make)
    got, w, gg = _masked(P, pl, X, LENS)
    want = [f.numpy() for f in _flat(jl(J.to_tensor(X),
                                        sequence_length=J.to_tensor(LENS)))]
    for g, v in zip(got, want):
        np.testing.assert_allclose(g, v, **FWD)
    np.testing.assert_array_equal(got[0][1, 2:], 0.0)
    for g, v in zip(gg, _prefix_grads(J, jl, X, LENS, w)):
        np.testing.assert_allclose(g, v, **GRAD)


def _flat(o):
    if isinstance(o, (tuple, list)):
        return [x for part in o for x in _flat(part)]
    return [o]


def test_rnn_wrapper_semantics():
    """``test_nn_extras.py``: ``RNN`` equals the manual cell loop, the
    reverse half of ``BiRNN`` at the last step is one cell step, a
    reverse ``RNN`` over a padded sequence ends in the state of its
    valid prefix; ``test_nn.py``'s shapes; ``dropout`` acts in training
    only."""
    nn = P.nn
    cell = nn.GRUCell(4, 8)
    x = P.to_tensor(X)
    out, final = nn.RNN(cell)(x)
    states, outs = None, []
    for t in range(5):
        o, states = cell(x[:, t], states)
        outs.append(o.numpy())
    np.testing.assert_allclose(out.numpy(), np.stack(outs, 1), rtol=1e-6)
    np.testing.assert_allclose(final.numpy(), outs[-1], rtol=1e-6)
    fw, bw = nn.SimpleRNNCell(4, 3), nn.SimpleRNNCell(4, 3)
    out, _ = nn.BiRNN(fw, bw)(x)
    np.testing.assert_allclose(out.numpy()[:, -1, 3:],
                               bw(x[:, -1], None)[0].numpy(), rtol=1e-6)
    rev = nn.RNN(cell, is_reverse=True)
    _, f1 = rev(P.to_tensor(X[:1]), sequence_length=P.to_tensor(LENS[1:2]))
    _, f2 = rev(P.to_tensor(X[:1, :2]))
    np.testing.assert_allclose(f1.numpy(), f2.numpy(), rtol=1e-6)
    lstm = nn.LSTM(4, 6, num_layers=2, dropout=0.5)
    out, (h, c) = lstm(x)
    assert out.shape == [3, 5, 6] and h.shape == [2, 3, 6] == c.shape
    lstm.eval()
    a, b = lstm(x)[0].numpy(), lstm(x)[0].numpy()
    np.testing.assert_array_equal(a, b)
    lstm.train()
    assert not np.allclose(lstm(x)[0].numpy(), a)
    assert set(dict(lstm.named_parameters())) >= {
        "weight_ih_l0", "weight_hh_l1", "bias_ih_l1", "bias_hh_l0"}
    assert lstm.weight_ih_l0.shape == [24, 4]
