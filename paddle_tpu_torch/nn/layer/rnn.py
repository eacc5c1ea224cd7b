"""RNN layers — counterpart of ``paddle_tpu/nn/layer/rnn.py``
(``SimpleRNN``, ``LSTM``, ``GRU``, their cells, ``RNNCellBase``, ``RNN``
and ``BiRNN``).

The JAX package runs each direction of each layer as one ``lax.scan``;
the port runs a loop over the time steps in torch ops (no Pallas kernel
is involved, so none is written by hand).  The input projection of every
step is one matmul over the whole sequence before the loop; each step
then adds the recurrent one.  Weights are the JAX layer's:
``weight_ih_l{k}[_reverse] [gates * H, in]``, ``weight_hh_l{k} [gates *
H, H]``, ``bias_ih`` / ``bias_hh [gates * H]``, multiplied as ``x @
w.T``, gates split as i, f, g, o (LSTM) and r, z, n (GRU); uniform in
``[-1/sqrt(H), 1/sqrt(H)]`` by default.  Dropout (training, more than
one layer) applies to every layer's output but the last.

``SimpleRNN`` / ``LSTM`` / ``GRU`` take ``sequence_length`` and ignore
it, as the JAX package's do; the generic ``RNN`` (and ``BiRNN``) over a
cell honours it: past each sequence's length the outputs are zero and
the states held.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as TF

from ... import amp
from .base import Layer
from .. import initializer as I
from ..functional._io import follows_input, tree_map

_GATES = {"LSTM": 4, "GRU": 3, "RNN": 1}


def _lstm_cell(gx, h, c, w_hh):
    """One LSTM step from the input projection ``gx`` (biases added)."""
    i, f, g, o = (gx + h @ w_hh.t()).chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _gru_cell(gx, h, w_hh, b_hh):
    """One GRU step from ``gx = x @ w_ih.T + b_ih``."""
    i_r, i_z, i_n = gx.chunk(3, dim=-1)
    h_r, h_z, h_n = (h @ w_hh.t() + b_hh).chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def _rnn_cell(gx, h, w_hh, activation):
    pre = gx + h @ w_hh.t()
    return torch.tanh(pre) if activation == "tanh" else torch.relu(pre)


def _uniform_params(layer, shapes, attrs, hidden_size):
    std = 1.0 / math.sqrt(hidden_size)
    return [layer.create_parameter(shape, attr=attr,
                                   default_initializer=I.Uniform(-std, std))
            for shape, attr in zip(shapes, attrs)]


class RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirect else 1
        g = _GATES[mode] * hidden_size
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_size = input_size if layer == 0 else \
                    hidden_size * self.num_directions
                suffix = f"_l{layer}" + ("_reverse" if d else "")
                params = _uniform_params(
                    self, [[g, in_size], [g, hidden_size], [g], [g]],
                    [weight_ih_attr, weight_hh_attr, bias_ih_attr,
                     bias_hh_attr], hidden_size)
                for kind, p in zip(("weight_ih", "weight_hh", "bias_ih",
                                    "bias_hh"), params):
                    self.add_parameter(kind + suffix, p)

    def _direction(self, x, h, c, w_ih, w_hh, b_ih, b_hh, reverse):
        """One direction of one layer over ``x [T, B, in]``: outputs
        ``[T, B, H]`` and the final ``(h, c)`` (c None but for LSTM)."""
        if self.mode == "GRU":
            gx = x @ w_ih.t() + b_ih
        else:
            gx = x @ w_ih.t() + (b_ih + b_hh)
        outs = [None] * x.shape[0]
        steps = range(x.shape[0] - 1, -1, -1) if reverse \
            else range(x.shape[0])
        for t in steps:
            if self.mode == "LSTM":
                h, c = _lstm_cell(gx[t], h, c, w_hh)
            elif self.mode == "GRU":
                h = _gru_cell(gx[t], h, w_hh, b_hh)
            else:
                h = _rnn_cell(gx[t], h, w_hh, self.activation)
            outs[t] = h
        return torch.stack(outs), h, c

    @follows_input
    def forward(self, inputs, initial_states=None, sequence_length=None):
        L, D, H = self.num_layers, self.num_directions, self.hidden_size
        lstm = self.mode == "LSTM"
        names = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
        params = [[self._parameters[n + f"_l{k}" + ("_reverse" if d else "")]
                   for n in names] for k in range(L) for d in range(D)]
        flat = amp.cast_inputs(self.mode.lower() + "_rnn", inputs,
                               *[p for group in params for p in group])
        x, flat = flat[0], flat[1:]
        params = [flat[4 * i:4 * i + 4] for i in range(L * D)]
        if not self.time_major:
            x = x.transpose(0, 1)
        if initial_states is None:
            h0 = x.new_zeros((L * D, x.shape[1], H))
            c0 = h0
        elif lstm:
            h0, c0 = (s.to(x.dtype) for s in initial_states)
        else:
            h0 = c0 = initial_states.to(x.dtype)
        final_h, final_c = [], []
        for k in range(L):
            outs = []
            for d in range(D):
                i = k * D + d
                out, h, c = self._direction(x, h0[i], c0[i], *params[i],
                                            reverse=d == 1)
                outs.append(out)
                final_h.append(h)
                final_c.append(c)
            x = torch.cat(outs, dim=-1) if D == 2 else outs[0]
            if self.dropout > 0.0 and self.training and k < L - 1:
                x = TF.dropout(x, p=float(self.dropout), training=True)
        out = x if self.time_major else x.transpose(0, 1)
        if lstm:
            return out, (torch.stack(final_h), torch.stack(final_c))
        return out, torch.stack(final_h)


class SimpleRNN(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation,
                         **kwargs)


class LSTM(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class _Cell(Layer):
    """A cell's four parameters ``[gates * H, in]``, ``[gates * H, H]``,
    ``[gates * H]``, ``[gates * H]``."""

    def __init__(self, gates, input_size, hidden_size, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = gates * hidden_size
        (self.weight_ih, self.weight_hh, self.bias_ih,
         self.bias_hh) = _uniform_params(
            self, [[g, input_size], [g, hidden_size], [g], [g]],
            [weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr],
            hidden_size)

    def _zeros(self, x):
        return x.new_zeros((x.shape[0], self.hidden_size))

    def _weights(self, name, x):
        return amp.cast_inputs(name, x, *(self._parameters[k] for k in (
            "weight_ih", "weight_hh", "bias_ih", "bias_hh")))


class LSTMCell(_Cell):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(4, input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @follows_input
    def forward(self, inputs, states=None):
        x, w_ih, w_hh, b_ih, b_hh = self._weights("lstm_cell", inputs)
        h, c = (self._zeros(x), self._zeros(x)) if states is None \
            else states
        h, c = _lstm_cell(x @ w_ih.t() + (b_ih + b_hh), h, c, w_hh)
        return h, (h, c)


class GRUCell(_Cell):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(3, input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @follows_input
    def forward(self, inputs, states=None):
        x, w_ih, w_hh, b_ih, b_hh = self._weights("gru_cell", inputs)
        h = self._zeros(x) if states is None else states
        h = _gru_cell(x @ w_ih.t() + b_ih, h, w_hh, b_hh)
        return h, h


class SimpleRNNCell(_Cell):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__(1, input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.activation = activation

    @follows_input
    def forward(self, inputs, states=None):
        x, w_ih, w_hh, b_ih, b_hh = self._weights("simple_rnn_cell", inputs)
        h = self._zeros(x) if states is None else states
        h = _rnn_cell(x @ w_ih.t() + (b_ih + b_hh), h, w_hh, self.activation)
        return h, h


class RNNCellBase(Layer):
    """A user cell's base: ``get_initial_states``."""

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        from ...core.tensor import Tensor
        ref = batch_ref._data if isinstance(batch_ref, Tensor) else batch_ref
        h = self.hidden_size if shape is None else shape[-1]
        z = torch.full((ref.shape[batch_dim_idx], h), init_value,
                       dtype=torch.float32, device=ref.device)
        return z if isinstance(batch_ref, torch.Tensor) else Tensor._wrap(z)


class RNN(Layer):
    """Runs ``cell`` over the time axis (a Python loop), in reverse with
    ``is_reverse``; with ``sequence_length`` each sequence's outputs past
    its length are zero and its states are held (zero when there was no
    initial state)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    @follows_input
    def forward(self, inputs, initial_states=None, sequence_length=None):
        if self.time_major:
            inputs = inputs.transpose(0, 1)
        steps = range(inputs.shape[1])
        if self.is_reverse:
            steps = reversed(steps)
        states, outs = initial_states, []
        for t in steps:
            out, new = self.cell(inputs[:, t], states)
            if sequence_length is not None:
                valid = t < sequence_length

                def keep(n, o=None, valid=valid):
                    v = valid.reshape((-1,) + (1,) * (n.dim() - 1))
                    return torch.where(v, n, torch.zeros_like(n)
                                       if o is None else o)

                out = keep(out)
                new = tree_map(keep, new) if states is None \
                    else tree_map(keep, new, states)
            states = new
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        outputs = torch.stack(outs, dim=1)
        if self.time_major:
            outputs = outputs.transpose(0, 1)
        return outputs, states


class BiRNN(Layer):
    """A forward and a reverse ``RNN``, outputs concatenated."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    @follows_input
    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_fw, states_bw = (None, None) if initial_states is None \
            else initial_states
        out_fw, st_fw = self.rnn_fw(inputs, states_fw,
                                    sequence_length=sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw,
                                    sequence_length=sequence_length)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)
