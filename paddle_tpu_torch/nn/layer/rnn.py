"""Recurrent layers: the port of ``paddle_tpu/nn/layer/rnn.py``
(reference: python/paddle/nn/layer/rnn.py).

The cells (``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``) are one step in
torch ops, with the reference's gate orders (LSTM i, f, g, o; GRU r, z, n
with the reset gate applied to the hidden product). ``RNN`` and ``BiRNN``
loop a cell over time in Python, as the reference's do.

``SimpleRNN``, ``LSTM`` and ``GRU`` run each layer's time loop as one call
of torch's fused recurrence (``torch._VF.lstm``, ``gru``, ``rnn_tanh``,
``rnn_relu``; on a CUDA tensor that is cuDNN's RNN): the same function as
the reference's ``lax.scan`` of the cell (``rnn.py:215-258``), same gate
orders, one launch sequence a layer instead of a few small kernels a time
step. Each layer is its own call, so that the dropout between layers is
``nn.functional.dropout`` on the port's generator, as the reference
applies it, and the weights stay the per-cell Parameters of the reference
(``cells.{i}.weight_ih``, ...), so that state_dicts carry across.
``ROUTES`` counts the layer calls by route: "cudnn" on the card, "aten"
(torch's own kernels) on the CPU.

As in the reference, ``sequence_length`` is accepted and ignored: padded
steps are run like the others (Paddle masks them).
"""
from __future__ import annotations

import math

import torch

from ...core.dispatch import run_op
from ...core.tensor import Tensor
from .. import functional as F
from .. import initializer as I
from .layers import Layer, LayerList

#: layer calls of the fused recurrence, by route
ROUTES = {"cudnn": 0, "aten": 0}


def reset_routes():
    for k in ROUTES:
        ROUTES[k] = 0


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        from ...core import dtype as dtype_mod
        b = batch_ref.shape[batch_dim_idx]
        td = dtype_mod.torch_dtype(dtype or "float32")
        return Tensor._wrap(torch.full((b, self.hidden_size), init_value,
                                       dtype=td,
                                       device=batch_ref._data.device))


def _cell_params(cell, input_size, hidden_size, gates, attrs):
    weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr = attrs
    std = 1.0 / math.sqrt(hidden_size)
    u = I.Uniform(-std, std)
    cell.input_size = input_size
    cell.hidden_size = hidden_size
    cell.weight_ih = cell.create_parameter(
        (gates * hidden_size, input_size), weight_ih_attr,
        default_initializer=u)
    cell.weight_hh = cell.create_parameter(
        (gates * hidden_size, hidden_size), weight_hh_attr,
        default_initializer=u)
    cell.bias_ih = cell.create_parameter(
        (gates * hidden_size,), bias_ih_attr, is_bias=True,
        default_initializer=u)
    cell.bias_hh = cell.create_parameter(
        (gates * hidden_size,), bias_hh_attr, is_bias=True,
        default_initializer=u)


def _lstm_step(x, h, c, wi, wh, bi, bh):
    gates = x @ wi.T + bi + h @ wh.T + bh
    i, fg, g, o = torch.chunk(gates, 4, dim=-1)
    new_c = torch.sigmoid(fg) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(new_c), new_c


def _gru_step(x, h, wi, wh, bi, bh):
    i_r, i_z, i_n = torch.chunk(x @ wi.T + bi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(h @ wh.T + bh, 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.activation = activation
        _cell_params(self, input_size, hidden_size, 1,
                     (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                      bias_hh_attr))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        act = torch.tanh if self.activation == "tanh" else torch.relu

        def f(x, h, wi, wh, bi, bh):
            return act(x @ wi.T + bi + h @ wh.T + bh)
        h = run_op("simple_rnn_cell", f, inputs, states, self.weight_ih,
                   self.weight_hh, self.bias_ih, self.bias_hh)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=0, name=None):
        super().__init__()
        _cell_params(self, input_size, hidden_size, 4,
                     (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                      bias_hh_attr))

    def forward(self, inputs, states=None):
        if states is None:
            h = self.get_initial_states(inputs)
            c = self.get_initial_states(inputs)
        else:
            h, c = states
        new_h, new_c = run_op("lstm_cell", _lstm_step, inputs, h, c,
                              self.weight_ih, self.weight_hh, self.bias_ih,
                              self.bias_hh)
        return new_h, (new_h, new_c)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        _cell_params(self, input_size, hidden_size, 3,
                     (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                      bias_hh_attr))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = run_op("gru_cell", _gru_step, inputs, states, self.weight_ih,
                   self.weight_hh, self.bias_ih, self.bias_hh)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class RNN(Layer):
    """A cell looped over time (the reference's RNN wrapper).
    ``sequence_length`` is ignored, as in the reference."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...ops.manipulation import stack
        time_axis = 0 if self.time_major else 1
        steps = inputs.shape[time_axis]
        outputs = []
        states = initial_states
        idx = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        for i in idx:
            xt = inputs[:, i] if time_axis == 1 else inputs[i]
            out, states = self.cell(xt, states)
            outputs.append(out)
        if self.is_reverse:
            outputs = outputs[::-1]
        return stack(outputs, axis=time_axis), states


_FUSED = {"LSTM": torch._VF.lstm, "GRU": torch._VF.gru,
          "RNN_TANH": torch._VF.rnn_tanh, "RNN_RELU": torch._VF.rnn_relu}


class _RNNBase(Layer):
    """Multi-layer (bi)directional recurrent net, a layer a fused call."""

    MODE = "RNN_TANH"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None,
                 activation=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction in ("bidirect", "bidirectional")
        num_dir = 2 if self.bidirect else 1
        cell_cls = {"RNN_TANH": SimpleRNNCell, "RNN_RELU": SimpleRNNCell,
                    "LSTM": LSTMCell, "GRU": GRUCell}[self.MODE]
        self.cells = LayerList()
        for layer in range(num_layers):
            for _ in range(num_dir):
                in_sz = input_size if layer == 0 else hidden_size * num_dir
                kw = {}
                if self.MODE.startswith("RNN"):
                    kw["activation"] = "tanh" if self.MODE == "RNN_TANH" \
                        else "relu"
                self.cells.append(cell_cls(in_sz, hidden_size,
                                           weight_ih_attr=weight_ih_attr,
                                           weight_hh_attr=weight_hh_attr,
                                           bias_ih_attr=bias_ih_attr,
                                           bias_hh_attr=bias_hh_attr, **kw))

    def _layer(self, x, init, cells):
        """One layer, both directions, as one fused call: x [T, B, C] or
        [B, T, C] -> (outputs, final h [num_dir, B, H], final c)."""
        is_lstm = self.MODE == "LSTM"
        fused = _FUSED[self.MODE]
        bidir, batch_first = len(cells) == 2, not self.time_major
        training = self.training
        weights = [w for c in cells
                   for w in (c.weight_ih, c.weight_hh, c.bias_ih, c.bias_hh)]
        ROUTES["cudnn" if x._data.is_cuda
               and torch.backends.cudnn.is_available()
               and torch.backends.cudnn.enabled else "aten"] += 1

        def f(a, *rest):
            n_state = 2 if is_lstm else 1
            hx, ws = rest[:n_state], list(rest[n_state:])
            if is_lstm:
                return tuple(fused(a, hx, ws, True, 1, 0.0, training, bidir,
                                   batch_first))
            return tuple(fused(a, hx[0], ws, True, 1, 0.0, training, bidir,
                               batch_first))
        states = list(init) if is_lstm else [init]
        outs = run_op(f"{self.MODE.lower()}_layer", f, x, *states, *weights)
        if is_lstm:
            return outs[0], (outs[1], outs[2])
        return outs[0], outs[1]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...ops.manipulation import concat
        num_dir = 2 if self.bidirect else 1
        b = inputs.shape[1 if self.time_major else 0]
        is_lstm = self.MODE == "LSTM"
        if initial_states is None:
            def z():
                return Tensor._wrap(torch.zeros(
                    (self.num_layers * num_dir, b, self.hidden_size),
                    dtype=inputs._data.dtype, device=inputs._data.device))
            initial_states = (z(), z()) if is_lstm else z()
        final_h, final_c = [], []
        out = inputs
        for layer in range(self.num_layers):
            sl = slice(layer * num_dir, (layer + 1) * num_dir)
            init = (initial_states[0][sl], initial_states[1][sl]) \
                if is_lstm else initial_states[sl]
            out, state = self._layer(out, init, self.cells[sl])
            if is_lstm:
                final_h.append(state[0])
                final_c.append(state[1])
            else:
                final_h.append(state)
            if self.dropout > 0 and layer < self.num_layers - 1:
                out = F.dropout(out, self.dropout, training=self.training)
        h_stack = concat(final_h, axis=0)
        if is_lstm:
            return out, (h_stack, concat(final_c, axis=0))
        return out, h_stack


class SimpleRNN(_RNNBase):
    MODE = "RNN_TANH"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        self.MODE = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kw)


class LSTM(_RNNBase):
    MODE = "LSTM"


class GRU(_RNNBase):
    MODE = "GRU"


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...ops.manipulation import concat
        if initial_states is None:
            states_fw = states_bw = None
        else:
            states_fw, states_bw = initial_states
        out_fw, st_fw = self.rnn_fw(inputs, states_fw)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw)
        return concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)
