"""The recurrent layers of the port (``nn/layer/rnn.py``) against the
reference on the CPU, from one state_dict carried across as numpy.

- ``LSTM`` and ``GRU``, bidirectional, 2 layers, T=7, B=3, hidden 16,
  batch-major and time-major: outputs, final states, and the gradients of
  the input and of every parameter. f32 outputs rtol 1e-5 / atol 1e-6,
  gradients within 1e-4 of their scale. The port runs a layer as one call of
  torch's fused recurrence (cuDNN's on the card), the reference a
  ``lax.scan`` of its cell: the same function.
- ``SimpleRNN`` (tanh and relu), the same shapes: the reference's
  ``nn.SimpleRNN`` cannot be built (its ``_RNNBase`` passes the weight
  attributes positionally into ``SimpleRNNCell``'s ``activation``
  parameter, ``rnn.py:190-200``, and raises TypeError), so its oracle is
  the reference's own ``SimpleRNNCell``s, run by its ``BiRNN`` layer by
  layer, which is what its ``_RNNBase`` computes for the other modes.
- the cells, ``RNN`` and ``BiRNN`` against the reference's.
- ``sequence_length`` is ignored, as the reference ignores it
  (``rnn.py:166``, ``:264``): the outputs with and without it are equal.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch.nn.layer import rnn as trnn
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

I, H, L, B, S = 12, 16, 2, 3, 7
OUT_RTOL, OUT_ATOL, GRAD_TOL = 1e-5, 1e-6, 1e-4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    T.seed(2024)
    yield


def _carry(ref_layer, port_layer):
    sd = {k: v.numpy() for k, v in ref_layer.state_dict().items()}
    assert set(sd) == set(port_layer.state_dict())
    port_layer.set_state_dict(sd)


def _close(got, want, what, grad=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    if grad:
        scale = max(float(np.max(np.abs(want))), 1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=OUT_RTOL, atol=OUT_ATOL,
                                   err_msg=what)


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return [x]


def _forward_backward(pd, layer, x_np, init=None):
    x = pd.to_tensor(x_np, stop_gradient=False)
    out, states = layer(x, init) if init is not None else layer(x)
    outs = [out] + _flat(states)
    r = np.random.RandomState(9)
    total = None
    for o in outs:
        w = pd.to_tensor(r.randn(*o.shape).astype(np.float32))
        term = (o * w).sum()
        total = term if total is None else total + term
    total.backward()
    grads = {"x": x.grad.numpy()}
    grads.update({k: p.grad.numpy() for k, p in layer.named_parameters()})
    return [o.numpy() for o in outs], grads


def _compare(ref, port):
    (r_outs, r_grads), (p_outs, p_grads) = ref, port
    assert len(p_outs) == len(r_outs)
    for i, (g, w) in enumerate(zip(p_outs, r_outs)):
        _close(g, w, f"output {i}")
    assert set(p_grads) == set(r_grads)
    for k in r_grads:
        _close(p_grads[k], r_grads[k], f"grad {k}", grad=True)


@pytest.mark.parametrize("mode", ["LSTM", "GRU"])
@pytest.mark.parametrize("time_major", [False, True])
def test_lstm_gru_match_reference(mode, time_major):
    P.seed(1)
    ref = getattr(P.nn, mode)(I, H, num_layers=L, direction="bidirect",
                              time_major=time_major)
    port = getattr(T.nn, mode)(I, H, num_layers=L, direction="bidirect",
                               time_major=time_major)
    _carry(ref, port)
    shape = (S, B, I) if time_major else (B, S, I)
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    r = np.random.RandomState(1)
    if mode == "LSTM":
        init_np = [r.randn(2 * L, B, H).astype(np.float32) for _ in range(2)]
    else:
        init_np = r.randn(2 * L, B, H).astype(np.float32)

    def init(pd):
        if isinstance(init_np, list):
            return tuple(pd.to_tensor(a) for a in init_np)
        return pd.to_tensor(init_np)
    _compare(_forward_backward(P, ref, x, init(P)),
             _forward_backward(T, port, x, init(T)))


class _RefSimpleRNN:
    """The reference's SimpleRNN function from its own cells: each layer a
    BiRNN over SimpleRNNCells, the next layer fed the concatenated
    directions."""

    def __init__(self, activation):
        self.cells = [P.nn.SimpleRNNCell(I if layer == 0 else 2 * H, H,
                                         activation=activation)
                      for layer in range(L) for _ in range(2)]
        self.layers = [P.nn.BiRNN(self.cells[2 * layer],
                                  self.cells[2 * layer + 1])
                       for layer in range(L)]

    def state_dict(self):
        return {f"cells.{i}.{k}": v for i, c in enumerate(self.cells)
                for k, v in c.state_dict().items()}

    def named_parameters(self):
        return [(f"cells.{i}.{k}", p) for i, c in enumerate(self.cells)
                for k, p in c.named_parameters()]

    def __call__(self, x):
        finals = []
        for layer in self.layers:
            x, (h_fw, h_bw) = layer(x)
            finals += [h_fw, h_bw]
        return x, P.stack(finals, 0)


@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_simple_rnn_matches_reference_cells(activation):
    P.seed(2)
    ref = _RefSimpleRNN(activation)
    port = T.nn.SimpleRNN(I, H, num_layers=L, direction="bidirect",
                          activation=activation)
    _carry(ref, port)
    x = np.random.RandomState(0).randn(B, S, I).astype(np.float32)
    _compare(_forward_backward(P, ref, x), _forward_backward(T, port, x))


def test_reference_simple_rnn_cannot_be_built():
    # the reference defect the oracle above works around
    with pytest.raises(TypeError, match="activation"):
        P.nn.SimpleRNN(I, H)
    assert T.nn.SimpleRNN(I, H).cells[0].activation == "tanh"


@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
def test_cells_rnn_and_birnn_match_reference(cell):
    P.seed(3)
    ref_fw, ref_bw = getattr(P.nn, cell)(I, H), getattr(P.nn, cell)(I, H)
    port_fw, port_bw = getattr(T.nn, cell)(I, H), getattr(T.nn, cell)(I, H)
    _carry(ref_fw, port_fw)
    _carry(ref_bw, port_bw)
    x = np.random.RandomState(0).randn(B, S, I).astype(np.float32)
    # one step of the cell, from zero states
    outs = {}
    for pd, c in ((P, ref_fw), (T, port_fw)):
        out, _ = c(pd.to_tensor(x[:, 0]))
        outs[pd] = out.numpy()
    _close(outs[T], outs[P], f"{cell} step")
    for wrap in ("RNN", "BiRNN"):
        runs = {}
        for pd, fw, bw in ((P, ref_fw, ref_bw), (T, port_fw, port_bw)):
            layer = pd.nn.RNN(fw, is_reverse=True) if wrap == "RNN" \
                else pd.nn.BiRNN(fw, bw)
            runs[pd] = _forward_backward(pd, layer, x)
        _compare(runs[P], runs[T])


def test_sequence_length_is_ignored_as_in_the_reference():
    P.seed(4)
    ref = P.nn.LSTM(I, H, num_layers=1)
    port = T.nn.LSTM(I, H, num_layers=1)
    _carry(ref, port)
    x = np.random.RandomState(0).randn(B, S, I).astype(np.float32)
    lens = np.array([7, 3, 1])
    outs = {}
    for pd, layer in ((P, ref), (T, port)):
        with_len, _ = layer(pd.to_tensor(x),
                            sequence_length=pd.to_tensor(lens))
        without, _ = layer(pd.to_tensor(x))
        np.testing.assert_array_equal(with_len.numpy(), without.numpy())
        outs[pd] = with_len.numpy()
    # the padded steps are run, not masked: equal to the reference's
    _close(outs[T], outs[P], "output with sequence_length")
    assert np.abs(outs[T][2, 1:]).max() > 0


def test_fused_route_is_counted_and_dropout_runs_between_layers():
    trnn.reset_routes()
    lstm = T.nn.LSTM(I, H, num_layers=2, dropout=0.5)
    x = T.to_tensor(np.ones((B, S, I), np.float32))
    out, _ = lstm(x)
    assert trnn.ROUTES == {"cudnn": 0, "aten": 2}
    lstm.eval()
    a, _ = lstm(x)
    b, _ = lstm(x)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
