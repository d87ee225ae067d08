"""The rest of the paddle.nn layers: the port of
``paddle_tpu/nn/layer/extended.py`` (reference:
python/paddle/nn/layer/{loss,pooling,common,distance,rnn}.py): thin Layer
wrappers over nn.functional.extended, and the seq2seq decode utilities
(``BeamSearchDecoder``, ``dynamic_decode``), whose nested states are torch
pytrees of Tensors."""
from __future__ import annotations

import numpy as np
import torch
import torch.utils._pytree as pytree

from ...core.tensor import Parameter, Tensor
from .layers import Layer
from ..functional import extended as FE
from .. import functional as F


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return FE.pairwise_distance(x, y, self.p, self.epsilon,
                                    self.keepdim)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self._a = (log_input, full, epsilon, reduction)

    def forward(self, input, label):
        return FE.poisson_nll_loss(input, label, *self._a)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self._a = (full, epsilon, reduction)

    def forward(self, input, label, variance):
        return FE.gaussian_nll_loss(input, label, variance, *self._a)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self._a = (p, margin, weight, reduction)

    def forward(self, input, label):
        p, margin, weight, reduction = self._a
        return FE.multi_margin_loss(input, label, p, margin, weight,
                                    reduction)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._a = (distance_function, margin, swap, reduction)

    def forward(self, input, positive, negative):
        return FE.triplet_margin_with_distance_loss(
            input, positive, negative, *self._a)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        rng = np.random.RandomState(0)
        bound = 1.0 / np.sqrt(feature_size)
        self.num_classes = num_classes
        self.weight = Parameter(rng.uniform(
            -bound, bound,
            (num_classes - 1, feature_size)).astype(np.float32))
        self.bias = None if bias_attr is False else Parameter(
            np.zeros((num_classes - 1, 1), np.float32))

    def forward(self, input, label, path_table=None, path_code=None):
        return FE.hsigmoid_loss(input, label, self.num_classes,
                                self.weight, self.bias, path_table,
                                path_code)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self._a = (blank, fastemit_lambda, reduction)

    def forward(self, input, label, input_lengths, label_lengths):
        blank, fe, red = self._a
        return FE.rnnt_loss(input, label, input_lengths, label_lengths,
                            blank, fe, red)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Adaptive softmax head (reference nn/layer/loss.py
    AdaptiveLogSoftmaxWithLoss): head covers the shortlist + one slot per
    cluster; tail clusters get down-projected two-matrix heads."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        self.cutoffs = cutoffs + [n_classes]
        self.div_value = div_value
        rng = np.random.RandomState(0)
        n_clusters = len(self.cutoffs) - 1
        head_sz = self.cutoffs[0] + n_clusters
        bound = 1.0 / np.sqrt(in_features)
        self.head_weight = Parameter(rng.uniform(
            -bound, bound, (in_features, head_sz)).astype(np.float32))
        self.head_bias = Parameter(np.zeros(head_sz, np.float32)) \
            if head_bias else None
        self.tail_weights = []
        for c in range(n_clusters):
            lo, hi = self.cutoffs[c], self.cutoffs[c + 1]
            proj = max(1, int(in_features / (div_value ** (c + 1))))
            w1 = Parameter(rng.uniform(
                -bound, bound, (in_features, proj)).astype(np.float32))
            w2 = Parameter(rng.uniform(
                -bound, bound, (proj, hi - lo)).astype(np.float32))
            self.tail_weights.append((w1, w2))
            setattr(self, f"_tail_{c}_0", w1)
            setattr(self, f"_tail_{c}_1", w2)

    def _tail_mats(self):
        import paddle_tpu_torch as paddle
        return [paddle.matmul(w1, w2) for w1, w2 in self.tail_weights]

    def forward(self, input, label):
        return FE.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self._tail_mats(),
            self.cutoffs, self.head_bias)

    def log_prob(self, input):
        import paddle_tpu_torch as paddle
        head = paddle.matmul(input, self.head_weight)
        if self.head_bias is not None:
            head = head + self.head_bias
        head_lp = F.log_softmax(head, -1)
        shortlist = self.cutoffs[0]
        outs = [head_lp[:, :shortlist]]
        for c, tw in enumerate(self._tail_mats()):
            tail_lp = F.log_softmax(paddle.matmul(input, tw), -1)
            outs.append(tail_lp + head_lp[:, shortlist + c:shortlist
                                          + c + 1])
        return paddle.concat(outs, axis=-1)

    def predict(self, input):
        import paddle_tpu_torch as paddle
        return paddle.argmax(self.log_prob(input), axis=-1)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return FE.feature_alpha_dropout(x, self.p, self.training)


class Softmax2D(Layer):
    """Softmax over channel dim of NCHW (reference nn/layer/activation.py
    Softmax2D)."""

    def forward(self, x):
        assert x.ndim in (3, 4), "Softmax2D expects 3-D/4-D input"
        return F.softmax(x, axis=-3)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape_ = axis, shape

    def forward(self, x):
        import paddle_tpu_torch as paddle
        return paddle.unflatten(x, self.axis, self.shape_)


class ZeroPad1D(Layer):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__()
        self.padding = [padding, padding] if isinstance(padding, int) \
            else list(padding)
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode="constant", value=0.0,
                     data_format=self.data_format)


class ZeroPad3D(Layer):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__()
        self.padding = [padding] * 6 if isinstance(padding, int) \
            else list(padding)
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode="constant", value=0.0,
                     data_format=self.data_format)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__()
        self._a = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, os_ = self._a
        return FE.max_unpool1d(x, indices, k, s, p, df, os_)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self._a = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, os_ = self._a
        return FE.max_unpool2d(x, indices, k, s, p, df, os_)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__()
        self._a = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, os_ = self._a
        return FE.max_unpool3d(x, indices, k, s, p, df, os_)


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self._a = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        return FE.fractional_max_pool2d(x, *self._a)


class FractionalMaxPool3D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self._a = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        return FE.fractional_max_pool3d(x, *self._a)


class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self._a = (norm_type, kernel_size, stride, padding, ceil_mode,
                   data_format)

    def forward(self, x):
        n, k, s, p, c, df = self._a
        return F.lp_pool1d(x, n, k, s, p, c, df)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self._a = (norm_type, kernel_size, stride, padding, ceil_mode,
                   data_format)

    def forward(self, x):
        n, k, s, p, c, df = self._a
        return F.lp_pool2d(x, n, k, s, p, c, df)


# ---------------------------------------------------------------------------
# seq2seq decoding (reference nn/layer/rnn.py BeamSearchDecoder +
# nn/decode.py dynamic_decode). Eager loop over steps; each step is one
# XLA computation — the idiomatic jit path is lax.while_loop inside
# paddle.jit.to_static, which this decoder supports via static max_step.
# ---------------------------------------------------------------------------

class BeamSearchDecoder:
    """Beam-search wrapper over an RNN cell (reference
    nn/layer/rnn.py:BeamSearchDecoder)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        import paddle_tpu_torch as paddle
        states = initial_cell_states
        if isinstance(states, (list, tuple)) and len(states) == 1:
            states = states[0]
        leaves = [s for s in pytree.tree_leaves(states)
                  if isinstance(s, Tensor)] or pytree.tree_leaves(states)
        batch = leaves[0].shape[0]
        k = self.beam_size

        def tile(s):
            return paddle.reshape(
                paddle.tile(paddle.unsqueeze(s, 1), [1, k] + [1] *
                            (s.ndim - 1)),
                [batch * k] + list(s.shape[1:]))
        states = pytree.tree_map(tile, states)
        ids = paddle.full([batch, k], self.start_token, dtype="int64")
        # only beam 0 is live at t=0
        probs = np.full((batch, k), -1e9, np.float32)
        probs[:, 0] = 0.0
        log_probs = paddle.to_tensor(probs)
        finished = paddle.zeros([batch, k], dtype="bool")
        return ids, states, log_probs, finished

    def step(self, inputs, states):
        if self.embedding_fn is not None:
            inputs = self.embedding_fn(inputs)
        out, new_states = self.cell(inputs, states)
        if self.output_fn is not None:
            out = self.output_fn(out)
        return out, new_states


def dynamic_decode(decoder, inits=None, max_step_num=100,
                   output_time_major=False, is_test=False,
                   return_length=False, **kwargs):
    """Unrolled beam-search decode (reference nn/decode.py
    dynamic_decode). Keeps the K best hypotheses per step; stops when all
    beams emit end_token or max_step_num is reached (one host read of
    that flag a step)."""
    import paddle_tpu_torch as paddle
    ids, states, log_probs, finished = decoder.initialize(inits)
    batch, k = ids.shape
    end = decoder.end_token
    step_ids = []
    lengths = paddle.zeros([batch, k], dtype="int64")
    cur = ids
    for _ in range(max_step_num):
        flat = paddle.reshape(cur, [batch * k])
        logits, states = decoder.step(flat, states)
        vocab = logits.shape[-1]
        lp = paddle.nn.functional.log_softmax(
            paddle.reshape(logits, [batch, k, vocab]), axis=-1)._data
        # frozen finished beams: only end_token continues, with lp 0
        mask = torch.full((1, 1, vocab), -1e9, dtype=lp.dtype,
                          device=lp.device)
        mask[0, 0, end] = 0.0
        fin = finished._data
        lp = torch.where(fin[:, :, None], mask, lp)
        total = log_probs._data[:, :, None] + lp            # [B,K,V]
        top_v, top_i = torch.topk(total.reshape(batch, k * vocab), k)
        beam_idx = top_i // vocab
        tok = top_i % vocab
        log_probs = Tensor._wrap(top_v)
        fin = torch.gather(fin, 1, beam_idx) | (tok == end)
        finished = Tensor._wrap(fin)
        lengths = Tensor._wrap(torch.gather(lengths._data, 1, beam_idx)
                               + (~fin).to(torch.int64))

        def reorder(s):
            arr = s._data.reshape((batch, k) + tuple(s._data.shape[1:]))
            idx = beam_idx.reshape((batch, k) + (1,) * (arr.ndim - 2))
            arr = torch.gather(arr, 1, idx.expand((batch, k)
                                                  + tuple(arr.shape[2:])))
            return Tensor._wrap(arr.reshape((batch * k,)
                                            + tuple(arr.shape[2:])))
        states = pytree.tree_map(reorder, states)
        cur = Tensor._wrap(tok.to(torch.int64))
        step_ids.append(cur)
        if bool(torch.all(fin)):
            break
    out = paddle.stack(step_ids, axis=0)  # [T, B, K]
    if not output_time_major:
        out = paddle.transpose(out, [1, 2, 0])  # [B, K, T]
    if return_length:
        return out, log_probs, lengths
    return out, log_probs


__all__ = [
    "PairwiseDistance", "PoissonNLLLoss", "GaussianNLLLoss",
    "MultiMarginLoss", "TripletMarginWithDistanceLoss", "HSigmoidLoss",
    "RNNTLoss", "AdaptiveLogSoftmaxWithLoss", "FeatureAlphaDropout",
    "Softmax2D", "Unflatten", "ZeroPad1D", "ZeroPad3D", "MaxUnPool1D",
    "MaxUnPool2D", "MaxUnPool3D", "FractionalMaxPool2D",
    "FractionalMaxPool3D", "LPPool1D", "LPPool2D", "BeamSearchDecoder",
    "dynamic_decode",
]
