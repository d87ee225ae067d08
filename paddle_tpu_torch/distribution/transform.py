"""Bijective transforms (reference: python/paddle/distribution/transform.py
— Transform, Abs/Affine/Chain/Exp/Independent/Power/Reshape/Sigmoid/
Softmax/Stack/StickBreaking/Tanh transforms).

Port of ``paddle_tpu/distribution/transform.py``: each transform exposes
forward / inverse / forward_log_det_jacobian over Tensors, and
TransformedDistribution composes them with a base distribution.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as tF

import paddle_tpu_torch as paddle
from ..core.dispatch import run_op
from ..core.tensor import Tensor


class _Type:
    BIJECTION = "bijection"
    INJECTION = "injection"
    SURJECTION = "surjection"
    OTHER = "other"


def _t(x):
    return x if isinstance(x, Tensor) else paddle.to_tensor(x)


def sum_rightmost(x, n):
    """Sum a Tensor over its last `n` dims (n == 0 -> unchanged)."""
    if n <= 0:
        return x
    return run_op("sum_rightmost",
                  lambda a: torch.sum(a, dim=tuple(range(-n, 0))), _t(x))


class Transform:
    _type = _Type.BIJECTION

    def forward(self, x):
        return self._forward(_t(x))

    def inverse(self, y):
        return self._inverse(_t(y))

    def forward_log_det_jacobian(self, x):
        return self._forward_log_det_jacobian(_t(x))

    def inverse_log_det_jacobian(self, y):
        return -self._forward_log_det_jacobian(self.inverse(y))

    def forward_shape(self, shape):
        return tuple(shape)

    def inverse_shape(self, shape):
        return tuple(shape)

    # event dims consumed/produced (reference _domain/_codomain event_rank)
    _domain_event_rank = 0
    _codomain_event_rank = 0


class AffineTransform(Transform):
    """y = loc + scale * x."""

    def __init__(self, loc, scale):
        self.loc = _t(loc)
        self.scale = _t(scale)

    def _forward(self, x):
        return self.loc + self.scale * x

    def _inverse(self, y):
        return (y - self.loc) / self.scale

    def _forward_log_det_jacobian(self, x):
        return run_op("affine_fldj",
                      lambda s, x: torch.log(torch.abs(s)).broadcast_to(
                          x.shape), self.scale, x)


class ExpTransform(Transform):
    def _forward(self, x):
        return paddle.exp(x)

    def _inverse(self, y):
        return paddle.log(y)

    def _forward_log_det_jacobian(self, x):
        return x


class PowerTransform(Transform):
    def __init__(self, power):
        self.power = _t(power)

    def _forward(self, x):
        return x ** self.power

    def _inverse(self, y):
        return y ** (1.0 / self.power)

    def _forward_log_det_jacobian(self, x):
        return run_op(
            "power_fldj",
            lambda p, x: torch.log(torch.abs(p * x ** (p - 1))),
            self.power, x)


class SigmoidTransform(Transform):
    def _forward(self, x):
        return paddle.sigmoid(x)

    def _inverse(self, y):
        return run_op("sigmoid_inv",
                      lambda y: torch.log(y) - torch.log1p(-y), y)

    def _forward_log_det_jacobian(self, x):
        return run_op("sigmoid_fldj",
                      lambda x: -tF.softplus(-x) - tF.softplus(x), x)


class TanhTransform(Transform):
    def _forward(self, x):
        return paddle.tanh(x)

    def _inverse(self, y):
        return run_op("tanh_inv", torch.atanh, y)

    def _forward_log_det_jacobian(self, x):
        # log(1 - tanh(x)^2) = 2 (log 2 - x - softplus(-2x))
        return run_op(
            "tanh_fldj",
            lambda x: 2.0 * (math.log(2.0) - x - tF.softplus(-2.0 * x)), x)


class AbsTransform(Transform):
    """y = |x| — a surjection; inverse returns the positive branch."""
    _type = _Type.SURJECTION

    def _forward(self, x):
        return paddle.abs(x)

    def _inverse(self, y):
        return y

    def _forward_log_det_jacobian(self, x):
        raise NotImplementedError("AbsTransform is not injective")


class SoftmaxTransform(Transform):
    """x -> softmax(x) over the last dim (surjection onto the simplex)."""
    _type = _Type.OTHER
    _domain_event_rank = 1
    _codomain_event_rank = 1

    def _forward(self, x):
        return run_op("softmax_fwd", lambda x: torch.softmax(x, -1), x)

    def _inverse(self, y):
        return paddle.log(y)

    def _forward_log_det_jacobian(self, x):
        raise NotImplementedError("softmax is not a bijection")


def _offset(k, like):
    return torch.arange(k, 0, -1, dtype=like.dtype, device=like.device)


class StickBreakingTransform(Transform):
    """R^{K-1} -> K-simplex via stick breaking (bijection)."""
    _domain_event_rank = 1
    _codomain_event_rank = 1

    def _forward(self, x):
        def f(x):
            z = torch.sigmoid(x - torch.log(_offset(x.shape[-1], x)))
            one = x.new_ones(x.shape[:-1] + (1,))
            zpad = torch.cat([z, one], -1)
            cum = torch.cat([one, torch.cumprod(1 - z, -1)], -1)
            return zpad * cum
        return run_op("stickbreak_fwd", f, x)

    def _inverse(self, y):
        def f(y):
            cum = torch.cumsum(y[..., :-1], -1)
            rem = 1.0 - torch.cat(
                [y.new_zeros(y.shape[:-1] + (1,)), cum[..., :-1]], -1)
            z = y[..., :-1] / rem
            return torch.log(z) - torch.log1p(-z) \
                + torch.log(_offset(y.shape[-1] - 1, y))
        return run_op("stickbreak_inv", f, y)

    def _forward_log_det_jacobian(self, x):
        # dy_k/dz_k = remaining stick before k; dz_k/dt_k = sig(t)sig(-t)
        def f(x):
            t = x - torch.log(_offset(x.shape[-1], x))
            z = torch.sigmoid(t)
            remaining = torch.cat(
                [x.new_ones(x.shape[:-1] + (1,)),
                 torch.cumprod(1 - z, -1)[..., :-1]], -1)
            return torch.sum(tF.logsigmoid(t) + tF.logsigmoid(-t)
                             + torch.log(remaining), -1)
        return run_op("stickbreak_fldj", f, x)

    def forward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)

    def inverse_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)


class ChainTransform(Transform):
    """Composition t_n(...t_1(x))."""

    def __init__(self, transforms):
        self.transforms = list(transforms)
        self._domain_event_rank = max(
            (t._domain_event_rank for t in self.transforms), default=0)
        self._codomain_event_rank = self._domain_event_rank

    def _forward(self, x):
        for t in self.transforms:
            x = t.forward(x)
        return x

    def _inverse(self, y):
        for t in reversed(self.transforms):
            y = t.inverse(y)
        return y

    def _forward_log_det_jacobian(self, x):
        # Mixed event ranks: each term is summed down to the chain's event
        # rank before accumulation (reference ChainTransform / torch
        # ComposeTransform semantics) so an elementwise ldj and an
        # event-rank-1 ldj add at the same (batch) shape.
        event_rank = self._domain_event_rank
        total = None
        for t in self.transforms:
            ldj = sum_rightmost(t.forward_log_det_jacobian(x),
                                event_rank - t._domain_event_rank)
            total = ldj if total is None else total + ldj
            x = t.forward(x)
        return total

    def forward_shape(self, shape):
        for t in self.transforms:
            shape = t.forward_shape(shape)
        return shape


class IndependentTransform(Transform):
    """Reinterpret `reinterpreted_batch_rank` batch dims as event dims: the
    log-det sums over them."""

    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self.rank = int(reinterpreted_batch_rank)
        self._domain_event_rank = base._domain_event_rank + self.rank
        self._codomain_event_rank = base._codomain_event_rank + self.rank

    def _forward(self, x):
        return self.base.forward(x)

    def _inverse(self, y):
        return self.base.inverse(y)

    def _forward_log_det_jacobian(self, x):
        return run_op(
            "indep_fldj",
            lambda l: torch.sum(l, dim=tuple(range(-self.rank, 0))),
            self.base.forward_log_det_jacobian(x))


class ReshapeTransform(Transform):
    def __init__(self, in_event_shape, out_event_shape):
        self.in_event_shape = tuple(int(s) for s in in_event_shape)
        self.out_event_shape = tuple(int(s) for s in out_event_shape)
        if np.prod(self.in_event_shape, dtype=int) != \
                np.prod(self.out_event_shape, dtype=int):
            raise ValueError("in/out event sizes must match")
        self._domain_event_rank = len(self.in_event_shape)
        self._codomain_event_rank = len(self.out_event_shape)

    def _forward(self, x):
        batch = tuple(x.shape)[:x.ndim - len(self.in_event_shape)]
        return paddle.reshape(x, batch + self.out_event_shape)

    def _inverse(self, y):
        batch = tuple(y.shape)[:y.ndim - len(self.out_event_shape)]
        return paddle.reshape(y, batch + self.in_event_shape)

    def _forward_log_det_jacobian(self, x):
        batch = tuple(x.shape)[:x.ndim - len(self.in_event_shape)]
        return paddle.zeros(batch if batch else (1,))

    def forward_shape(self, shape):
        n = len(self.in_event_shape)
        return tuple(shape[:-n] if n else shape) + self.out_event_shape

    def inverse_shape(self, shape):
        n = len(self.out_event_shape)
        return tuple(shape[:-n] if n else shape) + self.in_event_shape


class StackTransform(Transform):
    """Apply transforms[i] to slice i along `axis`."""

    def __init__(self, transforms, axis=0):
        self.transforms = list(transforms)
        self.axis = int(axis)

    def _map(self, x, method):
        parts = []
        for i, t in enumerate(self.transforms):
            sl = paddle.slice(x, [self.axis], [i], [i + 1])
            parts.append(getattr(t, method)(sl))
        return paddle.concat(parts, axis=self.axis)

    def _forward(self, x):
        return self._map(x, "forward")

    def _inverse(self, y):
        return self._map(y, "inverse")

    def _forward_log_det_jacobian(self, x):
        return self._map(x, "forward_log_det_jacobian")
