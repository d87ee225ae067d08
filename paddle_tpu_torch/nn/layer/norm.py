"""Norm layers: the port of ``paddle_tpu/nn/layer/norm.py`` (reference:
python/paddle/nn/layer/norm.py)."""
from __future__ import annotations

import math

import torch

from ...core.place import default_device
from ...core.tensor import Tensor
from .. import functional as F
from .. import initializer as I
from .layers import Layer


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            (num_features,), weight_attr,
            default_initializer=I.Constant(1.0)) \
            if weight_attr is not False else None
        self.bias = self.create_parameter(
            (num_features,), bias_attr, is_bias=True) \
            if bias_attr is not False else None
        self.register_buffer("_mean", Tensor._wrap(torch.zeros(
            num_features, dtype=self._dtype, device=default_device())))
        self.register_buffer("_variance", Tensor._wrap(torch.ones(
            num_features, dtype=self._dtype, device=default_device())))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, self.training, self._momentum,
                            self._epsilon, self._data_format,
                            self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """On one card SyncBatchNorm is BatchNorm (reference: nn/layer/norm.py
    SyncBatchNorm over c_sync_calc_stream; the reference's SPMD reduction
    over the sharded batch axis is its sync)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        for l in layer.sublayers(include_self=True):
            if isinstance(l, _BatchNormBase):
                l.__class__ = SyncBatchNorm
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, weight_attr,
            default_initializer=I.Constant(1.0)) \
            if weight_attr is not False else None
        self.bias = self.create_parameter(
            self._normalized_shape, bias_attr, is_bias=True) \
            if bias_attr is not False else None

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    """RMS norm layer (reference: incubate fused_rms_norm)."""

    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, None, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            (num_channels,), weight_attr,
            default_initializer=I.Constant(1.0)) \
            if weight_attr is not False else None
        self.bias = self.create_parameter(
            (num_channels,), bias_attr, is_bias=True) \
            if bias_attr is not False else None

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            (num_features,), weight_attr,
            default_initializer=I.Constant(1.0)) \
            if weight_attr is not False else None
        self.bias = self.create_parameter(
            (num_features,), bias_attr, is_bias=True) \
            if bias_attr is not False else None

    def forward(self, x):
        return F.instance_norm(x, None, None, self.weight, self.bias,
                               eps=self._epsilon)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        dev = default_device()
        self.register_buffer("weight_u", Tensor._wrap(torch.full(
            (h,), 1.0 / math.sqrt(h), dtype=self._dtype, device=dev)))
        self.register_buffer("weight_v", Tensor._wrap(torch.full(
            (w,), 1.0 / math.sqrt(w), dtype=self._dtype, device=dev)))

    def forward(self, weight):
        from ...core.dispatch import run_op
        dim, eps, iters = self._dim, self._epsilon, self._power_iters

        def f(w, u, v):
            wm = w.movedim(dim, 0).reshape(w.shape[dim], -1)
            for _ in range(iters):
                v = wm.T @ u
                v = v / (torch.linalg.norm(v) + eps)
                u = wm @ v
                u = u / (torch.linalg.norm(u) + eps)
            sigma = u @ wm @ v
            return w / sigma
        return run_op("spectral_norm", f, weight, self.weight_u,
                      self.weight_v)
