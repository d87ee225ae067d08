"""paddle.sparse.nn — layers over sparse COO tensors (reference:
python/paddle/sparse/nn/{layer,functional}/ over phi sparse conv/pool/bn
kernels).

Port of ``paddle_tpu/sparse/nn/__init__.py``: Conv3D/SubmConv3D run a
dense convolution on the densified block and keep the output's nonzeros
(submanifold: the input's active set), as the reference does. The
weights are the reference's draws (``RandomState(0)``), so a layer built
here equals the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Parameter, Tensor
from ...nn.layer.layers import Layer
from . import functional  # noqa: F401
from .functional import _channels_dense, _sp


class ReLU(Layer):
    def forward(self, x):
        return _sp().relu(x)


class ReLU6(Layer):
    def forward(self, x):
        return _sp().relu6(x)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return _sp().leaky_relu(x, self.negative_slope)


class Softmax(Layer):
    """Sparse softmax over the last dense dim: softmax across the stored
    values of each row (reference sparse softmax kernel semantics for CSR:
    normalization is over nonzeros only)."""

    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return functional.softmax(x, self.axis)


class BatchNorm(Layer):
    """BatchNorm over the channel (last) axis of a sparse NDHWC tensor:
    statistics computed over stored values only (matching the reference,
    which normalizes the nnz values per channel)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 data_format="NDHWC", use_global_stats=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = Parameter(np.ones(num_features, np.float32))
        self.bias = Parameter(np.zeros(num_features, np.float32))
        self.register_buffer("_mean",
                             Tensor(np.zeros(num_features, np.float32)))
        self.register_buffer("_variance",
                             Tensor(np.ones(num_features, np.float32)))

    def forward(self, x):
        sp = _sp()
        b = _channels_dense(x)
        vals = b._val  # [nnz, C]
        if self.training:
            mean = torch.mean(vals, dim=0)
            var = torch.var(vals, dim=0, unbiased=False)
            m = self.momentum
            with torch.no_grad():
                self._mean._assign_array(
                    m * self._mean._data + (1 - m) * mean.detach())
                self._variance._assign_array(
                    m * self._variance._data + (1 - m) * var.detach())
        else:
            mean, var = self._mean._data, self._variance._data
        inv = torch.rsqrt(var + self.epsilon)
        out = (vals - mean) * inv * self.weight._data + self.bias._data
        return sp.SparseCooTensor._wrap_coo(
            b._idx, out.to(vals.dtype), b._shape, False, b._coalesced)


class SyncBatchNorm(BatchNorm):
    """Cross-replica BatchNorm; in one process it equals BatchNorm."""


def _init_conv(layer, in_channels, out_channels, kernel_size, groups,
               bias_attr, ndim):
    ks = (kernel_size,) * ndim if isinstance(kernel_size, int) \
        else tuple(kernel_size)
    fan_in = in_channels * int(np.prod(ks))
    bound = 1.0 / np.sqrt(fan_in)
    rng = np.random.RandomState(0)
    layer.weight = Parameter(rng.uniform(
        -bound, bound,
        ks + (in_channels // groups, out_channels)).astype(np.float32))
    layer.bias = None if bias_attr is False else Parameter(
        rng.uniform(-bound, bound, (out_channels,)).astype(np.float32))


class Conv3D(Layer):
    """Sparse 3-D conv (reference sparse conv3d): the dense convolution;
    the output is made sparse again from its natural support."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NDHWC",
                 key=None):
        super().__init__()
        _init_conv(self, in_channels, out_channels, kernel_size, groups,
                   bias_attr, 3)
        self._cfg = (stride, padding, dilation, groups)
        self._subm = False

    def forward(self, x):
        stride, padding, dilation, groups = self._cfg
        return functional._conv(
            x, self.weight, self.bias, stride, padding, dilation,
            groups, subm=self._subm, ndim=3)


class SubmConv3D(Conv3D):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._subm = True


class Conv2D(Layer):
    """Sparse 2-D conv (NHWC) — same dense-compute design as Conv3D."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NHWC"):
        super().__init__()
        _init_conv(self, in_channels, out_channels, kernel_size, groups,
                   bias_attr, 2)
        self._cfg = (stride, padding, dilation, groups)
        self._subm = False

    def forward(self, x):
        stride, padding, dilation, groups = self._cfg
        return functional._conv(
            x, self.weight, self.bias, stride, padding, dilation,
            groups, subm=self._subm, ndim=2)


class SubmConv2D(Conv2D):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._subm = True


class MaxPool3D(Layer):
    """Sparse max pool over NDHWC (reference sparse max_pool3d)."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NDHWC"):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return functional.max_pool3d(x, self.kernel_size, self.stride,
                                     self.padding)


__all__ = ["functional",
           "ReLU", "ReLU6", "LeakyReLU", "Softmax", "BatchNorm",
           "SyncBatchNorm", "Conv2D", "Conv3D", "SubmConv2D", "SubmConv3D",
           "MaxPool3D"]
