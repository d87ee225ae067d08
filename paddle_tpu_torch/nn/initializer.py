"""Weight initializers: the port of ``paddle_tpu/nn/initializer.py``
(reference: python/paddle/nn/initializer/*).

Each initializer returns a torch tensor of the asked shape and dtype on the
current place (``set_device``). Random draws come from the port's default
``Generator`` (core/generator.py), so they are reproducible under
``paddle.seed`` but never equal to the reference's jax draws. Normal draws
are made in float32 and cast, as the reference's are.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.generator import generator_for, traced
from ..core.place import default_device


def _dt(dtype):
    return dtype_mod.torch_dtype(dtype)


def _normal(shape):
    dev = default_device()
    gen = generator_for(dev)
    if traced(gen):
        return gen.normal(tuple(shape), dev)
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=dev)


def _uniform(shape, low, high, dtype):
    dev = default_device()
    gen = generator_for(dev)
    if traced(gen):
        return gen.uniform(tuple(shape), dev, _dt(dtype) or torch.float32,
                           low, high)
    out = torch.empty(tuple(shape), dtype=_dt(dtype), device=dev)
    return out.uniform_(low, high, generator=gen)


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3.0,
        "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    return gains[nonlinearity]


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value, dtype=_dt(dtype),
                          device=default_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        return (self.mean + self.std * _normal(shape)).to(_dt(dtype))


class TruncatedNormal(Initializer):
    """mean + std * z with z standard normal truncated to [a, b], drawn by
    the inverse CDF of a uniform draw in [Phi(a), Phi(b)]."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype):
        lo = 0.5 * (1 + math.erf(self.a / math.sqrt(2)))
        hi = 0.5 * (1 + math.erf(self.b / math.sqrt(2)))
        u = _uniform(shape, lo, hi, "float32")
        z = math.sqrt(2) * torch.erfinv(2 * u - 1)
        z = z.clamp(self.a, self.b)
        return (self.mean + self.std * z).to(_dt(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        return _uniform(shape, self.low, self.high, dtype)


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 2:
        return (shape[0] if shape else 1,) * 2
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    # paddle convention: weight [out, in, *k] for conv, [in, out] for linear
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    else:
        fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    return fan_in, fan_out


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (std * _normal(shape)).to(_dt(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit, dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return (gain / math.sqrt(fi) * _normal(shape)).to(_dt(dtype))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, -limit, limit, dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        from ..core.tensor import Tensor
        v = self.value._data.detach() if isinstance(self.value, Tensor) \
            else dtype_mod.from_numpy(np.asarray(self.value))
        return v.reshape(tuple(shape)).to(device=default_device(),
                                          dtype=_dt(dtype))


class Orthogonal(Initializer):
    """gain * Q of the QR decomposition of a standard normal
    [max(rows, cols), min(rows, cols)] matrix, signs fixed by R's diagonal
    (jax.nn.initializers.orthogonal's construction)."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype):
        rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        cols = shape[-1]
        a = _normal((max(rows, cols), min(rows, cols)))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q.reshape(tuple(shape))).to(_dt(dtype))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype):
        w = np.zeros(shape, np.float32)
        out_c, in_c = shape[0], shape[1]
        centers = [s // 2 for s in shape[2:]]
        per = out_c // self.groups
        for g in range(self.groups):
            for i in range(min(per, in_c)):
                idx = (g * per + i, i) + tuple(centers)
                w[idx] = 1.0
        return torch.from_numpy(w).to(device=default_device(),
                                      dtype=_dt(dtype))


class Bilinear(Initializer):
    """Bilinear-interpolation kernel init for transposed-conv upsampling
    (reference nn/initializer/Bilinear)."""

    def __call__(self, shape, dtype):
        if len(shape) != 4:
            raise ValueError("Bilinear init expects a 4-D conv weight")
        k = shape[-1]
        factor = (k + 1) // 2
        center = factor - 1 if k % 2 == 1 else factor - 0.5
        og = np.ogrid[:k, :k]
        filt = ((1 - np.abs(og[0] - center) / factor)
                * (1 - np.abs(og[1] - center) / factor))
        w = np.zeros(shape, np.float32)
        for i in range(min(shape[0], shape[1])):
            w[i, i] = filt
        return torch.from_numpy(w).to(device=default_device(),
                                      dtype=_dt(dtype))


# default initializer used by layers when weight_attr is None
_GLOBAL_DEFAULT = XavierUniform()


def set_global_initializer(weight_init, bias_init=None):
    global _GLOBAL_DEFAULT
    _GLOBAL_DEFAULT = weight_init
