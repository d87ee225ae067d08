"""Activation functionals: the port of
``paddle_tpu/nn/functional/activation.py`` (reference: python/paddle/nn/
functional/activation.py). Each is one ``run_op`` over a torch function
with the reference's semantics; ``gelu(approximate=True)`` is the tanh
form. Random draws (``rrelu``, ``gumbel_softmax``) come from the port's
generator."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...core import dtype as dtype_mod
from ...core.dispatch import rebind_inplace, run_op, run_op_inplace
from ...core.generator import generator_for, traced
from ...ops.math import jax_clip


def relu(x, name=None):
    return run_op("relu", torch.relu, x)


def relu_(x, name=None):
    return run_op_inplace("relu_", torch.relu, x)


def relu6(x, name=None):
    return run_op("relu6", tF.relu6, x)


def leaky_relu(x, negative_slope=0.01, name=None):
    # jax.nn.leaky_relu's select: the gradient at 0 is 1 (torch's slope)
    return run_op("leaky_relu",
                  lambda a: torch.where(a >= 0, a, negative_slope * a), x)


def prelu(x, weight, data_format="NCHW", name=None):
    def f(a, w):
        if w.numel() == 1:
            wb = w.reshape(())
        else:
            shape = [1] * a.dim()
            ch = 1 if data_format[1] == "C" else a.dim() - 1
            shape[ch] = w.numel()
            wb = w.reshape(shape)
        return torch.where(a > 0, a, wb * a)
    return run_op("prelu", f, x, weight)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    if training:
        gen = generator_for(x._data.device)

        def f(a):
            slope = (gen.uniform(a.shape, a.device, a.dtype, lower, upper)
                     if traced(gen) else torch.empty_like(a).uniform_(
                         lower, upper, generator=gen))
            return torch.where(a >= 0, a, slope * a)
        return run_op("rrelu", f, x)
    return leaky_relu(x, (lower + upper) / 2.0)


def elu(x, alpha=1.0, name=None):
    return run_op("elu", lambda a: tF.elu(a, alpha), x)


def elu_(x, alpha=1.0, name=None):
    return run_op_inplace("elu_", lambda a: tF.elu(a, alpha), x)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return run_op("selu",
                  lambda a: scale * torch.where(
                      a > 0, a, alpha * (torch.exp(a) - 1)), x)


def celu(x, alpha=1.0, name=None):
    return run_op("celu", lambda a: tF.celu(a, alpha), x)


def gelu(x, approximate=False, name=None):
    mode = "tanh" if approximate else "none"
    return run_op("gelu", lambda a: tF.gelu(a, approximate=mode), x)


def silu(x, name=None):
    return run_op("silu", tF.silu, x)


def swish(x, name=None):
    return run_op("swish", tF.silu, x)


def hardswish(x, name=None):
    return run_op("hardswish",
                  lambda a: a * jax_clip(a + 3.0, 0.0, 6.0) / 6.0, x)


def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5, name=None):
    return run_op("hardsigmoid",
                  lambda a: jax_clip(slope * a + offset, 0.0, 1.0), x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return run_op("hardtanh", lambda a: jax_clip(a, min, max), x)


def hardshrink(x, threshold=0.5, name=None):
    return run_op("hardshrink",
                  lambda a: torch.where(torch.abs(a) > threshold, a, 0.0), x)


def softshrink(x, threshold=0.5, name=None):
    return run_op("softshrink",
                  lambda a: torch.where(
                      a > threshold, a - threshold,
                      torch.where(a < -threshold, a + threshold,
                                  torch.zeros_like(a))), x)


def tanhshrink(x, name=None):
    return run_op("tanhshrink", lambda a: a - torch.tanh(a), x)


def mish(x, name=None):
    return run_op("mish", tF.mish, x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return run_op("softplus",
                  lambda a: torch.where(
                      beta * a > threshold, a,
                      (1.0 / beta) * torch.log1p(torch.exp(beta * a))), x)


def softsign(x, name=None):
    return run_op("softsign", tF.softsign, x)


def sigmoid(x, name=None):
    return run_op("sigmoid", torch.sigmoid, x)


def tanh(x, name=None):
    return run_op("tanh", torch.tanh, x)


def tanh_(x, name=None):
    return run_op_inplace("tanh_", torch.tanh, x)


def log_sigmoid(x, name=None):
    return run_op("log_sigmoid", tF.logsigmoid, x)


def maxout(x, groups, axis=1, name=None):
    def f(a):
        ax = axis % a.dim()
        c = a.shape[ax]
        new_shape = a.shape[:ax] + (c // groups, groups) + a.shape[ax + 1:]
        return torch.amax(a.reshape(new_shape), dim=ax + 1)
    return run_op("maxout", f, x)


def softmax(x, axis=-1, dtype=None, name=None):
    d = dtype_mod.torch_dtype(dtype)
    return run_op("softmax", lambda a: torch.softmax(
        a if d is None else a.to(d), dim=axis), x)


def softmax_(x, axis=-1, dtype=None, name=None):
    return run_op_inplace("softmax_", lambda a: torch.softmax(a, dim=axis), x)


def log_softmax(x, axis=-1, dtype=None, name=None):
    d = dtype_mod.torch_dtype(dtype)
    return run_op("log_softmax", lambda a: torch.log_softmax(
        a if d is None else a.to(d), dim=axis), x)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    gen = generator_for(x._data.device)

    def f(a):
        u = (gen.uniform(a.shape, a.device, a.dtype) if traced(gen)
             else torch.empty_like(a).uniform_(generator=gen))
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(a.dtype).tiny)))
        y = torch.softmax((a + g) / temperature, dim=axis)
        if hard:
            idx = torch.argmax(y, dim=axis, keepdim=True)
            y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
            return y_hard - y.detach() + y
        return y
    return run_op("gumbel_softmax", f, x)


def glu(x, axis=-1, name=None):
    return run_op("glu", lambda a: tF.glu(a, dim=axis), x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return run_op("thresholded_relu",
                  lambda a: torch.where(a > threshold, a,
                                        torch.full_like(a, value)), x)


def hardtanh_(x, min=-1.0, max=1.0, name=None):
    return rebind_inplace(x, hardtanh(x, min, max))


def leaky_relu_(x, negative_slope=0.01, name=None):
    return rebind_inplace(x, leaky_relu(x, negative_slope))


def thresholded_relu_(x, threshold=1.0, value=0.0, name=None):
    return rebind_inplace(x, thresholded_relu(x, threshold, value))


__all__ = [n for n in dir() if not n.startswith("_")
           and n not in ("annotations", "torch", "tF", "dtype_mod", "run_op",
                         "run_op_inplace", "rebind_inplace", "generator_for")]
