"""Primitive decompositions of composite ops (reference:
decomposition/rules.py — the reference's op list, written over primitive
torch ops on torch tensors)."""
from __future__ import annotations

import math

import torch

from .register import register_decomp


@register_decomp("softmax")
def softmax(x, axis=-1):
    m = torch.amax(x, dim=axis, keepdim=True)
    e = torch.exp(x - m)
    return e / torch.sum(e, dim=axis, keepdim=True)


@register_decomp("log_softmax")
def log_softmax(x, axis=-1):
    m = torch.amax(x, dim=axis, keepdim=True)
    s = x - m
    return s - torch.log(torch.sum(torch.exp(s), dim=axis, keepdim=True))


@register_decomp("gelu")
def gelu(x, approximate=False):
    if approximate:
        c = math.sqrt(2.0 / math.pi)
        return 0.5 * x * (1 + torch.tanh(c * (x + 0.044715 * x ** 3)))
    return 0.5 * x * (1 + torch.erf(x / math.sqrt(2.0)))


@register_decomp("silu")
def silu(x):
    return x * (1 / (1 + torch.exp(-x)))


@register_decomp("layer_norm")
def layer_norm(x, scale=None, bias=None, epsilon=1e-5,
               begin_norm_axis=-1):
    axes = tuple(range(begin_norm_axis if begin_norm_axis >= 0
                       else x.dim() + begin_norm_axis, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=axes, keepdim=True)
    out = (x - mean) / torch.sqrt(var + epsilon)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


@register_decomp("rms_norm")
def rms_norm(x, scale=None, epsilon=1e-6):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x / torch.sqrt(var + epsilon)
    return out * scale if scale is not None else out


@register_decomp("batch_norm")
def batch_norm(x, mean, variance, scale=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    shape = [1, -1] + [1] * (x.dim() - 2) if data_format == "NCHW" \
        else [1] * (x.dim() - 1) + [-1]
    out = (x - mean.reshape(shape)) / torch.sqrt(
        variance.reshape(shape) + epsilon)
    if scale is not None:
        out = out * scale.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@register_decomp("dropout")
def dropout(x, mask, p=0.5):
    return x * mask / (1.0 - p)


@register_decomp("mean")
def mean(x, axis=None, keepdim=False):
    if axis is None:
        s = torch.sum(x).reshape((1,) * x.dim() if keepdim else ())
        return s / x.numel()
    axes = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    n = math.prod(x.shape[a] for a in axes)
    return torch.sum(x, dim=axes, keepdim=keepdim) / n


@register_decomp("sigmoid")
def sigmoid(x):
    return 1 / (1 + torch.exp(-x))


@register_decomp("swiglu")
def swiglu(x, y=None):
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return x * (1 / (1 + torch.exp(-x))) * y


@register_decomp("squared_l2_norm")
def squared_l2_norm(x):
    return torch.sum(x * x)
