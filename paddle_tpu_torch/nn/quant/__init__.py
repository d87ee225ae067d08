"""paddle.nn.quant: the port of ``paddle_tpu/nn/quant`` (reference:
nn/quant, the quantized layer building blocks of the QAT/PTQ stack).

Weights are int8, per output channel, symmetric; ``weight_only_linear``
dequantizes them into the activation's dtype and runs one matmul
(cuBLAS's on the card, as the reference hands the product to XLA's dot).
"""
from __future__ import annotations

import torch

from ...core import dtype as dtype_mod
from ...core.dispatch import run_op
from ...core.tensor import Tensor
from ..layer.layers import Layer

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "llm_int8_linear", "QuantizedLinear"]


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """Per-channel symmetric int8 weight quantization of w [in, out]
    (reference nn/quant/quantized_linear.py weight_quantize): returns
    (int8 weight, f32 scale [out])."""
    def f(w):
        scale = torch.amax(w.abs(), dim=0) / 127.0
        q = torch.clamp(torch.round(w / torch.clamp_min(scale, 1e-8)),
                        -127, 127).to(torch.int8)
        return q, scale.float()
    return run_op("weight_quantize", f, _t(x), differentiable=False)


def weight_dequantize(x, scale, algo="weight_only_int8",
                      out_dtype="float16"):
    td = dtype_mod.torch_dtype(str(out_dtype).replace("paddle.", ""))

    def f(q, s):
        return (q.float() * s).to(td)
    return run_op("weight_dequantize", f, _t(x), _t(scale),
                  differentiable=False)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """x @ (int8 weight * scale) (+ bias), with the weight dequantized into
    x's dtype before the product (reference weight_only_linear)."""
    def f(a, w, *rest):
        i = 0
        wf = w.to(a.dtype)
        if weight_scale is not None:
            wf = wf * rest[i].to(a.dtype)
            i += 1
        out = a @ wf
        if bias is not None:
            out = out + rest[i]
        return out
    args = [_t(x), _t(weight)]
    if weight_scale is not None:
        args.append(_t(weight_scale))
    if bias is not None:
        args.append(_t(bias))
    return run_op("weight_only_linear", f, *args)


def llm_int8_linear(x, weight, bias=None, weight_scale=None,
                    threshold=6.0):
    return weight_only_linear(x, weight, bias, weight_scale)


class QuantizedLinear(Layer):
    """Weight-only-int8 Linear (reference nn/quant quantized layers)."""

    def __init__(self, in_features, out_features, bias=True,
                 weight_dtype="int8"):
        super().__init__()
        from ...core.generator import generator_for
        from ...core.place import default_device
        dev = default_device()
        w = torch.empty((in_features, out_features), device=dev).uniform_(
            -0.05, 0.05, generator=generator_for(dev))
        self.quant_weight, self.weight_scale = weight_quantize(Tensor._wrap(w))
        self.bias = self.create_parameter(
            [out_features], default_initializer=None) if bias else None

    def forward(self, x):
        return weight_only_linear(x, self.quant_weight, self.bias,
                                  self.weight_scale)
