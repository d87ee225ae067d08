"""Pooling functionals: the port of ``paddle_tpu/nn/functional/pooling.py``
(reference: python/paddle/nn/functional/pooling.py).

The reference pools with ``lax.reduce_window`` over explicitly padded
windows: max pads with -inf, average divides by the count of real elements
in each window (``exclusive``) or by the window size, and ``ceil_mode``
extends the upper padding so that the last partial window is kept. The
port computes the same padding and calls torch's pools: the padding goes to
torch where torch takes it as the reference means it (symmetric, at most
half the window, no ceil extension), else it is applied first and the
counts are pooled beside the sums. Adaptive pools are torch's, whose bins
(floor(i * in / out) to ceil((i + 1) * in / out)) are the reference's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ...core.dispatch import run_op

_MAX = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}
_AVG = {1: tF.avg_pool1d, 2: tF.avg_pool2d, 3: tF.avg_pool3d}
_ADAPTIVE = {("avg", 1): tF.adaptive_avg_pool1d,
             ("avg", 2): tF.adaptive_avg_pool2d,
             ("avg", 3): tF.adaptive_avg_pool3d,
             ("max", 1): tF.adaptive_max_pool1d,
             ("max", 2): tF.adaptive_max_pool2d,
             ("max", 3): tF.adaptive_max_pool3d}


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _pairs(padding, n, ceil_mode, sizes, ksize, stride):
    """The reference's (lo, hi) padding of each spatial dim ("SAME" and
    "VALID" as XLA's reduce_window pads them)."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * n
        pairs = []
        for size, k, s in zip(sizes, ksize, stride):
            out = -(-size // s)
            total = max((out - 1) * s + k - size, 0)
            pairs.append((total // 2, total - total // 2))
        return pairs
    p = _tuple(padding, n)
    pairs = [(x, x) for x in p] if len(p) == n else \
        [(p[2 * i], p[2 * i + 1]) for i in range(n)]
    if ceil_mode:
        out = []
        for size, (lo, hi), k, s in zip(sizes, pairs, ksize, stride):
            rem = (size + lo + hi - k) % s
            out.append((lo, hi + ((s - rem) % s if rem else 0)))
        pairs = out
    return pairs


def _native(pairs, ksize):
    """Padding torch applies as the reference means it, or None."""
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pairs, ksize)):
        return tuple(lo for lo, _ in pairs)
    return None


def _flat(pairs):
    return [p for lo_hi in reversed(pairs) for p in lo_hi]


def _pool(name, x, n, kind, kernel_size, stride, padding, ceil_mode,
          channels_last, exclusive=True, divisor_override=None):
    ksize = _tuple(kernel_size, n)
    stride = _tuple(stride if stride is not None else kernel_size, n)

    def f(a):
        if channels_last:
            a = a.movedim(-1, 1)
        pairs = _pairs(padding, n, ceil_mode, a.shape[2:], ksize, stride)
        native = _native(pairs, ksize)
        if kind == "max":
            if native is None:
                a, native = tF.pad(a, _flat(pairs), value=-math.inf), 0
            out = _MAX[n](a, ksize, stride, native)
        elif divisor_override:
            out = _AVG[n](tF.pad(a, _flat(pairs)), ksize, stride, 0,
                          divisor_override=divisor_override)
        elif native is not None:
            out = _AVG[n](a, ksize, stride, native,
                          count_include_pad=not exclusive)
        else:
            padded = tF.pad(a, _flat(pairs))
            out = _AVG[n](padded, ksize, stride, 0)
            if exclusive:
                ones = tF.pad(torch.ones_like(a[:1, :1]), _flat(pairs))
                out = out / _AVG[n](ones, ksize, stride, 0)
        return out.movedim(1, -1) if channels_last else out
    return run_op(name, f, x)


def _max_pool_with_mask(name, x, n, kernel_size, stride, padding,
                        ceil_mode, channels_last):
    """Max pool returning (out, flat argmax indices over the pooled
    spatial dims of the input): torch's max pool with indices, whose ties
    go to the first index, as the reference's."""
    ksize = _tuple(kernel_size, n)
    stride_t = _tuple(stride if stride is not None else kernel_size, n)
    out = _pool(name, x, n, "max", kernel_size, stride, padding, ceil_mode,
                channels_last)

    def f_mask(a):
        if channels_last:
            a = a.movedim(-1, 1)
        pairs = _pairs(padding, n, False, a.shape[2:], ksize, stride_t)
        _, idx = _MAX[n](a, ksize, stride_t, tuple(lo for lo, _ in pairs),
                         ceil_mode=ceil_mode, return_indices=True)
        return idx.movedim(1, -1) if channels_last else idx
    return out, run_op(name + "_mask", f_mask, x, differentiable=False)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    cl = data_format.endswith("C") and data_format not in ("NCL", "NCW")
    if return_mask:
        return _max_pool_with_mask("max_pool1d", x, 1, kernel_size,
                                   stride, padding, ceil_mode, cl)
    return _pool("max_pool1d", x, 1, "max", kernel_size, stride, padding,
                 ceil_mode, cl)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        return _max_pool_with_mask("max_pool2d", x, 2, kernel_size,
                                   stride, padding, ceil_mode,
                                   data_format == "NHWC")
    return _pool("max_pool2d", x, 2, "max", kernel_size, stride, padding,
                 ceil_mode, data_format == "NHWC")


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        return _max_pool_with_mask("max_pool3d", x, 3, kernel_size,
                                   stride, padding, ceil_mode,
                                   data_format == "NDHWC")
    return _pool("max_pool3d", x, 3, "max", kernel_size, stride, padding,
                 ceil_mode, data_format == "NDHWC")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool("avg_pool1d", x, 1, "avg", kernel_size, stride, padding,
                 ceil_mode, False, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool("avg_pool2d", x, 2, "avg", kernel_size, stride, padding,
                 ceil_mode, data_format == "NHWC", exclusive,
                 divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool("avg_pool3d", x, 3, "avg", kernel_size, stride, padding,
                 ceil_mode, data_format == "NDHWC", exclusive,
                 divisor_override)


def _adaptive_pool(name, x, n, kind, output_size, channels_last):
    osize = _tuple(output_size, n)
    fn = _ADAPTIVE[(kind, n)]

    def f(a):
        if channels_last:
            a = a.movedim(-1, 1)
        out = fn(a, osize)
        return out.movedim(1, -1) if channels_last else out
    return run_op(name, f, x)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool("adaptive_avg_pool1d", x, 1, "avg", output_size,
                          False)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool("adaptive_avg_pool2d", x, 2, "avg", output_size,
                          data_format == "NHWC")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool("adaptive_avg_pool3d", x, 3, "avg", output_size,
                          data_format == "NDHWC")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool("adaptive_max_pool1d", x, 1, "max", output_size,
                          False)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool("adaptive_max_pool2d", x, 2, "max", output_size,
                          False)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool("adaptive_max_pool3d", x, 3, "max", output_size,
                          False)


def _lp_pool(name, x, n, norm_type, kernel_size, stride, padding, ceil_mode,
             channels_last):
    """(sum over the window of |a|^p)^(1/p)."""
    p = float(norm_type)
    ksize = _tuple(kernel_size, n)
    stride_t = _tuple(stride if stride is not None else kernel_size, n)

    def f(a):
        if channels_last:
            a = a.movedim(-1, 1)
        pairs = _pairs(padding, n, ceil_mode, a.shape[2:], ksize, stride_t)
        s = _AVG[n](tF.pad(torch.pow(torch.abs(a), p), _flat(pairs)), ksize,
                    stride_t, 0, divisor_override=1) if n > 1 else \
            _AVG[n](tF.pad(torch.pow(torch.abs(a), p), _flat(pairs)), ksize,
                    stride_t, 0) * ksize[0]
        out = torch.pow(s, 1.0 / p)
        return out.movedim(1, -1) if channels_last else out
    return run_op(name, f, x)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    return _lp_pool("lp_pool1d", x, 1, norm_type, kernel_size, stride,
                    padding, ceil_mode, False)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool("lp_pool2d", x, 2, norm_type, kernel_size, stride,
                    padding, ceil_mode, data_format == "NHWC")
