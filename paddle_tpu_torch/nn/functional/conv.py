"""Convolutions: the port of ``paddle_tpu/nn/functional/conv.py``
(reference: python/paddle/nn/functional/conv.py over phi conv kernels).

Each is one ``torch.nn.functional.conv*`` call on Paddle's layouts: the
weight is [out, in/groups, *k] ([in, out/groups, *k] transposed), as
torch's; channels-last inputs are moved to channels-first and back. Padding
takes Paddle's forms: an int, one per spatial dim, a (lo, hi) pair per dim,
or "SAME"/"VALID" (SAME as XLA pads it: out = ceil(in / stride), the extra
padding after). Padding torch cannot take symmetrically is applied with
``F.pad`` first (a transposed convolution crops instead).
"""
from __future__ import annotations

import torch.nn.functional as tF

from ...core.dispatch import run_op

_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}
_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) in (n, 2 * n):
            return tuple(int(x) for x in v)
        return tuple(int(v[0]) for _ in range(n))
    return (int(v),) * n


def _pad_pairs(padding, n, in_sizes, ksizes, stride, dilation):
    """(lo, hi) padding of each spatial dim."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return [(0, 0)] * n
        if p != "SAME":
            raise ValueError(padding)
        pairs = []
        for size, k, s, d in zip(in_sizes, ksizes, stride, dilation):
            out = -(-size // s)
            total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
            pairs.append((total // 2, total - total // 2))
        return pairs
    pads = _tuple(padding, n)
    if len(pads) == n:
        return [(p, p) for p in pads]
    return [(pads[2 * i], pads[2 * i + 1]) for i in range(n)]


def _flat_pad(pairs):
    """F.pad's argument: the last dim's (lo, hi) first."""
    return [p for lo_hi in reversed(pairs) for p in lo_hi]


def _conv(name, x, weight, bias, stride, padding, dilation, groups,
          data_format, n):
    stride = _tuple(stride, n)
    dilation = _tuple(dilation, n)
    last = data_format.endswith("C")

    def f(a, w, *maybe_b):
        if last:
            a = a.movedim(-1, 1)
        pairs = _pad_pairs(padding, n, a.shape[2:], w.shape[2:], stride,
                           dilation)
        if all(lo == hi for lo, hi in pairs):
            pad = tuple(lo for lo, _ in pairs)
        else:
            a, pad = tF.pad(a, _flat_pad(pairs)), 0
        out = _CONV[n](a, w, maybe_b[0] if maybe_b else None, stride, pad,
                       dilation, groups)
        return out.movedim(1, -1) if last else out
    if bias is not None:
        return run_op(name, f, x, weight, bias)
    return run_op(name, f, x, weight)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    df = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv("conv1d", x, weight, bias, stride, padding, dilation,
                 groups, df, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv("conv2d", x, weight, bias, stride, padding, dilation,
                 groups, data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv("conv3d", x, weight, bias, stride, padding, dilation,
                 groups, data_format, 3)


def _conv_transpose(name, x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, n, output_size):
    stride = _tuple(stride, n)
    dilation = _tuple(dilation, n)
    opad = _tuple(output_padding, n)
    last = data_format.endswith("C")
    if isinstance(padding, str):
        raise ValueError("string padding unsupported for conv_transpose")
    pads = _tuple(padding, n)
    pairs = [(p, p) for p in pads] if len(pads) == n else \
        [(pads[2 * i], pads[2 * i + 1]) for i in range(n)]
    symmetric = all(lo == hi for lo, hi in pairs)

    def f(a, w, *maybe_b):
        if last:
            a = a.movedim(-1, 1)
        b = maybe_b[0] if maybe_b else None
        if symmetric:
            out = _CONV_T[n](a, w, b, stride, tuple(lo for lo, _ in pairs),
                             opad, groups, dilation)
        else:
            out = _CONV_T[n](a, w, b, stride, 0, opad, groups, dilation)
            for d, (lo, hi) in enumerate(pairs):
                out = out.narrow(2 + d, lo, out.shape[2 + d] - lo - hi)
        return out.movedim(1, -1) if last else out
    if bias is not None:
        return run_op(name, f, x, weight, bias)
    return run_op(name, f, x, weight)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    df = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv_transpose("conv1d_transpose", x, weight, bias, stride,
                           padding, output_padding, dilation, groups, df, 1,
                           output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose("conv2d_transpose", x, weight, bias, stride,
                           padding, output_padding, dilation, groups,
                           data_format, 2, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose("conv3d_transpose", x, weight, bias, stride,
                           padding, output_padding, dilation, groups,
                           data_format, 3, output_size)
