"""Normalization functionals: the port of
``paddle_tpu/nn/functional/norm.py`` (reference: python/paddle/nn/
functional/norm.py; rms_norm from incubate fused_rms_norm).

``batch_norm``, ``layer_norm``, ``instance_norm`` and ``group_norm`` are
one torch call each. Two differences in rounding, none in the function:
torch keeps the statistics of a bfloat16 ``layer_norm`` (and the other
norms) in float32 where the reference computes them in the input dtype
(``norm.py:72-90``), so bf16 outputs agree to bf16's rounding, not bit for
bit; and BatchNorm's running statistics follow Paddle's convention
``running = m * running + (1 - m) * batch`` (m = 0.9, the unbiased batch
variance), which is torch's update with momentum 1 - m. Where each channel
has one value in training (a batch of one at 1x1), which torch refuses, the
reference's function is computed in torch ops instead. The running
statistics are updated on copies that are then rebound onto the buffers,
so no tensor that autograd or a caller holds is written in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...core.dispatch import run_op


def _channels_last(data_format):
    return data_format.endswith("C") and data_format not in (
        "NCHW", "NCL", "NCDHW")


def _one_value_per_channel(a, rm, rv, w, b, momentum, epsilon):
    """Train-mode batch norm of [N, C, ...] with one value per channel,
    which torch's call refuses: the reference's function
    (``paddle_tpu/nn/functional/norm.py:22-40``). The biased batch variance
    is 0, so the output is the bias (zeros without one); the running mean
    moves toward the value and the running variance toward 0 (the unbiased
    correction n / max(n - 1, 1) is 1)."""
    shape = [1, a.shape[1]] + [1] * (a.dim() - 2)
    m = a.reshape(shape)
    out = (a - m) * epsilon ** -0.5
    if w is not None:
        out = out * w.reshape(shape)
    if b is not None:
        out = out + b.reshape(shape)
    if rm is not None:
        rm.copy_(momentum * rm + (1 - momentum) * m.detach().reshape(-1))
    if rv is not None:
        rv.mul_(momentum)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    last = _channels_last(data_format) and x.ndim > 2
    use_batch_stats = training and not (use_global_stats or False)

    def f(a, rm, rv, *wb):
        w = wb[0] if weight is not None else None
        b = wb[-1] if bias is not None else None
        if last:
            a = a.movedim(-1, 1)
        if use_batch_stats and a.numel() == a.shape[1]:
            out = _one_value_per_channel(a, rm, rv, w, b, momentum, epsilon)
        else:
            out = tF.batch_norm(a, rm, rv, w, b, training=use_batch_stats,
                                momentum=1.0 - momentum, eps=epsilon)
        return out.movedim(1, -1) if last else out

    extras = [t for t in (weight, bias) if t is not None]
    if not use_batch_stats:
        return run_op("batch_norm_infer", f, x, running_mean, running_var,
                      *extras)
    rm = None if running_mean is None else running_mean._data.detach().clone()
    rv = None if running_var is None else running_var._data.detach().clone()
    out = run_op("batch_norm", lambda a, *wb: f(a, rm, rv, *wb), x, *extras)
    if running_mean is not None:
        running_mean._assign_array(rm)
    if running_var is not None:
        running_var._assign_array(rv)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    shape = tuple(int(s) for s in normalized_shape)

    def f(a, *wb):
        w = wb[0] if weight is not None else None
        b = wb[-1] if bias is not None else None
        return tF.layer_norm(a, shape, w, b, epsilon)

    extras = [t for t in (weight, bias) if t is not None]
    return run_op("layer_norm", f, x, *extras)


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1,
             name=None):
    """Root-mean-square norm over ``begin_norm_axis`` (reference: incubate
    fused_rms_norm), in float32 for bf16/f16 inputs, cast back before the
    affine."""
    axes = (begin_norm_axis,) if isinstance(begin_norm_axis, int) \
        else tuple(begin_norm_axis)

    def f(a, *wb):
        h = a.float() if a.dtype in (torch.bfloat16, torch.float16) else a
        ms = torch.mean(torch.square(h), dim=axes, keepdim=True)
        out = (h * torch.rsqrt(ms + epsilon)).to(a.dtype)
        i = 0
        if weight is not None:
            out = out * wb[i]
            i += 1
        if bias is not None:
            out = out + wb[i]
        return out

    extras = [t for t in (weight, bias) if t is not None]
    return run_op("rms_norm", f, x, *extras)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9,
                  eps=1e-05, data_format="NCHW", name=None):
    last = data_format.endswith("C") and not data_format.startswith("NC")

    def f(a, *wb):
        w = wb[0] if weight is not None else None
        b = wb[-1] if bias is not None else None
        if last:
            a = a.movedim(-1, 1)
        out = tF.instance_norm(a, weight=w, bias=b, eps=eps)
        return out.movedim(1, -1) if last else out

    extras = [t for t in (weight, bias) if t is not None]
    return run_op("instance_norm", f, x, *extras)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    last = _channels_last(data_format)

    def f(a, *wb):
        w = wb[0] if weight is not None else None
        b = wb[-1] if bias is not None else None
        if last:
            a = a.movedim(-1, 1)
        out = tF.group_norm(a, num_groups, w, b, epsilon)
        return out.movedim(1, -1) if last else out

    extras = [t for t in (weight, bias) if t is not None]
    return run_op("group_norm", f, x, *extras)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """a / (k + alpha * sum of a^2 over ``size`` channels)^beta, the window
    centred as the reference pads it (size // 2 before, (size - 1) // 2
    after)."""
    def f(a):
        ch = 1 if data_format.startswith("NC") else a.dim() - 1
        sq = torch.square(a).movedim(ch, -1)
        padded = tF.pad(sq, (size // 2, (size - 1) // 2))
        win = padded.unfold(-1, size, 1).sum(-1).movedim(-1, ch)
        return a / torch.pow(k + alpha * win, beta)
    return run_op("local_response_norm", f, x)
