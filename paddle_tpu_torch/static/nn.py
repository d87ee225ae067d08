"""paddle.static.nn on torch: the port of ``paddle_tpu/static/nn.py``
(reference: python/paddle/static/nn/common.py + control_flow.py).

These are eager functions that create their parameters on each call (the
reference creates them in the startup program); ``cond`` selects under a
``to_static`` trace so the captured program stays one graph.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn as _nn
from ..core.dispatch import run_op
from ..core.tensor import Tensor
from ..nn import functional as F
from ..ops import manipulation as _manip
from ..ops import math as _math


def _param(shape, dtype="float32", attr=None, is_bias=False,
           default_initializer=None):
    return _nn.Layer().create_parameter(
        [int(s) for s in shape], attr=attr, dtype=dtype, is_bias=is_bias,
        default_initializer=default_initializer)


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = []
    for xi in xs:
        in_f = int(np.prod(xi.shape[num_flatten_dims:]))
        w = _param([in_f, size], attr=weight_attr)
        outs.append(_manip.reshape(
            xi, list(xi.shape[:num_flatten_dims]) + [in_f]).matmul(w))
    out = outs[0]
    for o in outs[1:]:
        out = out + o
    if bias_attr is not False:
        b = _param([size], attr=bias_attr, is_bias=True)
        out = out + b
    if activation:
        out = getattr(F, activation)(out)
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    w = _param(list(size), dtype, attr=param_attr)
    return F.embedding(input, w, padding_idx=padding_idx)


sparse_embedding = embedding


def _ones(shape, attr):
    w = _param(shape, attr=attr)
    _math.fill_(w, 1.0)
    return w


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               **kw):
    from ..ops.creation import ones, zeros
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = _ones([c], param_attr)
    bias = _param([c], attr=bias_attr, is_bias=True)
    mean = zeros([c])
    var = ones([c])
    out = F.batch_norm(input, mean, var, weight=scale, bias=bias,
                       training=not is_test, momentum=momentum,
                       epsilon=epsilon, data_format=data_layout)
    return getattr(F, act)(out) if act else out


def _conv_nd(fconv, input, num_filters, filter_size, nd, stride, padding,
             dilation, groups, param_attr, bias_attr, act, data_format,
             transpose=False, output_size=None):
    cin = input.shape[1] if data_format[1] == "C" else input.shape[-1]
    ks = (filter_size,) * nd if isinstance(filter_size, int) \
        else tuple(filter_size)
    wshape = ([cin, num_filters // groups] if transpose
              else [num_filters, cin // groups]) + list(ks)
    w = _param(wshape, attr=param_attr)
    b = None if bias_attr is False else _param([num_filters],
                                               attr=bias_attr, is_bias=True)
    kw = dict(output_size=output_size) if transpose else {}
    out = fconv(input, w, b, stride=stride, padding=padding,
                dilation=dilation, groups=groups, data_format=data_format,
                **kw)
    return getattr(F, act)(out) if act else out


def conv2d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           act=None, data_format="NCHW", **kw):
    return _conv_nd(F.conv2d, input, num_filters, filter_size, 2, stride,
                    padding, dilation, groups, param_attr, bias_attr, act,
                    data_format)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           act=None, data_format="NCDHW", **kw):
    return _conv_nd(F.conv3d, input, num_filters, filter_size, 3, stride,
                    padding, dilation, groups, param_attr, bias_attr, act,
                    data_format)


def conv2d_transpose(input, num_filters, filter_size=None, output_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     data_format="NCHW", **kw):
    return _conv_nd(F.conv2d_transpose, input, num_filters, filter_size, 2,
                    stride, padding, dilation, groups, param_attr,
                    bias_attr, act, data_format, True, output_size)


def conv3d_transpose(input, num_filters, filter_size=None, output_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     data_format="NCDHW", **kw):
    return _conv_nd(F.conv3d_transpose, input, num_filters, filter_size, 3,
                    stride, padding, dilation, groups, param_attr,
                    bias_attr, act, data_format, True, output_size)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None):
    shape = list(input.shape[begin_norm_axis:])
    w = _ones(shape, param_attr) if scale else None
    b = _param(shape, attr=bias_attr, is_bias=True) if shift else None
    out = F.layer_norm(input, shape, weight=w, bias=b, epsilon=epsilon)
    return getattr(F, act)(out) if act else out


def group_norm(input, groups, epsilon=1e-5, param_attr=None,
               bias_attr=None, act=None, data_layout="NCHW"):
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    w = _ones([c], param_attr)
    b = _param([c], attr=bias_attr, is_bias=True)
    out = F.group_norm(input, groups, weight=w, bias=b, epsilon=epsilon,
                       data_format=data_layout)
    return getattr(F, act)(out) if act else out


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None):
    c = input.shape[1]
    w = _ones([c], param_attr)
    b = _param([c], attr=bias_attr, is_bias=True)
    return F.instance_norm(input, weight=w, bias=b, eps=epsilon)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    def f(w):
        wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
        u = torch.ones(wm.shape[0], dtype=w.dtype, device=w.device) \
            / np.sqrt(wm.shape[0])
        for _ in range(power_iters):
            v = wm.T @ u
            v = v / (torch.linalg.norm(v) + eps)
            u = wm @ v
            u = u / (torch.linalg.norm(u) + eps)
        sigma = u @ wm @ v
        return w / sigma
    return run_op("spectral_norm", f, weight)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None, **kw):
    def f(a):
        mean = a.mean(0, keepdim=True)
        scale = torch.rsqrt(a.var(0, unbiased=False, keepdim=True)
                            + epsilon)
        return (a - mean) * scale
    out = run_op("data_norm", f, input)
    return getattr(F, act)(out) if act else out


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    n = 1 if mode == "all" else (
        x.shape[1] if mode == "channel" else int(np.prod(x.shape[1:])))
    alpha = _param([n], attr=param_attr)
    _math.fill_(alpha, 0.25)
    return F.prelu(x, alpha, data_format=data_format)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    w = _param([size, x.shape[-1], y.shape[-1]], attr=param_attr)
    b = None if bias_attr is False else _param([size], attr=bias_attr,
                                               is_bias=True)
    out = F.bilinear(x, y, w, b)
    return getattr(F, act)(out) if act else out


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss (reference static nce op):
    logistic discrimination of the true class against k uniform noise
    samples."""
    k = num_neg_samples or 10
    dim = input.shape[-1]
    w = _param([num_total_classes, dim], attr=param_attr)
    b = _param([num_total_classes], attr=bias_attr, is_bias=True)
    rng = np.random.RandomState(seed or 0)
    neg = rng.randint(0, num_total_classes,
                      (int(input.shape[0]), k)).astype(np.int64)

    def f(x, y, wa, ba, negs):
        y = y.reshape(-1).long()
        pos_logit = (x * wa[y]).sum(-1) + ba[y] - np.log(k)
        neg_logit = torch.einsum("nd,nkd->nk", x, wa[negs]) + ba[negs] \
            - np.log(k)
        pos_loss = torch.log1p(torch.exp(-pos_logit))
        neg_loss = torch.log1p(torch.exp(neg_logit)).sum(-1)
        return (pos_loss + neg_loss)[:, None]
    return run_op("nce", f, input, label, w, b, Tensor(neg))


def row_conv(input, future_context_size, param_attr=None, act=None):
    d = input.shape[-1]
    k = future_context_size + 1
    w = _param([k, d], attr=param_attr)

    def f(x, wa):
        # x: [B, T, D]; out[t] = sum_{i=0..k-1} x[t+i] * w[i]
        xp = torch.nn.functional.pad(x, (0, 0, 0, k - 1))
        out = 0
        for i in range(k):
            out = out + xp[:, i:i + x.shape[1]] * wa[i]
        return out
    out = run_op("row_conv", f, input, w)
    return getattr(F, act)(out) if act else out


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, param_attr=None, bias_attr=None,
                  name=None):
    """Deformable convolution v1/v2 with its own weight (and bias), over
    ``vision.ops.deform_conv2d`` (reference static/nn.py:249)."""
    from ..vision.ops import deform_conv2d as _dc
    cin = x.shape[1]
    ks = (filter_size,) * 2 if isinstance(filter_size, int) \
        else tuple(filter_size)
    w = _param([num_filters, cin // groups, ks[0], ks[1]], attr=param_attr)
    b = None if bias_attr is False else _param(
        [num_filters], attr=bias_attr, is_bias=True)
    return _dc(x, offset, w, b, stride, padding, dilation,
               deformable_groups, groups, mask)


# ------------------------------------------------------------------
# control flow
# ------------------------------------------------------------------

def cond(pred, true_fn=None, false_fn=None, name=None,
         return_names=None):
    from ..jit import cond as _cond
    return _cond(pred, true_fn, false_fn)


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    from ..jit import while_loop as _wl
    return _wl(cond_fn, body_fn, loop_vars)


def case(pred_fn_pairs, default=None, name=None):
    for pred, fn in pred_fn_pairs:
        if bool(pred.numpy() if isinstance(pred, Tensor) else pred):
            return fn()
    return default() if default is not None else None


def switch_case(branch_index, branch_fns, default=None, name=None):
    i = int(branch_index.numpy() if isinstance(branch_index, Tensor)
            else branch_index)
    fns = dict(branch_fns) if not isinstance(branch_fns, dict) \
        else branch_fns
    fn = fns.get(i, default)
    return fn() if fn is not None else None


def static_pylayer(forward_fn, inputs, backward_fn=None, name=None):
    from ..autograd import PyLayer

    class _P(PyLayer):
        @staticmethod
        def forward(ctx, *args):
            return forward_fn(*args)

        @staticmethod
        def backward(ctx, *grads):
            return backward_fn(*grads)
    return _P.apply(*inputs)


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    xs = x if isinstance(x, (list, tuple)) else [x]
    res = func(*[np.asarray(v.numpy()) for v in xs])
    outs = out if isinstance(out, (list, tuple)) else [out]
    ress = res if isinstance(res, (list, tuple)) else [res]
    for o, r in zip(outs, ress):
        o.set_value(np.asarray(r))
    return out


# ------------------------------------------------------------------
# sequence ops (LoD-free: operate on padded [B, T, ...] + length masks)
# ------------------------------------------------------------------

def sequence_conv(input, num_filters, filter_size=3, param_attr=None,
                  bias_attr=None, act=None, **kw):
    return row_conv(input, filter_size - 1, param_attr, act)


def sequence_softmax(input, **kw):
    return F.softmax(input, axis=1)


def sequence_pool(input, pool_type="sum", **kw):
    pt = pool_type.lower()
    if pt == "sum":
        return _math.sum(input, axis=1)
    if pt in ("average", "mean", "avg"):
        return _math.mean(input, axis=1)
    if pt == "max":
        return _math.max(input, axis=1)
    if pt == "sqrt":
        n = input.shape[1]
        return _math.sum(input, axis=1) / np.sqrt(n)
    if pt == "first":
        return input[:, 0]
    if pt == "last":
        return input[:, -1]
    raise ValueError(pool_type)


def sequence_first_step(input):
    return input[:, 0]


def sequence_last_step(input):
    return input[:, -1]


def sequence_slice(input, offset, length, name=None):
    off = int(np.asarray(offset.numpy()).ravel()[0]) \
        if isinstance(offset, Tensor) else int(offset)
    ln = int(np.asarray(length.numpy()).ravel()[0]) \
        if isinstance(length, Tensor) else int(length)
    return input[:, off:off + ln]


def sequence_expand(x, y, ref_level=-1, name=None):
    reps = y.shape[1] if y.ndim > 1 else 1
    return _manip.tile(x, [1, reps] + [1] * (x.ndim - 2))


def sequence_expand_as(x, y, name=None):
    return _manip.expand_as(x, y)


def sequence_pad(x, pad_value, maxlen=None, name=None):
    t = x.shape[1]
    maxlen = maxlen or t
    lengths = Tensor(np.full(x.shape[0], t, np.int64))
    if maxlen <= t:
        return x[:, :maxlen], lengths
    pad_cfg = [0, 0, 0, maxlen - t] + [0, 0] * (x.ndim - 2)
    return F.pad(x, pad_cfg[2:2 + 2 * (x.ndim - 1)]), lengths


def sequence_unpad(x, length, name=None):
    ln = int(np.asarray(length.numpy()).max()) \
        if isinstance(length, Tensor) else int(np.asarray(length).max())
    return x[:, :ln]


def sequence_reshape(input, new_dim):
    b = input.shape[0]
    return _manip.reshape(input, [b, -1, new_dim])


def sequence_scatter(input, index, updates, name=None):
    return _manip.put_along_axis(input, index, updates, axis=1)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    def f(a):
        outs = []
        for i in range(win_size):
            sl = torch.nn.functional.pad(a[:, i:], (0, i), value=pad_value)
            outs.append(sl)
        return torch.stack(outs, -1)
    return run_op("sequence_enumerate", f, input)


__all__ = [
    "fc", "batch_norm", "bilinear_tensor_product", "embedding", "case",
    "cond", "static_pylayer", "conv2d", "conv2d_transpose", "conv3d",
    "conv3d_transpose", "data_norm", "deform_conv2d", "group_norm",
    "instance_norm", "layer_norm", "nce", "prelu", "py_func", "row_conv",
    "spectral_norm", "switch_case", "while_loop", "sparse_embedding",
    "sequence_conv", "sequence_softmax", "sequence_pool",
    "sequence_first_step", "sequence_last_step", "sequence_slice",
    "sequence_expand", "sequence_expand_as", "sequence_pad",
    "sequence_unpad", "sequence_reshape", "sequence_scatter",
    "sequence_enumerate",
]
