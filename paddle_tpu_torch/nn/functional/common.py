"""Common functionals: the port of ``paddle_tpu/nn/functional/common.py``
(linear, dropout, embedding, interpolate, normalize, cosine_similarity,
label_smooth, ...; reference: python/paddle/nn/functional/common.py +
input.py).

Paddle's layouts are kept: ``linear``'s weight is [in, out] and
``linear(x, W, b) = x @ W + b``, one ``addmm`` on that layout (torch's own
``linear`` would need Wᵀ), its operands promoted to their common dtype as
jnp's product promotes them. Dropout masks come from the port's generator.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ...core import dtype as dtype_mod
from ...core.dispatch import run_op
from ...core.generator import generator_for, traced
from ...core.tensor import Tensor
from ...ops.linalg import promoted
from ...ops.math import jax_abs


def _matmul_bias(a, w, b):
    """x @ W + b as one addmm over the rows of x (any leading dims)."""
    a, w, b = promoted(a, w, b)
    if a.dim() < 2:
        return torch.matmul(a, w) + b
    out = torch.addmm(b, a.reshape(-1, a.shape[-1]), w)
    return out.reshape(*a.shape[:-1], w.shape[-1])


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with paddle weight layout [in, out]."""
    if bias is None:
        return run_op("linear", lambda a, w: torch.matmul(*promoted(a, w)),
                      x, weight)
    return run_op("linear", _matmul_bias, x, weight, bias)


def _keep_mask(a, p, shape, gen):
    """Bernoulli(1 - p) keep mask of ``shape`` (bool), from ``gen``."""
    if traced(gen):
        return gen.uniform(shape, a.device) >= p
    return torch.empty(shape, device=a.device).bernoulli_(
        1.0 - p, generator=gen).bool()


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        return x if mode == "upscale_in_train" else run_op(
            "dropout_eval", lambda a: a * (1.0 - p), x)
    gen = generator_for(x._data.device)

    def f(a):
        if axis is None:
            shape = a.shape
        else:
            axes = axis if isinstance(axis, (list, tuple)) else [axis]
            shape = tuple(a.shape[i] if i in axes else 1
                          for i in range(a.dim()))
        keep = _keep_mask(a, p, shape, gen)
        if mode == "upscale_in_train":
            return torch.where(keep, a / (1.0 - p), 0.0)
        return torch.where(keep, a, 0.0)
    return run_op("dropout", f, x)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    gen = generator_for(x._data.device)

    def f(a):
        alpha = 1.6732632423543772
        scale = 1.0507009873554805
        alpha_p = -alpha * scale
        keep = _keep_mask(a, p, a.shape, gen)
        q = 1.0 - p
        coef_a = (q + alpha_p ** 2 * q * p) ** -0.5
        coef_b = -coef_a * alpha_p * p
        return coef_a * torch.where(keep, a, alpha_p) + coef_b
    return run_op("alpha_dropout", f, x)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids; rows at ``padding_idx`` are zero in
    the output (so they get no gradient), as the reference."""
    def f(ids, w):
        out = tF.embedding(ids.long(), w)
        if padding_idx is not None:
            out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
        return out
    return run_op("embedding", f, x, weight)


def one_hot(x, num_classes, name=None):
    from ...ops.creation import one_hot as _oh
    return _oh(x, num_classes)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def f(a):
        nrm = torch.pow(torch.sum(torch.pow(jax_abs(a), p), dim=axis,
                                  keepdim=True), 1.0 / p)
        return a / torch.clamp_min(nrm, epsilon)
    return run_op("normalize", f, x)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def f(a, b):
        dot = torch.sum(a * b, dim=axis)
        na = torch.sqrt(torch.sum(a * a, dim=axis))
        nb = torch.sqrt(torch.sum(b * b, dim=axis))
        return dot / torch.clamp_min(na * nb, eps)
    return run_op("cosine_similarity", f, x1, x2)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return run_op("label_smooth",
                      lambda l, pd: (1 - epsilon) * l + epsilon * pd,
                      label, prior_dist)
    return run_op("label_smooth",
                  lambda l: (1 - epsilon) * l + epsilon / l.shape[-1], label)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    from ...ops.manipulation import pad as _pad
    return _pad(x, pad, mode, value, data_format)


def _cubic_matrix(n_in, n_out, align_corners, device, a=-0.75):
    """[n_out, n_in] cubic-convolution resize weights (Keys kernel,
    a=-0.75 — the reference bicubic_interp kernel's constant), edge taps
    clamped (replicate)."""
    def kern(d):
        d = np.abs(d)
        return np.where(
            d <= 1, (a + 2) * d ** 3 - (a + 3) * d ** 2 + 1,
            np.where(d < 2, a * d ** 3 - 5 * a * d ** 2 + 8 * a * d - 4 * a,
                     0.0))

    i = np.arange(n_out)
    if align_corners and n_out > 1:
        s = i * (n_in - 1) / (n_out - 1)
    else:
        s = (i + 0.5) * n_in / n_out - 0.5
    f0 = np.floor(s).astype(int)
    w = np.zeros((n_out, n_in), np.float32)
    for tap in (-1, 0, 1, 2):
        idx = np.clip(f0 + tap, 0, n_in - 1)
        np.add.at(w, (i, idx), kern(s - (f0 + tap)).astype(np.float32))
    return torch.from_numpy(w).to(device)


_TORCH_LINEAR = {1: "linear", 2: "bilinear", 3: "trilinear"}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """The reference's resize: nearest takes src = floor(dst * in / out);
    (bi/tri)linear without align_corners is the half-pixel resize (area
    too, as the reference maps it), antialiased when shrinking (as
    jax.image.resize is) where torch offers it (2-D); with align_corners
    the corners map onto each other; bicubic is Keys' a = -0.75 kernel with
    clamped edges, as separable weight matrices."""
    nd = x.ndim - 2
    channels_last = data_format.endswith("C")
    spatial = list(x.shape[1:-1]) if channels_last else list(x.shape[2:])
    if size is not None:
        if isinstance(size, Tensor):
            size = size.tolist()
        out_size = [int(s.item() if isinstance(s, Tensor) else s)
                    for s in (size if isinstance(size, (list, tuple))
                              else [size] * nd)]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * nd
        out_size = [int(s * f) for s, f in zip(spatial, sf)]
    kind = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
            "trilinear": "linear", "bicubic": "cubic", "area": "linear",
            "cubic": "cubic"}[mode.lower()]

    def f(a):
        if channels_last:
            a = a.movedim(-1, 1)
        if kind == "nearest":
            out = a
            for d in range(nd):
                n_in, n_out = spatial[d], out_size[d]
                idx = torch.floor(torch.arange(n_out, device=a.device)
                                  * (n_in / n_out)).long().clamp_max(n_in - 1)
                out = torch.index_select(out, 2 + d, idx)
        elif kind == "cubic":
            out = a
            for d in range(nd):
                w = _cubic_matrix(spatial[d], out_size[d], align_corners,
                                  a.device).to(a.dtype)
                out = torch.tensordot(out.movedim(2 + d, -1), w,
                                      dims=([-1], [1])).movedim(-1, 2 + d)
        else:
            shrink = any(o < s for o, s in zip(out_size, spatial))
            out = tF.interpolate(a, size=out_size, mode=_TORCH_LINEAR[nd],
                                 align_corners=bool(align_corners),
                                 antialias=(nd == 2 and shrink
                                            and not align_corners))
        return out.movedim(1, -1) if channels_last else out
    return run_op("interpolate", f, x)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor

    def f(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            a = a.reshape(n, c // (r * r), r, r, h, w)
            a = a.permute(0, 1, 4, 2, 5, 3)
            return a.reshape(n, c // (r * r), h * r, w * r)
        n, h, w, c = a.shape
        a = a.reshape(n, h, w, r, r, c // (r * r))
        a = a.permute(0, 1, 3, 2, 4, 5)
        return a.reshape(n, h * r, w * r, c // (r * r))
    return run_op("pixel_shuffle", f, x)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor

    def f(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            a = a.reshape(n, c, h // r, r, w // r, r)
            a = a.permute(0, 1, 3, 5, 2, 4)
            return a.reshape(n, c * r * r, h // r, w // r)
        n, h, w, c = a.shape
        a = a.reshape(n, h // r, r, w // r, r, c)
        return a.permute(0, 1, 3, 5, 2, 4).reshape(
            n, h // r, w // r, c * r * r)
    return run_op("pixel_unshuffle", f, x)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def f(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            a = a.reshape(n, groups, c // groups, h, w)
            return a.transpose(1, 2).reshape(n, c, h, w)
        n, h, w, c = a.shape
        a = a.reshape(n, h, w, groups, c // groups)
        return a.transpose(3, 4).reshape(n, h, w, c)
    return run_op("channel_shuffle", f, x)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    from ...ops.manipulation import unfold as _unfold
    return _unfold(x, kernel_sizes, strides, paddings, dilations)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    ks = kernel_sizes if isinstance(kernel_sizes, (list, tuple)) \
        else [kernel_sizes] * 2
    st = strides if isinstance(strides, (list, tuple)) else [strides] * 2
    pd = paddings if isinstance(paddings, (list, tuple)) else [paddings] * 2
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]
    dl = dilations if isinstance(dilations, (list, tuple)) \
        else [dilations] * 2
    oh, ow = output_sizes

    def f(a):
        n, ckk, _ = a.shape
        c = ckk // (ks[0] * ks[1])
        nh = (oh + pd[0] + pd[2] - dl[0] * (ks[0] - 1) - 1) // st[0] + 1
        nw = (ow + pd[1] + pd[3] - dl[1] * (ks[1] - 1) - 1) // st[1] + 1
        a = a.reshape(n, c, ks[0], ks[1], nh, nw)
        out = torch.zeros((n, c, oh + pd[0] + pd[2], ow + pd[1] + pd[3]),
                          dtype=a.dtype, device=a.device)
        for i in range(ks[0]):
            for j in range(ks[1]):
                hs, ws = i * dl[0], j * dl[1]
                out[:, :, hs:hs + nh * st[0]:st[0],
                    ws:ws + nw * st[1]:st[1]] += a[:, :, i, j]
        return out[:, :, pd[0]:pd[0] + oh, pd[1]:pd[1] + ow]
    return run_op("fold", f, x)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    if maxlen is None:
        maxlen = int(x._data.max())
    d = dtype_mod.torch_dtype(dtype)

    def f(lengths):
        ids = torch.arange(maxlen, device=lengths.device)
        return (ids[None, :] < lengths[..., None]).to(d)
    return run_op("sequence_mask", f, x, differentiable=False)


def bilinear(x1, x2, weight, bias=None, name=None):
    def f(a, b, w, *maybe_bias):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        if maybe_bias:
            out = out + maybe_bias[0]
        return out
    if bias is not None:
        return run_op("bilinear", f, x1, x2, weight, bias)
    return run_op("bilinear", f, x1, x2, weight)
