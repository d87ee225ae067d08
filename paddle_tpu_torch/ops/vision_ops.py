"""The vision op batch: the port of ``paddle_tpu/ops/vision_ops.py``.

Interpolation kernels, grid_sample, affine_grid, pad3d, pool2d/pool3d (and
the index variant, unpool), temporal_shift and shuffle_channel (reference
schemas: paddle/phi/ops/yaml/ops.yaml bilinear_interp, ..., shuffle_channel),
NCHW/NCDHW like the reference's defaults. The reference's
``lax.reduce_window`` pooling is torch's pooling over an input padded as the
reference pads it (-inf for max, 0 for the sums), so that padding wider
than half the window, which torch's own padding refuses, gives the
reference's values; ``ceil_mode`` is accepted and ignored, as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ..core.dispatch import run_op
from ..core.tensor import Tensor


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


# ---------------------------------------------------------------------
# interpolation (phi *_interp kernels): the per-kernel entries of
# F.interpolate's modes, for _C_ops parity
# ---------------------------------------------------------------------
def _interp(x, size, method, align_corners=False):
    from ..nn.functional.common import interpolate
    return interpolate(_t(x), size=list(size), mode=method,
                       align_corners=align_corners)


def bilinear_interp(x, out_h, out_w, align_corners=False, **kw):
    return _interp(x, (out_h, out_w), "bilinear", align_corners)


def nearest_interp(x, out_h, out_w, align_corners=False, **kw):
    return _interp(x, (out_h, out_w), "nearest", align_corners)


def bicubic_interp(x, out_h, out_w, align_corners=False, **kw):
    return _interp(x, (out_h, out_w), "bicubic", align_corners)


def linear_interp(x, out_w, align_corners=False, **kw):
    return _interp(x, (out_w,), "linear", align_corners)


def trilinear_interp(x, out_d, out_h, out_w, align_corners=False, **kw):
    return _interp(x, (out_d, out_h, out_w), "trilinear", align_corners)


# ---------------------------------------------------------------------
# grid_sample / affine_grid (phi grid_sample_kernel, affine_grid_kernel)
# ---------------------------------------------------------------------
def _base_line(size, align_corners, like):
    if align_corners:
        return torch.linspace(-1.0, 1.0, size, dtype=like.dtype,
                              device=like.device)
    step = 2.0 / size
    return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size,
                          dtype=like.dtype, device=like.device)


def affine_grid(theta, out_shape, align_corners=True):
    """theta: [N, 2, 3]; out_shape: [N, C, H, W] -> grid [N, H, W, 2]."""
    def f(th):
        n, c, h, w = [int(s) for s in out_shape]
        ys = _base_line(h, align_corners, th)
        xs = _base_line(w, align_corners, th)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")     # [H, W]
        coords = torch.stack([gx, gy, torch.ones_like(gx)], -1)
        return torch.einsum("hwk,njk->nhwj", coords, th)
    return run_op("affine_grid", f, _t(theta))


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """x: [N, C, H, W]; grid: [N, Ho, Wo, 2] in [-1, 1] (x then y)."""
    def f(a, g):
        n, c, h, w = a.shape
        bidx = torch.arange(n, device=a.device)[:, None, None]

        def unnormalize(coord, size):
            if align_corners:
                return (coord + 1.0) * (size - 1) / 2.0
            return ((coord + 1.0) * size - 1.0) / 2.0
        ix = unnormalize(g[..., 0], w)
        iy = unnormalize(g[..., 1], h)

        def pad_coord(coord, size):
            if padding_mode == "border":
                return torch.clamp(coord, 0, size - 1)
            if padding_mode == "reflection":
                if align_corners:
                    span = 2 * max(size - 1, 1)
                    coord = torch.remainder(coord.abs(), span)
                    return torch.where(coord > size - 1, span - coord, coord)
                coord = torch.remainder(coord + 0.5, 2 * size)
                coord = (coord - size).abs() - 0.5
                return torch.clamp(coord, 0, size - 1)
            return coord

        def valid_of(cx, cy):
            return (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)

        if mode == "nearest":
            rx, ry = torch.round(ix), torch.round(iy)
            valid = valid_of(rx, ry)
            gx = torch.clamp(pad_coord(rx, w), 0, w - 1).long()
            gy = torch.clamp(pad_coord(ry, h), 0, h - 1).long()
            out = a[bidx, :, gy, gx].movedim(-1, 1)
            if padding_mode == "zeros":
                out = out * valid[:, None].to(a.dtype)
            return out

        x0, y0 = torch.floor(ix), torch.floor(iy)
        x1, y1 = x0 + 1, y0 + 1
        wx1, wy1 = ix - x0, iy - y0
        wx0, wy0 = 1.0 - wx1, 1.0 - wy1

        def gather(cx, cy):
            valid = valid_of(cx, cy)
            gx = torch.clamp(pad_coord(cx, w), 0, w - 1).long()
            gy = torch.clamp(pad_coord(cy, h), 0, h - 1).long()
            v = a[bidx, :, gy, gx]                        # [N, Ho, Wo, C]
            if padding_mode == "zeros":
                v = v * valid[..., None].to(a.dtype)
            return v
        out = gather(x0, y0) * (wx0 * wy0)[..., None] \
            + gather(x1, y0) * (wx1 * wy0)[..., None] \
            + gather(x0, y1) * (wx0 * wy1)[..., None] \
            + gather(x1, y1) * (wx1 * wy1)[..., None]
        return out.movedim(-1, 1)
    return run_op("grid_sample", f, _t(x), _t(grid))


# ---------------------------------------------------------------------
# pad3d (phi pad3d_kernel): paddings [l, r, t, b, front, back], NCDHW
# ---------------------------------------------------------------------
def pad3d(x, paddings, mode="constant", value=0.0, data_format="NCDHW"):
    pads = [int(p) for p in paddings]
    tmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "replicate", "circular": "circular"}[mode]

    def f(a):
        if data_format != "NCDHW":                           # NDHWC
            a = a.movedim(-1, 1)
        if tmode == "constant":
            out = tF.pad(a, pads, mode="constant", value=value)
        else:
            out = tF.pad(a, pads, mode=tmode)
        return out if data_format == "NCDHW" else out.movedim(1, -1)
    return run_op("pad3d", f, _t(x))


# ---------------------------------------------------------------------
# pooling (phi pool2d/pool3d kernels + index variant + unpool)
# ---------------------------------------------------------------------
def _tuple(v, n):
    return (int(v),) * n if isinstance(v, int) else tuple(int(s) for s in v)


def _adaptive_pool_axis(a, axis, out, pooling_type):
    """Pool ``axis`` into ``out`` adaptive bins (paddle's AdaptiveKernel
    boundary rule: start=floor(i*L/out), end=ceil((i+1)*L/out))."""
    L = a.shape[axis]
    pieces = []
    for i in range(int(out)):
        s = (i * L) // out
        e = -(-((i + 1) * L) // out)
        piece = a.narrow(axis, s, e - s)
        pieces.append(torch.amax(piece, axis, keepdim=True)
                      if pooling_type == "max"
                      else torch.mean(piece, axis, keepdim=True))
    return torch.cat(pieces, axis)


def _window_pool(a, ks, st, pd, pooling_type, exclusive):
    """The reference's reduce_window pooling over the last len(ks) axes."""
    n = len(ks)
    flat_pad = [p for q in reversed(pd) for p in (q, q)]
    pool = tF.max_pool2d if n == 2 else tF.max_pool3d
    avg = tF.avg_pool2d if n == 2 else tF.avg_pool3d
    if pooling_type == "max":
        padded = tF.pad(a, flat_pad, value=float("-inf")) if any(pd) else a
        return pool(padded, ks, st)
    padded = tF.pad(a, flat_pad) if any(pd) else a
    r = avg(padded, ks, st)                 # the window sum / prod(ks)
    if exclusive and any(pd):
        ones = tF.pad(torch.ones((1, 1) + tuple(a.shape[-n:]),
                                 dtype=a.dtype, device=a.device), flat_pad)
        r = r / avg(ones, ks, st)           # sum / count of real elements
    return r


def pool2d(x, kernel_size, strides=None, paddings=(0, 0),
           pooling_type="max", ceil_mode=False, exclusive=True,
           adaptive=False, global_pooling=False, data_format="NCHW",
           **kw):
    def f(a):
        if data_format == "NHWC":
            a = a.movedim(-1, 1)
        kh, kw_ = _tuple(kernel_size, 2)
        if global_pooling or (adaptive and (kh, kw_) == (1, 1)):
            r = (torch.amax(a, (-2, -1), keepdim=True)
                 if pooling_type == "max"
                 else torch.mean(a, (-2, -1), keepdim=True))
        elif adaptive:
            # kernel_size is the output size; the cells are a cross
            # product, so the pooling is separable: rows, then columns
            r = _adaptive_pool_axis(a, -2, kh, pooling_type)
            r = _adaptive_pool_axis(r, -1, kw_, pooling_type)
        else:
            st = _tuple(strides if strides is not None else kernel_size, 2)
            r = _window_pool(a, (kh, kw_), st, _tuple(paddings, 2),
                             pooling_type, exclusive)
        if data_format == "NHWC":
            r = r.movedim(1, -1)
        return r
    return run_op("pool2d", f, _t(x))


def pool3d(x, kernel_size, strides=None, paddings=(0, 0, 0),
           pooling_type="max", ceil_mode=False, exclusive=True,
           adaptive=False, global_pooling=False, data_format="NCDHW",
           **kw):
    def f(a):
        ks = _tuple(kernel_size, 3)
        st = ks if strides is None else _tuple(strides, 3)
        if global_pooling:
            return (torch.amax(a, (-3, -2, -1), keepdim=True)
                    if pooling_type == "max"
                    else torch.mean(a, (-3, -2, -1), keepdim=True))
        # the reference divides every window by its size (no exclusive)
        return _window_pool(a, ks, st, _tuple(paddings, 3), pooling_type,
                            False)
    return run_op("pool3d", f, _t(x))


def max_pool2d_with_index(x, kernel_size, strides=None, paddings=(0, 0),
                          global_pooling=False, adaptive=False,
                          ceil_mode=False):
    """Returns (pooled, flat indices into each H*W map), as the reference's
    max_pool2d_with_index kernel (the indices drive unpool): the first
    maximum of each window in row-major order, the input padded with the
    dtype's lowest value."""
    def f(a):
        n, c, h, w = a.shape
        kh, kw_ = _tuple(kernel_size, 2)
        sh, sw = _tuple(strides if strides is not None else kernel_size, 2)
        ph, pw = _tuple(paddings, 2)
        if ph or pw:
            low = torch.finfo(a.dtype).min if a.is_floating_point() \
                else torch.iinfo(a.dtype).min
            a = tF.pad(a, (pw, pw, ph, ph), value=low)
        hp, wp = a.shape[-2:]
        ho, wo = (hp - kh) // sh + 1, (wp - kw_) // sw + 1
        patches = tF.unfold(a, (kh, kw_), stride=(sh, sw))
        patches = patches.reshape(n, c, kh * kw_, ho, wo)
        val, arg = torch.max(patches, 2)
        oy = torch.arange(ho, device=a.device)[:, None] * sh - ph
        ox = torch.arange(wo, device=a.device)[None, :] * sw - pw
        iy = torch.clamp(oy + arg // kw_, 0, h - 1)
        ix = torch.clamp(ox + arg % kw_, 0, w - 1)
        return val, (iy * w + ix).to(torch.int64)
    return run_op("max_pool2d_with_index", f, _t(x))


def unpool(x, indices, kernel_size=2, strides=None, paddings=0,
           output_size=None, data_format="NCHW"):
    """Scatter pooled values back to the positions recorded by
    max_pool2d_with_index (reference unpool kernel)."""
    def f(a, idx):
        n, c, ho, wo = a.shape
        if output_size is not None:
            h, w = int(output_size[-2]), int(output_size[-1])
        else:
            kh, kw_ = _tuple(kernel_size, 2)
            sh, sw = _tuple(strides if strides is not None
                            else kernel_size, 2)
            h = (ho - 1) * sh + kh
            w = (wo - 1) * sw + kw_
        flat = torch.zeros((n, c, h * w), dtype=a.dtype, device=a.device)
        flat = flat.scatter_add(2, idx.reshape(n, c, -1).long(),
                                a.reshape(n, c, -1))
        return flat.reshape(n, c, h, w)
    return run_op("unpool", f, _t(x), _t(indices))


# ---------------------------------------------------------------------
# temporal_shift / shuffle_channel
# ---------------------------------------------------------------------
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """reference temporal_shift kernel (TSM): shift a ratio of the channels
    backward and forward along the segment (time) axis."""
    def f(a):
        if data_format == "NHWC":
            a = a.movedim(-1, 1)
        nt, c, h, w = a.shape
        a = a.reshape(nt // seg_num, seg_num, c, h, w)
        c1 = int(c * shift_ratio)
        c2 = int(c * 2 * shift_ratio)
        back = torch.cat([a[:, 1:, :c1], torch.zeros_like(a[:, :1, :c1])], 1)
        fwd = torch.cat([torch.zeros_like(a[:, :1, c1:c2]),
                         a[:, :-1, c1:c2]], 1)
        out = torch.cat([back, fwd, a[:, :, c2:]], 2).reshape(nt, c, h, w)
        if data_format == "NHWC":
            out = out.movedim(1, -1)
        return out
    return run_op("temporal_shift", f, _t(x))


def shuffle_channel(x, group):
    def f(a):
        n, c, h, w = a.shape
        return a.reshape(n, group, c // group, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)
    return run_op("shuffle_channel", f, _t(x))
