"""The rest of paddle.nn.functional: the port of
``paddle_tpu/nn/functional/extended.py`` (reference:
python/paddle/nn/functional/{loss,common,pooling,vision,extension}.py).

Each op is torch ops through ``run_op``. Anything with a structure fixed
before the op runs (fractional pooling boundaries, adaptive softmax
clusters, hierarchical-sigmoid paths) is tabled in numpy on the host, as
in the reference. The RNN-T loss's forward variables run one time row at a
time, and each row's recurrence over the label axis is one
``logcumsumexp``: alpha[t, u] = logaddexp(blank[u], alpha[t, u-1] +
emit[u-1]) unrolls to E[u] + logsumexp_{k<=u}(blank[k] - E[k]), E the
running sum of the emissions.
"""
from __future__ import annotations

import math as _math

import numpy as np
import torch
import torch.nn.functional as tF

from ...core.dispatch import run_op
from ...core.generator import generator_for
from ...core.tensor import Tensor


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


# ---------------------------------------------------------------------------
# distances
# ---------------------------------------------------------------------------

def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """||x - y + eps||_p along the last axis (reference
    nn/functional/distance.py pairwise_distance)."""
    def f(a, b):
        d = a - b + epsilon
        if p == 2.0:
            out = torch.sqrt(torch.sum(d * d, -1))
        elif np.isinf(p):
            out = torch.amax(d.abs(), -1)
        else:
            out = torch.sum(d.abs() ** p, -1) ** (1.0 / p)
        return out[..., None] if keepdim else out
    return run_op("pairwise_distance", f, _t(x), _t(y))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean", name=None):
    def f(a, b):
        if log_input:
            out = torch.exp(a) - b * a
        else:
            out = a - b * torch.log(a + epsilon)
        if full:
            stirling = b * torch.log(b) - b + 0.5 * torch.log(2 * np.pi * b)
            out = out + torch.where(b > 1, stirling, torch.zeros_like(b))
        return _reduce(out, reduction)
    return run_op("poisson_nll_loss", f, _t(input), _t(label))


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    def f(a, b, var):
        var = torch.clamp_min(var, epsilon)
        out = 0.5 * (torch.log(var) + (a - b) ** 2 / var)
        if full:
            out = out + 0.5 * np.log(2 * np.pi)
        return _reduce(out, reduction)
    return run_op("gaussian_nll_loss", f, _t(input), _t(label),
                  _t(variance))


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    def f(a, y, *w):
        n, c = a.shape
        y = y.long()
        xy = torch.gather(a, 1, y[:, None])
        m = torch.clamp_min(margin - xy + a, 0.0)
        if p != 1:
            m = m ** p
        if w:
            m = m * w[0][y][:, None]
        mask = torch.ones_like(m)
        mask[torch.arange(n, device=a.device), y] = 0.0
        return _reduce(torch.sum(m * mask, 1) / c, reduction)
    args = [_t(input), _t(label)] + ([_t(weight)] if weight is not None
                                     else [])
    return run_op("multi_margin_loss", f, *args)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function
    if dist is None:
        def dist(a, b):
            from ...ops.linalg import norm
            return norm(a - b, p=2, axis=-1)
    dp = _t(dist(_t(input), _t(positive)))
    dn = _t(dist(_t(input), _t(negative)))
    if swap:
        dpn = _t(dist(_t(positive), _t(negative)))
        dn = run_op("min_swap", torch.minimum, dn, dpn)

    def f(p_, n_):
        return _reduce(torch.clamp_min(p_ - n_ + margin, 0.0), reduction)
    return run_op("triplet_margin_with_distance_loss", f, dp, dn)


def _heap_paths(num_classes):
    """Each class's path of internal heap nodes (root 0, children 2i+1 and
    2i+2, class c at leaf c + num_classes - 1), its right-child bits and
    which of the depth slots are real."""
    n_internal = num_classes - 1
    depth = max(1, int(np.ceil(np.log2(max(num_classes, 2)))))
    tbl = np.zeros((num_classes, depth), np.int64)
    code = np.zeros((num_classes, depth), np.float32)
    valid = np.zeros((num_classes, depth), np.float32)
    for c in range(num_classes):
        node = c + n_internal
        path, bits = [], []
        while node != 0:
            parent = (node - 1) // 2
            path.append(parent)
            bits.append(float(node == 2 * parent + 2))
            node = parent
        tbl[c, :len(path)] = path[::-1]
        code[c, :len(bits)] = bits[::-1]
        valid[c, :len(path)] = 1.0
    return tbl, code, valid


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss over a complete binary tree (reference
    nn/functional/loss.py hsigmoid_loss -> phi hsigmoid_loss kernel), or
    over the given path table and codes."""
    if path_table is None:
        tbl, code, valid = _heap_paths(num_classes)
    else:
        tbl = np.asarray(path_table.numpy() if isinstance(path_table, Tensor)
                         else path_table, np.int64)
        code = np.asarray(path_code.numpy() if isinstance(path_code, Tensor)
                          else path_code, np.float32)
        valid = (tbl >= 0).astype(np.float32)
        tbl = np.maximum(tbl, 0)

    def f(x, y, w, *b):
        dev = x.device
        y = y.reshape(-1).long()
        p = torch.as_tensor(tbl, device=dev)[y]              # [N, depth]
        cde = torch.as_tensor(code, device=dev).to(x.dtype)[y]
        vld = torch.as_tensor(valid, device=dev).to(x.dtype)[y]
        logits = torch.einsum("ndf,nf->nd", w[p], x)
        if b:
            logits = logits + b[0].reshape(-1)[p]
        losses = torch.clamp_min(logits, 0) - logits * cde + \
            torch.log1p(torch.exp(-logits.abs()))
        return torch.sum(losses * vld, 1, keepdim=True)
    args = [_t(input), _t(label), _t(weight)]
    if bias is not None:
        args.append(_t(bias))
    return run_op("hsigmoid_loss", f, *args)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-Transducer loss (reference nn/functional/loss.py rnnt_loss ->
    warprnnt): log_softmax of the joint logits [B, T, U+1, V], then the
    forward variables row by row (module docstring)."""
    def f(logits, labels, in_lens, lab_lens):
        logp = torch.log_softmax(logits, -1)
        b_, t_, u1, _ = logp.shape
        dev = logp.device
        blank_lp = logp[..., blank]                            # [B,T,U+1]
        emit_lp = torch.gather(logp[:, :, :u1 - 1, :], 3,
                               labels.long()[:, None, :, None]
                               .expand(b_, t_, u1 - 1, 1))[..., 0]
        zero = logp.new_zeros((b_, 1))

        def emit_prefix(t):
            return torch.cat([zero, torch.cumsum(emit_lp[:, t], 1)], 1)

        alphas = [emit_prefix(0)]                              # t = 0
        for t in range(1, t_):
            from_blank = alphas[-1] + blank_lp[:, t - 1, :]
            e = emit_prefix(t)
            alphas.append(e + torch.logcumsumexp(from_blank - e, 1))
        alphas = torch.stack(alphas, 1)                        # [B,T,U+1]
        bi = torch.arange(b_, device=dev)
        tl = in_lens.long() - 1
        ul = lab_lens.long()
        out = -(alphas[bi, tl, ul] + blank_lp[bi, tl, ul])
        return _reduce(out, reduction)
    return run_op("rnnt_loss", f, _t(input), _t(label), _t(input_lengths),
                  _t(label_lengths))


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """Adaptive softmax (Grave et al.), reference nn/functional/loss.py
    adaptive_log_softmax_with_loss: the head covers [0, cutoffs[0]) and one
    slot per tail cluster; cluster c projects to its own vocabulary
    chunk. Returns (per-row log-probability of the label, loss)."""
    cutoffs = list(cutoffs)
    tails = [_t(tw[0]) if isinstance(tw, (list, tuple)) else _t(tw)
             for tw in tail_weights]
    hb = _t(head_bias) if head_bias is not None else None

    def f(xa, ya, hwa, *rest):
        hba = rest[0] if hb is not None else None
        tail_ws = rest[1:] if hb is not None else rest
        shortlist = cutoffs[0]
        head_logits = xa @ hwa
        if hba is not None:
            head_logits = head_logits + hba
        head_lp = torch.log_softmax(head_logits, -1)
        yi = ya.long()
        rows = torch.arange(xa.shape[0], device=xa.device)
        out = head_lp[rows, torch.clamp_max(yi, shortlist - 1)]
        lo = shortlist
        for c, tw in enumerate(tail_ws):
            hi = cutoffs[c + 1] if c + 1 < len(cutoffs) else None
            if hi is None:
                break
            in_c = (yi >= lo) & (yi < hi)
            tail_lp = torch.log_softmax(xa @ tw, -1)
            rel = torch.clamp(yi - lo, 0, tail_lp.shape[1] - 1)
            cluster_lp = head_lp[:, shortlist + c] + tail_lp[rows, rel]
            out = torch.where(in_c, cluster_lp, out)
            lo = hi
        return out, -torch.mean(out)
    args = [_t(input), _t(label), _t(head_weight)] \
        + ([hb] if hb is not None else []) + tails
    return run_op("adaptive_log_softmax_with_loss", f, *args)


# ---------------------------------------------------------------------------
# dropout / padding
# ---------------------------------------------------------------------------

def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout that drops whole channels (dim 1), keeping SELU's
    self-normalizing statistics (reference feature_alpha_dropout)."""
    x = _t(x)
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    gen = generator_for(x._data.device)

    def f(a):
        shape = (a.shape[0], a.shape[1]) + (1,) * (a.ndim - 2)
        keep = torch.rand(shape, generator=gen, device=a.device) < 1 - p
        av = 1.0 / _math.sqrt((alpha_p ** 2 * p + 1) * (1 - p))
        bv = -av * alpha_p * p
        return (torch.where(keep, a, torch.full_like(a, alpha_p)) * av
                + bv).to(a.dtype)
    return run_op("feature_alpha_dropout", f, x)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    pl, pr, pt, pb = [int(p) for p in padding]

    def f(a):
        if data_format == "NCHW":
            return tF.pad(a, (pl, pr, pt, pb))
        return tF.pad(a, (0, 0, pl, pr, pt, pb))
    return run_op("zeropad2d", f, _t(x))


# ---------------------------------------------------------------------------
# unpooling / fractional pooling
# ---------------------------------------------------------------------------

def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _max_unpool(x, indices, n, kernel_size, stride, padding, output_size,
                data_format):
    def f(a, idx):
        if output_size is not None:
            out_sp = tuple(int(s) for s in output_size[-n:])
        else:
            ks = _ntuple(kernel_size, n)
            st = ks if stride is None else _ntuple(stride, n)
            pd = _ntuple(padding, n)
            out_sp = tuple((si - 1) * s + k - 2 * p for si, s, k, p in
                           zip(a.shape[2:], st, ks, pd))
        nb, c = a.shape[:2]
        flat = torch.zeros((nb, c, int(np.prod(out_sp))), dtype=a.dtype,
                           device=a.device)
        flat = flat.scatter(2, idx.reshape(nb, c, -1).long(),
                            a.reshape(nb, c, -1))
        return flat.reshape((nb, c) + out_sp)
    return run_op("max_unpool", f, _t(x), _t(indices))


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, padding,
                       output_size, data_format)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, padding,
                       output_size, data_format)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, padding,
                       output_size, data_format)


def _fractional_bounds(in_sz, out_sz, u):
    """Graham's fractional pooling boundaries: a_i = ceil(alpha*(i+u)) with
    alpha = in/out; a static table per (in, out, u)."""
    alpha = in_sz / out_sz
    idx = np.arange(out_sz + 1)
    b = np.ceil(alpha * (idx + u)).astype(np.int64) - \
        int(np.ceil(alpha * u))
    b = np.clip(b, 0, in_sz)
    b[-1] = in_sz
    return b


def _fractional_pool(x, n, output_size, kernel_size, random_u, name):
    u = float(random_u) if random_u is not None else \
        float(np.random.RandomState(0).uniform(0, 1))
    xt = _t(x)
    out_sp = (output_size,) * n if isinstance(output_size, int) \
        else tuple(int(s) for s in output_size[-n:])
    bounds = [_fractional_bounds(i, o, u)
              for i, o in zip(xt.shape[2:], out_sp)]

    def f(a):
        for d in range(n):
            axis, b = 2 + d, bounds[d]
            pieces = []
            for i in range(len(b) - 1):
                s = int(b[i])
                e = min(max(int(b[i + 1]), s + 1), a.shape[axis])
                pieces.append(torch.amax(a.narrow(axis, s, e - s), axis,
                                         keepdim=True))
            a = torch.cat(pieces, axis)
        return a
    return run_op(name, f, xt)


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    out = _fractional_pool(x, 2, output_size, kernel_size, random_u,
                           "fractional_max_pool2d")
    if return_mask:
        from ...ops.creation import zeros
        return out, zeros(out.shape, dtype="int64")
    return out


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    out = _fractional_pool(x, 3, output_size, kernel_size, random_u,
                           "fractional_max_pool3d")
    if return_mask:
        from ...ops.creation import zeros
        return out, zeros(out.shape, dtype="int64")
    return out


# ---------------------------------------------------------------------------
# vision: affine_grid / grid_sample
# ---------------------------------------------------------------------------

def affine_grid(theta, out_shape, align_corners=True, name=None):
    """2-D/3-D affine sampling grid (reference nn/functional/vision.py
    affine_grid)."""
    out_shape = [int(s) for s in (out_shape.tolist()
                                  if isinstance(out_shape, Tensor)
                                  else out_shape)]

    def f(th):
        def line(n):
            if align_corners:
                return torch.linspace(-1.0, 1.0, n, device=th.device)
            step = 2.0 / n
            return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, n,
                                  device=th.device)
        if len(out_shape) == 4:
            _, _, h, w = out_shape
            ys, xs = torch.meshgrid(line(h), line(w), indexing="ij")
            base = torch.stack([xs, ys, torch.ones_like(xs)], -1)
            return torch.einsum("hwk,njk->nhwj", base.to(th.dtype), th)
        _, _, d, h, w = out_shape
        zs, ys, xs = torch.meshgrid(line(d), line(h), line(w),
                                    indexing="ij")
        base = torch.stack([xs, ys, zs, torch.ones_like(xs)], -1)
        return torch.einsum("dhwk,njk->ndhwj", base.to(th.dtype), th)
    return run_op("affine_grid", f, _t(theta))


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample x at normalized grid locations (reference grid_sample
    kernel), by gathers."""
    def f(a, g):
        n, c, h, w = a.shape
        bidx = torch.arange(n, device=a.device)[:, None, None]

        def unnorm(v, size):
            if align_corners:
                return (v + 1) * (size - 1) / 2
            return ((v + 1) * size - 1) / 2
        fx, fy = unnorm(g[..., 0], w), unnorm(g[..., 1], h)

        def refl(v, size):
            if align_corners:
                span = 2 * (size - 1)
                v = torch.remainder(v.abs(), max(span, 1))
                return torch.where(v >= size, span - v, v)
            span = 2 * size
            v = torch.remainder((v + 0.5).abs(), max(span, 1))
            v = torch.where(v >= size, span - v, v) - 0.5
            return torch.clamp(v, 0, size - 1)

        def sample(ix, iy):
            if padding_mode == "border":
                ix, iy = torch.clamp(ix, 0, w - 1), torch.clamp(iy, 0, h - 1)
                valid = None
            elif padding_mode == "reflection":
                ix, iy = refl(ix, w), refl(iy, h)
                valid = None
            else:
                valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
                ix, iy = torch.clamp(ix, 0, w - 1), torch.clamp(iy, 0, h - 1)
            out = a[bidx, :, iy.long(), ix.long()]          # [N, Ho, Wo, C]
            if valid is not None:
                out = torch.where(valid[..., None], out,
                                  torch.zeros((), dtype=out.dtype,
                                              device=out.device))
            return out

        if mode == "nearest":
            out = sample(torch.round(fx), torch.round(fy))
        else:
            x0, y0 = torch.floor(fx), torch.floor(fy)
            x1, y1 = x0 + 1, y0 + 1
            out = (sample(x0, y0) * ((x1 - fx) * (y1 - fy))[..., None]
                   + sample(x0, y1) * ((x1 - fx) * (fy - y0))[..., None]
                   + sample(x1, y0) * ((fx - x0) * (y1 - fy))[..., None]
                   + sample(x1, y1) * ((fx - x0) * (fy - y0))[..., None])
        return out.movedim(-1, 1).to(a.dtype)
    return run_op("grid_sample", f, _t(x), _t(grid))


# ---------------------------------------------------------------------------
# misc extension ops
# ---------------------------------------------------------------------------

def class_center_sample(label, num_classes, num_samples, group=None,
                        name=None):
    """Sample class centers: every positive class, then random negatives up
    to num_samples (reference class_center_sample op used by the margin
    losses; single-process semantics). Returns (the labels remapped to
    their sampled index, the sampled classes)."""
    from ...ops.creation import to_tensor
    lab = _t(label)
    lab_np = np.asarray(lab.numpy(), np.int64)
    pos = np.unique(lab_np)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        rest = np.setdiff1d(np.arange(num_classes), pos)
        extra = np.random.RandomState(0).choice(
            rest, num_samples - len(pos), replace=False)
        sampled = np.concatenate([pos, extra])
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    return to_tensor(remap[lab_np]), to_tensor(sampled)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Block-sparse attention given a CSR pattern (reference
    sparse_attention op): the mask is built from the CSR rows, then
    masked attention."""
    def f(q, k, v, off, cols):
        nb, nh, seq, dk = q.shape
        scores = torch.einsum("nhqd,nhkd->nhqk", q, k) / np.sqrt(dk)
        offs = off.long()
        nnz = cols.shape[-1]
        pos = torch.arange(nnz, device=q.device).expand(nb, nh, nnz)
        # the row of each stored entry, and whether it is one
        row = torch.searchsorted(offs[..., 1:].contiguous(),
                                 pos.contiguous(), right=True)
        live = pos < offs[..., -1:]
        flat = torch.where(live, row * (seq + 1) + cols.long(),
                           torch.full_like(row, seq * (seq + 1) + seq))
        mask = torch.zeros((nb, nh, (seq + 1) * (seq + 1)), dtype=torch.bool,
                           device=q.device)
        mask = mask.scatter(2, flat, True).reshape(nb, nh, seq + 1, seq + 1)
        scores = torch.where(mask[:, :, :seq, :seq], scores,
                             torch.full((), -1e30, dtype=scores.dtype,
                                        device=q.device))
        return torch.einsum("nhqk,nhkd->nhqd", torch.softmax(scores, -1), v)
    return run_op("sparse_attention", f, _t(query), _t(key), _t(value),
                  _t(sparse_csr_offset), _t(sparse_csr_columns))


def gather_tree(ids, parents):
    from ...ops.extra import gather_tree as _gt
    return _gt(ids, parents)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    from ...ops.vision_ops import temporal_shift as _ts
    return _ts(x, seg_num, shift_ratio, data_format)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction=None, name=None):
    from ...ops.extra import margin_cross_entropy as _mce
    from ...ops.math import mean, sum as _sum
    out = _mce(logits, label, margin1, margin2, margin3, scale,
               return_softmax=return_softmax)
    if reduction is None:
        return out
    loss = out[0] if return_softmax else out
    red = mean(loss) if reduction == "mean" else _sum(loss)
    return (red, out[1]) if return_softmax else red


# ---------------------------------------------------------------------------
# flash-attention packed variants (reference nn/functional/
# flash_attention.py): the same dispatch as flash_attention, other packing
# ---------------------------------------------------------------------------

def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, name=None):
    """qkv: [B, S, 3, H, D] packed (reference flash_attn_qkvpacked)."""
    from .attention import flash_attention
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout=dropout, causal=causal,
                           return_softmax=return_softmax)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale=None,
                                dropout=0.0, causal=False,
                                return_softmax=False, name=None):
    """Varlen packed qkv: [total_tokens, 3, H, D] + cumulative lengths
    (reference flash_attn_varlen_qkvpacked)."""
    from .attention import flash_attn_unpadded
    return flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                               cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                               max_seqlen_k, scale=scale, dropout=dropout,
                               causal=causal, return_softmax=return_softmax)


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """FlashMask attention (reference incubate flashmask_attention):
    attention with per-row start/end column masks, columns in
    [start, end) masked out."""
    def f(qa, ka, va, *rows):
        _, sq, _, d = qa.shape
        sk = ka.shape[1]
        qh, kh, vh = qa.movedim(1, 2), ka.movedim(1, 2), va.movedim(1, 2)
        scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / np.sqrt(d)
        cols = torch.arange(sk, device=qa.device)
        neg = torch.full((), -1e30, dtype=scores.dtype, device=qa.device)
        if causal:
            rows_i = torch.arange(sq, device=qa.device)
            scores = torch.where(cols[None, None, None, :]
                                 <= rows_i[None, None, :, None], scores, neg)
        if rows:
            sr = rows[0]          # [B, H or 1, S, n] start/end row indices
            start = sr[..., 0]
            end = sr[..., 1] if sr.shape[-1] > 1 else \
                torch.full_like(start, sk)
            masked = (cols[None, None, None, :] >= start[..., :, None]) & \
                (cols[None, None, None, :] < end[..., :, None])
            scores = torch.where(masked, neg, scores)
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1), vh)
        return out.movedim(2, 1)
    args = [_t(query), _t(key), _t(value)]
    if startend_row_indices is not None:
        args.append(_t(startend_row_indices))
    return run_op("flashmask_attention", f, *args)
