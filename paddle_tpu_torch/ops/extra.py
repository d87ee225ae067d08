"""The op-surface completion batch: the port of ``paddle_tpu/ops/extra.py``.

Norms, special functions, manipulation, losses, sequence decode, sampling,
the eager ``flash_attn`` and the fused AMP and optimizer device ops
(reference schemas: paddle/phi/ops/yaml/ops.yaml p_norm, renorm, ...,
check_finite_and_unscale_, update_loss_scaling_, sgd_, momentum_, adam_,
adamw_). Each op's body is torch ops on the tensors of its inputs,
dispatched through ``run_op``; torch's autograd is the backward.

Where the port differs on purpose:

- ``standard_gamma``, ``dirichlet`` and ``top_p_sampling`` draw from the
  port's torch generators: their draws differ from jax's by design, their
  distributions do not;
- ``as_strided`` and ``tensor_unfold`` are gathers in the reference, so
  they return copies: the port's return copies too, and a write to the
  result never reaches the input;
- the reference's ``lax.scan`` loops (``edit_distance``, ``viterbi_decode``,
  ``gather_tree``) are Python loops over time whose carries stay on the
  device: no step reads a value on the host;
- ``gammainc``/``gammaincc`` differentiate in ``a`` through
  ``_igamma_grad_a``, the series and continued fraction of jax's
  ``igamma_grad_a`` written in torch (torch has no derivative in ``a``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as tF

from ..core import dtype as dtype_mod
from ..core.dispatch import run_op
from ..core.generator import generator_for
from ..core.tensor import Tensor
from .hopper.flash_attention import flash_attention_maybe


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


# ---------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------
def p_norm(x, porder=2.0, axis=-1, epsilon=1e-12, keepdim=False,
           asvector=False):
    """reference ops.yaml p_norm (phi/kernels/p_norm_kernel)."""
    def f(a):
        ax = tuple(range(a.ndim)) if asvector else axis
        if porder == float("inf"):
            return torch.amax(a.abs(), dim=ax, keepdim=keepdim)
        if porder == float("-inf"):
            return torch.amin(a.abs(), dim=ax, keepdim=keepdim)
        if porder == 0:
            return torch.sum((a != 0).to(a.dtype), dim=ax, keepdim=keepdim)
        return torch.sum(a.abs() ** porder, dim=ax,
                         keepdim=keepdim) ** (1.0 / porder)
    return run_op("p_norm", f, _t(x))


def frobenius_norm(x, axis=None, keepdim=False):
    def f(a):
        ax = tuple(range(a.ndim)) if axis is None else _axes(axis)
        return torch.sqrt(torch.sum(a * a, dim=ax, keepdim=keepdim))
    return run_op("frobenius_norm", f, _t(x))


def squared_l2_norm(x):
    return run_op("squared_l2_norm", lambda a: torch.sum(a * a).reshape(1),
                  _t(x))


def clip_by_norm(x, max_norm):
    def f(a):
        norm = torch.sqrt(torch.sum(a * a))
        scale = torch.where(norm > max_norm, max_norm / norm,
                            torch.ones_like(norm))
        return a * scale.to(a.dtype)
    return run_op("clip_by_norm", f, _t(x))


def renorm(x, p, axis, max_norm):
    """Per-slice p-norm clamp along ``axis`` (reference renorm op)."""
    def f(a):
        dims = tuple(d for d in range(a.ndim) if d != axis % a.ndim)
        norms = torch.sum(a.abs() ** p, dim=dims,
                          keepdim=True) ** (1.0 / p)
        scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                            torch.ones_like(norms))
        return a * scale.to(a.dtype)
    return run_op("renorm", f, _t(x))


# ---------------------------------------------------------------------
# special functions / sampling
# ---------------------------------------------------------------------
def gammaln(x):
    return run_op("gammaln", torch.lgamma, _t(x))


def polygamma(x, n):
    def f(a):
        if n == 0:
            return torch.digamma(a)
        return torch.special.polygamma(n, a)
    return run_op("polygamma", f, _t(x))


def _igamma_grad_a(a, x):
    """d P(a, x) / da, elementwise: jax's ``igamma_grad_a`` (the series of
    P for x <= 1 or x <= a, else the continued fraction of Q), each iterated
    until its derivative term moves by less than the dtype's eps."""
    eps = torch.finfo(a.dtype).eps
    a, x = torch.broadcast_tensors(a, x)
    x_is_zero = x == 0
    domain = (x < 0) | (a <= 0) | torch.isnan(a) | torch.isnan(x)
    use_cf = (x > 1) & (x > a)
    safe_x = torch.where(x_is_zero | domain, torch.ones_like(x), x)
    safe_a = torch.where(domain, torch.ones_like(a), a)
    logax = safe_a * torch.log(safe_x) - safe_x - torch.lgamma(safe_a)
    underflow = logax < -math.log(torch.finfo(a.dtype).max)
    ax = torch.exp(logax)
    enabled = ~(x_is_zero | domain | underflow)

    # the series: P = ax / a * sum_n c_n, c_0 = 1, c_n = c_{n-1} x / (a + n)
    on = enabled & ~use_cf
    r, c, ans = safe_a.clone(), torch.ones_like(a), torch.ones_like(a)
    dc, dans = torch.zeros_like(a), torch.zeros_like(a)
    while bool(on.any()):
        r1 = r + 1
        dc1 = dc * (safe_x / r1) - (c * safe_x) / (r1 * r1)
        dans1 = dans + dc1
        c1 = c * (safe_x / r1)
        r, c = torch.where(on, r1, r), torch.where(on, c1, c)
        ans = torch.where(on, ans + c1, ans)
        dc, dans = torch.where(on, dc1, dc), torch.where(on, dans1, dans)
        on = on & ((dc1 / dans1).abs() > eps)
    dlogax = torch.log(safe_x) - torch.digamma(safe_a + 1)
    series = ax * (ans * dlogax + dans) / safe_a

    # the continued fraction of Q (Cephes igamc), with its derivative in a
    on = enabled & use_cf
    y = 1 - safe_a
    z = safe_x + y + 1
    cnt = torch.zeros_like(a)
    pkm2, qkm2 = torch.ones_like(a), safe_x.clone()
    pkm1, qkm1 = safe_x + 1, z * safe_x
    ans = pkm1 / qkm1
    dpkm2, dqkm2 = torch.zeros_like(a), torch.zeros_like(a)
    dpkm1, dqkm1 = torch.zeros_like(a), -safe_x
    dans = (dpkm1 - ans * dqkm1) / qkm1
    n = 0
    while bool(on.any()) and n < 2000:
        n += 1
        cnt, y, z = cnt + 1, y + 1, z + 2
        yc = y * cnt
        pk = pkm1 * z - pkm2 * yc
        qk = qkm1 * z - qkm2 * yc
        nz = qk != 0
        rk = pk / torch.where(nz, qk, torch.ones_like(qk))
        ans1 = torch.where(nz, rk, ans)
        dpk = dpkm1 * z - pkm1 - dpkm2 * yc + pkm2 * cnt
        dqk = dqkm1 * z - qkm1 - dqkm2 * yc + qkm2 * cnt
        dans1 = torch.where(
            nz, (dpk - ans1 * dqk) / torch.where(nz, qk, torch.ones_like(qk)),
            dans)
        moved = torch.where(nz, (dans1 - dans).abs(), torch.ones_like(dans))
        pkm2n, pkm1n, qkm2n, qkm1n = pkm1, pk, qkm1, qk
        dpkm2n, dqkm2n, dpkm1n, dqkm1n = dpkm1, dqkm1, dpk, dqk
        big = pk.abs() > 1 / eps
        scale = torch.where(big, torch.full_like(pk, eps), torch.ones_like(pk))
        pkm2n, pkm1n = pkm2n * scale, pkm1n * scale
        qkm2n, qkm1n = qkm2n * scale, qkm1n * scale
        dpkm2n, dqkm2n = dpkm2n * scale, dqkm2n * scale
        dpkm1n, dqkm1n = dpkm1n * scale, dqkm1n * scale
        ans, dans = torch.where(on, ans1, ans), torch.where(on, dans1, dans)
        pkm2, pkm1 = torch.where(on, pkm2n, pkm2), torch.where(on, pkm1n, pkm1)
        qkm2, qkm1 = torch.where(on, qkm2n, qkm2), torch.where(on, qkm1n, qkm1)
        dpkm2 = torch.where(on, dpkm2n, dpkm2)
        dqkm2 = torch.where(on, dqkm2n, dqkm2)
        dpkm1 = torch.where(on, dpkm1n, dpkm1)
        dqkm1 = torch.where(on, dqkm1n, dqkm1)
        on = on & (moved > eps)
    dlogax = torch.log(safe_x) - torch.digamma(safe_a)
    cf = -ax * (ans * dlogax + dans)

    out = torch.where(use_cf, cf, series)
    out = torch.where(x_is_zero, torch.zeros_like(out), out)
    return torch.where(domain, torch.full_like(out, float("nan")), out)


def _igamma_grad_x(a, x):
    """d P(a, x) / dx = x^(a-1) e^(-x) / Gamma(a)."""
    return torch.exp((a - 1) * torch.log(x) - x - torch.lgamma(a))


def _unbroadcast(g, shape):
    while g.ndim > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _Igamma(torch.autograd.Function):
    """P(a, x) (sign 1) or Q(a, x) = 1 - P (sign -1), differentiable in
    both arguments."""

    @staticmethod
    def forward(ctx, a, x, sign):
        ctx.save_for_backward(a, x)
        ctx.sign = sign
        return (torch.special.gammainc if sign > 0
                else torch.special.gammaincc)(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        ga = gx = None
        with torch.no_grad():
            if ctx.needs_input_grad[0]:
                ga = _unbroadcast(ctx.sign * g * _igamma_grad_a(a, x),
                                  a.shape)
            if ctx.needs_input_grad[1]:
                gx = _unbroadcast(ctx.sign * g * _igamma_grad_x(a, x),
                                  x.shape)
        return ga, gx, None


def gammaincc(x, y):
    """Regularized upper incomplete gamma Q(x, y)."""
    return run_op("gammaincc", lambda a, b: _Igamma.apply(a, b, -1),
                  _t(x), _t(y))


def gammainc(x, y):
    return run_op("gammainc", lambda a, b: _Igamma.apply(a, b, 1),
                  _t(x), _t(y))


def standard_gamma(x):
    """Sample Gamma(alpha=x, 1) elementwise (reference standard_gamma)."""
    x = _t(x)
    gen = generator_for(x._data.device)
    return run_op("standard_gamma",
                  lambda a: torch._standard_gamma(a, generator=gen), x)


def dirichlet(alpha):
    alpha = _t(alpha)
    gen = generator_for(alpha._data.device)
    return run_op("dirichlet",
                  lambda a: torch._sample_dirichlet(a, generator=gen), alpha)


def logsigmoid(x):
    return run_op("logsigmoid", tF.logsigmoid, _t(x))


def tanh_shrink(x):
    return run_op("tanh_shrink", lambda a: a - torch.tanh(a), _t(x))


def swiglu(x, y=None):
    """silu(x) * y; with y=None x is split in half on the last dim
    (reference ops.yaml swiglu / fused swiglu kernel)."""
    if y is None:
        def f(a):
            u, v = torch.chunk(a, 2, dim=-1)
            return tF.silu(u) * v
        return run_op("swiglu", f, _t(x))
    return run_op("swiglu", lambda a, b: tF.silu(a) * b, _t(x), _t(y))


# ---------------------------------------------------------------------
# manipulation
# ---------------------------------------------------------------------
def fill(x, value):
    return run_op("fill", lambda a: torch.full_like(a, value), _t(x))


def fill_diagonal(x, value, offset=0, wrap=False):
    def f(a):
        out = a.clone()
        if a.ndim == 2 and wrap:
            rows, cols = a.shape
            i = torch.arange(rows, device=a.device)
            out[i, (i + offset) % cols] = value
            return out
        rows, cols = a.shape[-2], a.shape[-1]
        k = min(rows, cols - offset) if offset >= 0 \
            else min(rows + offset, cols)
        idx = torch.arange(max(k, 0), device=a.device)
        out[..., idx + max(-offset, 0), idx + max(offset, 0)] = value
        return out
    return run_op("fill_diagonal", f, _t(x))


def reverse(x, axis):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return run_op("reverse", lambda a: torch.flip(a, ax), _t(x))


def shape(x):
    """Shape as an int32 tensor (reference shape op)."""
    t = _t(x)
    return Tensor._wrap(torch.tensor(list(t._data.shape), dtype=torch.int32,
                                     device=t._data.device), True)


def as_strided(x, shape_, stride, offset=0):
    """The strided window of ``x``'s elements in row-major order
    (reference as_strided). As in the reference, whose result is a gather,
    this is a copy: a write to it does not reach ``x``."""
    def f(a):
        flat = a.reshape(-1)
        return torch.as_strided(flat, [int(s) for s in shape_],
                                [int(s) for s in stride],
                                int(offset)).clone()
    return run_op("as_strided", f, _t(x))


def tensor_unfold(x, axis, size, step):
    """Sliding windows along ``axis``: that axis becomes the window count
    and the window is the new last axis (reference tensor_unfold). A copy,
    as the reference's gather is."""
    def f(a):
        return a.unfold(axis % a.ndim, size, step).clone()
    return run_op("tensor_unfold", f, _t(x))


def view_dtype(x, dtype):
    td = dtype_mod.torch_dtype(dtype)
    return run_op("view_dtype", lambda a: a.view(td), _t(x))


def view_shape(x, shape_):
    return run_op("view_shape",
                  lambda a: a.reshape(tuple(int(s) for s in shape_)), _t(x))


def split_with_num(x, num, axis=0):
    def f(a):
        n = a.shape[axis]
        if n % num:
            raise ValueError(f"split_with_num: {n} not divisible by {num}")
        return tuple(torch.split(a, n // num, dim=axis))
    return run_op("split_with_num", f, _t(x))


def reduce_as(x, target):
    """Sum-reduce x down to target's shape (reference reduce_as)."""
    def f(a, tg):
        extra = a.ndim - tg.ndim
        if extra > 0:
            a = torch.sum(a, dim=tuple(range(extra)))
        axes = tuple(i for i in range(a.ndim)
                     if tg.shape[i] == 1 and a.shape[i] != 1)
        if axes:
            a = torch.sum(a, dim=axes, keepdim=True)
        return a
    return run_op("reduce_as", f, _t(x), _t(target))


# ---------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------
def bce_loss(input, label):
    def f(p, y):
        eps = 1e-12
        p = torch.clamp(p, eps, 1 - eps)
        return -(y * torch.log(p) + (1 - y) * torch.log1p(-p))
    return run_op("bce_loss", f, _t(input), _t(label))


def hinge_loss(logits, labels):
    return run_op(
        "hinge_loss",
        lambda lg, y: torch.clamp_min(1.0 - (2.0 * y - 1.0) * lg, 0.0),
        _t(logits), _t(labels))


def kldiv_loss(x, label, reduction="mean", log_target=False):
    def f(lp, y):
        if log_target:
            out = torch.exp(y) * (y - lp)
        else:
            safe_y = torch.where(y > 0, y, torch.ones_like(y))
            out = torch.where(y > 0, y * (torch.log(safe_y) - lp),
                              torch.zeros_like(y))
        if reduction == "mean":
            return torch.mean(out)
        if reduction == "batchmean":
            return torch.sum(out) / lp.shape[0]
        if reduction == "sum":
            return torch.sum(out)
        return out
    return run_op("kldiv_loss", f, _t(x), _t(label))


def sigmoid_cross_entropy_with_logits(x, label, normalize=False,
                                      ignore_index=-100):
    def f(lg, y):
        out = torch.clamp_min(lg, 0) - lg * y + tF.softplus(-lg.abs())
        mask = (y != ignore_index).to(out.dtype)
        out = out * mask
        if normalize:
            out = out / torch.clamp_min(torch.sum(mask), 1.0)
        return out
    return run_op("sigmoid_ce_logits", f, _t(x), _t(label))


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, return_softmax=False):
    """ArcFace-style margin softmax (reference margin_cross_entropy;
    single-shard variant)."""
    def f(lg, y):
        c = lg.shape[1]
        onehot = tF.one_hot(y.long(), c).to(lg.dtype)
        theta = torch.arccos(torch.clamp(lg, -1.0, 1.0))
        target = torch.cos(margin1 * theta + margin2) - margin3
        adj = (lg * (1 - onehot) + target * onehot) * scale
        logp = torch.log_softmax(adj, -1)
        loss = -torch.sum(logp * onehot, -1)
        if return_softmax:
            return loss, torch.exp(logp)
        return loss
    return run_op("margin_cross_entropy", f, _t(logits), _t(label))


# ---------------------------------------------------------------------
# fused attention-adjacent ops
# ---------------------------------------------------------------------
def fused_softmax_mask(x, mask):
    """softmax(x + mask) in f32 (reference fused_softmax_mask)."""
    def f(a, m):
        return torch.softmax(a.float() + m.float(), -1).to(a.dtype)
    return run_op("fused_softmax_mask", f, _t(x), _t(mask))


def fused_softmax_mask_upper_triangle(x):
    """Causal-masked softmax over the last two dims (reference
    fused_softmax_mask_upper_triangle)."""
    def f(a):
        s_q, s_k = a.shape[-2], a.shape[-1]
        iq = torch.arange(s_q, device=a.device)[:, None]
        ik = torch.arange(s_k, device=a.device)[None, :]
        logits = torch.where(iq >= ik, a.float(),
                             torch.full((), -1e30, device=a.device))
        return torch.softmax(logits, -1).to(a.dtype)
    return run_op("fused_softmax_mask_triu", f, _t(x))


def _plain_attention(q, k, v, causal):
    """The reference's XLA attention (extra.py:348-359): f32 scores, the
    causal mask top-left aligned, p in v's dtype."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        iq = torch.arange(s_q, device=q.device)[:, None]
        ik = torch.arange(s_k, device=q.device)[None, :]
        logits = torch.where(iq >= ik, logits, -1e30)
    p = torch.softmax(logits, -1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def flash_attn(q, k, v, dropout=0.0, causal=False, return_softmax=False,
               is_test=True, rng_name=""):
    """Reference flash_attn op (phi flash_attn_kernel.cu:587) on [B, S, H, D]
    q/k/v: the Hopper kernel that the port's attention dispatch picks
    (``ops/hopper/flash_attention.flash_attention_maybe``, whose custom ops
    carry their own backward kernels), or plain attention where it returns
    None (CPU tensors, shapes no kernel takes)."""
    def f(q, k, v):
        out = flash_attention_maybe(q, k, v, causal=causal)
        return _plain_attention(q, k, v, causal) if out is None else out
    return run_op("flash_attn", f, _t(q), _t(k), _t(v))


# ---------------------------------------------------------------------
# sequence decode / sampling
# ---------------------------------------------------------------------
def edit_distance(hyps, refs, hyp_lengths=None, ref_lengths=None,
                  normalized=False):
    """Batched Levenshtein distance, one dynamic-programming row per
    hypothesis token (reference edit_distance op). hyps/refs: [B, L] int
    tensors. Within a row, d[j] = min(cand[j], d[j-1] + 1) is a running
    minimum of cand[k] + (j - k), so each row is one ``cummin``."""
    hl_t = _t(hyp_lengths)._data if hyp_lengths is not None else None
    rl_t = _t(ref_lengths)._data if ref_lengths is not None else None

    def f(h, r):
        b, lh = h.shape
        lr = r.shape[1]
        dev = h.device
        hl = hl_t.to(dev) if hl_t is not None else \
            torch.full((b,), lh, device=dev)
        rl = rl_t.to(dev) if rl_t is not None else \
            torch.full((b,), lr, device=dev)
        col = torch.arange(lr + 1, device=dev)
        prev = col.expand(b, lr + 1).to(torch.int64)
        for i in range(lh):
            sub = (h[:, i][:, None] != r).to(torch.int64)
            cand = torch.minimum(prev[:, :-1] + sub, prev[:, 1:] + 1)
            first = prev[:, :1] + 1
            c = torch.cat([first, cand], 1)
            row = torch.cummin(c - col, 1).values + col
            prev = torch.where((i < hl)[:, None], row, prev)
        dist = torch.gather(prev, 1, rl.long()[:, None])[:, 0].float()
        if normalized:
            dist = dist / torch.clamp_min(rl.float(), 1.0)
        return dist
    return run_op("edit_distance", f, _t(hyps), _t(refs),
                  differentiable=False)


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True):
    """CRF Viterbi decode (reference viterbi_decode op).
    potentials: [B, L, T]; transition: [T+2, T+2] if bos/eos else [T, T].
    Returns (scores [B], paths [B, L] int64)."""
    lens_t = _t(lengths)._data

    def f(emis, trans):
        b, L, t = emis.shape
        lens = lens_t.to(emis.device)
        if include_bos_eos_tag:
            start, stop, tr = trans[-2, :t], trans[:t, -1], trans[:t, :t]
        else:
            start = stop = torch.zeros((t,), dtype=emis.dtype,
                                       device=emis.device)
            tr = trans
        alpha = emis[:, 0] + start[None]
        backptrs = []
        for i in range(1, L):
            scores = alpha[:, :, None] + tr[None]          # [B, T, T]
            best, best_prev = torch.max(scores, 1)
            alpha = torch.where((i < lens)[:, None], best + emis[:, i],
                                alpha)
            backptrs.append(best_prev)
        alpha = alpha + stop[None]
        score, last = torch.max(alpha, -1)
        tag = last
        path = [last]
        for i in range(L - 1, 0, -1):
            prev = torch.gather(backptrs[i - 1], 1, tag[:, None])[:, 0]
            tag = torch.where(i < lens, prev, tag)
            path.append(tag)
        return score, torch.stack(path[::-1], 1).to(torch.int64)
    return run_op("viterbi_decode", f, _t(potentials), _t(transition_params))


def gather_tree(ids, parents):
    """Beam-search backtrace (reference gather_tree op).
    ids/parents: [L, B, W] -> full beams [L, B, W]."""
    def f(ids, par):
        L, w = ids.shape[0], ids.shape[-1]
        beam = torch.arange(w, device=ids.device).expand(
            ids.shape[1:]).to(ids.dtype)
        outs = []
        for i in range(L - 1, -1, -1):
            outs.append(torch.gather(ids[i], -1, beam.long()))
            beam = torch.gather(par[i], -1, beam.long())
        return torch.stack(outs[::-1], 0)
    return run_op("gather_tree", f, _t(ids), _t(parents),
                  differentiable=False)


def top_p_sampling(x, ps, threshold=None, seed=None):
    """Nucleus sampling (reference top_p_sampling op). x: [B, V] probs.
    Returns (sampled values [B, 1], sampled ids [B, 1]), through the one
    implementation in ops.search."""
    from .search import top_p_sampling as _impl
    return _impl(_t(x), _t(ps), threshold=threshold,
                 seed=-1 if seed is None else int(seed))


# ---------------------------------------------------------------------
# graph / segment ops (geometric kernels)
# ---------------------------------------------------------------------
def send_u_recv(x, src_index, dst_index, reduce_op="SUM", out_size=None):
    """Gather x[src] and segment-reduce onto dst (reference send_u_recv,
    the message-passing kernel under paddle.geometric); empty segments
    are 0."""
    from ..geometric import _segment, _segment_mean

    def f(a, src, dst):
        n = int(out_size) if out_size is not None else a.shape[0]
        msgs = a[src.long()]
        op = reduce_op.upper()
        if op == "MEAN":
            return _segment_mean(msgs, dst, n)
        if op not in ("SUM", "MAX", "MIN"):
            raise ValueError(f"reduce_op {reduce_op}")
        out = _segment(msgs, dst, n, op.lower())
        if op == "SUM":
            return out
        # the empty segments' sentinels (+-inf, the int extremes) become 0
        if out.is_floating_point():
            return torch.where(torch.isfinite(out), out,
                               torch.zeros_like(out))
        info = torch.iinfo(out.dtype)
        sentinel = info.min if op == "MAX" else info.max
        return torch.where(out == sentinel, torch.zeros_like(out), out)
    return run_op("send_u_recv", f, _t(x), _t(src_index), _t(dst_index))


def segment_pool(x, segment_ids, pooltype="SUM"):
    """Segment reduce; the segment count is max(id) + 1 (read on the host,
    as the reference does). An empty MAX/MIN segment holds the dtype's
    lowest/highest value, as jax's segment_max/min give."""
    from ..geometric import _segment, _segment_mean

    def f(a, seg):
        m = int(seg.max()) + 1
        if pooltype == "MEAN":
            return _segment_mean(a, seg, m)
        if pooltype not in ("SUM", "MAX", "MIN"):
            raise ValueError(pooltype)
        return _segment(a, seg, m, pooltype.lower())
    return run_op("segment_pool", f, _t(x), _t(segment_ids))


# ---------------------------------------------------------------------
# AMP device ops (GradScaler halves): no value leaves the device
# ---------------------------------------------------------------------
def check_finite_and_unscale_(xs, scale):
    """reference CheckFiniteAndUnscaleKernel (phi/kernels/amp_kernel.h:25):
    unscale grads by 1/scale; found_inf = any nonfinite, a device tensor
    [1]. In place on the list of grad tensors; returns (xs, found_inf)."""
    xs = [_t(x) for x in xs]
    with torch.no_grad():
        inv = 1.0 / _t(scale)._data
        found = torch.zeros((), dtype=torch.bool, device=inv.device)
        outs = []
        for x in xs:
            d = x._data
            du = (d.float() * inv).to(d.dtype)
            found = found | ~torch.all(torch.isfinite(du.float()))
            outs.append(du)
    for x, o in zip(xs, outs):
        x._assign_array(o)
    return xs, Tensor._wrap(found.reshape(1), True)


def update_loss_scaling_(xs, found_inf, prev_loss_scaling, in_good_steps,
                         in_bad_steps, incr_every_n_steps=2000,
                         decr_every_n_nan_or_inf=1, incr_ratio=2.0,
                         decr_ratio=0.5, stop_update=False):
    """reference UpdateLossScalingKernel (amp_kernel.h:32): the dynamic
    loss scale's state machine, in device tensors; zeroes the grads on
    overflow."""
    with torch.no_grad():
        fi = _t(found_inf)._data.reshape(())
        ls = _t(prev_loss_scaling)._data
        good = _t(in_good_steps)._data
        bad = _t(in_bad_steps)._data
        zero = torch.zeros_like(bad)
        bad_n = torch.where(fi, bad + 1, zero)
        good_n = torch.where(fi, torch.zeros_like(good), good + 1)
        decr = bad_n >= decr_every_n_nan_or_inf
        incr = good_n >= incr_every_n_steps
        ls_n = torch.where(decr, torch.clamp_min(ls * decr_ratio, 1.0), ls)
        ls_n = torch.where(incr, ls_n * incr_ratio, ls_n)
        bad_n = torch.where(decr, zero, bad_n)
        good_n = torch.where(incr, torch.zeros_like(good), good_n)
    if not stop_update:
        _t(prev_loss_scaling)._assign_array(ls_n)
        _t(in_good_steps)._assign_array(good_n.to(good.dtype))
        _t(in_bad_steps)._assign_array(bad_n.to(bad.dtype))
    for x in xs:
        t = _t(x)
        with torch.no_grad():
            z = torch.where(fi, torch.zeros_like(t._data), t._data)
        t._assign_array(z)
    return xs


# ---------------------------------------------------------------------
# fused optimizer update ops (reference sgd_/momentum_/adam_/adamw_ phi
# kernels): the parameter and state are rebound in place
# ---------------------------------------------------------------------
def _lr(learning_rate, like):
    lr = _t(learning_rate)._data
    return lr.to(like.device)


def sgd_(param, learning_rate, grad, master_param=None,
         multi_precision=False):
    p, g = _t(param), _t(grad)
    mw = _t(master_param) if master_param is not None else None
    with torch.no_grad():
        base = (mw._data if mw is not None else p._data).float()
        pf = base - _lr(learning_rate, base) * g._data.float()
    p._assign_array(pf.to(p._data.dtype))
    if mw is not None:
        mw._assign_array(pf)
    return p


def momentum_(param, grad, velocity, learning_rate, master_param=None,
              mu=0.9, use_nesterov=False, regularization_method="",
              regularization_coeff=0.0, multi_precision=False,
              rescale_grad=1.0):
    p, g, v = _t(param), _t(grad), _t(velocity)
    with torch.no_grad():
        pd = p._data
        gf = g._data.float() * rescale_grad
        if regularization_method == "l2_decay":
            gf = gf + regularization_coeff * pd.float()
        vn = mu * v._data.float() + gf
        upd = gf + mu * vn if use_nesterov else vn
        pn = (pd.float() - _lr(learning_rate, pd) * upd).to(pd.dtype)
    p._assign_array(pn)
    v._assign_array(vn.to(v._data.dtype))
    return p, v


def adamw_(param, grad, learning_rate, moment1, moment2, beta1_pow,
           beta2_pow, master_param=None, skip_update=None, beta1=0.9,
           beta2=0.999, epsilon=1e-8, lr_ratio=1.0, coeff=0.01,
           with_decay=True, lazy_mode=False, min_row_size_to_use_multithread=0,
           multi_precision=False, use_global_beta_pow=False):
    """Fused AdamW step (reference adamw.py:495 -> fused adamw kernel).
    With ``master_param`` the f32 master weights are updated and the
    parameter gets their value in its own dtype."""
    p, g = _t(param), _t(grad)
    m1, m2 = _t(moment1), _t(moment2)
    b1p, b2p = _t(beta1_pow), _t(beta2_pow)
    mw = _t(master_param) if master_param is not None else None
    with torch.no_grad():
        pf = (mw._data if mw is not None else p._data).float()
        lr = _lr(learning_rate, pf) * lr_ratio
        gf = g._data.float()
        if with_decay:
            pf = pf * (1.0 - lr * coeff)
        m1n = beta1 * m1._data + (1 - beta1) * gf
        m2n = beta2 * m2._data + (1 - beta2) * gf * gf
        b1pn = b1p._data * beta1
        b2pn = b2p._data * beta2
        mhat = m1n / (1 - b1pn)
        vhat = m2n / (1 - b2pn)
        pf = pf - lr * mhat / (torch.sqrt(vhat) + epsilon)
    p._assign_array(pf.to(p._data.dtype))
    if mw is not None:
        mw._assign_array(pf)
    m1._assign_array(m1n)
    m2._assign_array(m2n)
    b1p._assign_array(b1pn)
    b2p._assign_array(b2pn)
    return p


def adam_(param, grad, learning_rate, moment1, moment2, beta1_pow,
          beta2_pow, master_param=None, skip_update=None, beta1=0.9,
          beta2=0.999, epsilon=1e-8, lazy_mode=False,
          min_row_size_to_use_multithread=0, multi_precision=False,
          use_global_beta_pow=False):
    """``adamw_`` without decay (reference extra.py:657-666)."""
    return adamw_(param, grad, learning_rate, moment1, moment2, beta1_pow,
                  beta2_pow, master_param=master_param, beta1=beta1,
                  beta2=beta2, epsilon=epsilon, coeff=0.0,
                  with_decay=False, multi_precision=multi_precision)


def accuracy_check(x, y, fn_name="", rtol=1e-5, atol=1e-8,
                   equal_nan=False):
    """Cross-run tensor comparison op (reference accuracy_check,
    ops.yaml:31, phi/kernels/accuracy_check_kernel.h:29): elementwise
    allclose(x, y) -> bool tensor; raises with fn_name context when any
    element mismatches (the reference kernel PADDLE_ENFORCEs)."""
    def f(a, b):
        return torch.isclose(a.float(), b.float(), rtol=rtol, atol=atol,
                             equal_nan=equal_nan)
    out = run_op("accuracy_check", f, _t(x), _t(y), differentiable=False)
    arr = np.asarray(out.numpy())
    if not arr.all():
        bad = int(arr.size - arr.sum())
        raise AssertionError(
            f"accuracy_check failed for {fn_name or 'tensor'}: "
            f"{bad}/{arr.size} elements differ "
            f"(rtol={rtol}, atol={atol})")
    return out
