"""Fused LM-head + softmax cross-entropy (chunked, logits never stored).

Port of ``paddle_tpu/ops/fused_ce.py``: the token dim is cut into chunks,
each [chunk, vocab] f32 logits tile lives only inside one chunk's step, and
the backward recomputes it instead of saving it. Residuals are O(tokens)
(logz, picked) plus the inputs. The matmuls are plain ``torch`` products,
as the reference left them to XLA; their outputs are f32 from bf16 inputs,
the reference's ``preferred_element_type=float32``.
"""
from __future__ import annotations

import torch

# Cap on the chunk, bounding the transient f32 tile (~1.6 GB at V=50k).
_CHUNK_CAP = 8192


def _chunked(t: int):
    """(chunk, padded_t). n = ceil(t / cap) near-equal chunks, each
    rounded up to a 128-row tile, so padding waste stays at a few
    percent (naive pad-to-cap wastes up to ~2x at t slightly over the
    cap, e.g. t=8200 -> pt=16384)."""
    if t <= _CHUNK_CAP:
        return t, t
    n = -(-t // _CHUNK_CAP)
    c = -(-(-(-t // n)) // 128) * 128
    return c, n * c


def _mm_f32(a, b):
    """a @ b with an f32 result from the inputs' own dtype: products exact,
    sums in f32, no rounding of the output to bf16."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _pad(a, pt):
    t = a.shape[0]
    if pt == t:
        return a
    return torch.cat([a, a.new_zeros((pt - t,) + tuple(a.shape[1:]))])


class FusedLMCE(torch.autograd.Function):
    """Weighted-mean token cross-entropy of softmax(x @ w.T) vs targets.

    x: [T, H] activations (bf16/fp32), w: [V, H] tied LM head weight,
    targets: [T] int labels, weights: [T] f32 per-token weights (use 0/1
    to mask padding). Returns sum(w_i * ce_i) / sum(w_i) as f32 (0 when
    all weights are 0)."""

    @staticmethod
    def forward(ctx, x, w, targets, weights):
        t = x.shape[0]
        c, pt = _chunked(t)
        xp, tp = _pad(x, pt), _pad(targets, pt)
        wp = _pad(weights.float(), pt)
        total = x.new_zeros((), dtype=torch.float32)
        logz, picked = [], []
        for i in range(0, pt, c):
            logits = _mm_f32(xp[i:i + c], w.t())
            lz = torch.logsumexp(logits, dim=-1)
            pk = logits.gather(1, tp[i:i + c, None])[:, 0]
            total = total + torch.sum(wp[i:i + c] * (lz - pk))
            logz.append(lz)
            picked.append(pk)
        denom = torch.sum(weights.float())
        live = denom > 0
        loss = torch.where(live, total / torch.where(live, denom, 1.0), 0.0)
        ctx.save_for_backward(x, w, targets, weights,
                              torch.cat(logz)[:t], torch.cat(picked)[:t],
                              denom)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, targets, weights, logz, picked, denom = ctx.saved_tensors
        t, h = x.shape
        c, pt = _chunked(t)
        live = denom > 0
        safe = torch.where(live, denom, 1.0)
        wf = weights.float()
        scale = _pad(torch.where(live, wf * (g / safe), 0.0), pt)
        xp, tp, zp = _pad(x, pt), _pad(targets, pt), _pad(logz, pt)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dx = []
        for i in range(0, pt, c):
            xi = xp[i:i + c]
            p = torch.exp(_mm_f32(xi, w.t()) - zp[i:i + c, None])
            p[torch.arange(p.shape[0], device=p.device), tp[i:i + c]] -= 1.0
            dlog = (p * scale[i:i + c, None]).to(w.dtype)       # [C, V]
            dx.append(_mm_f32(dlog, w).to(x.dtype))
            dw += _mm_f32(dlog.t(), xi)
        # d loss / d w_i = (ce_i - loss) / denom  (quotient rule)
        ce = logz - picked
        loss = torch.sum(wf * ce) / safe
        dweights = torch.where(live, g * (ce - loss) / safe, 0.0) \
            .to(weights.dtype)
        return torch.cat(dx)[:t], dw.to(w.dtype), None, dweights


def fused_lm_ce(x, w, targets, weights):
    return FusedLMCE.apply(x, w, targets, weights)
