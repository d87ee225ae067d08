"""Attention functionals: the port of ``paddle_tpu/nn/functional/attention.py``
(reference surface: paddle scaled_dot_product_attention +
nn/functional/flash_attention.py:195), on [batch, seq, heads, head_dim].

On the card, ``scaled_dot_product_attention`` without a mask or dropout
takes the reference's gate (``_maybe_pallas_attention``,
``attention.py:49-61``: f32/bf16, Sq and Skv multiples of 128, D in
{64, 128, 256}) to the library tier,
``ops/hopper/flash_attention.flash_attention`` (the custom op
``paddle_tpu_torch::library_flash`` over hand-written sm_90a kernels,
causal masked top-left), under torch autograd. Where the reference's
library kernel would refuse the shape, the gate refuses it beforehand
(``_library_refuses``) rather than catching an error. Everywhere else (the
CPU, masks, dropout, other shapes) it runs the plain ``_xla_attention``,
whose causal mask is bottom-right aligned, as the reference's is.

Each call on the card ticks ``nn.sdpa{route=}`` on observability's
``REGISTRY`` with the route it took ("library_flash" or "plain"), so that
a run can show where its attention went
(``ops.hopper.flash_attention.dispatch_counts``).
"""
from __future__ import annotations

import math

import torch

from ...core.dispatch import run_op
from ...core.generator import generator_for, traced
from ...ops.hopper import flash_attention as fa


def _xla_attention(q, k, v, mask=None, causal=False, scale=None,
                   dropout_p=0.0, gen=None):
    """q/k/v: [B, S, H, D]: f32 logits, the causal mask bottom-right
    aligned (row i sees columns up to i + Skv - Sq), a bool mask keeps where
    True and an additive one is added, f32 softmax cast to q's dtype, then
    dropout with ``gen``'s draws."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * s).float()
    if causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(qlen, klen, dtype=torch.bool,
                          device=q.device).tril(klen - qlen)
        logits = logits.masked_fill(~keep, -1e30)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, -1e30)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0 and gen is not None:
        keep = (gen.uniform(probs.shape, probs.device) >= dropout_p
                if traced(gen) else
                torch.empty(probs.shape, device=probs.device).bernoulli_(
                    1.0 - dropout_p, generator=gen).bool())
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _maybe_pallas_attention(q, k, v, causal, scale):
    """The library tier on the card for the shapes the reference's gate
    sends to it, else None."""
    if q.device.type != "cuda":
        return None
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or q.shape[1] % 128 != 0 or k.shape[1] % 128 != 0 \
            or q.shape[-1] not in (64, 128, 256) \
            or fa._library_refuses(q.shape[1], k.shape[1], q.shape[-1]):
        fa._count("nn.sdpa", "plain")
        return None
    fa._count("nn.sdpa", "library_flash")
    return fa.flash_attention(q, k, v, causal=causal, scale=scale)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """paddle.nn.functional.scaled_dot_product_attention; layout
    [batch, seq, num_heads, head_dim]."""
    p = dropout_p if training else 0.0
    gen = generator_for(query._data.device) if p > 0.0 else None

    def f(q, k, v, *maybe_mask):
        if not maybe_mask and p == 0.0:
            out = _maybe_pallas_attention(q, k, v, is_causal, None)
            if out is not None:
                return out
        elif q.device.type == "cuda":
            fa._count("nn.sdpa", "plain")
        return _xla_attention(q, k, v,
                              maybe_mask[0] if maybe_mask else None,
                              causal=is_causal, dropout_p=p, gen=gen)
    if attn_mask is not None:
        return run_op("scaled_dot_product_attention", f, query, key, value,
                      attn_mask)
    return run_op("scaled_dot_product_attention", f, query, key, value)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """paddle flash_attention API (nn/functional/flash_attention.py:195).
    Returns (out, softmax) like the reference, softmax None."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False, training=True,
                        name=None):
    """Varlen attention over packed sequences ([total, H, D]), as the
    reference: segment ids from the cumulative lengths, attention masked to
    each segment (and causal within it, top-left per segment)."""
    def f(q, k, v, cu_q, cu_k):
        pos = torch.arange(q.shape[0], device=q.device, dtype=cu_q.dtype)
        seg_q = torch.searchsorted(cu_q, pos, right=True) - 1
        pos_k = torch.arange(k.shape[0], device=q.device, dtype=cu_k.dtype)
        seg_k = torch.searchsorted(cu_k, pos_k, right=True) - 1
        s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
        logits = torch.einsum("qhd,khd->hqk", q, k) * s
        mask = seg_q[:, None] == seg_k[None, :]
        if causal:
            off_q = pos - cu_q[seg_q]
            off_k = pos_k - cu_k[seg_k]
            mask = mask & (off_q[:, None] >= off_k[None, :])
        logits = logits.float().masked_fill(~mask[None], -1e30)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("hqk,khd->qhd", probs, v)
    out = run_op("flash_attn_unpadded", f, query, key, value, cu_seqlens_q,
                 cu_seqlens_k)
    return out, None


def sdp_kernel(*args, **kwargs):  # torch-style context shim
    import contextlib
    return contextlib.nullcontext()
