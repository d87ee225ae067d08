"""The eager ``flash_attn`` op: the part of ``paddle_tpu/ops/extra.py``
(:338-360) that this slice ports; the rest of that module waits for a later
slice (ROADMAP)."""
from __future__ import annotations

import math

import torch

from ..core.dispatch import run_op
from ..core.tensor import Tensor
from .hopper.flash_attention import flash_attention_maybe


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


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
