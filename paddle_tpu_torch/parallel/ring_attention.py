"""Ring attention over a mesh axis: the port of
``paddle_tpu/parallel/ring_attention.py`` (long-context sequence
parallelism; the reference snapshot has none, SURVEY §2.7).

Each rank keeps its query slice of the sequence while the key/value slices
rotate around the ring (``ppermute`` to the next rank), and each block's
attention is merged into a running flash-style softmax in f32, so memory
stays O(S / n). Causal: the query block of rank r attends the key block
that left rank src fully when src < r, through the triangular mask when
src == r, and not at all when src > r (that block is masked out, but
attended all the same: every rank must run the same ops in the same order,
so that the backward's collectives pair up). The backward is torch's autograd through the rotation, whose gradient is the
inverse permutation, as in jax.

    out = ring_attention(q, k, v, axis_name="sp", causal=True)

q/k/v: [B, S_local, H, D] (this rank's slice); out the same shape.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..distributed import collective as C


def _block_attend(q, k, v, scale, mask):
    """One q-block x kv-block pass: (scores max, exp sums, output part) in
    f32. q [B, Sq, H, D], k/v [B, Sk, H, D], mask [Sq, Sk] bool or None
    (True = attend)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[None, None], -1e30)
    m = logits.amax(-1)                                # [B, H, Sq]
    p = torch.exp(logits - m[..., None])
    if mask is not None:
        # fully masked rows: no exp(-1e30 + 1e30) = 1 garbage
        any_valid = mask.any(-1)                       # [Sq]
        p = torch.where(any_valid[None, None, :, None], p, 0.0)
        m = torch.where(any_valid[None, None, :], m, -math.inf)
    l_sum = p.sum(-1)                                  # [B, H, Sq]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    return m, l_sum, o


def _safe_exp(x, mn):
    return torch.where(torch.isfinite(mn), torch.exp(x - mn), 0.0)


def ring_attention(q, k, v, axis_name, causal: bool = False,
                   scale: Optional[float] = None):
    """Exact attention over the whole (ring-distributed) sequence."""
    group = C._axis_group(axis_name)
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    n, me = group.nranks, group.rank
    b, sq, h, _ = q.shape
    acc = q.new_zeros((b, sq, h, d), dtype=torch.float32)
    m_run = q.new_full((b, h, sq), -math.inf, dtype=torch.float32)
    l_run = q.new_zeros((b, h, sq), dtype=torch.float32)
    perm = [(i, (i + 1) % n) for i in range(n)]
    ones = torch.ones(sq, sq, dtype=torch.bool, device=q.device)
    masks = (ones, ones.tril(), ~ones)   # src < me, src == me, src > me

    def merge(acc, m_run, l_run, k_cur, v_cur, t):
        src = (me - t) % n             # the rank k_cur started on
        # every block is attended, a masked-out one too: each rank's graph
        # must hold the same ops in the same order, or the backward's
        # collectives would pair up differently on different ranks
        mask = masks[(src > me) - (src < me) + 1] if causal else None
        m_blk, l_blk, o_blk = _block_attend(q, k_cur, v_cur, s, mask)
        m_new = torch.maximum(m_run, m_blk)
        alpha = _safe_exp(m_run, m_new)                # rescale the old
        beta = _safe_exp(m_blk, m_new)                 # and the new
        l_new = alpha * l_run + beta * l_blk
        acc = acc * alpha.transpose(1, 2)[..., None] \
            + o_blk * beta.transpose(1, 2)[..., None]
        return acc, m_new, l_new

    acc, m_run, l_run = merge(acc, m_run, l_run, k, v, 0)
    k_cur, v_cur = k, v
    for t in range(1, n):
        k_cur = C.ops.ppermute(k_cur, group, perm)
        v_cur = C.ops.ppermute(v_cur, group, perm)
        acc, m_run, l_run = merge(acc, m_run, l_run, k_cur, v_cur, t)
    denom = l_run.transpose(1, 2)[..., None]
    return (acc / denom.clamp_min(1e-30)).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False):
    """The global form: q/k/v [B, S, H, D] whole on every rank; this rank
    runs the ring on its slice of the sequence, and the output is gathered
    whole on every rank."""
    g = mesh.get_group(axis_name) if mesh is not None \
        else C._axis_group(axis_name)
    def split(t):
        return C._Split.apply(t, g, 1)
    out = ring_attention(split(q), split(k), split(v), g, causal=causal)
    return C._GatherInvariant.apply(out, g, 1)
