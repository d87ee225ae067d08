"""Ulysses (DeepSpeed-style) all-to-all sequence parallelism: the port of
``paddle_tpu/parallel/ulysses.py`` (the reference snapshot has none,
SURVEY §2.7).

One all-to-all turns this rank's [B, S / n, H, D] slice of the sequence
into [B, S, H / n, D] (the whole sequence, its group of heads), attention
runs over the whole sequence on those heads, and one all-to-all turns it
back. The same result as ring attention, with two exchanges instead of
n - 1; it needs H % n == 0. Its gradient is the reverse all-to-all.

    out = ulysses_attention(q, k, v, axis_name="sp", causal=True)
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..distributed import collective as C


def _full_attention(q, k, v, scale, causal):
    """Dense attention over whole-sequence blocks. q/k/v: [B, S, Hl, D]."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep[None, None], -1e30)
    probs = _softmax(logits)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _softmax(x):
    m = x.amax(-1, keepdim=True)
    e = torch.exp(x - m)
    return e / e.sum(-1, keepdim=True)


def ulysses_attention(q, k, v, axis_name, causal: bool = False,
                      scale: Optional[float] = None):
    """Exact attention over the whole sequence via the head <-> sequence
    all-to-all."""
    group = C._axis_group(axis_name)
    n = group.nranks
    b, s_local, h, d = q.shape
    if h % n != 0:
        raise ValueError(f"ulysses needs heads ({h}) % axis ({n}) == 0")
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    if n == 1:
        return _full_attention(q, k, v, sc, causal).to(q.dtype)
    # gather the sequence, scatter the heads: [B,S/n,H,D] -> [B,S,H/n,D]
    a2a = functools.partial(C.ops.all_to_all, axis_name=group, split_axis=2,
                            concat_axis=1)
    out = _full_attention(a2a(q), a2a(k), a2a(v), sc, causal)
    # and back: scatter the sequence, gather the heads
    return C.ops.all_to_all(out.to(q.dtype), group, split_axis=1,
                            concat_axis=2)


def ulysses_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False):
    """The global form: q/k/v [B, S, H, D] whole on every rank; this rank
    attends its slice of the sequence, and the output is gathered whole on
    every rank."""
    g = mesh.get_group(axis_name) if mesh is not None \
        else C._axis_group(axis_name)
    if q.shape[2] % g.nranks:
        raise ValueError(f"ulysses needs heads ({q.shape[2]}) % axis "
                         f"({g.nranks}) == 0")
    def split(t):
        return C._Split.apply(t, g, 1)
    out = ulysses_attention(split(q), split(k), split(v), g, causal=causal)
    return C._GatherInvariant.apply(out, g, 1)
