"""Attention dispatch: which Hopper kernel takes a [B, S, H, D] attention.

Port of ``paddle_tpu/ops/pallas/flash_attention.py`` (``supported_shape``,
``_gate_reason``, ``flash_attention``, ``flash_attention_maybe``). After the
library gate the autotuner's winner (``autotune.decide``: a Hopper kernel
that ``autotune.measure`` found fastest for the shape) takes precedence,
exactly where the reference consults it; without one the port walks the
reference's static chain with the tiers' own gates, so that it picks the
tier the reference picks: the monolithic ``simple_attention`` where the
whole (b, h) slice fits the reference's VMEM budget (S <= 1024 at D=128),
then ``causal_attention`` (the causal S=2048 rung), ``qblock_attention``
(the non-causal middle tier, and causal S=4096 at D=64), ``blocked_flash``
(S >= 4096), and last the library flash kernel. That last tier wraps JAX's
own kernel in the reference and has no Hopper kernel: it is reached only by
shapes that ``blocked_flash``'s gate refuses (a head dim such as 192, causal
Sq != Skv). A head dim above 128 that is not a multiple of 128 is refused by
JAX's kernel itself while it traces, and the reference then counts the
fallback and returns None; the port makes the same refusal without a kernel
(``_library_refuses``). Every other shape of that tier makes
``flash_attention`` raise ``NotImplementedError`` naming the shape; the port
never falls back to plain attention on the card there.

Errors propagate: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

from collections import Counter

import torch

from . import autotune
from . import blocked_flash as bf
from . import causal_attention as ca
from . import simple_attention as sa
from . import simple_attention2 as sa2

# Every registered attention op whose outputs the "names" remat policy keeps
# as "attn_out" (models/gpt_hybrid.py).
ATTENTION_OPS = (sa.OP, ca.OP, ca.HYBRID_OP, sa2.OP, bf.OP)

# attn.dispatch{kernel=} and attn.dispatch_fallback{reason=} ticks since the
# last reset_dispatch_counts(), keyed (metric, label value).
DISPATCH_COUNTS: Counter = Counter()


def reset_dispatch_counts():
    DISPATCH_COUNTS.clear()


def _count(metric, value):
    DISPATCH_COUNTS[(metric, value)] += 1


def supported_shape(bshd, skv, dtype) -> bool:
    """Library-flash shape gate ([B,S,H,D] + kv length)."""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    b, s, h, d = bshd
    return s % 128 == 0 and skv % 128 == 0 and d % 64 == 0


def _supported(q, k, v):
    return supported_shape(tuple(q.shape), k.shape[1], q.dtype)


def _gate_reason(q, k):
    """Why the library-flash shape gate rejected ([B,S,H,D] inputs) —
    the label on the attn.dispatch_fallback counter."""
    if q.shape[-1] % 64 != 0:
        return "head_dim"
    if q.shape[1] % 128 != 0 or k.shape[1] % 128 != 0:
        return "seq_len"
    return "dtype"


def flash_attention(q, k, v, causal=False, scale=None):
    """The reference's library tier (``flash_attention.py:53``, JAX's own
    Pallas TPU flash kernel, which this repo did not write): no Hopper
    kernel takes its shapes yet."""
    raise NotImplementedError(
        f"attention tier 'library_flash' (JAX's own flash kernel in the "
        f"reference) for q {tuple(q.shape)}, kv length {k.shape[1]}, "
        f"{q.dtype}, causal={causal}: no Hopper kernel takes this shape "
        "yet; ROADMAP queue 2 lists it")


def _library_refuses(d):
    """What JAX's library kernel refuses while it traces, before it looks
    at the backend (``jax/experimental/pallas/ops/tpu/flash_attention.py``,
    "head_dim ... should be a multiple of 128 if larger"): the reference
    catches that error and returns None."""
    return d > 128 and d % 128 != 0


def flash_attention_maybe(q, k, v, causal=False, scale=None):
    """q/k/v: [B, S, H, D] -> [B, S, H, D] through a Hopper kernel, or None.

    None (the caller then takes plain attention) for CPU tensors, as the
    reference returns None off a TPU, and for CUDA shapes the library gate
    rejects, counted on ``attn.dispatch_fallback{reason=}``. A CUDA shape
    that a ported tier's gate admits launches its kernels and ticks
    ``attn.dispatch{kernel=}`` ("simple", "causal_skip", "qblock",
    "blocked", or the autotuner's winner, which is always a kernel). The
    library tier returns None, counted as the reference counts it, at the
    head dims JAX's kernel refuses, and raises at every other shape."""
    if q.device.type != "cuda":
        return None
    return _dispatch(q, k, v, causal, scale)


def _dispatch(q, k, v, causal, scale):
    """The chain itself, for tensors that are not on the CPU."""
    if not _supported(q, k, v):
        _count("attn.dispatch_fallback", _gate_reason(q, k))
        return None
    # a winner in the autotuner's table (written by autotune.measure)
    # takes precedence over the static chain below
    tuned = autotune.decide(q, k, causal)
    if tuned is not None:
        _count("attn.dispatch", tuned)
        return autotune.run(tuned, q, k, v, causal, scale)
    bhsd = (q.shape[0], q.shape[2], q.shape[1], q.shape[3])
    same_len = q.shape[1] == k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if same_len and sa.supported(bhsd, q.dtype):
        _count("attn.dispatch", "simple")
        return sa.attention_bhsd(qt, kt, vt, causal=causal,
                                 scale=scale).transpose(1, 2)
    if causal and same_len and ca.supported(bhsd, q.dtype):
        _count("attn.dispatch", "causal_skip")
        return ca.attention_bhsd(qt, kt, vt, causal=True,
                                 scale=scale).transpose(1, 2)
    if same_len and sa2.supported(bhsd, q.dtype):
        _count("attn.dispatch", "qblock")
        return sa2.attention_bhsd(qt, kt, vt, causal=causal,
                                  scale=scale).transpose(1, 2)
    if bf.supported(bhsd, k.shape[1], q.dtype, causal):
        _count("attn.dispatch", "blocked")
        return bf.attention_bhsd(qt, kt, vt, causal=causal,
                                 scale=scale).transpose(1, 2)
    if _library_refuses(q.shape[-1]):
        _count("attn.dispatch", "library_flash")
        _count("attn.dispatch_fallback", "error")
        return None
    return flash_attention(q, k, v, causal=causal, scale=scale)
