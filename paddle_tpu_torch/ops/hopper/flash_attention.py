"""Attention dispatch: which Hopper kernel takes a [B, S, H, D] attention.

Port of ``paddle_tpu/ops/pallas/flash_attention.py`` (``supported_shape``,
``_gate_reason``, ``flash_attention_maybe``). The port walks the reference's
static chain with the tiers' own gates, so that it picks the tier the
reference picks: the monolithic ``simple_attention`` where the whole (b, h)
slice fits the reference's VMEM budget (S <= 1024 at D=128), then
``causal_attention`` (the causal S=2048 rung), ``qblock_attention`` (the
non-causal middle tier), ``blocked_flash`` (S >= 4096), and last the
library flash kernel. ``qblock_attention`` is not ported yet, and the last
tier, which wraps JAX's own kernel in the reference, has no Hopper kernel:
it is reached only by shapes that ``blocked_flash``'s gate refuses (a head
dim such as 192, causal Sq != Skv). A shape sent to either raises
``NotImplementedError`` naming it, and never falls back to plain attention
on the card. The reference's runtime autotuner (``ops/pallas/autotune.py``),
which can override the chain on a TPU, is not ported yet either (ROADMAP
queue 2); the port takes the static chain, as the reference does on a
cold trace.

Errors propagate: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

from collections import Counter

import torch

from . import blocked_flash as bf
from . import causal_attention as ca
from . import simple_attention as sa

# Every registered attention op whose outputs the "names" remat policy keeps
# as "attn_out" (models/gpt_hybrid.py).
ATTENTION_OPS = (sa.OP, ca.OP, ca.HYBRID_OP, bf.OP)

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


# ---- the gate of the reference's tier that has no Hopper kernel yet --------
def _qblock_gate(bhsd, dtype, budget=11 * 2 ** 20):
    """simple_attention2.supported (simple_attention2.py:108, _pick_bq :94)."""
    b, h, s, d = bhsd
    if (d % 128 != 0 and d != 64) or s % 128 != 0:
        return False
    for bq in (1024, 512, 256, 128):
        need = 2 * bq * s * 4 + 4 * s * d * 4 + 3 * bq * d * 4
        if bq <= s and need <= budget and s % bq == 0:
            return True
    return False


def _unported(kernel, reference):
    raise NotImplementedError(
        f"attention tier {kernel!r} ({reference}) has no Hopper kernel yet: "
        "ROADMAP queue 2 lists it")


def flash_attention_maybe(q, k, v, causal=False, scale=None):
    """q/k/v: [B, S, H, D] -> [B, S, H, D] through a Hopper kernel, or None.

    None (the caller then takes plain attention) for CPU tensors, as the
    reference returns None off a TPU, and for CUDA shapes the library gate
    rejects, counted on ``attn.dispatch_fallback{reason=}``. A CUDA shape
    that a ported tier's gate admits launches its kernels and ticks
    ``attn.dispatch{kernel=}`` ("simple", "causal_skip", "blocked"); the
    unported tiers raise."""
    if q.device.type != "cuda":
        return None
    return _dispatch(q, k, v, causal, scale)


def _dispatch(q, k, v, causal, scale):
    """The chain itself, for tensors that are not on the CPU."""
    if not _supported(q, k, v):
        _count("attn.dispatch_fallback", _gate_reason(q, k))
        return None
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
    if same_len and _qblock_gate(bhsd, q.dtype):
        _unported("qblock", "ops/pallas/simple_attention2.py")
    if bf.supported(bhsd, k.shape[1], q.dtype, causal):
        _count("attn.dispatch", "blocked")
        return bf.attention_bhsd(qt, kt, vt, causal=causal,
                                 scale=scale).transpose(1, 2)
    raise NotImplementedError(
        f"attention tier 'library_flash' (JAX's own flash kernel in the "
        f"reference) for q {tuple(q.shape)}, kv length {k.shape[1]}, "
        f"{q.dtype}, causal={causal}: no Hopper kernel takes this shape "
        "yet; ROADMAP queue 2 lists it")
