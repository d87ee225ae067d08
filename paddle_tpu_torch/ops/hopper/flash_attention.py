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
(S >= 4096), and last the library flash tier. That last tier wraps JAX's own
Pallas TPU flash kernel in the reference (``flash_attention``); it is
reached by shapes that ``blocked_flash``'s gate refuses (causal Sq != Skv, a
head dim such as 192) and by ``nn.functional.scaled_dot_product_attention``
directly. In the port it is the custom op ``paddle_tpu_torch::library_flash``
over ``blocked_flash.cu``'s kernels, through entry points that admit causal
Sq != Skv, masked top-left (col <= row) as JAX's kernel masks it; forward
(o, lse), backward the lse pair (dq, then dk/dv). JAX's kernel refuses some
shapes while it traces: sequence lengths that its blocks (``min(512, S)``,
as the reference picks them) do not divide, and, where Skv takes more than
one block, a head dim above 128 that is not a multiple of 128. The
reference then counts the fallback and
returns None; the port makes the same refusal without a kernel
(``_library_refuses``), before the forward (see ROADMAP queue 3: the
reference meets the backward's rule only in the backward). The port never
falls back to plain attention on the card otherwise.

Errors propagate: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import math
import threading

import torch

from ...observability import metrics as _met
from . import _launch as L
from . import autotune
from . import blocked_flash as bf
from . import causal_attention as ca
from . import lse_backward
from . import simple_attention as sa
from . import simple_attention2 as sa2

# The dispatch counters on observability's REGISTRY, as the reference ticks
# them, each with its label key: attn.dispatch{kernel=},
# attn.dispatch_fallback{reason=}, and nn.sdpa{route=} (ticked by
# nn.functional.scaled_dot_product_attention).
DISPATCH_LABELS = {"attn.dispatch": "kernel",
                   "attn.dispatch_fallback": "reason", "nn.sdpa": "route"}


def _count(metric, value):
    if _met._ENABLED:
        _met.REGISTRY.counter(metric, **{DISPATCH_LABELS[metric]: value}).inc()


def dispatch_counts(since=None):
    """{(metric, label value): count} of the dispatch counters on the
    registry; with ``since`` (an earlier return of this function), the ticks
    after it, the series that did not move left out."""
    now = {}
    for d in _met.REGISTRY.snapshot():
        key = DISPATCH_LABELS.get(d["name"])
        if key is not None and key in d["labels"]:
            now[(d["name"], d["labels"][key])] = int(d["value"])
    if since is None:
        return now
    moved = {k: n - since.get(k, 0) for k, n in now.items()}
    return {k: n for k, n in moved.items() if n}


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


# ------------------------------------------------------- the library tier
# Kernel launches of the library tier since the last reset_launch_counts();
# a lock makes each count exact when threads launch (a fleet executor's
# interceptors run a model's stages on threads of one process)
LAUNCHES = {"library_flash_fwd": 0, "library_flash_bwd_dq": 0,
            "library_flash_bwd_dkv": 0}
_LAUNCHES_LOCK = threading.Lock()


def _count_launch(name):
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library_blocks(sq, skv):
    """The block sizes the reference hands JAX's kernel
    (``flash_attention.py:68-69``): every q block min(512, Sq), every kv
    block min(512, Skv)."""
    return min(512, sq), min(512, skv)


def _library_refuses(sq, skv, d):
    """What JAX's library kernel refuses while it traces, before it looks
    at the backend (``jax/experimental/pallas/ops/tpu/flash_attention.py``):
    a kv block that does not divide Skv (the forward's ``_verify_block``), a
    q block that does not divide Sq (the backward's), and, where the kv
    sequence takes more than one block (Skv > 512: the tiled forward; the
    single-block one has no such rule), a head dim above 128 that is not a
    multiple of 128 ("should be a multiple of 128 if larger"). The reference
    catches the error and returns None."""
    bq, bk = _library_blocks(sq, skv)
    return (skv % bk != 0 or sq % bq != 0
            or (bk < skv and d > 128 and d % 128 != 0))


def library_flash_reference(q, k, v, sm_scale, causal):
    """Plain forward of the library tier: q [B, H, Sq, D], k/v
    [B, H, Skv, D] -> (o in q's dtype, lse [B, H, Sq] f32). f32 scores,
    causal masked top-left (col <= row) for any Sq and Skv, as JAX's kernel
    and its ``mha_reference``; f32 softmax and P V, cast at the end."""
    s = lse_backward.scores(q, k, sm_scale, causal)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def library_flash_fwd_cuda(q, k, v, sm_scale, causal):
    """Launches ``blocked_flash.cu``'s online forward through ``lf_fwd``
    (any Sq, Skv when causal): (o, lse)."""
    out = bf.fwd_launch("lf", q, k, v, sm_scale, causal)
    _count_launch("library_flash_fwd")
    return out


def library_flash_bwd_dq_cuda(q, k, v, o, lse, do, sm_scale, causal):
    """Launches the lse backward's dq kernel through ``lf_bwd_dq``: (dq,
    delta)."""
    out = bf.dq_launch("lf", q, k, v, o, lse, do, sm_scale, causal)
    _count_launch("library_flash_bwd_dq")
    return out


def library_flash_bwd_dkv_cuda(q, k, v, lse, delta, do, sm_scale, causal):
    """Launches the lse backward's dk/dv kernel through ``lf_bwd_dkv``:
    (dk, dv); a kv tile past the last q row (causal, Sq < Skv) gets
    zeros."""
    out = bf.dkv_launch("lf", q, k, v, lse, delta, do, sm_scale, causal)
    _count_launch("library_flash_bwd_dkv")
    return out


def _device_error(q):
    return ValueError(f"library_flash: no kernel for {q.device}")


@torch.library.custom_op(
    "paddle_tpu_torch::library_flash", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float sm_scale, bool causal) "
           "-> (Tensor, Tensor)")
def _library_op(q, k, v, sm_scale, causal):
    if q.device.type == "cuda":
        return library_flash_fwd_cuda(q, k, v, sm_scale, causal)
    if q.device.type == "cpu":
        return library_flash_reference(q, k, v, sm_scale, causal)
    raise _device_error(q)


@torch.library.custom_op(
    "paddle_tpu_torch::library_flash_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do, "
           "float sm_scale, bool causal) -> (Tensor, Tensor, Tensor)")
def _library_bwd_op(q, k, v, o, lse, do, sm_scale, causal):
    if q.device.type == "cuda":
        if not L.aligned(do):     # e.g. the expanded gradient of a sum()
            do = do.contiguous()
        dq, delta = library_flash_bwd_dq_cuda(q, k, v, o, lse, do, sm_scale,
                                              causal)
        return (dq, *library_flash_bwd_dkv_cuda(q, k, v, lse, delta, do,
                                                sm_scale, causal))
    if q.device.type == "cpu":
        return lse_backward.bwd_reference(q, k, v, o, lse, do, sm_scale,
                                          causal)
    raise _device_error(q)


def _setup_context(ctx, inputs, output):
    q, k, v, sm_scale, causal = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.mark_non_differentiable(lse)
    ctx.sm_scale = sm_scale
    ctx.causal = causal


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    # the op aligns do on the card: here do may be a traced (fake) tensor,
    # which has no data pointer
    dq, dk, dv = _library_bwd_op(q, k, v, o, lse, do, ctx.sm_scale,
                                 ctx.causal)
    return dq, dk, dv, None, None


_library_op.register_autograd(_backward, setup_context=_setup_context)


@_library_op.register_fake
def _library_fake(q, k, v, sm_scale, causal):
    b, h, sq, d = q.shape
    return L.empty_bshd(b, h, sq, d, q), L.empty_lse(b, h, sq, q)


@_library_bwd_op.register_fake
def _library_bwd_fake(q, k, v, o, lse, do, sm_scale, causal):
    return (L.empty_bshd(*q.shape, q),
            *(L.empty_bshd(*k.shape, k) for _ in range(2)))


OP = torch.ops.paddle_tpu_torch.library_flash.default

# Every registered attention op whose outputs the "names" remat policy keeps
# as "attn_out" (models/gpt_hybrid.py).
ATTENTION_OPS = (sa.OP, ca.OP, ca.HYBRID_OP, sa2.OP, bf.OP, OP)


def flash_attention(q, k, v, causal=False, scale=None):
    """The reference's library tier (``flash_attention.py:53``, JAX's own
    Pallas TPU flash kernel): q/k/v [B, S, H, D] -> [B, S, H, D],
    differentiable, through ``paddle_tpu_torch::library_flash`` (the
    kernels on a CUDA tensor, the plain version on a CPU one). Raises
    ``NotImplementedError`` where JAX's kernel refuses the shape
    (``_library_refuses``), as the reference's call raises."""
    sq, skv, d = q.shape[1], k.shape[1], q.shape[-1]
    if _library_refuses(sq, skv, d):
        bq, bk = _library_blocks(sq, skv)
        raise NotImplementedError(
            f"library_flash: JAX's library kernel refuses q "
            f"{tuple(q.shape)} against kv length {skv} (blocks {bq} x {bk} "
            f"must divide Sq and Skv; a head dim above 128 must be a "
            f"multiple of 128)")
    sm = scale if scale is not None else 1.0 / math.sqrt(d)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return _library_op(qt, kt, vt, float(sm), bool(causal))[0].transpose(1, 2)


def flash_attention_maybe(q, k, v, causal=False, scale=None):
    """q/k/v: [B, S, H, D] -> [B, S, H, D] through a Hopper kernel, or None.

    None (the caller then takes plain attention) for CPU tensors, as the
    reference returns None off a TPU, and for CUDA shapes the library gate
    rejects, counted on ``attn.dispatch_fallback{reason=}``. A CUDA shape
    that a tier's gate admits launches its kernels and ticks
    ``attn.dispatch{kernel=}`` ("simple", "causal_skip", "qblock",
    "blocked", "library_flash", or the autotuner's winner, which is always
    a kernel). The library tier returns None, counted as the reference
    counts it, at the shapes JAX's kernel refuses."""
    if q.device.type != "cuda":
        return None
    return _dispatch(q, k, v, causal, scale)


def static_tier(bhsd, skv, dtype, causal):
    """The tier the static chain picks for q [B, H, Sq, D] against kv length
    ``skv``, the tiers' gates in the reference's order: "simple",
    "causal_skip", "qblock", "blocked", else "library_flash"."""
    same_len = bhsd[2] == skv
    if same_len and sa.supported(bhsd, dtype):
        return "simple"
    if causal and same_len and ca.supported(bhsd, dtype):
        return "causal_skip"
    if same_len and sa2.supported(bhsd, dtype):
        return "qblock"
    if bf.supported(bhsd, skv, dtype, causal):
        return "blocked"
    return "library_flash"


_TIER_OPS = {"simple": sa, "causal_skip": ca, "qblock": sa2, "blocked": bf}


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
    tier = static_tier(bhsd, k.shape[1], q.dtype, causal)
    _count("attn.dispatch", tier)
    if tier != "library_flash":
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        return _TIER_OPS[tier].attention_bhsd(
            qt, kt, vt, causal=causal, scale=scale).transpose(1, 2)
    if _library_refuses(q.shape[1], k.shape[1], q.shape[-1]):
        _count("attn.dispatch_fallback", "error")
        return None
    return flash_attention(q, k, v, causal=causal, scale=scale)
