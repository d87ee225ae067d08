"""Q-blocked monolithic-softmax attention (the middle tier), as Hopper kernels.

Port of ``paddle_tpu/ops/pallas/simple_attention2.py``: the same gate
(``_pick_bq`` and ``supported``, verbatim, so that the port takes this tier
exactly where the reference does), function and residuals (q, k, v). The
forward and backward launch the CUDA kernels for ``sm_90a`` of
``csrc/simple_attention.cu``, whose header says why they are this tier's
too: the two Pallas kernels compute the same function, and this one's TPU
design kept k and v whole in VMEM, which a Hopper block cannot.

The op is registered with ``torch.library.custom_op`` and its gradient with
``register_autograd``, so that the ``"names"`` remat policy of
``models/gpt_hybrid.py`` keeps its output and each layer launches the
forward once.

Devices: for CUDA tensors the op launches the kernels or raises; for CPU
tensors it runs the plain versions below, which follow the reference's
kernels q block by q block and which the tests and ``chip_smoke.py`` also
use as the yardstick of the kernels.
"""
from __future__ import annotations

import math

import torch

from . import _launch as L
from . import simple_attention as sa

NEG_INF = -1e30

# Kernel launches since the last reset_launch_counts(), by kernel.
LAUNCHES = {"qblock_attention_fwd": 0, "qblock_attention_bwd": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------ the gate ------------------------------------
def _itemsize(dtype):
    return 2 if dtype in (torch.bfloat16, torch.float16) else 4


def _pick_bq(s, d, itemsize, budget=11 * 2 ** 20):
    """Largest power-of-two q block whose bwd VMEM footprint fits:
    strips p(f32)+dp(f32) [bq,S] dominate."""
    for bq in (1024, 512, 256, 128):
        if bq > s:
            continue
        need = (2 * bq * s * 4            # p, dp f32 strips
                + 4 * s * d * 4           # k, v, dk, dv f32
                + 3 * bq * d * 4)         # q, do, dq
        if need <= budget and s % bq == 0:
            return bq
    return None


def supported(q_shape, dtype):
    """The reference gate (``simple_attention2.py:108``), verbatim."""
    b, h, s, d = q_shape
    if d % 128 != 0 and d != 64:
        return False
    if s % 128 != 0:
        return False
    return _pick_bq(s, d, _itemsize(dtype)) is not None


def _require_bq(s, d, dtype):
    bq = _pick_bq(s, d, _itemsize(dtype))
    if bq is None:
        raise ValueError(
            f"qblock_attention: no q block for S={s}, D={d}, {dtype} within "
            "the reference's VMEM budget; check supported() before calling")
    return bq


# ------------------------------ plain versions ------------------------------
def _block_scores(qb, k, sm_scale, causal, q0):
    """Scaled scores of one q block [B, H, bq, D] against every key, in f32,
    with the causal mask at -1e30 (rows q0.., top-left alignment)."""
    s = torch.matmul(qb.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        iq = torch.arange(q0, q0 + qb.shape[2], device=s.device)[:, None]
        ik = torch.arange(k.shape[2], device=s.device)[None, :]
        s = s.masked_fill(iq < ik, NEG_INF)
    return s


def qblock_attention_reference(q, k, v, sm_scale, causal=True):
    """Plain forward of ``_fwd_kernel``, q block by q block of
    ``_pick_bq``'s size: q/k/v [B, H, S, D] -> [B, H, S, D]. Scores and
    softmax in f32, p normalized and then rounded to v's dtype before PV."""
    b, h, s, d = q.shape
    bq = _require_bq(s, d, q.dtype)
    vf = v.float()
    out = []
    for q0 in range(0, s, bq):
        sb = _block_scores(q[:, :, q0:q0 + bq], k, sm_scale, causal, q0)
        m = sb.amax(-1, keepdim=True)
        p = torch.exp(sb - m)
        p = (p / p.sum(-1, keepdim=True)).to(v.dtype)
        out.append(torch.matmul(p.float(), vf).to(q.dtype))
    return torch.cat(out, dim=2)


def qblock_attention_bwd_reference(q, k, v, do, sm_scale, causal=True):
    """Plain backward, step by step as ``_bwd_kernel`` over the q blocks: P
    recomputed in f32, delta = rowsum(dP * P), dq cast per block, dk and dv
    summed in f32 across the blocks and cast at the end (``_bwd``). Returns
    (dq, dk, dv) in the inputs' dtype."""
    b, h, s, d = q.shape
    bq = _require_bq(s, d, q.dtype)
    kf, vf = k.float(), v.float()
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    dq = []
    for q0 in range(0, s, bq):
        qb = q[:, :, q0:q0 + bq].float()
        dob = do[:, :, q0:q0 + bq].float()
        sb = _block_scores(qb, kf, sm_scale, causal, q0)
        e = torch.exp(sb - sb.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
        dv += torch.matmul(p.transpose(-1, -2), dob)
        dp = torch.matmul(dob, vf.transpose(-1, -2))
        delta = (dp * p).sum(-1, keepdim=True)
        ds = p * (dp - delta) * sm_scale
        dq.append(torch.matmul(ds, kf).to(q.dtype))
        dk += torch.matmul(ds.transpose(-1, -2), qb)
    return torch.cat(dq, dim=2), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------- kernels ----------------------------------
# simple_attention.cu's kernels (its header says why they are this tier's
# too), under this module's own launch counters.
def qblock_attention_fwd_cuda(q, k, v, sm_scale, causal):
    """Launches the forward kernel: q/k/v [B, H, S, D] CUDA views sharing
    one layout -> o [B, H, S, D] (a view of a [B, S, H, D] buffer)."""
    o = sa.launch_fwd("qblock_attention", q, k, v, sm_scale, causal)
    LAUNCHES["qblock_attention_fwd"] += 1
    return o


def qblock_attention_bwd_cuda(q, k, v, do, sm_scale, causal):
    """Launches the backward pair (dq + row statistics, then dk/dv).
    Returns (dq, dk, dv), each a [B, H, S, D] view of a [B, S, H, D]
    buffer."""
    grads = sa.launch_bwd("qblock_attention", q, k, v, do, sm_scale,
                          causal)
    LAUNCHES["qblock_attention_bwd"] += 1
    return grads


# ------------------------------ the registered op ---------------------------
def _device_error(q):
    return ValueError(f"qblock_attention: no kernel for {q.device}")


@torch.library.custom_op(
    "paddle_tpu_torch::qblock_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float sm_scale, bool causal) "
           "-> Tensor")
def _attention_op(q, k, v, sm_scale, causal):
    _require_bq(q.shape[2], q.shape[3], q.dtype)
    if q.device.type == "cuda":
        return qblock_attention_fwd_cuda(q, k, v, sm_scale, causal)
    if q.device.type == "cpu":
        return qblock_attention_reference(q, k, v, sm_scale, causal)
    raise _device_error(q)


@torch.library.custom_op(
    "paddle_tpu_torch::qblock_attention_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor do, float sm_scale, "
           "bool causal) -> (Tensor, Tensor, Tensor)")
def _attention_bwd_op(q, k, v, do, sm_scale, causal):
    if q.device.type == "cuda":
        return qblock_attention_bwd_cuda(q, k, v, do, sm_scale, causal)
    if q.device.type == "cpu":
        return qblock_attention_bwd_reference(q, k, v, do, sm_scale, causal)
    raise _device_error(q)


def _setup_context(ctx, inputs, output):
    q, k, v, sm_scale, causal = inputs
    ctx.save_for_backward(q, k, v)       # residuals: (q, k, v) only
    ctx.sm_scale = sm_scale
    ctx.causal = causal


def _backward(ctx, do):
    q, k, v = ctx.saved_tensors
    if not L.aligned(do):      # e.g. the expanded gradient of a sum()
        do = do.contiguous()
    dq, dk, dv = _attention_bwd_op(q, k, v, do, ctx.sm_scale, ctx.causal)
    return dq, dk, dv, None, None


_attention_op.register_autograd(_backward, setup_context=_setup_context)


# Shapes and layouts only (meta tensors, tracing): what the kernels return.
@_attention_op.register_fake
def _attention_fake(q, k, v, sm_scale, causal):
    _require_bq(q.shape[2], q.shape[3], q.dtype)
    return L.empty_bshd(*q.shape, q)


@_attention_bwd_op.register_fake
def _attention_bwd_fake(q, k, v, do, sm_scale, causal):
    return tuple(L.empty_bshd(*q.shape, q) for _ in range(3))


# What a selective-checkpoint policy sees when the op runs.
OP = torch.ops.paddle_tpu_torch.qblock_attention.default


def qblock_attention(q, k, v, sm_scale, causal=True):
    """q/k/v: [B, H, S, D] -> [B, H, S, D]; S streamed in q blocks.
    Differentiable."""
    return _attention_op(q, k, v, float(sm_scale), bool(causal))


def attention_bhsd(q, k, v, causal=True, scale=None):
    """Convenience: [B,H,S,D] layout with defaulted scale."""
    d = q.shape[-1]
    sm = scale if scale is not None else 1.0 / math.sqrt(d)
    return qblock_attention(q, k, v, sm, causal)
