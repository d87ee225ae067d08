"""Causal-skip attention for the S=2048 rung, as Hopper kernels.

Port of ``paddle_tpu/ops/pallas/causal_attention.py``: the same gate (the
reference's ``_pick_nq`` with its 11 MiB budget, verbatim, so that the port
takes this tier exactly where the reference does), function, residuals
(q, k, v, o, lse) and hybrid. The forward and backward are CUDA kernels for
``sm_90a`` (``csrc/causal_attention.cu``, whose header says how the tiling
stands in for the reference's static strips).

The forward op returns (o, lse). ``register_autograd`` saves both, so that
the ``"names"`` remat policy of ``models/gpt_hybrid.py``, which keeps this
op's outputs, runs the kernel once a layer; the reference recomputes its
residuals under that policy and so runs its forward twice (see PERF.md).

Devices: for CUDA tensors the ops launch the kernels or raise; for CPU
tensors they run the plain versions below, which the tests and
``chip_smoke.py`` also use as the yardstick of the kernels.
"""
from __future__ import annotations

import math

import torch

from . import _launch as L
from . import lse_backward
from . import simple_attention as sa

NEG_INF = -1e30

# Kernel launches since the last reset_launch_counts(), by kernel.
LAUNCHES = {"causal_attention_fwd": 0, "causal_attention_bwd": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------ the gate ------------------------------------
_NQ = 2   # preferred (fewest, biggest strips); _pick_nq may raise it


def _itemsize(dtype):
    return 2 if dtype in (torch.bfloat16, torch.float16) else 4


def _vmem_need(s, d, nq, itemsize):
    """bwd residency: q/k/v/o/do native + dk/dv f32 + p/dp strips f32."""
    bq = s // nq
    return (5 * s * d * itemsize + 2 * s * d * 4
            + 2 * bq * s * 4 + 8 * s * 4)


def _pick_nq(s, d, itemsize, vmem_budget=11 * 2 ** 20):
    """The reference's strip count: the smallest nq whose backward working
    set fits its VMEM budget (nq=8 at S=2048, D=128, bf16)."""
    for nq in (_NQ, 4, 8, 16):
        if s % (nq * 128) == 0 and _vmem_need(s, d, nq, itemsize) \
                <= vmem_budget:
            return nq
    return None


def supported(q_shape, dtype, vmem_budget=11 * 2 ** 20):
    """The reference gate (``causal_attention.py:133``), verbatim."""
    b, h, s, d = q_shape
    if d % 128 != 0 and d != 64:
        return False
    return _pick_nq(s, d, _itemsize(dtype), vmem_budget) is not None


def _require_nq(s, d, dtype):
    nq = _pick_nq(s, d, _itemsize(dtype))
    if nq is None:
        raise ValueError(
            f"causal_attention: shape (S={s}, D={d}, {dtype}) exceeds "
            "the VMEM budget — check supported() before calling")
    return nq


# ------------------------------ plain versions ------------------------------
def causal_attention_reference(q, k, v, sm_scale):
    """Plain forward of ``_fwd_kernel``: q/k/v [B, H, S, D] -> (o, lse).
    Exact softmax in f32, p / l rounded to v's dtype before PV, and
    lse = m + log l in f32 [B, H, S]. The reference's strips leave out only
    columns that the mask zeroes (exp(-1e30 - m) is 0), so the whole
    masked row gives the same values."""
    s = lse_backward.scores(q, k, sm_scale, causal=True)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul((p / l).to(v.dtype).float(), v.float()).to(q.dtype)
    return o, (m + torch.log(l))[..., 0]


def causal_attention_bwd_reference(q, k, v, o, lse, do, sm_scale):
    """Plain backward of ``_bwd_kernel``: p = exp(s - lse) in f32,
    delta = rowsum(dO * O), dk and dv summed in f32 and cast at the end.
    Returns (dq, dk, dv)."""
    return lse_backward.bwd_reference(q, k, v, o, lse, do, sm_scale, True)


# --------------------------------- kernels ----------------------------------
_SIGNATURES = {
    "ca_fwd": [L.INT, L.INT] + [L.VP] * 5
              + [L.STRIDES, L.INT, L.INT, L.INT, L.FLOAT, L.VP],
    "ca_bwd": [L.INT, L.INT] + [L.VP] * 10
              + [L.STRIDES, L.INT, L.INT, L.INT, L.FLOAT, L.VP],
}


def _lib():
    return L.library("causal_attention", "ca", _SIGNATURES)


def causal_attention_fwd_cuda(q, k, v, sm_scale):
    """Launches the forward kernel: q/k/v [B, H, S, D] CUDA views sharing
    one layout -> (o [B, H, S, D] view of a [B, S, H, D] buffer,
    lse [B, H, S] f32)."""
    shape = tuple(q.shape)
    L.check("causal_attention", "forward",
            [(t, shape, q.dtype) for t in (q, k, v)])
    L.same_layout("causal_attention", "forward", (q, k, v))
    b, h, s, d = shape
    o, lse = L.empty_bshd(b, h, s, d, q), L.empty_lse(b, h, s, q)
    L.launch(_lib(), "ca", "causal_attention", "forward", q.device, "ca_fwd",
             L.DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), o.data_ptr(), lse.data_ptr(), L.layouts(q, o),
             b, h, s, float(sm_scale))
    LAUNCHES["causal_attention_fwd"] += 1
    return o, lse


def causal_attention_bwd_cuda(q, k, v, o, lse, do, sm_scale):
    """Launches the backward pair (dq, which also writes delta =
    rowsum(dO * O) into f32 scratch, then dk/dv) from the saved o and lse.
    Returns (dq, dk, dv), each a [B, H, S, D] view of a [B, S, H, D]
    buffer."""
    shape = tuple(q.shape)
    b, h, s, d = shape
    L.check("causal_attention", "backward",
            [(t, shape, q.dtype) for t in (q, k, v, o, do)]
            + [(lse, (b, h, s), torch.float32)])
    L.same_layout("causal_attention", "backward", (k, v))
    dq, dk, dv = (L.empty_bshd(b, h, s, d, q) for _ in range(3))
    delta = L.empty_lse(b, h, s, q)
    L.launch(_lib(), "ca", "causal_attention", "backward", q.device, "ca_bwd",
             L.DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
             L.layouts(q, k, o, do, dq, dk), b, h, s, float(sm_scale))
    LAUNCHES["causal_attention_bwd"] += 1
    return dq, dk, dv


# ------------------------------ the registered ops --------------------------
def _device_error(q):
    return ValueError(f"causal_attention: no kernel for {q.device}")


@torch.library.custom_op(
    "paddle_tpu_torch::causal_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float sm_scale) "
           "-> (Tensor, Tensor)")
def _attention_op(q, k, v, sm_scale):
    _require_nq(q.shape[2], q.shape[3], q.dtype)
    if q.device.type == "cuda":
        return causal_attention_fwd_cuda(q, k, v, sm_scale)
    if q.device.type == "cpu":
        return causal_attention_reference(q, k, v, sm_scale)
    raise _device_error(q)


@torch.library.custom_op(
    "paddle_tpu_torch::causal_attention_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do, "
           "float sm_scale) -> (Tensor, Tensor, Tensor)")
def _attention_bwd_op(q, k, v, o, lse, do, sm_scale):
    if q.device.type == "cuda":
        return causal_attention_bwd_cuda(q, k, v, o, lse, do, sm_scale)
    if q.device.type == "cpu":
        return causal_attention_bwd_reference(q, k, v, o, lse, do, sm_scale)
    raise _device_error(q)


def _setup_context(ctx, inputs, output):
    q, k, v, sm_scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)   # the reference's residuals
    ctx.mark_non_differentiable(lse)
    ctx.sm_scale = sm_scale


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    if not L.aligned(do):     # e.g. the expanded gradient of a sum()
        do = do.contiguous()
    dq, dk, dv = _attention_bwd_op(q, k, v, o, lse, do, ctx.sm_scale)
    return dq, dk, dv, None


_attention_op.register_autograd(_backward, setup_context=_setup_context)


# Shapes and layouts only (meta tensors, tracing): what the kernels return.
@_attention_op.register_fake
def _attention_fake(q, k, v, sm_scale):
    _require_nq(q.shape[2], q.shape[3], q.dtype)
    b, h, s, d = q.shape
    return L.empty_bshd(b, h, s, d, q), L.empty_lse(b, h, s, q)


@_attention_bwd_op.register_fake
def _attention_bwd_fake(q, k, v, o, lse, do, sm_scale):
    return tuple(L.empty_bshd(*q.shape, q) for _ in range(3))


# What a selective-checkpoint policy sees when the op runs.
OP = torch.ops.paddle_tpu_torch.causal_attention.default


def causal_attention(q, k, v, sm_scale):
    """q/k/v: [B, H, S, D] -> [B, H, S, D]; causal only. Differentiable."""
    return _attention_op(q, k, v, float(sm_scale))[0]


def attention_bhsd(q, k, v, causal=True, scale=None):
    """Convenience: [B,H,S,D] layout with defaulted scale."""
    assert causal, "causal_attention is causal-only"
    d = q.shape[-1]
    sm = scale if scale is not None else 1.0 / math.sqrt(d)
    return causal_attention(q, k, v, sm)


# ------------------------------------------------------------------------
# Hybrid: the strip forward with simple_attention's backward and residuals
# (q, k, v) only (the reference's causal_fwd_attention, :217). On no path:
# ported to complete the module.
# ------------------------------------------------------------------------
@torch.library.custom_op(
    "paddle_tpu_torch::causal_fwd_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float sm_scale) -> Tensor")
def _hybrid_op(q, k, v, sm_scale):
    _require_nq(q.shape[2], q.shape[3], q.dtype)
    if q.device.type == "cuda":
        return causal_attention_fwd_cuda(q, k, v, sm_scale)[0]
    if q.device.type == "cpu":
        return causal_attention_reference(q, k, v, sm_scale)[0]
    raise _device_error(q)


def _hybrid_setup_context(ctx, inputs, output):
    q, k, v, sm_scale = inputs
    ctx.save_for_backward(q, k, v)
    ctx.sm_scale = sm_scale


def _hybrid_backward(ctx, do):
    q, k, v = ctx.saved_tensors
    if not L.aligned(do):
        do = do.contiguous()
    dq, dk, dv = sa._attention_bwd_op(q, k, v, do, ctx.sm_scale, True)
    return dq, dk, dv, None


_hybrid_op.register_autograd(_hybrid_backward,
                             setup_context=_hybrid_setup_context)


@_hybrid_op.register_fake
def _hybrid_fake(q, k, v, sm_scale):
    _require_nq(q.shape[2], q.shape[3], q.dtype)
    return L.empty_bshd(*q.shape, q)


HYBRID_OP = torch.ops.paddle_tpu_torch.causal_fwd_attention.default


def causal_fwd_attention(q, k, v, sm_scale):
    """q/k/v: [B, H, S, D] -> [B, H, S, D]; causal only. Differentiable."""
    return _hybrid_op(q, k, v, float(sm_scale))


def hybrid_supported(q_shape, dtype):
    """The strip forward fits AND simple_attention's backward fits (the
    reference's ``hybrid_supported``, :223)."""
    return supported(q_shape, dtype) and sa.supported(q_shape, dtype)


def attention_bhsd_hybrid(q, k, v, causal=True, scale=None):
    assert causal, "causal_fwd_attention is causal-only"
    if not hybrid_supported(q.shape, q.dtype):
        raise ValueError(
            f"hybrid attention unsupported for shape {tuple(q.shape)} "
            f"{q.dtype}: the monolithic backward must also fit VMEM "
            "(check hybrid_supported() before calling)")
    d = q.shape[-1]
    sm = scale if scale is not None else 1.0 / math.sqrt(d)
    return causal_fwd_attention(q, k, v, sm)
