"""Monolithic-softmax attention for short sequences, as Hopper kernels.

Port of ``paddle_tpu/ops/pallas/simple_attention.py``: the same function,
gate and residuals, with the forward and backward as hand-written CUDA
kernels for ``sm_90a`` (``csrc/simple_attention.cu``, whose header says how
they tile what the TPU kernel held whole).

The op is registered with ``torch.library.custom_op`` and its gradient with
``register_autograd``, so that a selective-checkpoint policy can name it and
keep its output (the ``"names"`` remat policy of ``models/gpt_hybrid.py``).

Devices: for CUDA tensors the op launches the kernels or raises; for CPU
tensors it runs the plain versions below, which the tests and
``chip_smoke.py`` also use as the yardstick of the kernels.
"""
from __future__ import annotations

import math

import torch

from . import _launch as L

NEG_INF = -1e30

# Kernel launches since the last reset_launch_counts(), by kernel.
LAUNCHES = {"simple_attention_fwd": 0, "simple_attention_bwd": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------ plain versions ------------------------------
def _causal_mask(s, device):
    return torch.ones(s, s, dtype=torch.bool, device=device).tril()


def simple_attention_reference(q, k, v, sm_scale, causal=True):
    """Plain forward of ``_fwd_kernel``: q/k/v [B, H, S, D] -> [B, H, S, D].
    Scores and softmax in f32, p cast to v's dtype before PV."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        s = s.masked_fill(~_causal_mask(s.shape[-1], s.device), NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def simple_attention_bwd_reference(q, k, v, do, sm_scale, causal=True):
    """Plain backward, step by step as ``_bwd_kernel``: P recomputed in f32,
    delta = rowsum(dP * P). Returns (dq, dk, dv) in q's dtype."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    if causal:
        s = s.masked_fill(~_causal_mask(s.shape[-1], s.device), NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - delta) * sm_scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# --------------------------------- kernels ----------------------------------
_SIGNATURES = {
    "sa_fwd": [L.INT, L.INT] + [L.VP] * 4 + [L.LL] * 6
              + [L.INT, L.INT, L.INT, L.FLOAT, L.INT, L.VP],
    "sa_bwd": [L.INT, L.INT] + [L.VP] * 9 + [L.LL] * 9
              + [L.INT, L.INT, L.INT, L.FLOAT, L.INT, L.VP],
}


def _lib():
    return L.library("simple_attention", "sa", _SIGNATURES)


def _check(kernel, what, tensors, shape, dtype):
    """q, k and v (the first three) must share one layout."""
    L.check(kernel, what, [(t, shape, dtype) for t in tensors])
    L.same_layout(kernel, what, tensors[:3])


def launch_fwd(kernel, q, k, v, sm_scale, causal):
    """One launch of the forward kernel, named ``kernel`` in errors (it also
    serves ``simple_attention2``): q/k/v [B, H, S, D] CUDA views sharing
    one layout -> o [B, H, S, D] (a view of a [B, S, H, D] buffer)."""
    shape = tuple(q.shape)
    _check(kernel, "forward", (q, k, v), shape, q.dtype)
    b, h, s, d = shape
    o = L.empty_bshd(b, h, s, d, q)
    L.launch(_lib(), "sa", kernel, "forward", q.device, "sa_fwd",
             L.DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), o.data_ptr(), *L.strides(q), *L.strides(o),
             b, h, s, float(sm_scale), int(causal))
    return o


def launch_bwd(kernel, q, k, v, do, sm_scale, causal):
    """One backward pair (dq + row statistics, then dk/dv), named
    ``kernel`` in errors. Returns (dq, dk, dv), each a [B, H, S, D] view of
    a [B, S, H, D] buffer."""
    shape = tuple(q.shape)
    _check(kernel, "backward", (q, k, v, do), shape, q.dtype)
    b, h, s, d = shape
    dq, dk, dv = (L.empty_bshd(b, h, s, d, q) for _ in range(3))
    lse, delta = (L.empty_lse(b, h, s, q) for _ in range(2))
    L.launch(_lib(), "sa", kernel, "backward", q.device, "sa_bwd",
             L.DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             *L.strides(q), *L.strides(do),
             *L.strides(dq), b, h, s, float(sm_scale), int(causal))
    return dq, dk, dv


def simple_attention_fwd_cuda(q, k, v, sm_scale, causal):
    """Launches the forward kernel (``launch_fwd``)."""
    o = launch_fwd("simple_attention", q, k, v, sm_scale, causal)
    LAUNCHES["simple_attention_fwd"] += 1
    return o


def simple_attention_bwd_cuda(q, k, v, do, sm_scale, causal):
    """Launches the backward pair (``launch_bwd``): (dq, dk, dv)."""
    grads = launch_bwd("simple_attention", q, k, v, do, sm_scale, causal)
    LAUNCHES["simple_attention_bwd"] += 1
    return grads


# ------------------------------ the registered op ---------------------------
@torch.library.custom_op(
    "paddle_tpu_torch::simple_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float sm_scale, bool causal) "
           "-> Tensor")
def _attention_op(q, k, v, sm_scale, causal):
    if q.device.type == "cuda":
        return simple_attention_fwd_cuda(q, k, v, sm_scale, causal)
    if q.device.type == "cpu":
        return simple_attention_reference(q, k, v, sm_scale, causal)
    raise ValueError(f"simple_attention: no kernel for {q.device}")


@torch.library.custom_op(
    "paddle_tpu_torch::simple_attention_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor do, float sm_scale, "
           "bool causal) -> (Tensor, Tensor, Tensor)")
def _attention_bwd_op(q, k, v, do, sm_scale, causal):
    if q.device.type == "cuda":
        return simple_attention_bwd_cuda(q, k, v, do, sm_scale, causal)
    if q.device.type == "cpu":
        return simple_attention_bwd_reference(q, k, v, do, sm_scale, causal)
    raise ValueError(f"simple_attention: no kernel for {q.device}")


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
    return L.empty_bshd(*q.shape, q)


@_attention_bwd_op.register_fake
def _attention_bwd_fake(q, k, v, do, sm_scale, causal):
    return tuple(L.empty_bshd(*q.shape, q) for _ in range(3))

# What a selective-checkpoint policy sees when the op runs.
OP = torch.ops.paddle_tpu_torch.simple_attention.default


def simple_attention(q, k, v, sm_scale, causal=True):
    """q/k/v: [B, H, S, D] -> [B, H, S, D]. Differentiable."""
    return _attention_op(q, k, v, float(sm_scale), bool(causal))


def supported(q_shape, dtype, vmem_budget=12 * 2 ** 20):
    """The reference gate, verbatim (``simple_attention.py:144``), so that
    the port picks the tier the reference picks: q/k/v/o [S,D] + scores
    [S,S] f32 (x2 for fwd+recompute headroom) within its VMEM budget."""
    b, h, s, d = q_shape
    if d % 128 != 0 and d != 64:
        return False
    if s % 128 != 0:
        return False
    itemsize = 2 if dtype in (torch.bfloat16, torch.float16) else 4
    need = 4 * s * d * itemsize + 2 * s * s * 4
    return need <= vmem_budget


def attention_bhsd(q, k, v, causal=True, scale=None):
    """Convenience: [B,H,S,D] layout with defaulted scale."""
    d = q.shape[-1]
    sm = scale if scale is not None else 1.0 / math.sqrt(d)
    return simple_attention(q, k, v, sm, causal)
