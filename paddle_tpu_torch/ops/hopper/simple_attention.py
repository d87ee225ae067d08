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

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30

# Kernel launches since the last reset_launch_counts(), by kernel.
LAUNCHES = {"simple_attention_fwd": 0, "simple_attention_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128, 256)


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
def _aligned(t):
    """Unit-stride head dim and 16-byte aligned rows: the kernels' loads."""
    align = 16 // t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
        and all(st % align == 0 for st in t.stride()[:-1])


def _check(what, tensors, shape, dtype):
    """Refuses what the kernels do not take, before any pointer is passed.
    q, k and v (the first three) must share one layout."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"simple_attention {what}: expected CUDA "
                             f"tensors, got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"simple_attention {what}: expected {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != tensors[0].device:
            raise ValueError(f"simple_attention {what}: tensors on "
                             f"{t.device} and {tensors[0].device}")
        if not _aligned(t):
            raise ValueError(
                f"simple_attention {what}: the head dim must be unit-stride "
                f"and rows 16-byte aligned, got strides {t.stride()}")
    if any(t.stride() != tensors[0].stride() for t in tensors[1:3]):
        raise ValueError(f"simple_attention {what}: q, k and v must share "
                         "one layout")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"simple_attention {what}: dtype {dtype} "
                         f"not in {list(_DTYPE_CODE)}")
    b, h, s, d = shape
    if d not in _HEAD_DIMS:
        raise NotImplementedError(
            f"simple_attention: head dim {d} has no Hopper kernel yet "
            f"(built for {_HEAD_DIMS}; ROADMAP queue 2)")
    if s % 64:
        raise ValueError(f"simple_attention: S={s} is not a multiple of 64")


def _strides(t):
    """(batch, head, row) element strides of a [B, H, S, D] view."""
    return t.stride(0), t.stride(1), t.stride(2)


def _empty_bshd(b, h, s, d, like):
    """[B, H, S, D] view of a fresh [B, S, H, D] buffer: what the model's
    [B, S, H*D] activations reshape to without a copy."""
    return torch.empty(b, s, h, d, dtype=like.dtype,
                       device=like.device).transpose(1, 2)


_typed_lib = []


def _lib():
    """The kernels' library with every entry point's C types declared."""
    if not _typed_lib:
        lib = _build.library("simple_attention")
        vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
        lib.sa_fwd.argtypes = [i, i, vp, vp, vp, vp, ll, ll, ll, ll, ll, ll,
                               i, i, i, f, i, vp]
        lib.sa_fwd.restype = i
        lib.sa_bwd.argtypes = [i, i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                               ll, ll, ll, ll, ll, ll, ll, ll, ll,
                               i, i, i, f, i, vp]
        lib.sa_bwd.restype = i
        lib.sa_error_string.argtypes = [i]
        lib.sa_error_string.restype = ctypes.c_char_p
        _typed_lib.append(lib)
    return _typed_lib[0]


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(f"simple_attention {what} kernel failed to launch: "
                           f"{lib.sa_error_string(err).decode()} ({err})")


def simple_attention_fwd_cuda(q, k, v, sm_scale, causal):
    """Launches the forward kernel: q/k/v [B, H, S, D] CUDA views sharing
    one layout -> o [B, H, S, D] (a view of a [B, S, H, D] buffer)."""
    shape = tuple(q.shape)
    _check("forward", (q, k, v), shape, q.dtype)
    b, h, s, d = shape
    o = _empty_bshd(b, h, s, d, q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sa_fwd(_DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), o.data_ptr(), *_strides(q),
                         *_strides(o), b, h, s, float(sm_scale), int(causal),
                         stream)
    _raise_on(lib, err, "forward")
    LAUNCHES["simple_attention_fwd"] += 1
    return o


def simple_attention_bwd_cuda(q, k, v, do, sm_scale, causal):
    """Launches the backward pair (dq + row statistics, then dk/dv).
    Returns (dq, dk, dv), each a [B, H, S, D] view of a [B, S, H, D]
    buffer."""
    shape = tuple(q.shape)
    _check("backward", (q, k, v, do), shape, q.dtype)
    b, h, s, d = shape
    dq, dk, dv = (_empty_bshd(b, h, s, d, q) for _ in range(3))
    stats = torch.empty(3, b, h, s, dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sa_bwd(_DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), do.data_ptr(), dq.data_ptr(),
                         dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(),
                         stats[1].data_ptr(), stats[2].data_ptr(),
                         *_strides(q), *_strides(do), *_strides(dq),
                         b, h, s, float(sm_scale), int(causal), stream)
    _raise_on(lib, err, "backward")
    LAUNCHES["simple_attention_bwd"] += 1
    return dq, dk, dv


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
    if not _aligned(do):      # e.g. the expanded gradient of a sum()
        do = do.contiguous()
    dq, dk, dv = _attention_bwd_op(q, k, v, do, ctx.sm_scale, ctx.causal)
    return dq, dk, dv, None, None


_attention_op.register_autograd(_backward, setup_context=_setup_context)


# Shapes and layouts only (meta tensors, tracing): what the kernels return.
@_attention_op.register_fake
def _attention_fake(q, k, v, sm_scale, causal):
    return _empty_bshd(*q.shape, q)


@_attention_bwd_op.register_fake
def _attention_bwd_fake(q, k, v, do, sm_scale, causal):
    return tuple(_empty_bshd(*q.shape, q) for _ in range(3))

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
