"""q x kv blocked flash attention for the S>=4096 rung, as Hopper kernels.

Port of ``paddle_tpu/ops/pallas/blocked_flash.py``: the same gate and block
choice (``_pick_block``, ``_blocks_for``, ``block_candidates``,
``supported``, verbatim), function and residuals (o, lse). The forward, the
dq launch and the dk/dv launch are CUDA kernels for ``sm_90a``, on the
tensor cores for bf16 and f16 (``csrc/blocked_flash.cu``, whose header says
how a block's own loop takes the place of the reference's sequential grid).
The dq launch also returns delta = rowsum(dO * O), which the dk/dv launch
reads, so that delta is summed once per row.

Block sizes: ``block_q``/``block_kv`` are validated as the reference does.
They set the plain version's kv loop, and with it where the running max
moves and so where bf16 rounds p; the kernels stream kv in their own tiles
of 64 rows (32 at D=256) whatever the blocks. Causal is top-left and needs Sq == Skv;
non-causal cross-attention (Sq != Skv) is supported.

Devices: for CUDA tensors the ops launch the kernels or raise; for CPU
tensors they run the plain versions below, which the tests and
``chip_smoke.py`` also use as the yardstick of the kernels.
"""
from __future__ import annotations

import math

import torch

from . import _launch as L
from . import lse_backward

NEG_INF = -1e30

#: preferred block edges, largest first (the reference's MXU multiples)
_BLOCKS = (512, 256, 128)

# Kernel launches since the last reset_launch_counts(), by kernel.
LAUNCHES = {"blocked_flash_fwd": 0, "blocked_flash_bwd_dq": 0,
            "blocked_flash_bwd_dkv": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------ gates and blocks ----------------------------
def _pick_block(n: int):
    for b in _BLOCKS:
        if n % b == 0:
            return b
    return None


def _blocks_for(sq: int, skv: int, block_q=None, block_kv=None):
    bq = block_q if block_q is not None else _pick_block(sq)
    bkv = block_kv if block_kv is not None else _pick_block(skv)
    if bq is None or bkv is None or sq % bq or skv % bkv:
        raise ValueError(
            f"blocked_flash: no block sizes for S={sq}, Skv={skv} "
            f"(got bq={block_q}, bkv={block_kv}; sequence lengths must "
            "be multiples of 128 and of any explicit block size)")
    return bq, bkv


def block_candidates(sq: int, skv: int):
    """(bq, bkv) variants worth measuring for this problem, preferred
    first (the reference's autotune candidates)."""
    combos = [(512, 512), (256, 512), (512, 1024)]
    out = [(bq, bkv) for bq, bkv in combos
           if sq % bq == 0 and skv % bkv == 0]
    if not out:
        bq, bkv = _pick_block(sq), _pick_block(skv)
        if bq is not None and bkv is not None:
            out = [(bq, bkv)]
    return out


def supported(q_shape, skv, dtype, causal=True):
    """Shape gate ([B,H,S,D] + kv length), the reference's verbatim."""
    b, h, s, d = q_shape
    if dtype not in (torch.bfloat16, torch.float16, torch.float32):
        return False
    if d % 128 != 0 and d != 64:
        return False
    if s % 128 != 0 or skv % 128 != 0:
        return False
    if causal and s != skv:
        return False                # causal cross-attn: not this kernel
    return _pick_block(s) is not None and _pick_block(skv) is not None


def _require_causal_square(sq, skv, causal):
    if causal and sq != skv:
        raise ValueError(f"blocked_flash: causal attention is top-left and "
                         f"needs Sq == Skv, got Sq={sq}, Skv={skv}")


# ------------------------------ plain versions ------------------------------
def blocked_flash_reference(q, k, v, sm_scale, causal=True, block_kv=None):
    """Plain forward of ``_fwd_kernel``: q [B, H, Sq, D], k/v [B, H, Skv, D]
    -> (o, lse [B, H, Sq] f32). The online softmax runs over the
    reference's kv blocks of ``block_kv`` (default ``_pick_block(Skv)``):
    (m, l, acc) in f32 from m = -1e30, the unnormalized p = exp(s - m_new)
    rounded to v's dtype before PV, the division by l at the end. kv blocks
    that the reference skips lie wholly above the row's diagonal: they move
    neither m, l nor acc, so running them changes nothing."""
    sq, skv = q.shape[2], k.shape[2]
    _require_causal_square(sq, skv, causal)
    _, bkv = _blocks_for(sq, skv, None, block_kv)
    s_all = lse_backward.scores(q, k, sm_scale, causal)
    m = torch.full(q.shape[:3] + (1,), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j in range(0, skv, bkv):
        s = s_all[..., j:j + bkv]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(),
                                         v[..., j:j + bkv, :].float())
        m = m_new
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def blocked_flash_bwd_dq_reference(q, k, v, o, lse, do, sm_scale,
                                   causal=True):
    """Plain ``_bwd_dq_kernel``: dq in q's dtype."""
    return lse_backward.dq_reference(q, k, v, o, lse, do, sm_scale, causal)


def blocked_flash_bwd_dkv_reference(q, k, v, o, lse, do, sm_scale,
                                    causal=True):
    """Plain ``_bwd_dkv_kernel``: (dk, dv), summed in f32, cast at the
    end."""
    return lse_backward.dkv_reference(q, k, v, o, lse, do, sm_scale, causal)


# --------------------------------- kernels ----------------------------------
_TAIL = [L.STRIDES, L.INT, L.INT, L.INT, L.INT, L.FLOAT, L.INT, L.VP]
# bf_*: blocked_flash's launches; lf_*: the same kernels for the library
# tier (flash_attention.py), which admit causal Sq != Skv (top-left).
_SIGNATURES = {
    f"{prefix}_{what}": [L.INT, L.INT] + [L.VP] * n + _TAIL
    for prefix in ("bf", "lf")
    for what, n in (("fwd", 5), ("bwd_dq", 8), ("bwd_dkv", 8))
}


def _lib():
    return L.library("blocked_flash", "bf", _SIGNATURES)


def _launch(what, fn, tensors, laid_out, sm_scale, causal):
    """Calls ``fn`` with the pointers of ``tensors`` (q, k first) and the
    strides of ``laid_out``."""
    q, k = tensors[:2]
    b, h, sq, d = q.shape
    L.launch(_lib(), "bf", "blocked_flash", what, q.device, fn,
             L.DTYPE_CODE[q.dtype], d, *(t.data_ptr() for t in tensors),
             L.layouts(*laid_out), b, h, sq, k.shape[2], float(sm_scale),
             int(causal))


def _check_bwd(what, q, k, v, do, rows, stats):
    """q, k, v and dO, then ``rows`` [B, H, Sq, D] operands in q's dtype
    and ``stats`` f32 [B, H, Sq] row statistics."""
    b, h, sq, d = q.shape
    kv_shape = (b, h, k.shape[2], d)
    L.check("blocked_flash", what,
            [(q, q.shape, q.dtype), (k, kv_shape, q.dtype),
             (v, kv_shape, q.dtype), (do, q.shape, q.dtype)]
            + [(t, q.shape, q.dtype) for t in rows]
            + [(t, (b, h, sq), torch.float32) for t in stats])
    L.same_layout("blocked_flash", what, (k, v))


def fwd_launch(prefix, q, k, v, sm_scale, causal):
    """Launches the forward kernel through entry point ``<prefix>_fwd``:
    q [B, H, Sq, D], k/v [B, H, Skv, D] CUDA views (k and v sharing one
    layout) -> (o [B, H, Sq, D] view of a [B, S, H, D] buffer, lse
    [B, H, Sq] f32)."""
    b, h, sq, d = q.shape
    kv_shape = (b, h, k.shape[2], d)
    L.check("blocked_flash", "forward",
            [(q, q.shape, q.dtype), (k, kv_shape, q.dtype),
             (v, kv_shape, q.dtype)])
    L.same_layout("blocked_flash", "forward", (k, v))
    o, lse = L.empty_bshd(b, h, sq, d, q), L.empty_lse(b, h, sq, q)
    _launch("forward", f"{prefix}_fwd", (q, k, v, o, lse), (q, k, o),
            sm_scale, causal)
    return o, lse


def dq_launch(prefix, q, k, v, o, lse, do, sm_scale, causal):
    """Launches the dq kernel through ``<prefix>_bwd_dq``. Returns (dq,
    delta): dq a [B, H, Sq, D] view of a [B, S, H, D] buffer, delta =
    rowsum(dO * O) f32 [B, H, Sq], which the dk/dv kernel reads."""
    _check_bwd("backward dq", q, k, v, do, (o,), (lse,))
    dq = L.empty_bshd(*q.shape, q)
    delta = L.empty_lse(*q.shape[:3], q)
    _launch("backward dq", f"{prefix}_bwd_dq",
            (q, k, v, o, lse, do, dq, delta), (q, k, o, do, dq), sm_scale,
            causal)
    return dq, delta


def dkv_launch(prefix, q, k, v, lse, delta, do, sm_scale, causal):
    """Launches the dk/dv kernel through ``<prefix>_bwd_dkv`` from the
    forward's lse and the dq kernel's delta. Returns (dk, dv), each a
    [B, H, Skv, D] view of a [B, S, H, D] buffer."""
    _check_bwd("backward dkv", q, k, v, do, (), (lse, delta))
    dk, dv = (L.empty_bshd(*k.shape, k) for _ in range(2))
    _launch("backward dkv", f"{prefix}_bwd_dkv",
            (q, k, v, lse, delta, do, dk, dv), (q, k, do, dk), sm_scale,
            causal)
    return dk, dv


def blocked_flash_fwd_cuda(q, k, v, sm_scale, causal):
    """The forward kernel (``fwd_launch``); causal needs Sq == Skv."""
    _require_causal_square(q.shape[2], k.shape[2], causal)
    out = fwd_launch("bf", q, k, v, sm_scale, causal)
    LAUNCHES["blocked_flash_fwd"] += 1
    return out


def blocked_flash_bwd_dq_cuda(q, k, v, o, lse, do, sm_scale, causal):
    """The dq kernel (``dq_launch``): (dq, delta)."""
    _require_causal_square(q.shape[2], k.shape[2], causal)
    out = dq_launch("bf", q, k, v, o, lse, do, sm_scale, causal)
    LAUNCHES["blocked_flash_bwd_dq"] += 1
    return out


def blocked_flash_bwd_dkv_cuda(q, k, v, lse, delta, do, sm_scale, causal):
    """The dk/dv kernel (``dkv_launch``): (dk, dv)."""
    _require_causal_square(q.shape[2], k.shape[2], causal)
    out = dkv_launch("bf", q, k, v, lse, delta, do, sm_scale, causal)
    LAUNCHES["blocked_flash_bwd_dkv"] += 1
    return out


# ------------------------------ the registered ops --------------------------
def _device_error(q):
    return ValueError(f"blocked_flash: no kernel for {q.device}")


def _validate(q, k, causal, block_q, block_kv):
    _blocks_for(q.shape[2], k.shape[2], block_q, block_kv)
    _require_causal_square(q.shape[2], k.shape[2], causal)


@torch.library.custom_op(
    "paddle_tpu_torch::blocked_flash", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float sm_scale, bool causal, "
           "int? block_q, int? block_kv) -> (Tensor, Tensor)")
def _attention_op(q, k, v, sm_scale, causal, block_q, block_kv):
    _validate(q, k, causal, block_q, block_kv)
    if q.device.type == "cuda":
        return blocked_flash_fwd_cuda(q, k, v, sm_scale, causal)
    if q.device.type == "cpu":
        return blocked_flash_reference(q, k, v, sm_scale, causal, block_kv)
    raise _device_error(q)


@torch.library.custom_op(
    "paddle_tpu_torch::blocked_flash_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do, "
           "float sm_scale, bool causal) -> (Tensor, Tensor, Tensor)")
def _attention_bwd_op(q, k, v, o, lse, do, sm_scale, causal):
    if q.device.type == "cuda":
        dq, delta = blocked_flash_bwd_dq_cuda(q, k, v, o, lse, do, sm_scale,
                                              causal)
        return (dq, *blocked_flash_bwd_dkv_cuda(q, k, v, lse, delta, do,
                                                sm_scale, causal))
    if q.device.type == "cpu":
        return lse_backward.bwd_reference(q, k, v, o, lse, do, sm_scale,
                                          causal)
    raise _device_error(q)


def _setup_context(ctx, inputs, output):
    q, k, v, sm_scale, causal, _, _ = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)   # the reference's residuals
    ctx.mark_non_differentiable(lse)
    ctx.sm_scale = sm_scale
    ctx.causal = causal


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    if not L.aligned(do):     # e.g. the expanded gradient of a sum()
        do = do.contiguous()
    dq, dk, dv = _attention_bwd_op(q, k, v, o, lse, do, ctx.sm_scale,
                                   ctx.causal)
    return dq, dk, dv, None, None, None, None


_attention_op.register_autograd(_backward, setup_context=_setup_context)


# Shapes and layouts only (meta tensors, tracing): what the kernels return.
@_attention_op.register_fake
def _attention_fake(q, k, v, sm_scale, causal, block_q, block_kv):
    _validate(q, k, causal, block_q, block_kv)
    b, h, sq, d = q.shape
    return L.empty_bshd(b, h, sq, d, q), L.empty_lse(b, h, sq, q)


@_attention_bwd_op.register_fake
def _attention_bwd_fake(q, k, v, o, lse, do, sm_scale, causal):
    return (L.empty_bshd(*q.shape, q),
            *(L.empty_bshd(*k.shape, k) for _ in range(2)))


# What a selective-checkpoint policy sees when the op runs.
OP = torch.ops.paddle_tpu_torch.blocked_flash.default


def blocked_flash(q, k, v, sm_scale, causal=True, block_q=None,
                  block_kv=None):
    """q: [B, H, Sq, D], k/v: [B, H, Skv, D] -> [B, H, Sq, D].
    Differentiable."""
    return _attention_op(q, k, v, float(sm_scale), bool(causal), block_q,
                         block_kv)[0]


def attention_bhsd(q, k, v, causal=True, scale=None, block_q=None,
                   block_kv=None):
    """Convenience: [B,H,S,D] layout with defaulted scale."""
    d = q.shape[-1]
    sm = scale if scale is not None else 1.0 / math.sqrt(d)
    return blocked_flash(q, k, v, sm, causal, block_q, block_kv)
