"""Plain PyTorch versions of the attention backward from a saved lse, the
function of ``csrc/lse_backward.cuh``: p = exp(s - lse) in f32,
delta = rowsum(dO * O) with O the saved output, dS = p (dP - delta) scale,
every product summed in f32 and cast to the input dtype at the end.

``causal_attention``'s backward and ``blocked_flash``'s dq and dk/dv
launches compute this function (``_bwd_kernel`` of
``paddle_tpu/ops/pallas/causal_attention.py``, ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` of ``blocked_flash.py``). Causal is top-left and needs
Sq == Skv."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def scores(q, k, sm_scale, causal):
    """Scaled f32 scores [B, H, Sq, Skv], masked at -1e30 above the
    diagonal when causal: dot, times scale, then the mask."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        sq, skv = s.shape[-2:]
        keep = torch.ones(sq, skv, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _probs_and_ds(q, k, v, o, lse, do, sm_scale, causal):
    p = torch.exp(scores(q, k, sm_scale, causal) - lse[..., None])
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    return p, p * (dp - delta) * sm_scale


def dq_reference(q, k, v, o, lse, do, sm_scale, causal):
    """dq in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, o, lse, do, sm_scale, causal)
    return torch.matmul(ds, k.float()).to(q.dtype)


def dkv_reference(q, k, v, o, lse, do, sm_scale, causal):
    """(dk, dv) in k's and v's dtypes."""
    p, ds = _probs_and_ds(q, k, v, o, lse, do, sm_scale, causal)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def bwd_reference(q, k, v, o, lse, do, sm_scale, causal):
    """(dq, dk, dv) from one P."""
    p, ds = _probs_and_ds(q, k, v, o, lse, do, sm_scale, causal)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
