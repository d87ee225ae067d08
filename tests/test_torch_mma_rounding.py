"""The tensor-core backwards' one new rounding point, held against the
reference Pallas kernels run in interpret mode on the CPU: the recompute
backward (paddle_tpu.ops.pallas.simple_attention and simple_attention2,
qblock_attention) and the backward from a saved lse (causal_attention and
blocked_flash).

The bf16/f16 kernels of csrc/attention_mma.cuh take P in f32 (recomputed, or
exp(s - lse) from the forward's lse) and delta in f32 (rowsum(dP * P), or
rowsum(dO * O) from the saved O), as the references do, but feed P and dS to
the tensor cores ROUNDED TO THE INPUT DTYPE as the operands of
dV = P^T dO, dQ = dS K and dK = dS^T Q, with f32 sums; the references
multiply P and dS in f32. The emulations below are that arithmetic in plain
PyTorch, kept in this test only: the port's plain versions stay the
references' function. tests/test_torch_cuda.py holds the kernels against
those plain versions on the card at the same tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import blocked_flash as jbf
from paddle_tpu.ops.pallas import causal_attention as jca
from paddle_tpu.ops.pallas import simple_attention as jsa
from paddle_tpu.ops.pallas import simple_attention2 as jsa2
from paddle_tpu_torch.ops.hopper import blocked_flash as tbf
from paddle_tpu_torch.ops.hopper import causal_attention as tca
from paddle_tpu_torch.ops.hopper import lse_backward as tlse
from paddle_tpu_torch.ops.hopper import simple_attention as tsa

B, H = 1, 2
NEG_INF = -1e30

# bf16: outputs carry bf16's 2^-8 relative step, and the rounded operands
# add one bf16 rounding of each P and dS element to sums that average it
# out; 2e-2 of the gradient's scale is the card's bf16 tolerance.
BF16_TOL = 2e-2


def _rounded_operand_products(q, k, do, p, ds):
    """dv = P^T dO, dq = dS K, dk = dS^T Q with P and dS rounded to the
    input dtype as operands, f32 sums, each gradient cast at the end."""
    qf, kf, dof = (x.float() for x in (q, k, do))
    p_op, ds_op = (x.to(q.dtype).float() for x in (p, ds))
    dv = torch.matmul(p_op.transpose(-1, -2), dof)
    dq = torch.matmul(ds_op, kf)
    dk = torch.matmul(ds_op.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _emulated_bwd(q, k, v, do, scale, causal):
    """(dq, dk, dv) as the tensor-core recompute backward computes them:
    scores and P in f32 from exact products of the inputs,
    delta = rowsum(dP * P) in f32, then the rounded-operand products."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(),
                          NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dp * p).sum(-1, keepdim=True)
    return _rounded_operand_products(q, k, do, p, p * (dp - delta) * scale)


def _emulated_lse_bwd(q, k, v, o, lse, do, scale, causal):
    """(dq, dk, dv) as the tensor-core lse backward computes them: scores
    in f32 from exact products of the inputs, P = exp(s - lse) from the
    forward's lse and delta = rowsum(dO * O) from its saved O, both in f32,
    then the rounded-operand products."""
    p = torch.exp(tlse.scores(q, k, scale, causal) - lse[..., None])
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    return _rounded_operand_products(q, k, do, p, p * (dp - delta) * scale)


def _rel_err(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _reference_grads(module, q, k, v, do, scale, causal):
    """jax.vjp of the reference op in interpret mode, bf16."""
    op = jsa.simple_attention if module == "simple" else jsa2.qblock_attention
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16)
                       for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: op(a, b, c, scale, causal, True),
                     jq, jk, jv)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]


# qblock at S=256 runs two q blocks of 128 (bq forced on the reference, so
# that it sums dk and dv across its sequential q-block grid).
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("module", ["simple", "qblock"])
def test_rounded_operand_backward_matches_reference(monkeypatch, module,
                                                    causal, d, s):
    if module == "qblock":
        monkeypatch.setattr(jsa2, "_pick_bq", lambda *a, **kw: 128)
    rng = np.random.RandomState(s + d + causal)
    q, k, v, do = (rng.randn(B, H, s, d).astype(np.float32)
                   for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    want = _reference_grads(module, q, k, v, do, scale, causal)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    got = _emulated_bwd(tq, tk, tv, tdo, scale, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == (B, H, s, d)
        assert _rel_err(g.float(), w) < BF16_TOL, name
    # the rounding point is real: the emulation is not the plain backward
    plain = tsa.simple_attention_bwd_reference(tq, tk, tv, tdo, scale,
                                               causal)
    assert any(not torch.equal(g, p) for g, p in zip(got, plain))


# The lse backward: causal_attention (its strips need S a multiple of 256)
# and blocked_flash at blocks of 128 (so S=256 runs two q and two kv blocks
# on the reference), causal and not, and cross-attention Sq < Skv. o and
# lse come from the port's plain forwards, the kernels' yardstick.
LSE_CASES = [("causal_attention", True, s, s, d)
             for s in (256, 512) for d in (64, 128)] \
    + [("blocked_flash", causal, s, s, d) for causal in (True, False)
       for s in (128, 256) for d in (64, 128)] \
    + [("blocked_flash", False, 128, 256, d) for d in (64, 128)]


def _reference_lse_grads(module, q, k, v, do, scale, causal):
    """jax.vjp of the reference op in interpret mode, bf16."""
    if module == "causal_attention":
        def op(a, b, c):
            return jca.causal_attention(a, b, c, scale, True)
    else:
        def op(a, b, c):
            return jbf.blocked_flash(a, b, c, scale, causal, True, 128, 128)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16)
                       for x in (q, k, v, do))
    _, vjp = jax.vjp(op, jq, jk, jv)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]


@pytest.mark.parametrize(
    "module,causal,sq,skv,d", LSE_CASES,
    ids=[f"{m}-{'causal' if c else 'full'}-sq{sq}-skv{skv}-d{d}"
         for m, c, sq, skv, d in LSE_CASES])
def test_rounded_operand_lse_backward_matches_reference(module, causal, sq,
                                                        skv, d):
    rng = np.random.RandomState(sq + skv + d + causal)
    q, do = (rng.randn(B, H, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, skv, d).astype(np.float32) for _ in range(2))
    scale = 1.0 / np.sqrt(d)
    want = _reference_lse_grads(module, q, k, v, do, scale, causal)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    if module == "causal_attention":
        o, lse = tca.causal_attention_reference(tq, tk, tv, scale)
    else:
        o, lse = tbf.blocked_flash_reference(tq, tk, tv, scale, causal, 128)
    got = _emulated_lse_bwd(tq, tk, tv, o, lse, tdo, scale, causal)
    for name, g, w, n in zip(("dq", "dk", "dv"), got, want, (sq, skv, skv)):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == (B, H, n, d)
        assert _rel_err(g.float(), w) < BF16_TOL, name
    # the rounding point is real: the emulation is not the plain backward
    plain = tlse.bwd_reference(tq, tk, tv, o, lse, tdo, scale, causal)
    assert any(not torch.equal(g, p) for g, p in zip(got, plain))
