"""The tensor-core recompute backward's one new rounding point, held against
the reference Pallas kernels (paddle_tpu.ops.pallas.simple_attention and
simple_attention2, qblock_attention) run in interpret mode on the CPU.

The bf16/f16 kernels of csrc/attention_mma.cuh recompute P in f32 and take
delta = rowsum(dP * P) in f32, as the references do, but feed P and dS to
the tensor cores ROUNDED TO THE INPUT DTYPE as the operands of
dV = P^T dO, dQ = dS K and dK = dS^T Q, with f32 sums; the references
multiply P and dS in f32. The emulation below is that arithmetic in plain
PyTorch, kept in this test only: the port's plain versions stay the
references' function. tests/test_torch_cuda.py holds the kernels against
those plain versions on the card at the same tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import simple_attention as jsa
from paddle_tpu.ops.pallas import simple_attention2 as jsa2
from paddle_tpu_torch.ops.hopper import simple_attention as tsa

B, H = 1, 2
NEG_INF = -1e30

# bf16: outputs carry bf16's 2^-8 relative step, and the rounded operands
# add one bf16 rounding of each P and dS element to sums that average it
# out; 2e-2 of the gradient's scale is the card's bf16 tolerance.
BF16_TOL = 2e-2


def _emulated_bwd(q, k, v, do, scale, causal):
    """(dq, dk, dv) as the tensor-core backward computes them: scores and
    P in f32 from exact products of the inputs, delta = rowsum(dP * P) in
    f32, P and dS rounded to the input dtype before the three products,
    f32 sums, each gradient cast to the input dtype at the end."""
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
    ds = p * (dp - delta) * scale
    p_op, ds_op = (x.to(q.dtype).float() for x in (p, ds))
    dv = torch.matmul(p_op.transpose(-1, -2), dof)
    dq = torch.matmul(ds_op, kf)
    dk = torch.matmul(ds_op.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


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
