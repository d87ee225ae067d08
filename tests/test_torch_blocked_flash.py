"""paddle_tpu_torch.ops.hopper.blocked_flash against the reference Pallas
kernels (paddle_tpu.ops.pallas.blocked_flash) run in interpret mode on the
CPU: the plain forward (o and lse), dq and dk/dv the port keeps beside its
Hopper kernels, at default and explicit blocks, ragged S and
cross-attention; the registered op's CPU autograd; the gates and block
choice. The kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import blocked_flash as jbf
from paddle_tpu_torch.ops.hopper import blocked_flash as tbf
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

B, H = 1, 2


def _inputs(sq, skv, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, sq, d).astype(np.float32),
            rng.randn(B, H, skv, d).astype(np.float32),
            rng.randn(B, H, skv, d).astype(np.float32),
            rng.randn(B, H, sq, d).astype(np.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


def _rel_err(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# f32: the same f32 arithmetic in another summation order (and another exp):
# a few ulps of the output scale.
F32_TOL = 2e-5
# bf16: both sides round the unnormalized p to bf16 at the same running max
# (the plain version follows the reference's kv blocks), but a different f32
# sum can tip a rounding the other way, and outputs carry bf16's 2^-8
# relative step; 2e-2 of the output scale covers a few such steps.
BF16_TOL = 2e-2

# (Sq, Skv, D, causal, block_q, block_kv): default blocks, explicit blocks
# with bq != bkv, ragged S=384 (blocks of 128), cross-attention Sq != Skv.
CASES = [
    (256, 256, 64, True, None, None),
    (512, 512, 128, True, None, None),
    (512, 512, 64, False, None, None),
    (512, 512, 128, True, 128, 256),
    (384, 384, 64, True, None, None),
    (256, 384, 128, False, None, None),
]
IDS = [f"sq{c[0]}-skv{c[1]}-d{c[2]}-{'causal' if c[3] else 'full'}"
       f"-bq{c[4]}-bkv{c[5]}" for c in CASES]


def _reference(q, k, v, do, scale, causal, bq, bkv, dtype=jnp.float32):
    """The three Pallas kernels in interpret mode, in the reference's
    order: (o, lse [B, H, Sq]) from _fwd, dq and (dk, dv) from the saved
    residuals."""
    bq, bkv = jbf._blocks_for(q.shape[2], k.shape[2], bq, bkv)
    jq, jk, jv, jdo = (_j(x, dtype) for x in (q, k, v, do))
    o, lse = jbf._fwd(jq, jk, jv, scale, causal, True, bq, bkv)
    dq = jbf._bwd_dq(jq, jk, jv, o, lse, jdo, scale, causal, True, bq, bkv)
    dk, dv = jbf._bwd_dkv(jq, jk, jv, o, lse, jdo, scale, causal, True, bq,
                          bkv)
    return o, lse[:, :, 0, :], dq, dk.astype(dtype), dv.astype(dtype)


@pytest.mark.parametrize("sq,skv,d,causal,bq,bkv", CASES, ids=IDS)
def test_plain_versions_match_interpret_kernels(sq, skv, d, causal, bq, bkv):
    q, k, v, do = _inputs(sq, skv, d, seed=sq + d)
    scale = 1.0 / np.sqrt(d)
    o, lse, dq, dk, dv = _reference(q, k, v, do, scale, causal, bq, bkv)
    bkv_used = jbf._blocks_for(sq, skv, bq, bkv)[1]
    got_o, got_lse = tbf.blocked_flash_reference(_t(q), _t(k), _t(v), scale,
                                                 causal, bkv_used)
    assert got_o.shape == (B, H, sq, d) and got_lse.shape == (B, H, sq)
    assert _rel_err(got_o, o) < F32_TOL
    assert _rel_err(got_lse, lse) < F32_TOL
    # each backward kernel from the reference's own residuals
    res = (_t(q), _t(k), _t(v), _t(o), _t(lse), _t(do), scale, causal)
    assert _rel_err(tbf.blocked_flash_bwd_dq_reference(*res), dq) < F32_TOL
    got_dk, got_dv = tbf.blocked_flash_bwd_dkv_reference(*res)
    assert got_dk.shape == got_dv.shape == (B, H, skv, d)
    assert _rel_err(got_dk, dk) < F32_TOL
    assert _rel_err(got_dv, dv) < F32_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_versions_match_interpret_kernels(causal):
    sq = skv = 512
    d = 128
    q, k, v, do = _inputs(sq, skv, d, seed=9)
    scale = 1.0 / np.sqrt(d)
    bf = jnp.bfloat16
    o, lse, dq, dk, dv = _reference(q, k, v, do, scale, causal, 256, 128,
                                    dtype=bf)
    tq, tk, tv, tdo = (_t(x, torch.bfloat16) for x in (q, k, v, do))
    got_o, got_lse = tbf.blocked_flash_reference(tq, tk, tv, scale, causal,
                                                 128)
    assert got_o.dtype == torch.bfloat16
    assert _rel_err(got_o.float(), o.astype(jnp.float32)) < BF16_TOL
    assert _rel_err(got_lse, lse) < F32_TOL
    ro = _t(o.astype(jnp.float32), torch.bfloat16)
    res = (tq, tk, tv, ro, _t(lse), tdo, scale, causal)
    got = (tbf.blocked_flash_bwd_dq_reference(*res),
           *tbf.blocked_flash_bwd_dkv_reference(*res))
    for g, w in zip(got, (dq, dk, dv)):
        assert g.dtype == torch.bfloat16
        assert _rel_err(g.float(), w.astype(jnp.float32)) < BF16_TOL


@pytest.mark.parametrize("causal,sq,skv", [(True, 384, 384),
                                           (False, 256, 384)])
def test_registered_op_gradient_on_cpu_is_the_plain_backward(causal, sq,
                                                             skv):
    q, k, v, do = (_t(x) for x in _inputs(sq, skv, 64, seed=3))
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tbf.blocked_flash(*qkv, 0.125, causal)
    want_o, want_lse = tbf.blocked_flash_reference(q, k, v, 0.125, causal)
    np.testing.assert_array_equal(out.detach(), want_o)
    got = torch.autograd.grad(out, qkv, do)
    res = (q, k, v, want_o, want_lse, do, 0.125, causal)
    want = (tbf.blocked_flash_bwd_dq_reference(*res),
            *tbf.blocked_flash_bwd_dkv_reference(*res))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_plain_backward_matches_autograd_of_plain_forward():
    q, k, v, do = (_t(x) for x in _inputs(384, 384, 64, seed=2))
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o, lse = tbf.blocked_flash_reference(*qkv, 0.125, True)
    want = torch.autograd.grad(o, qkv, do)
    res = (q, k, v, o.detach(), lse.detach(), do, 0.125, True)
    got = (tbf.blocked_flash_bwd_dq_reference(*res),
           *tbf.blocked_flash_bwd_dkv_reference(*res))
    for g, w in zip(got, want):
        assert _rel_err(g, w) < F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_gate_matches_reference_gate(dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dtype]
    lens = (64, 128, 256, 384, 640, 1024, 2048, 4096)
    for s in lens:
        for skv in lens:
            for d in (32, 64, 96, 128, 192, 256):
                for causal in (True, False):
                    shape = (2, 8, s, d)
                    assert tbf.supported(shape, skv, dtype, causal) == \
                        jbf.supported(shape, skv, jdt, causal), \
                        (shape, skv, dtype, causal)


def test_block_choice_matches_reference():
    lens = (128, 256, 384, 512, 640, 1024, 1536, 2048, 4096)
    for s in lens:
        assert tbf._pick_block(s) == jbf._pick_block(s)
        for skv in lens:
            assert tbf.block_candidates(s, skv) == \
                jbf.block_candidates(s, skv)
            for bq, bkv in ((None, None), (128, 256), (256, 512),
                            (512, 384), (384, None)):
                try:
                    want = jbf._blocks_for(s, skv, bq, bkv)
                except ValueError:
                    with pytest.raises(ValueError, match="no block sizes"):
                        tbf._blocks_for(s, skv, bq, bkv)
                else:
                    assert tbf._blocks_for(s, skv, bq, bkv) == want
    assert tbf._blocks_for(4096, 4096) == (512, 512)


def test_op_refuses_bad_blocks_and_causal_cross_attention():
    q = torch.zeros(1, 2, 256, 64)
    k = torch.zeros(1, 2, 384, 64)
    with pytest.raises(ValueError, match="no block sizes"):
        tbf.blocked_flash(q, q, q, 0.125, True, block_q=512)
    with pytest.raises(ValueError, match="Sq == Skv"):
        tbf.blocked_flash(q, k, k, 0.125, True)


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 256, 64)
    lse = torch.zeros(1, 2, 256)
    with pytest.raises(ValueError, match="CUDA"):
        tbf.blocked_flash_fwd_cuda(q, q, q, 0.125, True)
    with pytest.raises(ValueError, match="CUDA"):
        tbf.blocked_flash_bwd_dq_cuda(q, q, q, q, lse, q, 0.125, True)
    with pytest.raises(ValueError, match="CUDA"):
        tbf.blocked_flash_bwd_dkv_cuda(q, q, q, lse, lse, q, 0.125, True)
