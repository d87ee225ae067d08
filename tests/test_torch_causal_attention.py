"""paddle_tpu_torch.ops.hopper.causal_attention against the reference Pallas
kernel (paddle_tpu.ops.pallas.causal_attention) run in interpret mode on the
CPU: the plain forward (o and lse) and backward the port keeps beside its
Hopper kernels, the registered ops' CPU autograd, the hybrid, and the gate.
The kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import causal_attention as jca
from paddle_tpu_torch.ops.hopper import causal_attention as tca

B, H = 1, 2


def _inputs(s, d, seed=0, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, s, d).astype(np.float32) for _ in range(n)]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


def _rel_err(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# f32: both sides compute the same f32 arithmetic in another summation order
# (and another exp), so the outputs agree to a few ulps of their scale.
F32_TOL = 2e-5
# bf16: p is rounded to bf16 before PV on both sides, but a different f32
# sum can tip a rounding the other way, and outputs carry bf16's 2^-8
# relative step; 2e-2 of the output scale covers a few such steps.
BF16_TOL = 2e-2


def _reference_fwd(q, k, v, scale, dtype=jnp.float32):
    """The Pallas forward in interpret mode: (o, lse [B, H, S]) as numpy."""
    o, (_, _, _, _, lse) = jca._fwd(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                    scale, True)
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse[:, :, 0, :])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [256, 512])
def test_plain_forward_and_lse_match_interpret_kernel(s, d):
    q, k, v, _ = _inputs(s, d)
    scale = 1.0 / np.sqrt(d)
    want_o, want_lse = _reference_fwd(q, k, v, scale)
    o, lse = tca.causal_attention_reference(_t(q), _t(k), _t(v), scale)
    assert o.shape == (B, H, s, d) and lse.shape == (B, H, s)
    assert lse.dtype == torch.float32
    assert _rel_err(o, want_o) < F32_TOL
    assert _rel_err(lse, want_lse) < F32_TOL


@pytest.mark.parametrize("d", [64, 128])
def test_plain_backward_matches_interpret_kernel(d):
    s = 256
    q, k, v, do = _inputs(s, d, seed=1)
    scale = 1.0 / np.sqrt(d)
    _, res = jca._fwd(_j(q), _j(k), _j(v), scale, True)
    want = jca._bwd(scale, True, res, _j(do))
    o, lse = np.asarray(res[3]), np.asarray(res[4][:, :, 0, :])
    got = tca.causal_attention_bwd_reference(_t(q), _t(k), _t(v), _t(o),
                                             _t(lse), _t(do), scale)
    for g, w in zip(got, want):
        assert _rel_err(g, w) < F32_TOL


def test_plain_bf16_forward_and_backward():
    s, d = 256, 128
    q, k, v, do = _inputs(s, d, seed=4)
    scale = 1.0 / np.sqrt(d)
    bf = jnp.bfloat16
    _, res = jca._fwd(_j(q, bf), _j(k, bf), _j(v, bf), scale, True)
    want_g = jca._bwd(scale, True, res, _j(do, bf))
    tq, tk, tv, tdo = (_t(x, torch.bfloat16) for x in (q, k, v, do))
    o, lse = tca.causal_attention_reference(tq, tk, tv, scale)
    assert o.dtype == torch.bfloat16
    assert _rel_err(o.float(), res[3].astype(jnp.float32)) < BF16_TOL
    assert _rel_err(lse, res[4][:, :, 0, :]) < F32_TOL
    # the backward from the reference's own residuals
    ro = _t(res[3].astype(jnp.float32), torch.bfloat16)
    got = tca.causal_attention_bwd_reference(tq, tk, tv, ro,
                                             _t(res[4][:, :, 0, :]), tdo,
                                             scale)
    for g, w in zip(got, want_g):
        assert g.dtype == torch.bfloat16
        assert _rel_err(g.float(), w.astype(jnp.float32)) < BF16_TOL


def test_registered_op_gradient_on_cpu_is_the_plain_backward():
    q, k, v, do = (_t(x) for x in _inputs(256, 64, seed=3))
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tca.causal_attention(*qkv, 0.125)
    want_o, want_lse = tca.causal_attention_reference(q, k, v, 0.125)
    np.testing.assert_array_equal(out.detach(), want_o)
    got = torch.autograd.grad(out, qkv, do)
    want = tca.causal_attention_bwd_reference(q, k, v, want_o, want_lse, do,
                                              0.125)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_plain_backward_matches_autograd_of_plain_forward():
    q, k, v, do = (_t(x) for x in _inputs(256, 64, seed=2))
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o, lse = tca.causal_attention_reference(*qkv, 0.125)
    want = torch.autograd.grad(o, qkv, do)
    got = tca.causal_attention_bwd_reference(q, k, v, o.detach(),
                                             lse.detach(), do, 0.125)
    for g, w in zip(got, want):
        assert _rel_err(g, w) < F32_TOL


# The pattern of tests/test_causal_attention.py:99: outputs and gradients of
# sum(out^2), here the port's hybrid against the reference's in interpret
# mode (strip forward, simple_attention's backward from (q, k, v)).
def test_hybrid_matches_reference_hybrid():
    b, h, s, d = 2, 2, 256, 64
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    want = jca.attention_bhsd_hybrid(_j(q), _j(k), _j(v), causal=True,
                                     interpret=True)
    want_g = jax.grad(lambda a: jnp.sum(jca.attention_bhsd_hybrid(
        *a, causal=True, interpret=True) ** 2))((_j(q), _j(k), _j(v)))
    qkv = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = tca.attention_bhsd_hybrid(*qkv, causal=True)
    got_g = torch.autograd.grad((out ** 2).sum(), qkv)
    assert _rel_err(out.detach(), want) < F32_TOL
    for g, w in zip(got_g, want_g):
        assert _rel_err(g, w) < 2e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_gate_matches_reference_gate(dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dtype]
    isz = 2 if dtype != torch.float32 else 4
    for s in (128, 256, 384, 512, 1024, 1152, 2048, 3072, 4096, 8192):
        for d in (32, 64, 96, 128, 192, 256, 384):
            shape = (4, 8, s, d)
            assert tca.supported(shape, dtype) == jca.supported(shape, jdt), \
                (shape, dtype)
            assert tca.hybrid_supported(shape, dtype) == \
                jca.hybrid_supported(shape, jdt), (shape, dtype)
            assert tca._pick_nq(s, d, isz) == jca._pick_nq(s, d, isz)


def test_rung_shape_takes_eight_strips_and_s4096_is_refused():
    assert tca._pick_nq(2048, 128, 2) == 8
    assert tca.supported((4, 8, 2048, 128), torch.bfloat16)
    assert not tca.supported((2, 8, 4096, 128), torch.bfloat16)
    q = torch.zeros(1, 2, 4096, 128)
    with pytest.raises(ValueError, match="VMEM budget"):
        tca.causal_attention(q, q, q, 0.1)


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 256, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tca.causal_attention_fwd_cuda(q, q, q, 0.125)
    lse = torch.zeros(1, 2, 256)
    with pytest.raises(ValueError, match="CUDA"):
        tca.causal_attention_bwd_cuda(q, q, q, q, lse, q, 0.125)
