"""paddle_tpu_torch.ops.hopper.simple_attention against the reference Pallas
kernel (paddle_tpu.ops.pallas.simple_attention) run in interpret mode on the
CPU: the plain forward and backward the port keeps beside its Hopper
kernels, and the gate. The kernels themselves are held against these plain
versions on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import simple_attention as jsa
from paddle_tpu_torch.ops.hopper import simple_attention as tsa
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

B, H = 1, 2


def _inputs(s, d, seed=0, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, s, d).astype(np.float32) for _ in range(n)]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


def _rel_err(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# f32: both sides compute the same f32 arithmetic in another summation order
# (and another exp), so the outputs agree to a few ulps of their scale.
F32_TOL = 2e-5


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [128, 256])
def test_plain_forward_matches_interpret_kernel(s, d, causal):
    q, k, v, _ = _inputs(s, d)
    want = jsa.attention_bhsd(_j(q), _j(k), _j(v), causal=causal,
                              interpret=True)
    got = tsa.attention_bhsd(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == (B, H, s, d)
    assert _rel_err(got, want) < F32_TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_plain_backward_matches_interpret_vjp(d, causal):
    s = 128
    q, k, v, do = _inputs(s, d, seed=1)
    scale = 1.0 / np.sqrt(d)
    _, vjp = jax.vjp(lambda a, b, c: jsa.simple_attention(
        a, b, c, scale, causal, True), _j(q), _j(k), _j(v))
    want = vjp(_j(do))
    got = tsa.simple_attention_bwd_reference(_t(q), _t(k), _t(v), _t(do),
                                             scale, causal)
    for g, w in zip(got, want):
        assert _rel_err(g, w) < F32_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_autograd_of_plain_forward(causal):
    q, k, v, do = (_t(x).requires_grad_(True) if i < 3 else _t(x)
                   for i, x in enumerate(_inputs(256, 64, seed=2)))
    scale = 0.125
    out = tsa.simple_attention_reference(q, k, v, scale, causal)
    want = torch.autograd.grad(out, (q, k, v), do)
    got = tsa.simple_attention_bwd_reference(q.detach(), k.detach(),
                                             v.detach(), do, scale, causal)
    for g, w in zip(got, want):
        assert _rel_err(g, w) < F32_TOL


def test_registered_op_gradient_on_cpu_is_the_plain_backward():
    q, k, v, do = (_t(x) for x in _inputs(128, 64, seed=3))
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tsa.simple_attention(*qkv, 0.125, True)
    np.testing.assert_array_equal(
        out.detach(), tsa.simple_attention_reference(q, k, v, 0.125, True))
    got = torch.autograd.grad(out, qkv, do)
    want = tsa.simple_attention_bwd_reference(q, k, v, do, 0.125, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# bf16: p is rounded to bf16 before PV on both sides, but a different f32
# sum can tip a rounding the other way, and outputs carry bf16's 2^-8
# relative step; 2e-2 of the output scale covers a few such steps.
BF16_TOL = 2e-2


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_forward_and_backward(causal):
    s, d = 128, 128
    q, k, v, do = _inputs(s, d, seed=4)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = (_j(x, jnp.bfloat16) for x in (q, k, v, do))
    want, vjp = jax.vjp(lambda a, b, c: jsa.simple_attention(
        a, b, c, scale, causal, True), jq, jk, jv)
    tq, tk, tv, tdo = (_t(x, torch.bfloat16) for x in (q, k, v, do))
    got = tsa.simple_attention_reference(tq, tk, tv, scale, causal)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float(), want.astype(jnp.float32)) < BF16_TOL
    gots = tsa.simple_attention_bwd_reference(tq, tk, tv, tdo, scale, causal)
    for g, w in zip(gots, vjp(jdo)):
        assert g.dtype == torch.bfloat16
        assert _rel_err(g.float(), w.astype(jnp.float32)) < BF16_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_gate_matches_reference_gate(dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dtype]
    for s in (64, 128, 256, 384, 512, 1024, 1152, 2048):
        for d in (32, 64, 96, 128, 192, 256, 384, 512):
            shape = (4, 16, s, d)
            assert tsa.supported(shape, dtype) == jsa.supported(shape, jdt), \
                (shape, dtype)


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 2, 128, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tsa.simple_attention_fwd_cuda(q, q, q, 0.125, True)
