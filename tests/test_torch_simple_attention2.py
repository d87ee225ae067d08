"""paddle_tpu_torch.ops.hopper.simple_attention2 against the reference Pallas
kernels (paddle_tpu.ops.pallas.simple_attention2, qblock_attention) run in
interpret mode on the CPU: the plain forward and backward the port keeps
beside its Hopper kernels, one q block and several, the registered op's
residuals and CPU autograd, and the gate. The kernels themselves are held
against these plain versions on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import simple_attention2 as jsa2
from paddle_tpu_torch.ops.hopper import simple_attention2 as tsa2
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

B, H = 1, 2


def _inputs(s, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, s, d).astype(np.float32) for _ in range(4)]


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
_DT = {"float32": (torch.float32, jnp.float32, F32_TOL),
       "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _reference(q, k, v, do, scale, causal, jdt):
    """The reference op in interpret mode: its output and jax.grad's
    (dq, dk, dv) through its custom_vjp."""
    out, vjp = jax.vjp(lambda a, b, c: jsa2.qblock_attention(
        a, b, c, scale, causal, True), *(_j(x, jdt) for x in (q, k, v)))
    return (out, *vjp(_j(do, jdt)))


def _check(s, d, causal, dtype, seed):
    tdt, jdt, tol = _DT[dtype]
    q, k, v, do = _inputs(s, d, seed=seed)
    scale = 1.0 / np.sqrt(d)
    want = _reference(q, k, v, do, scale, causal, jdt)
    tq, tk, tv, tdo = (_t(x, tdt) for x in (q, k, v, do))
    got = (tsa2.qblock_attention_reference(tq, tk, tv, scale, causal),
           *tsa2.qblock_attention_bwd_reference(tq, tk, tv, tdo, scale,
                                                causal))
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and tuple(g.shape) == (B, H, s, d), name
        assert _rel_err(g.float(), w.astype(jnp.float32)) < tol, name


# One q block: _pick_bq gives bq = S at these lengths.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_plain_versions_match_interpret_kernels(d, causal, dtype):
    assert jsa2._pick_bq(256, d, 4) == 256
    _check(256, d, causal, dtype, seed=d)


# Several q blocks: bq forced to 128 on both sides, so that the reference
# sums dk and dv across its sequential q-block grid and the plain version
# across its loop.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,d,causal", [(256, 64, True), (512, 128, True),
                                        (512, 64, False)])
def test_plain_versions_match_interpret_kernels_across_q_blocks(
        monkeypatch, s, d, causal, dtype):
    for mod in (jsa2, tsa2):
        monkeypatch.setattr(mod, "_pick_bq", lambda *a, **kw: 128)
    _check(s, d, causal, dtype, seed=s + d)


def test_plain_backward_matches_autograd_of_plain_forward(monkeypatch):
    monkeypatch.setattr(tsa2, "_pick_bq", lambda *a, **kw: 128)
    q, k, v, do = (_t(x) for x in _inputs(384, 64, seed=2))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tsa2.qblock_attention_reference(*leaves, 0.125, True)
    want = torch.autograd.grad(out, leaves, do)
    got = tsa2.qblock_attention_bwd_reference(q, k, v, do, 0.125, True)
    for g, w in zip(got, want):
        assert _rel_err(g, w) < F32_TOL


def test_registered_op_saves_q_k_v_only_and_runs_the_plain_backward():
    q, k, v, do = (_t(x) for x in _inputs(256, 64, seed=3))
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tsa2.qblock_attention(*qkv, 0.125, True)
    # the residuals the autograd node holds: exactly q, k and v (_fwd :140)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3
    for t, x in zip(saved, qkv):
        assert t.data_ptr() == x.data_ptr() and t.shape == x.shape
    np.testing.assert_array_equal(
        out.detach(), tsa2.qblock_attention_reference(q, k, v, 0.125, True))
    got = torch.autograd.grad(out, qkv, do)
    want = tsa2.qblock_attention_bwd_reference(q, k, v, do, 0.125, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_pick_bq_and_gate_match_reference(dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dtype]
    item = 2 if dtype != torch.float32 else 4
    for s in range(128, 8192 + 1, 128):
        for d in (64, 128, 192, 256):
            assert tsa2._pick_bq(s, d, item) == jsa2._pick_bq(s, d, item), \
                (s, d, item)
            shape = (2, 16, s, d)
            assert tsa2.supported(shape, dtype) == \
                jsa2.supported(shape, jdt), (shape, dtype)
    # the path's shape: GPT-3 Medium's heads at S=4096 take bq=128
    assert tsa2._pick_bq(4096, 64, 2) == 128


def test_op_refuses_shapes_without_a_q_block():
    q = torch.zeros(1, 2, 8192, 128)
    with pytest.raises(ValueError, match="no q block"):
        tsa2.qblock_attention(q, q, q, 0.125, True)


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 256, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tsa2.qblock_attention_fwd_cuda(q, q, q, 0.125, True)
    with pytest.raises(ValueError, match="CUDA"):
        tsa2.qblock_attention_bwd_cuda(q, q, q, q, 0.125, True)
