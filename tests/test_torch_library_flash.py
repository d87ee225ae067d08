"""The library attention tier of the port (ops/hopper/flash_attention.py)
against JAX's own library kernel, on the CPU.

The reference's library tier is ``jax.experimental.pallas.ops.tpu.
flash_attention`` (TPU only); its plain reference ``mha_reference`` runs on
the CPU. The port's plain version (``library_flash_reference``, what the
op runs on a CPU tensor and what the card's kernels are held against) must
compute its function, causal masked top-left for any Sq and Skv, forward
and gradients. The shapes the library kernel refuses while it traces
(``jax.eval_shape`` of the kernel and of its gradient, at the block sizes
the reference picks) must be exactly those ``_library_refuses`` names. The
kernels themselves run only on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu.flash_attention import (
    BlockSizes, flash_attention as jax_library_flash, mha_reference)

from paddle_tpu_torch.ops.hopper import flash_attention as tfa
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

# (causal, Sq, Skv)
CASES = [(True, 128, 384), (True, 384, 128), (True, 256, 256),
         (False, 128, 256)]
# f32: the same function in another order. bf16: mha_reference rounds its
# logits, weights and output to bf16 (its products run at bf16 precision);
# the plain version keeps f32 and rounds once, at the end.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(sq, skv, d=64, seed=0):
    """q, k, v, dO [1, 2, S, D]; q carries the softmax scale 1/sqrt(D)
    (mha_reference's backward takes sm_scale=1 only), so that the logits
    have the unit spread they have in use."""
    rs = np.random.RandomState(seed)
    return ((rs.randn(1, 2, sq, d) / np.sqrt(d)).astype(np.float32),
            rs.randn(1, 2, skv, d).astype(np.float32),
            rs.randn(1, 2, skv, d).astype(np.float32),
            rs.randn(1, 2, sq, d).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,skv", CASES)
def test_plain_version_matches_mha_reference(causal, sq, skv, dname):
    """Forward and jax.grad (mha_reference's backward takes sm_scale=1)."""
    q, k, v, do = _inputs(sq, skv)
    jdt, tdt = getattr(jnp, dname), getattr(torch, dname)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))

    def jax_loss(q, k, v):
        o = mha_reference(q, k, v, None, causal=causal, sm_scale=1.0)
        return jnp.sum(o.astype(jnp.float32) * do)

    want_o = mha_reference(jq, jk, jv, None, causal=causal, sm_scale=1.0)
    want_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_(True)
                  for x in (q, k, v))
    o, lse = tfa.library_flash_reference(tq, tk, tv, 1.0, causal)
    grads = torch.autograd.grad(o.float(), (tq, tk, tv), torch.from_numpy(do))
    tol = TOL[dname]
    assert o.dtype == tdt and lse.dtype == torch.float32
    assert _rel(o.detach().float(), want_o.astype(jnp.float32)) < tol
    for g, w in zip(grads, want_grads):
        assert _rel(g.float(), w.astype(jnp.float32)) < tol


@pytest.mark.parametrize("causal,sq,skv", CASES)
def test_op_backward_is_the_plain_gradient(causal, sq, skv):
    """The registered op (CPU body: the plain forward and the lse backward
    of lse_backward.py) against torch autograd of the plain forward, on
    [B, S, H, D] as the dispatch hands them over; with Sq < Skv the kv rows
    past Sq get no gradient."""
    q, k, v, do = _inputs(sq, skv, seed=1)
    t = [torch.from_numpy(x).transpose(1, 2).contiguous().requires_grad_(True)
         for x in (q, k, v)]
    tdo = torch.from_numpy(do).transpose(1, 2)
    out = tfa.flash_attention(*t, causal=causal, scale=0.125)
    got = torch.autograd.grad(out, t, tdo)
    plain = [x.detach().transpose(1, 2).requires_grad_(True) for x in t]
    o, _ = tfa.library_flash_reference(*plain, 0.125, causal)
    want = torch.autograd.grad(o, plain, tdo.transpose(1, 2))
    assert _rel(out.detach().transpose(1, 2), o.detach()) < 1e-6
    for g, w in zip(got, want):
        assert _rel(g.transpose(1, 2), w) < 1e-5
    if causal and sq < skv:
        assert not got[1][:, sq:].any() and not got[2][:, sq:].any()


def _jax_refuses(sq, skv, d):
    """Whether JAX's library kernel, at the reference's block sizes
    (flash_attention.py:68-69), refuses to trace the forward or its
    gradient at this shape."""
    bq, bk = min(512, sq), min(512, skv)
    blocks = BlockSizes(
        block_q=bq, block_k_major=bk, block_k=bk, block_b=1,
        block_q_major_dkv=bq, block_k_major_dkv=bk, block_k_dkv=bk,
        block_q_dkv=bq, block_k_major_dq=bk, block_k_dq=bk, block_q_dq=bq)

    def f(q, k, v):
        return jax_library_flash(q, k, v, causal=True, sm_scale=0.1,
                                 block_sizes=blocks)

    q = jax.ShapeDtypeStruct((1, 2, sq, d), jnp.bfloat16)
    k = jax.ShapeDtypeStruct((1, 2, skv, d), jnp.bfloat16)
    try:
        jax.eval_shape(f, q, k, k)
        jax.eval_shape(jax.grad(
            lambda *a: f(*a).astype(jnp.float32).sum(), argnums=(0, 1, 2)),
            q, k, k)
    except (ValueError, NotImplementedError):
        return True
    return False


@pytest.mark.parametrize("sq,skv,d", [
    (128, 128, 64), (2048, 4096, 128), (4096, 1024, 128), (512, 384, 64),
    (640, 640, 128), (1024, 640, 128), (640, 1024, 128),
    (256, 256, 192), (1024, 1024, 192), (4096, 4096, 320),
    (128, 128, 384)])
def test_refusals_are_the_library_kernels(sq, skv, d):
    assert tfa._library_refuses(sq, skv, d) == _jax_refuses(sq, skv, d)


def test_dispatch_counts_a_refused_shape_as_the_reference_does():
    """S=640: JAX's 512-row blocks do not divide it; the reference's last
    tier counts the fallback and returns None (plain attention)."""
    before = tfa.dispatch_counts()
    q = torch.empty(1, 640, 2, 128, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, 1280, 2, 128, dtype=torch.bfloat16, device="meta")
    assert tfa._dispatch(q, k, k, True, None) is None
    assert tfa.dispatch_counts(before) == {
        ("attn.dispatch", "library_flash"): 1,
        ("attn.dispatch_fallback", "error"): 1}
