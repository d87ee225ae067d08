"""paddle_tpu_torch.ops.fused_ce.FusedLMCE against the reference
paddle_tpu.ops.fused_ce.fused_lm_ce: the loss and the gradients of x, w and
the token weights, for one chunk, for several padded chunks (t > 8192),
and for all-zero weights."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import fused_ce as jfc
from paddle_tpu_torch.ops import fused_ce as tfc
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()


def _inputs(t, v, h, zero_weights=False, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, h).astype(np.float32)
    w = (rng.randn(v, h) * 0.1).astype(np.float32)
    tgt = rng.randint(0, v, (t,)).astype(np.int32)
    wts = np.zeros(t, np.float32) if zero_weights else \
        (rng.rand(t) > 0.2).astype(np.float32)
    return x, w, tgt, wts


def _reference(x, w, tgt, wts):
    args = tuple(jnp.asarray(a) for a in (x, w, tgt, wts))
    loss = jfc.fused_lm_ce(*args)
    gx, gw, gm = jax.grad(jfc.fused_lm_ce, argnums=(0, 1, 3))(*args)
    return [np.asarray(a) for a in (loss, gx, gw, gm)]


def _port(x, w, tgt, wts):
    tx, tw, twts = (torch.from_numpy(a).requires_grad_(True)
                    for a in (x, w, wts))
    loss = tfc.fused_lm_ce(tx, tw, torch.from_numpy(tgt).long(), twts)
    grads = torch.autograd.grad(loss, (tx, tw, twts))
    return [loss.detach().numpy()] + [g.numpy() for g in grads]


# f32 on both sides, sums in another order: rounding-level agreement.
@pytest.mark.parametrize("t,v,h", [
    (64, 97, 32),       # one chunk
    (8200, 33, 16),     # t > cap: two padded chunks of 4224 rows
])
def test_loss_and_grads_match_reference(t, v, h):
    assert tfc._chunked(t) == jfc._chunked(t)
    want = _reference(*_inputs(t, v, h))
    got = _port(*_inputs(t, v, h))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())


def test_all_zero_weights_give_zero_loss_and_grads():
    inputs = _inputs(64, 97, 32, zero_weights=True)
    want = _reference(*inputs)
    got = _port(*inputs)
    assert float(got[0]) == float(want[0]) == 0.0
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
        assert not np.any(g)


def test_bf16_inputs_keep_f32_logits():
    # bf16 x and w: the logits are f32 products of bf16 values (the
    # reference's preferred_element_type), so the loss matches the
    # reference to f32 rounding and dx/dw come back in bf16.
    x, w, tgt, wts = _inputs(256, 97, 32, seed=1)
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
             jnp.asarray(tgt), jnp.asarray(wts))
    want = float(jfc.fused_lm_ce(*jargs))
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    tw = torch.from_numpy(w).bfloat16().requires_grad_(True)
    loss = tfc.fused_lm_ce(tx, tw, torch.from_numpy(tgt).long(),
                           torch.from_numpy(wts))
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5)
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    assert gx.dtype == gw.dtype == torch.bfloat16
