"""Head dims above 256, and the library tier's 192 and 320: the plain
versions the port keeps beside its runtime-D Hopper kernels
(``csrc/attention_wide.cuh``) against the reference's Pallas kernels run in
interpret mode on the CPU (the four kernel families at D = 384 and 512) and
against the reference's plain attention (the library tier); the port's
static dispatch chain against the reference's at those dims; and the head
dims the kernels' wrappers admit against the reference's gates. The
kernels themselves are held against these plain versions on the card by
``chip_smoke.py`` phase 23a."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import blocked_flash as jbf
from paddle_tpu.ops.pallas import causal_attention as jca
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import simple_attention as jsa
from paddle_tpu.ops.pallas import simple_attention2 as jsa2
from paddle_tpu_torch._testing import share_the_cores_fixture
from paddle_tpu_torch.ops.hopper import _launch
from paddle_tpu_torch.ops.hopper import blocked_flash as tbf
from paddle_tpu_torch.ops.hopper import causal_attention as tca
from paddle_tpu_torch.ops.hopper import flash_attention as tfa
from paddle_tpu_torch.ops.hopper import simple_attention as tsa
from paddle_tpu_torch.ops.hopper import simple_attention2 as tsa2

_share_the_cores = share_the_cores_fixture()

B, H = 1, 2
# as the kernel files' tests: f32 the same arithmetic in another order; bf16
# a few of bf16's 2^-8 steps of the output scale
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (family, D, S, dtype, causal): each family at both dims, bf16 and f32,
# S = 128 and 256, causal and not (causal_attention is causal only, and its
# reference needs S to be a multiple of 256)
CASES = [
    ("simple", 384, 128, "float32", True),
    ("simple", 512, 256, "bfloat16", False),
    ("qblock", 384, 256, "bfloat16", True),
    ("qblock", 512, 128, "float32", False),
    ("causal", 384, 256, "float32", True),
    ("causal", 512, 256, "bfloat16", True),
    ("blocked", 384, 128, "bfloat16", False),
    ("blocked", 512, 256, "float32", True),
]


def _inputs(s, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, s, d).astype(np.float32) for _ in range(4)]


def _rel_err(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _reference(family, q, k, v, do, scale, causal):
    """o and (dq, dk, dv) of the reference's Pallas kernels in interpret
    mode, the backward from the forward's own residuals."""
    if family == "blocked":
        bq, bkv = jbf._blocks_for(q.shape[2], k.shape[2])
        o, lse = jbf._fwd(q, k, v, scale, causal, True, bq, bkv)
        dq = jbf._bwd_dq(q, k, v, o, lse, do, scale, causal, True, bq, bkv)
        dk, dv = jbf._bwd_dkv(q, k, v, o, lse, do, scale, causal, True, bq,
                              bkv)
        return o, (dq, dk, dv)
    fn = {"simple": lambda *a: jsa.simple_attention(*a, scale, causal, True),
          "qblock": lambda *a: jsa2.qblock_attention(*a, scale, causal, True),
          "causal": lambda *a: jca.causal_attention(*a, scale, True)}[family]
    o, vjp = jax.vjp(fn, q, k, v)
    return o, vjp(do)


def _port(family, q, k, v, do, scale, causal):
    """o and (dq, dk, dv) of the port's plain versions."""
    if family == "simple":
        return (tsa.simple_attention_reference(q, k, v, scale, causal),
                tsa.simple_attention_bwd_reference(q, k, v, do, scale,
                                                   causal))
    if family == "qblock":
        return (tsa2.qblock_attention_reference(q, k, v, scale, causal),
                tsa2.qblock_attention_bwd_reference(q, k, v, do, scale,
                                                    causal))
    if family == "causal":
        o, lse = tca.causal_attention_reference(q, k, v, scale)
        return o, tca.causal_attention_bwd_reference(q, k, v, o, lse, do,
                                                     scale)
    o, lse = tbf.blocked_flash_reference(q, k, v, scale, causal)
    res = (q, k, v, o, lse, do, scale, causal)
    return o, (tbf.blocked_flash_bwd_dq_reference(*res),
               *tbf.blocked_flash_bwd_dkv_reference(*res))


@pytest.mark.parametrize(
    "family,d,s,dname,causal", CASES,
    ids=[f"{c[0]}-d{c[1]}-s{c[2]}-{c[3]}-{'causal' if c[4] else 'full'}"
         for c in CASES])
def test_plain_versions_match_interpret_kernels(family, d, s, dname,
                                                causal):
    """The port's plain forward and backward of each family against the
    reference's Pallas kernels in interpret mode: o, dq, dk and dv."""
    arrays = _inputs(s, d, seed=d + s)
    scale = 1.0 / math.sqrt(d)
    jdt, tdt = getattr(jnp, dname), getattr(torch, dname)
    want_o, want_g = _reference(family, *(jnp.asarray(x).astype(jdt)
                                          for x in arrays), scale, causal)
    got_o, got_g = _port(family, *(torch.from_numpy(x).to(tdt)
                                   for x in arrays), scale, causal)
    for name, g, w in zip(("o", "dq", "dk", "dv"), (got_o, *got_g),
                          (want_o, *want_g)):
        assert g.dtype == tdt and tuple(g.shape) == (B, H, s, d), name
        err = _rel_err(g.float(), w.astype(jnp.float32))
        assert err < TOL[dname], (name, err)


@pytest.mark.parametrize("d", [192, 320, 384])
def test_library_tier_matches_reference_plain_attention(d):
    """The library tier's plain path (its op on CPU tensors, forward and
    autograd) against the reference's plain attention at Skv = 256, f32,
    causal: out and the gradients of q, k and v."""
    from paddle_tpu.nn.functional.attention import _xla_attention
    s = 256
    q, k, v, do = (x.transpose(0, 2, 1, 3) for x in _inputs(s, d, seed=d))
    want, vjp = jax.vjp(lambda a, b, c: _xla_attention(a, b, c, causal=True),
                        *(jnp.asarray(x) for x in (q, k, v)))
    want_g = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    out.backward(torch.from_numpy(do))
    assert _rel_err(out.detach(), want) < TOL["float32"]
    for g, w in zip((tq.grad, tk.grad, tv.grad), want_g):
        assert _rel_err(g, w) < TOL["float32"]


def _reference_tier(bhsd, skv, dtype, causal):
    """The reference's static chain (flash_attention_maybe, past the library
    gate and without an autotune entry), tier by tier."""
    same_len = bhsd[2] == skv
    if same_len and jsa.supported(bhsd, dtype):
        return "simple"
    if causal and same_len and jca.supported(bhsd, dtype):
        return "causal_skip"
    if same_len and jsa2.supported(bhsd, dtype):
        return "qblock"
    if jbf.supported(bhsd, skv, dtype, causal):
        return "blocked"
    return "library_flash"


@pytest.mark.parametrize("d", [384, 512])
def test_dispatch_chain_picks_the_reference_tier(d):
    """At D = 384 and 512 the port's static chain picks the reference's
    tier for S in 512..4096, bf16 and f32, causal and not (H48, as a
    GPT-3-sized head count), and the library gate agrees."""
    picked = {}
    for s in (512, 1024, 2048, 4096):
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
            for causal in (True, False):
                bhsd = (1, 48, s, d)
                want = _reference_tier(bhsd, s, jdt, causal)
                assert tfa.static_tier(bhsd, s, tdt, causal) == want
                assert tfa.supported_shape((1, s, 48, d), s, tdt) == \
                    jfa.supported_shape((1, s, 48, d), s, jdt)
                picked[(s, tdt, causal)] = want
    # bf16 causal: the monolithic tier up to S = 1024, blocked above
    assert [picked[(s, torch.bfloat16, True)] for s in (512, 1024, 2048,
                                                        4096)] == \
        ["simple", "simple", "blocked", "blocked"]


def test_launch_head_dim_rule_is_the_gates():
    """_launch's head-dim rule admits exactly the dims some gate admits:
    the four tiers' d % 128 == 0 or 64, and the library tier's d % 64 == 0
    (at shapes each gate takes otherwise)."""
    for d in range(16, 1100, 16):
        tiers = (jsa.supported((1, 1, 128, d), jnp.bfloat16)
                 or jca.supported((1, 1, 256, d), jnp.bfloat16)
                 or jsa2.supported((1, 1, 128, d), jnp.bfloat16)
                 or jbf.supported((1, 1, 128, d), 128, jnp.bfloat16))
        library = jfa.supported_shape((1, 128, 1, d), 128, jnp.bfloat16)
        assert _launch.head_dim_ok(d) == (tiers or library), d
    assert not _launch.head_dim_ok(0)

