"""The port's Hopper kernels on the card: each kernel against its plain
PyTorch version, small train steps that must go through them, and the
attention autotuner's measurement.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import json

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.ops.hopper import autotune as tat
from paddle_tpu_torch.ops.hopper import blocked_flash as tbf
from paddle_tpu_torch.ops.hopper import causal_attention as tca
from paddle_tpu_torch.ops.hopper import flash_attention as tfa
from paddle_tpu_torch.ops.hopper import simple_attention as tsa
from paddle_tpu_torch.ops.hopper import simple_attention2 as tsa2

_KERNEL_MODULES = (tsa, tca, tbf, tsa2)


@pytest.fixture(autouse=True)
def _fresh_autotune_table(tmp_path, monkeypatch):
    """Dispatch consults the autotuner's table: each test gets an empty
    one in its own directory."""
    monkeypatch.setenv("PADDLE_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(tat, "_table", None)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


# f32: the same f32 arithmetic in another order, so a few ulps of the
# output scale. bf16: one bf16 step (2^-8) of the output, a few times over.
# bf16 and f16 run on the tensor cores (csrc/attention_mma.cuh), whose
# backward rounds P and dS to the input dtype before its products
# (tests/test_torch_mma_rounding.py pins that rounding against the
# reference); f32 runs the CUDA-core templates and holds 1e-4.
_DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2),
           (torch.float16, 1e-2)]


def _sizes(path_d, path_bhs, small):
    """(D, (B, H, S)) cases: every head dim at two small sizes, and the
    path's own shape at its head dim."""
    return [(d, bhs) for d in (64, 128, 256) for bhs in small] \
        + [(path_d, path_bhs)]


# simple_attention: S=320 is five 64-row tiles, not a multiple of 128; the
# path's shape is the flagship's.
@pytest.mark.parametrize("dtype,tol", _DTYPES)
@pytest.mark.parametrize("d,bhs", _sizes(128, (4, 16, 1024),
                                         ((2, 4, 256), (1, 3, 320))))
def test_kernels_match_plain_versions(d, bhs, dtype, tol):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = _qkv_views(gen, dtype, *bhs, d)
    do = _randn(gen, dtype, *bhs, d)
    scale = 1.0 / np.sqrt(d)
    for causal in (True, False):
        got = tsa.simple_attention_fwd_cuda(q, k, v, scale, causal)
        want = tsa.simple_attention_reference(q, k, v, scale, causal)
        assert _rel_err(got, want) < tol, causal
        gots = tsa.simple_attention_bwd_cuda(q, k, v, do, scale, causal)
        wants = tsa.simple_attention_bwd_reference(q, k, v, do, scale, causal)
        for g, w in zip(gots, wants):
            assert _rel_err(g, w) < tol, causal


def test_kernel_wrapper_refuses_unbuilt_head_dim():
    _need_card()
    q = torch.zeros(1, 2, 128, 384, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head dim 384"):
        tsa.simple_attention_fwd_cuda(q, q, q, 0.05, True)


def test_train_step_goes_through_the_kernels():
    _need_card()
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=128)
    pcfg = TH.ParallelConfig(remat=True, remat_policy="names",
                             param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16)
    params, opt, step = TH.setup(cfg, pcfg, seed=0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 128))).cuda()
    tfa.reset_dispatch_counts()
    tsa.reset_launch_counts()
    losses = [float(step(params, opt, (ids, ids))[2]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    L = cfg.num_layers
    assert tsa.LAUNCHES == {"simple_attention_fwd": 3 * L,
                            "simple_attention_bwd": 3 * L}
    assert set(tfa.DISPATCH_COUNTS) == {("attn.dispatch", "simple")}


def _randn(gen, dtype, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _qkv_views(gen, dtype, b, h, s, d):
    """q, k, v as the model hands them over: [B, H, S, D] views into one
    [B, S, 3*H*D] activation."""
    qkv = _randn(gen, dtype, b, s, 3 * h * d)
    return [x.reshape(b, s, h, d).transpose(1, 2)
            for x in qkv.split(h * d, dim=-1)]


# The forward (tensor cores for bf16/f16) with its lse, and the lse
# backward; the path's shape is the S=2048 rung's.
@pytest.mark.parametrize("dtype,tol", _DTYPES)
@pytest.mark.parametrize("d,bhs", _sizes(128, (4, 8, 2048),
                                         ((2, 4, 256), (1, 3, 320))))
def test_causal_attention_kernels_match_plain_versions(d, bhs, dtype, tol):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(d + 1)
    q, k, v = _qkv_views(gen, dtype, *bhs, d)
    do = _randn(gen, dtype, *bhs, d)
    scale = 1.0 / np.sqrt(d)
    o, lse = tca.causal_attention_fwd_cuda(q, k, v, scale)
    want_o, want_lse = tca.causal_attention_reference(q, k, v, scale)
    assert _rel_err(o, want_o) < tol
    assert lse.dtype == torch.float32 and _rel_err(lse, want_lse) < 1e-5
    gots = tca.causal_attention_bwd_cuda(q, k, v, want_o, want_lse, do,
                                         scale)
    wants = tca.causal_attention_bwd_reference(q, k, v, want_o, want_lse,
                                               do, scale)
    for g, w in zip(gots, wants):
        assert _rel_err(g, w) < tol


# The online forward and the lse backward (tensor cores for bf16/f16):
# causal at S=384 (six 64-row tiles, not a power of two; the plain
# version's blocks need multiples of 128), not causal, and cross-attention
# with Sq < Skv and Sq > Skv. The dq launch's delta = rowsum(dO * O) is held
# to f32 accuracy.
@pytest.mark.parametrize("dtype,tol", _DTYPES)
@pytest.mark.parametrize("d", [64, 128, 256])
def test_blocked_flash_kernels_match_plain_versions(d, dtype, tol):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(d + 2)
    scale = 1.0 / np.sqrt(d)
    for causal, sq, skv in ((True, 384, 384), (False, 256, 256),
                            (False, 128, 384), (False, 384, 128)):
        q = _randn(gen, dtype, 2, 4, sq, d)
        k, v = (_randn(gen, dtype, 2, 4, skv, d) for _ in range(2))
        do = _randn(gen, dtype, 2, 4, sq, d)
        o, lse = tbf.blocked_flash_fwd_cuda(q, k, v, scale, causal)
        want_o, want_lse = tbf.blocked_flash_reference(q, k, v, scale,
                                                       causal)
        assert _rel_err(o, want_o) < tol, (causal, sq, skv)
        assert _rel_err(lse, want_lse) < 1e-5, (causal, sq, skv)
        dq, delta = tbf.blocked_flash_bwd_dq_cuda(q, k, v, want_o, want_lse,
                                                  do, scale, causal)
        assert _rel_err(dq, tbf.blocked_flash_bwd_dq_reference(
            q, k, v, want_o, want_lse, do, scale, causal)) < tol
        assert _rel_err(delta, (do.float() * want_o.float()).sum(-1)) < 1e-5
        gots = tbf.blocked_flash_bwd_dkv_cuda(q, k, v, want_lse, delta, do,
                                              scale, causal)
        wants = tbf.blocked_flash_bwd_dkv_reference(q, k, v, want_o,
                                                    want_lse, do, scale,
                                                    causal)
        for g, w in zip(gots, wants):
            assert _rel_err(g, w) < tol, (causal, sq, skv)


def test_new_kernel_wrappers_refuse_causal_cross_attention():
    _need_card()
    q = torch.zeros(1, 2, 128, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 256, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Sq == Skv"):
        tbf.blocked_flash_fwd_cuda(q, k, k, 0.125, True)


# The rungs' tiers at a tiny width: S=2048 at D=64 takes causal_skip (nq=4),
# S=4096 at D=128 takes blocked (qblock's gate refuses it there), and
# S=1408 at D=64 takes qblock (the monolithic gate refuses it and
# causal_attention's strips need a multiple of 256).
@pytest.mark.parametrize("s,d,tier,launches", [
    (2048, 64, "causal_skip", {"causal_attention_fwd": 1,
                               "causal_attention_bwd": 1}),
    (4096, 128, "blocked", {"blocked_flash_fwd": 1,
                            "blocked_flash_bwd_dq": 1,
                            "blocked_flash_bwd_dkv": 1}),
    (1408, 64, "qblock", {"qblock_attention_fwd": 1,
                          "qblock_attention_bwd": 1})])
def test_long_context_step_goes_through_the_new_kernels(s, d, tier,
                                                        launches):
    _need_card()
    cfg = GPTConfig(vocab_size=256, hidden_size=2 * d, num_layers=2,
                    num_heads=2, max_seq_len=s)
    pcfg = TH.ParallelConfig(remat=True, remat_policy="names",
                             param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16)
    params, opt, step = TH.setup(cfg, pcfg, seed=0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, s))).cuda()
    tfa.reset_dispatch_counts()
    for mod in _KERNEL_MODULES:
        mod.reset_launch_counts()
    losses = [float(step(params, opt, (ids, ids))[2]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    steps_layers = 3 * cfg.num_layers
    got = {n: c for mod in _KERNEL_MODULES for n, c in mod.LAUNCHES.items()}
    assert got == {n: launches.get(n, 0) * steps_layers for n in got}
    assert set(tfa.DISPATCH_COUNTS) == {("attn.dispatch", tier)}


# An independent yardstick for the lse backward kernels: autograd of the
# plain forward (f32), not the plain backward they share their formula with.
# Both kernels and the plain backward sum in f32; 1e-5 of the gradient's
# scale leaves room for another summation order and nothing more.
@pytest.mark.parametrize("module", ["causal_attention", "blocked_flash"])
def test_lse_backward_kernels_match_autograd_of_the_plain_forward(module):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (_randn(gen, torch.float32, 1, 2, 256, 64)
                   for _ in range(4))
    if module == "causal_attention":
        o, lse = tca.causal_attention_fwd_cuda(q, k, v, 0.125)
        got = tca.causal_attention_bwd_cuda(q, k, v, o, lse, do, 0.125)
        plain = tca.causal_attention_reference
    else:
        o, lse = tbf.blocked_flash_fwd_cuda(q, k, v, 0.125, True)
        dq, delta = tbf.blocked_flash_bwd_dq_cuda(q, k, v, o, lse, do, 0.125,
                                                  True)
        got = (dq, *tbf.blocked_flash_bwd_dkv_cuda(q, k, v, lse, delta, do,
                                                   0.125, True))

        def plain(*a):
            return tbf.blocked_flash_reference(*a, True)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(plain(*leaves, 0.125)[0], leaves, do)
    for g, w in zip(got, want):
        assert _rel_err(g, w) < 1e-5


# S=384 and S=640: the plain versions run 3 and 5 q blocks of 128
# (_pick_bq); the path's shape is GPT-3 Medium's heads at S=4096, where
# _pick_bq gives 128 at D=64 only.
@pytest.mark.parametrize("dtype,tol", _DTYPES)
@pytest.mark.parametrize("d,bhs", _sizes(64, (2, 16, 4096),
                                         ((2, 4, 384), (1, 3, 640))))
def test_qblock_kernels_match_plain_versions(d, bhs, dtype, tol):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(d + 3)
    q, k, v = _qkv_views(gen, dtype, *bhs, d)
    do = _randn(gen, dtype, *bhs, d)
    scale = 1.0 / np.sqrt(d)
    for causal in (True, False):
        got = tsa2.qblock_attention_fwd_cuda(q, k, v, scale, causal)
        want = tsa2.qblock_attention_reference(q, k, v, scale, causal)
        assert _rel_err(got, want) < tol, causal
        gots = tsa2.qblock_attention_bwd_cuda(q, k, v, do, scale, causal)
        wants = tsa2.qblock_attention_bwd_reference(q, k, v, do, scale,
                                                    causal)
        for g, w in zip(gots, wants):
            assert _rel_err(g, w) < tol, causal


def test_autotune_measures_on_the_card_and_persists():
    _need_card()
    bshd = (1, 512, 2, 64)
    names = tat.candidates(bshd, 512, torch.bfloat16, True)
    winner = tat.measure(bshd, 512, torch.bfloat16, True)
    assert winner in names and winner != tat.PLAIN
    with open(tat._cache_path()) as f:
        entry = json.load(f)[tat._key(bshd, 512, torch.bfloat16, True)]
    assert entry["winner"] == winner
    times, spread = entry["timings_ms"], entry["spread_ms"]
    assert set(times) == set(spread) == set(names)
    assert times["library_flash"] is None
    assert all(t > 0 and spread[n] >= 0 for n, t in times.items()
               if n != "library_flash")
    tat._table = None
    assert tat.lookup(bshd, 512, torch.bfloat16, True) == winner


# A winner in the table (here one the static chain would not pick at this
# shape) is what flash_attention_maybe launches.
def test_dispatch_launches_the_autotune_winner():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (x.transpose(1, 2)
               for x in _qkv_views(gen, torch.bfloat16, 1, 2, 512, 64))
    tat._load_table()[tat._key(tuple(q.shape), 512, torch.bfloat16,
                               True)] = {"winner": "qblock"}
    tfa.reset_dispatch_counts()
    for mod in _KERNEL_MODULES:
        mod.reset_launch_counts()
    out = tfa.flash_attention_maybe(q, k, v, causal=True)
    want = tsa2.qblock_attention_reference(
        *(x.transpose(1, 2) for x in (q, k, v)), 0.125, True)
    assert _rel_err(out.transpose(1, 2), want) < 2e-2
    assert tfa.DISPATCH_COUNTS == {("attn.dispatch", "qblock"): 1}
    assert {n: c for mod in _KERNEL_MODULES
            for n, c in mod.LAUNCHES.items() if c} == \
        {"qblock_attention_fwd": 1}


# Plain attention timed fastest still leaves the call on a Hopper kernel:
# measure picks the fastest kernel, and an entry that names "xla" is no
# entry (the static chain's kernel takes the call).
def test_dispatch_launches_a_kernel_when_plain_attention_is_fastest(
        monkeypatch):
    _need_card()
    timed = tat._time_candidate
    monkeypatch.setattr(tat, "_time_candidate", lambda name, *a, **k: (
        [1e-9] if name == tat.PLAIN else timed(name, *a, **k)))
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (x.transpose(1, 2)
               for x in _qkv_views(gen, torch.bfloat16, 1, 2, 512, 64))
    key = tat._key(tuple(q.shape), 512, torch.bfloat16, True)
    for stale in (False, True):
        if stale:
            tat._load_table()[key] = {"winner": tat.PLAIN}
        else:
            tat.measure(tuple(q.shape), 512, torch.bfloat16, True)
            assert tat._table[key]["timings_ms"][tat.PLAIN] == 0.0
        tfa.reset_dispatch_counts()
        for mod in _KERNEL_MODULES:
            mod.reset_launch_counts()
        out = tfa.flash_attention_maybe(q, k, v, causal=True)
        assert out is not None and out.shape == q.shape
        (kernel,) = [kk for (_, kk) in tfa.DISPATCH_COUNTS]
        assert kernel != tat.PLAIN
        assert sum(c for mod in _KERNEL_MODULES
                   for c in mod.LAUNCHES.values()) == 1
