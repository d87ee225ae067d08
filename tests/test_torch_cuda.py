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
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

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
    before = tfa.dispatch_counts()
    tsa.reset_launch_counts()
    losses = [float(step(params, opt, (ids, ids))[2]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    L = cfg.num_layers
    assert tsa.LAUNCHES == {"simple_attention_fwd": 3 * L,
                            "simple_attention_bwd": 3 * L}
    assert set(tfa.dispatch_counts(before)) == {("attn.dispatch", "simple")}


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


# The library tier's kernels (blocked_flash.cu through its lf_* entry
# points) against its plain version: causal with Sq == Skv, Sq < Skv and
# Sq > Skv (top-left), and not causal. Where Sq < Skv the kv rows past Sq
# see no q row: their dk and dv are exactly zero.
@pytest.mark.parametrize("dtype,tol", _DTYPES)
@pytest.mark.parametrize("d", [64, 128, 256])
def test_library_flash_kernels_match_plain_versions(d, dtype, tol):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(d + 7)
    scale = 1.0 / np.sqrt(d)
    for causal, sq, skv in ((True, 384, 384), (True, 256, 512),
                            (True, 512, 256), (False, 256, 512)):
        q = _randn(gen, dtype, 2, 4, sq, d)
        k, v = (_randn(gen, dtype, 2, 4, skv, d) for _ in range(2))
        do = _randn(gen, dtype, 2, 4, sq, d)
        case = (causal, sq, skv)
        o, lse = tfa.library_flash_fwd_cuda(q, k, v, scale, causal)
        want_o, want_lse = tfa.library_flash_reference(q, k, v, scale,
                                                       causal)
        assert _rel_err(o, want_o) < tol, case
        assert _rel_err(lse, want_lse) < 1e-5, case
        dq, delta = tfa.library_flash_bwd_dq_cuda(q, k, v, want_o, want_lse,
                                                  do, scale, causal)
        want = tbf.lse_backward.bwd_reference(q, k, v, want_o, want_lse, do,
                                              scale, causal)
        assert _rel_err(dq, want[0]) < tol, case
        assert _rel_err(delta, (do.float() * want_o.float()).sum(-1)) < 1e-5
        dk, dv = tfa.library_flash_bwd_dkv_cuda(q, k, v, want_lse, delta, do,
                                                scale, causal)
        for g, w in zip((dk, dv), want[1:]):
            assert _rel_err(g, w) < tol, case
        if causal and sq < skv:
            assert not dk[:, :, sq:].any() and not dv[:, :, sq:].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,skv", [(1024, 4096), (4096, 1024)])
def test_library_flash_op_causal_cross_attention(sq, skv, dtype):
    """The op under autograd at [1, 8, Sq, Skv, 128], causal: o and every
    gradient against autograd of the plain version, and zeros in dk and dv
    past Sq."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(sq)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    q = _randn(gen, dtype, 1, sq, 8, 128)
    k, v = (_randn(gen, dtype, 1, skv, 8, 128) for _ in range(2))
    do = _randn(gen, dtype, 1, sq, 8, 128)
    tfa.reset_launch_counts()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=True)
    got = (out, *torch.autograd.grad(out, leaves, do))
    assert tfa.LAUNCHES == {"library_flash_fwd": 1, "library_flash_bwd_dq": 1,
                            "library_flash_bwd_dkv": 1}
    plain = [x.float().transpose(1, 2).requires_grad_(True)
             for x in (q, k, v)]
    o, _ = tfa.library_flash_reference(*plain, 1.0 / np.sqrt(128), True)
    want = (o.transpose(1, 2), *(g.transpose(1, 2) for g in
                                 torch.autograd.grad(
                                     o, plain, do.float().transpose(1, 2))))
    for g, w in zip(got, want):
        assert _rel_err(g, w) < tol
    if sq < skv:
        assert not got[2][:, sq:].any() and not got[3][:, sq:].any()


def test_blocked_flash_keeps_refusing_causal_cross_attention():
    _need_card()
    q = torch.zeros(1, 2, 128, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 256, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Sq == Skv"):
        tbf.blocked_flash_bwd_dq_cuda(q, k, k, q, q[..., 0].float(), q, 0.125,
                                      True)
    assert not tbf.supported((1, 2, 128, 64), 256, torch.bfloat16, True)


def test_layer_gpt_trains_through_the_library_kernels():
    """A small Layer GPT (D=64, S=256) in f32 on the card: its loss and
    gradients against the same model on the CPU, and each step launches
    the library tier's three kernels once a layer and no other attention
    kernel."""
    _need_card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=4, max_seq_len=256)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 256))
    out = {}
    paddle.seed(0)
    paddle.set_device("cpu")
    state = {k: v.numpy() for k, v in GPTForCausalLM(cfg).state_dict()
             .items()}
    for dev in ("cpu", "gpu:0"):
        paddle.set_device(dev)
        model = GPTForCausalLM(cfg)
        model.set_state_dict(state)
        for mod in _KERNEL_MODULES + (tfa,):
            mod.reset_launch_counts()
        before = tfa.dispatch_counts()
        t = paddle.to_tensor(ids)
        loss = model(t, t)
        loss.backward()
        out[dev] = (float(loss), {n: p.grad.numpy()
                                  for n, p in model.named_parameters()})
        if dev != "cpu":
            L = cfg.num_layers
            assert tfa.LAUNCHES == {n: L for n in tfa.LAUNCHES}
            assert not any(n for mod in _KERNEL_MODULES
                           for n in mod.LAUNCHES.values())
            assert tfa.dispatch_counts(before) == {
                ("nn.sdpa", "library_flash"): L}
    paddle.set_device("cpu")
    (lc, gc), (lg, gg) = out["cpu"], out["gpu:0"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for n, w in gc.items():
        assert np.abs(gg[n] - w).max() <= 1e-4 * np.abs(w).max(), n


def test_compiled_layer_gpt_step_launches_the_library_kernels():
    """The small Layer GPT's train step through jit.to_static (aot_eager,
    the backend the CPU tests use; chip_smoke.py phase 14 compiles with
    inductor): each compiled call launches the library tier's three
    kernels once a layer and no other attention kernel, the trace alone
    ticks nn.sdpa, and the losses equal eager steps' from one state."""
    _need_card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=4, max_seq_len=256)
    paddle.set_device("gpu:0")
    paddle.seed(0)
    state = GPTForCausalLM(cfg).state_dict()
    ids = paddle.to_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 256)))
    losses = {}
    for compiled in (False, True):
        model = GPTForCausalLM(cfg)
        model.set_state_dict(state)
        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())

        def step():
            loss = model(ids, ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        fn = paddle.jit.to_static(step, objs=[model, opt],
                                  backend="aot_eager") if compiled else step
        losses[compiled] = []
        for i in range(3):
            tfa.reset_launch_counts()
            before = tfa.dispatch_counts()
            losses[compiled].append(float(fn()))
            L = cfg.num_layers
            assert tfa.LAUNCHES == {n: L for n in tfa.LAUNCHES}
            ticks = tfa.dispatch_counts(before)
            if compiled:
                assert ticks == ({("nn.sdpa", "library_flash"): L}
                                 if i == 0 else {})
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-4)
    paddle.set_device("cpu")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_library_ops_fake_strides_equal_the_kernels(dtype):
    """Inductor trusts the fake (meta) implementation's strides: they must
    be the CUDA kernels' real ones, forward and backward."""
    _need_card()
    from torch._subclasses.fake_tensor import FakeTensorMode
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(2, 256, 3 * 4 * 64, generator=gen,
                      device="cuda").to(dtype)
    q, k, v = (x.reshape(2, 256, 4, 64).transpose(1, 2)
               for x in qkv.split(4 * 64, -1))
    do = torch.randn(2, 4, 256, 64, generator=gen, device="cuda").to(dtype)
    real = tfa.OP(q, k, v, 0.125, True)
    real += tuple(torch.ops.paddle_tpu_torch.library_flash_bwd(
        q, k, v, real[0], real[1], do, 0.125, True))
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fq, fk, fv, fdo = (mode.from_tensor(t) for t in (q, k, v, do))
        fake = tfa.OP(fq, fk, fv, 0.125, True)
        fake += tuple(torch.ops.paddle_tpu_torch.library_flash_bwd(
            fq, fk, fv, fake[0], fake[1], fdo, 0.125, True))
    assert [t.stride() for t in fake] == [t.stride() for t in real]
    assert [t.dtype for t in fake] == [t.dtype for t in real]


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
    before = tfa.dispatch_counts()
    for mod in _KERNEL_MODULES:
        mod.reset_launch_counts()
    losses = [float(step(params, opt, (ids, ids))[2]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    steps_layers = 3 * cfg.num_layers
    got = {n: c for mod in _KERNEL_MODULES for n, c in mod.LAUNCHES.items()}
    assert got == {n: launches.get(n, 0) * steps_layers for n in got}
    assert set(tfa.dispatch_counts(before)) == {("attn.dispatch", tier)}


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
    # every candidate has a kernel now, the library tier too
    assert all(t is not None and t > 0 and spread[n] >= 0
               for n, t in times.items())
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
    before = tfa.dispatch_counts()
    for mod in _KERNEL_MODULES:
        mod.reset_launch_counts()
    out = tfa.flash_attention_maybe(q, k, v, causal=True)
    want = tsa2.qblock_attention_reference(
        *(x.transpose(1, 2) for x in (q, k, v)), 0.125, True)
    assert _rel_err(out.transpose(1, 2), want) < 2e-2
    assert tfa.dispatch_counts(before) == {("attn.dispatch", "qblock"): 1}
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
        before = tfa.dispatch_counts()
        for mod in _KERNEL_MODULES:
            mod.reset_launch_counts()
        out = tfa.flash_attention_maybe(q, k, v, causal=True)
        assert out is not None and out.shape == q.shape
        (kernel,) = [kk for (_, kk) in tfa.dispatch_counts(before)]
        assert kernel != tat.PLAIN
        assert sum(c for mod in _KERNEL_MODULES
                   for c in mod.LAUNCHES.values()) == 1


# The eager API's flash_attn (chip_smoke.py phase 7a) at each path's
# attention shape, [B, S, H, D] bf16 causal: one dispatch to the path's tier,
# one launch of each of its kernels, forward and backward, and values against
# f32 autograd of plain causal attention on the same bf16 inputs.
@pytest.mark.parametrize("bshd,tier,kernels", [
    ((4, 1024, 16, 128), "simple",
     ("simple_attention_fwd", "simple_attention_bwd")),
    ((4, 2048, 8, 128), "causal_skip",
     ("causal_attention_fwd", "causal_attention_bwd")),
    ((2, 4096, 8, 128), "blocked",
     ("blocked_flash_fwd", "blocked_flash_bwd_dq", "blocked_flash_bwd_dkv")),
    ((2, 4096, 16, 64), "qblock",
     ("qblock_attention_fwd", "qblock_attention_bwd")),
], ids=["simple", "causal_skip", "blocked", "qblock"])
def test_eager_flash_attn_reaches_the_tier_kernels(bshd, tier, kernels):
    _need_card()
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu:0")
    paddle.seed(4)
    q, k, v = (paddle.randn(list(bshd), dtype="bfloat16") for _ in range(3))
    for t in (q, k, v):
        t.stop_gradient = False
    for mod in _KERNEL_MODULES:
        mod.reset_launch_counts()
    before = tfa.dispatch_counts()
    out = paddle.ops.extra.flash_attn(q, k, v, causal=True)
    out.backward()
    torch.cuda.synchronize()
    launches = {n: c for mod in _KERNEL_MODULES
                for n, c in mod.LAUNCHES.items()}
    assert launches == {n: int(n in kernels) for n in launches}
    assert tfa.dispatch_counts(before) == {("attn.dispatch", tier): 1}

    qf, kf, vf = (t._data.detach().float().requires_grad_(True)
                  for t in (q, k, v))
    s = bshd[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / np.sqrt(bshd[3])
    mask = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    p = torch.softmax(logits.masked_fill(~mask, -1e30), -1)
    want = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    want.sum().backward()
    for got, ref in ((out._data, want), (q.grad._data, qf.grad),
                     (k.grad._data, kf.grad), (v.grad._data, vf.grad)):
        assert _rel_err(got.detach(), ref.detach()) < 2e-2


# ---------------------------------------------------------------- serving
def _chip_smoke():
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serving_small_models_on_the_card():
    """chip_smoke.py phase 9a: tiny Llama (GQA) and tiny GPT in f32 from
    one state_dict each; DecodeSession's greedy ids on the card equal the
    CPU's, and a ContinuousBatchingSession with overlapping lifetimes on
    the card equals isolated DecodeSession runs there (but at a step whose
    top-2 logit margin is under 1e-4 of the logit scale)."""
    _need_card()
    import paddle_tpu_torch as paddle
    cs = _chip_smoke()
    run = cs.Run()
    try:
        cs.check_small_serving(run, paddle, torch)
    finally:
        paddle.set_device("cpu")
    assert not run.failures, run.failures


@pytest.mark.parametrize("s", [1, 5])
def test_cache_writes_at_the_capacity_clamp_on_the_card(s):
    """A write at len = C - 1 and len = C lands at C - s, as on the CPU
    (and as lax.dynamic_update_slice clamps): no index past the capacity,
    no device assert, the same attention output."""
    _need_card()
    from paddle_tpu_torch.inference import decode as tdec
    g = torch.Generator().manual_seed(0)
    b, c, h, hkv, d = 2, 16, 4, 2, 8
    q = torch.randn(b, s, h, d, generator=g)
    kn, vn = (torch.randn(b, s, hkv, d, generator=g) for _ in range(2))
    kbuf, vbuf = (torch.randn(b, c, hkv, d, generator=g) for _ in range(2))
    lens = torch.tensor([c - 1, c], dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        kb, vb = kbuf.clone().to(dev), vbuf.clone().to(dev)
        o, ln = tdec._cache_attention(q.to(dev), kn.to(dev), vn.to(dev),
                                      kb, vb, lens.to(dev))
        torch.cuda.synchronize()
        out[dev] = (o.cpu(), kb.cpu(), vb.cpu(), ln.cpu())
    assert _rel_err(out["cuda"][0], out["cpu"][0]) < 1e-5
    for got, want in zip(out["cuda"][1:], out["cpu"][1:]):
        assert torch.equal(got, want)
    assert torch.equal(out["cpu"][1][:, c - s:], kn)


def test_small_moe_gpt_on_the_card():
    """chip_smoke.py phase 10a: a small gpt_hybrid with 2 experts on the
    card (simple_attention's kernels) against the same params on the CPU:
    the loss, every gradient (the MoE leaves included), and the parameters
    after build_accum_steps with k=2 and one apply."""
    _need_card()
    cs = _chip_smoke()
    run = cs.Run()
    cs.check_small_moe(run, TH, GPTConfig, _KERNEL_MODULES + (tfa,), torch)
    assert not run.failures, run.failures


def test_small_bert_eval_forward_on_the_card():
    """chip_smoke.py phase 11a: a small BERT MLM in eval mode without a
    mask, f32, on the card (the library tier's kernels) against the CPU
    from one state_dict: the logits, the loss and every gradient."""
    _need_card()
    import paddle_tpu_torch as paddle
    cs = _chip_smoke()
    run = cs.Run()
    try:
        cs.check_small_bert(run, paddle, tfa, _KERNEL_MODULES + (tfa,),
                            torch)
    finally:
        paddle.set_device("cpu")
    assert not run.failures, run.failures


def test_f32_convolution_follows_the_precision_flag():
    """FLAGS_matmul_precision governs cuDNN's f32 convolutions: under
    "highest" an f32 Conv2D on the card is within 1e-5 of the CPU's (of the
    output's scale); under "default" (TF32) it is further off, which shows
    that the switch acts."""
    _need_card()
    import paddle_tpu_torch as paddle
    rng = np.random.RandomState(0)
    x = rng.randn(8, 64, 32, 32).astype(np.float32)
    w = rng.randn(64, 64, 3, 3).astype(np.float32)
    saved = paddle.get_flags(["FLAGS_matmul_precision"])
    out = {}
    try:
        for prec, dev in (("highest", "cpu"), ("highest", "gpu:0"),
                          ("default", "gpu:0")):
            paddle.set_flags({"FLAGS_matmul_precision": prec})
            paddle.set_device(dev)
            conv = paddle.nn.Conv2D(64, 64, 3, padding=1, bias_attr=False)
            conv.weight.set_value(w)
            out[prec, dev] = conv(paddle.to_tensor(x))._data.detach().cpu()
    finally:
        paddle.set_flags(saved)
        paddle.set_device("cpu")
    want = out["highest", "cpu"]
    f32 = _rel_err(out["highest", "gpu:0"], want)
    tf32 = _rel_err(out["default", "gpu:0"], want)
    assert f32 < 1e-5, f32
    assert tf32 > 10 * f32, (tf32, f32)


@pytest.mark.parametrize("shape", [(1, 4, 1, 1), (1, 4)])
def test_batch_norm_with_one_value_per_channel_on_the_card(shape):
    """Train-mode BatchNorm with one value a channel (torch's own call
    refuses it) on the card equals the CPU: the output (the bias), the
    input's gradient and both running buffers."""
    _need_card()
    import paddle_tpu_torch as paddle
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    out = {}
    try:
        for dev in ("cpu", "gpu:0"):
            paddle.set_device(dev)
            bn = (paddle.nn.BatchNorm2D if len(shape) == 4
                  else paddle.nn.BatchNorm1D)(4)
            bn.bias.set_value(np.linspace(-1, 1, 4).astype(np.float32))
            xt = paddle.to_tensor(x, stop_gradient=False)
            y = bn(xt)
            (y * paddle.to_tensor(np.arange(4, dtype=np.float32).reshape(
                (1, 4) + (1,) * (len(shape) - 2)))).sum().backward()
            out[dev] = [t.numpy() for t in (y, xt.grad, bn._mean,
                                            bn._variance)]
    finally:
        paddle.set_device("cpu")
    for got, want in zip(out["gpu:0"], out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.allclose(out["cpu"][3], 0.9)


def test_small_resnet_on_the_card():
    """chip_smoke.py phase 12a: resnet18 at B4 32x32 f32 on the card
    against the CPU from one state_dict (a train-mode B1 forward, then the
    logits, loss, every gradient and one Momentum step's parameters and
    BatchNorm buffers)."""
    _need_card()
    import paddle_tpu_torch as paddle
    cs = _chip_smoke()
    run = cs.Run()
    try:
        cs.check_small_resnet(run, paddle, torch)
    finally:
        paddle.set_device("cpu")
    assert not run.failures, run.failures


def test_forked_loader_workers_after_cuda_init():
    """Workers forked after the parent initialised CUDA build on the CPU;
    their batches land on the card and equal the single-process loader's
    (seeded shuffle), Tensor samples from ToTensor included."""
    _need_card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision import transforms
    from paddle_tpu_torch.vision.datasets import FakeData
    torch.zeros(1, device="cuda")
    ds = FakeData(size=24, image_shape=(8, 8, 3),
                  transform=transforms.ToTensor())
    try:
        paddle.set_device("gpu:0")
        sp = list(DataLoader(ds, batch_size=5, shuffle=True, seed=1))
        mp = list(DataLoader(ds, batch_size=5, shuffle=True, seed=1,
                             num_workers=2))
    finally:
        paddle.set_device("cpu")
    assert len(mp) == len(sp) == 5
    for a, b in zip(mp, sp):
        for x, y in zip(a, b):
            assert x._data.is_cuda and y._data.is_cuda
            assert torch.equal(x._data, y._data)


def test_async_checkpoint_snapshots_the_card_state_before_the_next_step(
        tmp_path):
    """A bf16 model with f32 masters and moments (AdamW multi_precision) on
    the card, saved with async_save while the write is held back; the
    optimizer then steps in place; the loaded tensors equal the pre-step
    values bit for bit, on the card, in their own dtypes."""
    _need_card()
    import threading
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import checkpoint as dc
    try:
        paddle.set_device("gpu:0")
        paddle.seed(0)
        net = paddle.nn.Linear(256, 256)
        net.bfloat16()
        opt = paddle.optimizer.AdamW(1e-2, parameters=net.parameters(),
                                     multi_precision=True)
        x = paddle.randn([8, 256]).astype("bfloat16")

        def step():
            net(x).astype("float32").mean().backward()
            opt.step()
            opt.clear_grad()
        step()
        state = {"model": net.state_dict(), "opt": opt.state_dict()}
        flat = {k: v for k, v in dc._flat(state).items()
                if hasattr(v, "_data")}
        dtypes = {v._data.dtype for v in flat.values()}
        assert {torch.bfloat16, torch.float32} <= dtypes
        before = {k: v._data.clone() for k, v in flat.items()}
        gate = threading.Event()
        real = dc.np.savez

        def held_savez(*a, **kw):
            gate.wait(30)
            return real(*a, **kw)
        dc.np.savez = held_savez
        try:
            th = dc.save_state_dict(state, str(tmp_path), async_save=True)
            step()
            torch.cuda.synchronize()
            gate.set()
            th.join()
        finally:
            dc.np.savez = real
        assert any(not torch.equal(v._data, before[k])
                   for k, v in flat.items())
        dc.load_state_dict(state, str(tmp_path))
        for k, v in flat.items():
            assert v._data.is_cuda and v._data.dtype == before[k].dtype, k
            assert torch.equal(v._data.view(-1).view(torch.uint8),
                               before[k].view(-1).view(torch.uint8)), k
    finally:
        paddle.set_device("cpu")


def test_capi_gpt_matches_eager_gpt_on_the_card():
    """chip_smoke.py phase 15b at a small width: the GPT written in
    paddle._C_ops (capi_gpt_loss) against eager_gpt_loss on the card, from
    one gpt_hybrid.init_params (seed 0), bf16: the loss within 1e-2, every
    gradient within 5e-2 of its leaf's scale, and each forward+backward
    launching each of simple_attention's two kernels once a layer."""
    _need_card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import _C_ops as C
    cs = _chip_smoke()
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=2, max_seq_len=256)
    pcfg = TH.ParallelConfig(param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16)
    tparams = TH.init_params(cfg, pcfg,
                             torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
    paddle.set_device("gpu:0")
    try:
        ids = paddle.to_tensor(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (2, 256)))
        runs = []
        for fn in (lambda p: cs.capi_gpt_loss(C, p, ids, cfg),
                   lambda p: cs.eager_gpt_loss(paddle, p, ids, cfg)):
            params = TH.eager_params_from_jax(
                {k: ({kk: vv.clone() for kk, vv in v.items()}
                     if isinstance(v, dict) else v.clone())
                 for k, v in tparams.items()}, device="cuda")
            tsa.reset_launch_counts()
            loss = fn(params)
            loss.backward()
            torch.cuda.synchronize()
            leaves = [params["wte"], params["blocks"]["qkv_w"],
                      params["blocks"]["fc2_w"]]
            runs.append((float(loss), [t.grad._data for t in leaves],
                         dict(tsa.LAUNCHES)))
        (capi, capi_g, capi_n), (eager, eager_g, eager_n) = runs
        assert abs(capi - eager) <= 1e-2, (capi, eager)
        for g, w in zip(capi_g, eager_g):
            assert _rel_err(g, w) <= 5e-2
        assert capi_n == eager_n == {"simple_attention_fwd": 2,
                                     "simple_attention_bwd": 2}
    finally:
        paddle.set_device("cpu")


def test_small_lstm_lm_on_the_card():
    """chip_smoke.py phase 15c's small copy of the PTB LSTM LM (vocab 50,
    hidden 32, dropout 0): the loss and every gradient on the card (cuDNN's
    LSTM) within 1e-5 of the CPU's, from one state_dict."""
    _need_card()
    import paddle_tpu_torch as paddle
    cs = _chip_smoke()
    run = cs.Run()
    try:
        cs.check_small_lstm(run, paddle, torch)
    finally:
        paddle.set_device("cpu")
    assert not run.failures, run.failures


def test_cuda_rng_state_round_trip_on_the_card():
    """get_cuda_rng_state/set_cuda_rng_state read and write the card's
    torch.Generator: a restore repeats the draws made after it."""
    _need_card()
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu:0")
    try:
        paddle.seed(3)
        states = paddle.get_cuda_rng_state()
        assert len(states) == torch.cuda.device_count()
        first = paddle.rand([64]).numpy()
        paddle.set_cuda_rng_state(states)
        np.testing.assert_array_equal(paddle.rand([64]).numpy(), first)
    finally:
        paddle.set_device("cpu")


def test_nccl_world1_collectives_on_the_card():
    """init_parallel_env over NCCL at world 1 on cuda:0, and each eager
    collective's world-1 value on a card tensor (chip_smoke.py phase 16a's
    checks)."""
    _need_card()
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    cs = _chip_smoke()
    run = cs.Run()
    paddle.set_device("gpu:0")
    try:
        cs.check_collectives(run, paddle, dist, torch)
    finally:
        dist.destroy_process_group()
        paddle.set_device("cpu")
    assert not run.failures, run.failures


def test_tiny_gpt_hybrid_distributed_step_on_the_card():
    """gpt_hybrid's data-parallel step at world 1 over NCCL on the card
    (ZeRO-1, gradient merge 2) against the single-device step on the CPU:
    f32, the same arithmetic in another order (1e-4 of the loss and of each
    leaf's scale, beside Adam's 0.1 lr a step on rounding noise)."""
    _need_card()
    import paddle_tpu_torch.distributed as dist
    import paddle_tpu_torch as paddle
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=128)
    pcfg = TH.ParallelConfig(dp=1, zero1=True, gradient_merge_steps=2,
                             remat=True, remat_policy="names",
                             param_dtype=torch.float32,
                             compute_dtype=torch.float32)
    start = TH.init_params(cfg, pcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 128)))

    def run(device):
        params = TH.params_from_jax(
            {k: ({kk: vv.numpy() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.numpy())
             for k, v in start.items()}, device=device)
        opt = TH.dp_adamw_init(params, pcfg) if dist.is_initialized() \
            else TH.adamw_init(params, pcfg)
        step = TH.build_train_step(cfg, pcfg)
        batch = (ids.to(device), ids.to(device))
        losses = [float(step(params, opt, batch)[2]) for _ in range(3)]
        return losses, [p.detach().float().cpu() for p in TH._leaves(params)]

    want_l, want_p = run("cpu")
    paddle.set_device("gpu:0")
    dist.init_parallel_env()
    try:
        assert dist.get_backend() == "nccl"
        tsa.reset_launch_counts()
        got_l, got_p = run("cuda")
    finally:
        dist.destroy_process_group()
        paddle.set_device("cpu")
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    for g, w in zip(got_p, want_p):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()) \
            + 3 * 0.1 * 3e-4
    L = cfg.num_layers
    assert tsa.LAUNCHES == {"simple_attention_fwd": 3 * 2 * L,
                            "simple_attention_bwd": 3 * 2 * L}


def test_tensor_parallel_primitives_world1_on_the_card():
    """The tensor- and sequence-parallel primitives at world 1 over NCCL on
    the card against their plain single-device forms, f32 and bf16, output
    and gradients (chip_smoke.py phase 17a's checks)."""
    _need_card()
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    cs = _chip_smoke()
    run = cs.Run()
    paddle.set_device("gpu:0")
    try:
        cs.check_tp_primitives(run, paddle, dist, torch)
    finally:
        dist.destroy_process_group()
        paddle.set_device("cpu")
    assert not run.failures, run.failures


def test_tiny_tp_sp_step_on_the_card():
    """gpt_hybrid's tp + sp step (the manual-tp block, the vocab-parallel
    embedding and head, ZeRO-1) at world 1 over NCCL on the card, with and
    without collective_matmul, against the single-device step on the CPU:
    f32, the same arithmetic in another order (1e-4 of the loss and of each
    leaf's scale, beside Adam's 0.1 lr a step on rounding noise); each step
    launches causal_attention's two kernels once a layer (S = 2048)."""
    _need_card()
    import paddle_tpu_torch.distributed as dist
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import collective as C
    cfg = GPTConfig(vocab_size=256, hidden_size=256, num_layers=2,
                    num_heads=2, max_seq_len=2048)
    fields = dict(remat=True, remat_policy="names",
                  param_dtype=torch.float32, compute_dtype=torch.float32)
    start = TH.init_params(cfg, TH.ParallelConfig(**fields),
                           torch.Generator().manual_seed(0), device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 2048)))

    def run(device, pcfg):
        params = TH.params_from_jax(
            {k: ({kk: vv.numpy() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.numpy())
             for k, v in start.items()}, device=device)
        opt = TH.dp_adamw_init(params, pcfg) if dist.is_initialized() \
            else TH.adamw_init(params, pcfg)
        step = TH.build_train_step(cfg, pcfg)
        batch = (ids.to(device), ids.to(device))
        losses = [float(step(params, opt, batch)[2]) for _ in range(3)]
        return losses, [p.detach().float().cpu() for p in TH._leaves(params)]

    want_l, want_p = run("cpu", TH.ParallelConfig(**fields))
    paddle.set_device("gpu:0")
    dist.init_parallel_env()
    staged = dict(C.HOST_STAGED)
    try:
        for cm in (False, True):
            tca.reset_launch_counts()
            got_l, got_p = run("cuda", TH.ParallelConfig(
                sp=True, collective_matmul=cm, **fields))
            np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
            for g, w in zip(got_p, want_p):
                assert float((g - w).abs().max()) <= \
                    1e-4 * float(w.abs().max()) + 3 * 0.1 * 3e-4
            assert tca.LAUNCHES == {"causal_attention_fwd": 3 * 2,
                                    "causal_attention_bwd": 3 * 2}
    finally:
        dist.destroy_process_group()
        paddle.set_device("cpu")
    assert dict(C.HOST_STAGED) == staged


def test_profiler_without_a_ready_step_keeps_every_kernel_row():
    """A Profiler without a scheduler warms its device window up before
    the recording's marker: the library kernels of the recorded steps each
    have their row, no launch of the recording lacks one, and the
    warm-up's own kernels are not in the recording."""
    _need_card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import profiler
    paddle.set_device("gpu:0")
    try:
        q = torch.randn(1, 1024, 8, 64, device="cuda",
                        dtype=torch.bfloat16).requires_grad_(True)
        x = paddle.Tensor(q)
        x.stop_gradient = False

        def step():
            paddle.nn.functional.scaled_dot_product_attention(
                x, x, x, is_causal=True).sum().backward()
            torch.cuda.synchronize()
        step()
        p = profiler.Profiler(targets=[profiler.ProfilerTarget.GPU])
        p.start()
        for _ in range(2):
            step()
            p.step()
        p.stop()
        rows = [s.name for s in p._all_spans() if s.pid == 1]
        assert p.device_launches_unrecorded == []
        for kernel in ("mma_online_fwd_kernel", "mma_dq_kernel",
                       "mma_dkv_kernel"):
            assert sum(kernel in r for r in rows) == 2, kernel
        assert len(rows) < 200    # the warm-up's thousands stay out
    finally:
        paddle.set_device("cpu")
