#!/usr/bin/env python3
"""Drives the PyTorch port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card: its name and power limit; builds every Hopper kernel of the
     port from the sources in this checkout (nvcc, sm_90a, one process per
     source, all started together);
  2. each kernel against its plain PyTorch version on the card, with q, k
     and v laid out as the step hands them over: simple_attention at the
     flagship's shape (B4 H16 S1024 D128, bf16 causal and not, f32);
     causal_attention at the S=2048 rung's (B4 H8 S2048 D128, bf16 and
     f32); blocked_flash at the S=4096 rung's (B2 H8 S4096 D128: bf16
     causal and not, f32, and cross-attention Sq=1024 Skv=4096);
     qblock_attention at the GPT-3 Medium layout's (B2 H16 S4096 D64: bf16
     causal and not, f32) and at the S=2048 rung's, non-causal (the
     non-causal middle tier);
  3. a small model on the card (kernels) against the same model on the CPU
     (plain path): the loss and gradients agree;
  4. the paths, each through the port's setup() and step with random
     weights from a seed (PATHS): the GPT-1.3B flagship step (h2048, 24
     layers, 16 heads, vocab 50304, B4 S1024, bf16, remat "names", fused
     CE), then the reference bench's long-context rungs (bench.py:301-333),
     the 350M-class model (h1024, 24 layers, 8 heads of 128) at B4 S2048
     and at B2 S4096, and the same width at GPT-3 Medium's published head
     layout (16 heads of 64; Brown et al. 2020, Table 2.1) at B2 S4096,
     which the reference's gates send to qblock_attention. Every count is
     zeroed just before a path and read just after: each step must launch
     each kernel of the path's tier 24
     times and no other attention kernel, with dispatch only to that tier,
     a finite loss near ln(vocab) at step 0 and a loss that falls. Prints
     ms/step, tokens/s, MFU, peak memory and where the time goes;
  5. each kernel timed at its path's shape beside its plain version, its
     bound on this card and one PyTorch library call that computes the same
     function (scaled_dot_product_attention, never used by the port);
  6. the attention autotuner: at each path's attention shape (bf16,
     causal) autotune.measure times every candidate's forward+backward (the
     median of 5 windows, and their spread); the winner must be the
     fastest Hopper kernel, plain attention ("xla") timed beside them but
     never the winner, every ported tier finite and library_flash None (no
     Hopper kernel); the persisted table, reloaded, must give the same
     winner, decide() too, and one flash_attention_maybe call must then
     launch the winner's kernel.
The whole run keeps the autotuner's table in a fresh temporary
PADDLE_TPU_CACHE_DIR, empty until phase 6, with FLAGS_attn_autotune at its
default: phases 2-5 run the configuration a user gets on a new checkout.
Prints the card line, then one {"kernels": [...]} line, then as the last
line {"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12     # H100 SXM, dense bf16 tensor cores
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3
TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # max |err| / max |plain|

# (label, GPTConfig fields, B, S, dispatch tier, the kernels each layer
#  launches once a step, warm-up steps, timed steps)
PATHS = (
    ("flagship", dict(vocab_size=50304, hidden_size=2048, num_layers=24,
                      num_heads=16, max_seq_len=1024), 4, 1024, "simple",
     ("simple_attention_fwd", "simple_attention_bwd"), 2, 6),
    ("train_s2048", dict(vocab_size=50304, hidden_size=1024, num_layers=24,
                         num_heads=8, max_seq_len=2048), 4, 2048,
     "causal_skip", ("causal_attention_fwd", "causal_attention_bwd"), 1, 3),
    ("train_s4096", dict(vocab_size=50304, hidden_size=1024, num_layers=24,
                         num_heads=8, max_seq_len=4096), 2, 4096, "blocked",
     ("blocked_flash_fwd", "blocked_flash_bwd_dq", "blocked_flash_bwd_dkv"),
     1, 3),
    ("train_s4096_d64", dict(vocab_size=50304, hidden_size=1024,
                             num_layers=24, num_heads=16, max_seq_len=4096),
     2, 4096, "qblock", ("qblock_attention_fwd", "qblock_attention_bwd"),
     1, 3),
)

# (kernel, module stem (the reference's and the port's), line of its
#  pl.pallas_call in the reference, the
#  path whose shape it is held and timed at, its outputs, the products its
#  function needs, the [B, H, S, D] tensors it must move, whether it moves
#  an lse, the library call of the same function)
# simple_attention2's kernels are simple_attention.cu's; that file's header
# says why.
CUDA_SOURCE = {"simple_attention2": "simple_attention"}

KERNELS = (
    ("simple_attention_fwd", "simple_attention", 113, "flagship", ("o",),
     2, 4, False, "fwd"),
    ("simple_attention_bwd", "simple_attention", 130, "flagship",
     ("dq", "dk", "dv"), 5, 7, False, "bwd"),
    ("causal_attention_fwd", "causal_attention", 164, "train_s2048",
     ("o", "lse"), 2, 4, True, "fwd"),
    ("causal_attention_bwd", "causal_attention", 184, "train_s2048",
     ("dq", "dk", "dv"), 5, 8, True, "bwd"),
    ("blocked_flash_fwd", "blocked_flash", 210, "train_s4096", ("o", "lse"),
     2, 4, True, "fwd"),
    ("blocked_flash_bwd_dq", "blocked_flash", 326, "train_s4096", ("dq",),
     3, 6, True, "bwd"),
    ("blocked_flash_bwd_dkv", "blocked_flash", 362, "train_s4096",
     ("dk", "dv"), 4, 7, True, "bwd"),
    ("qblock_attention_fwd", "simple_attention2", 131, "train_s4096_d64",
     ("o",), 2, 4, False, "fwd"),
    ("qblock_attention_bwd", "simple_attention2", 151, "train_s4096_d64",
     ("dq", "dk", "dv"), 5, 7, False, "bwd"),
)

# Phase 2's cases: (source stem, path of the shape, Sq (None: the path's S),
# dtype name, causal). The first bf16 causal case of each source at its
# path's shape gives the kernels' max_abs_err.
CHECKS = (
    ("simple_attention", "flagship", None, "bfloat16", True),
    ("simple_attention", "flagship", None, "bfloat16", False),
    ("simple_attention", "flagship", None, "float32", True),
    ("causal_attention", "train_s2048", None, "bfloat16", True),
    ("causal_attention", "train_s2048", None, "float32", True),
    ("blocked_flash", "train_s4096", None, "bfloat16", True),
    ("blocked_flash", "train_s4096", None, "bfloat16", False),
    ("blocked_flash", "train_s4096", 1024, "bfloat16", False),
    ("blocked_flash", "train_s4096", None, "float32", True),
    ("simple_attention2", "train_s4096_d64", None, "bfloat16", True),
    ("simple_attention2", "train_s4096_d64", None, "bfloat16", False),
    ("simple_attention2", "train_s4096_d64", None, "float32", True),
    ("simple_attention2", "train_s2048", None, "bfloat16", False),
)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10):
    """Mean device time of fn() over reps calls, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_shape(label):
    """B, H, S, D of a path's attention."""
    _, fields, batch, seq, *_ = next(p for p in PATHS if p[0] == label)
    heads = fields["num_heads"]
    return batch, heads, seq, fields["hidden_size"] // heads


def bound(kernel):
    """Least time (ms) of a kernel at its path's shape (bf16) on this card
    and what sets it: its products of 2 * pairs * D operations over the
    bf16 peak, against its bytes (each input read once, each output
    written once) over HBM. Causal pairs (i, j <= i) only."""
    name, _, _, label, _, products, tensors, lse, _ = kernel
    b, h, s, d = attention_shape(label)
    ops_ms = products * 2 * b * h * s * (s + 1) // 2 * d \
        / PEAK_BF16_FLOPS * 1e3
    nbytes = tensors * b * h * s * d * 2 + (b * h * s * 4 if lse else 0)
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms > bytes_ms else "bytes")


def max_err(got, want):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    return err, err / float(want.abs().max())


class Run:
    def __init__(self):
        self.failures = []

    def check(self, ok, what):
        print(("ok   " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)


def path_inputs(gen, dtype, torch, shape, sq=None):
    """q, k, v and dO as a model hands them to the kernels: [B, H, S, D]
    views into one [B, S, 3*H*D] qkv activation, or for cross-attention
    (sq given) q a view of a [B, Sq, H*D] activation and k, v views of one
    [B, S, 2*H*D]."""
    b, h, s, d = shape
    sq = sq or s

    def heads(x, n):
        return x.reshape(b, n, h, d).transpose(1, 2)

    def randn(*size):
        return torch.randn(*size, generator=gen, device="cuda").to(dtype)

    if sq == s:
        q, k, v = (heads(x, s) for x in randn(b, s, 3 * h * d).split(h * d, -1))
    else:
        q = heads(randn(b, sq, h * d), sq)
        k, v = (heads(x, s) for x in randn(b, s, 2 * h * d).split(h * d, -1))
    return q, k, v, heads(randn(b, sq, h * d), sq)


def kernel_calls(mods, source, q, k, v, do, scale, causal):
    """{kernel: (launch, plain version)} of one source's kernels on these
    inputs. A backward takes the forward kernel's own o and lse, as the
    step hands them over."""
    sa, ca, bf, sa2 = mods
    if source == "simple_attention2":
        return {
            "qblock_attention_fwd": (
                lambda: sa2.qblock_attention_fwd_cuda(q, k, v, scale, causal),
                lambda: sa2.qblock_attention_reference(q, k, v, scale,
                                                       causal)),
            "qblock_attention_bwd": (
                lambda: sa2.qblock_attention_bwd_cuda(q, k, v, do, scale,
                                                      causal),
                lambda: sa2.qblock_attention_bwd_reference(q, k, v, do, scale,
                                                           causal))}
    if source == "simple_attention":
        return {
            "simple_attention_fwd": (
                lambda: sa.simple_attention_fwd_cuda(q, k, v, scale, causal),
                lambda: sa.simple_attention_reference(q, k, v, scale,
                                                      causal)),
            "simple_attention_bwd": (
                lambda: sa.simple_attention_bwd_cuda(q, k, v, do, scale,
                                                     causal),
                lambda: sa.simple_attention_bwd_reference(q, k, v, do, scale,
                                                          causal))}
    if source == "causal_attention":
        o, lse = ca.causal_attention_fwd_cuda(q, k, v, scale)
        res = (q, k, v, o, lse, do, scale)
        return {
            "causal_attention_fwd": (
                lambda: ca.causal_attention_fwd_cuda(q, k, v, scale),
                lambda: ca.causal_attention_reference(q, k, v, scale)),
            "causal_attention_bwd": (
                lambda: ca.causal_attention_bwd_cuda(*res),
                lambda: ca.causal_attention_bwd_reference(*res))}
    o, lse = bf.blocked_flash_fwd_cuda(q, k, v, scale, causal)
    res = (q, k, v, o, lse, do, scale, causal)
    return {
        "blocked_flash_fwd": (
            lambda: bf.blocked_flash_fwd_cuda(q, k, v, scale, causal),
            lambda: bf.blocked_flash_reference(q, k, v, scale, causal)),
        "blocked_flash_bwd_dq": (
            lambda: bf.blocked_flash_bwd_dq_cuda(*res),
            lambda: bf.blocked_flash_bwd_dq_reference(*res)),
        "blocked_flash_bwd_dkv": (
            lambda: bf.blocked_flash_bwd_dkv_cuda(*res),
            lambda: bf.blocked_flash_bwd_dkv_reference(*res))}


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_kernels(run, mods, torch):
    """Phase 2: every kernel against its plain version on the card, each
    output (lse included) within the dtype's tolerance of the plain
    output's scale (an lse within the f32 one). Returns the worst absolute
    error of each kernel in its bf16 causal case at its path's shape."""
    outputs = {k[0]: k[4] for k in KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for source, label, sq, dname, causal in CHECKS:
        dtype = getattr(torch, dname)
        shape = attention_shape(label)
        q, k, v, do = path_inputs(gen, dtype, torch, shape, sq)
        calls = kernel_calls(mods, source, q, k, v, do,
                             1.0 / math.sqrt(shape[-1]), causal)
        tag = (f"{dname} causal={causal} Sq={sq or shape[2]} Skv={shape[2]} "
               f"(B{shape[0]} H{shape[1]} D{shape[3]})")
        for name, (launch, plain) in calls.items():
            got = _tuple(launch())
            torch.cuda.synchronize()
            for out, g, w in zip(outputs[name], got, _tuple(plain())):
                tol = TOL["float32"] if out == "lse" else TOL[dname]
                a, r = max_err(g, w)
                run.check(r <= tol, f"{name} {out} {tag}: max abs err {a:.3e}"
                          f" rel {r:.3e} (tolerance rel {tol})")
                if dname == "bfloat16" and causal and sq is None:
                    errs[name] = max(errs.get(name, 0.0), a)
    return errs


def check_small_model(run, TH, GPTConfig, torch):
    """Phase 3: the same tiny model, kernels on the card vs plain on CPU."""
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=128)
    pcfg = TH.ParallelConfig(remat=True, remat_policy="names",
                             param_dtype=torch.float32,
                             compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    cpu_params = TH.init_params(cfg, pcfg, gen, device="cpu")
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 128)))
    out = {}
    for dev in ("cpu", "cuda"):
        params = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(dev))
                  for k, v in cpu_params.items()}
        leaves = TH._leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = (ids.to(dev), ids.to(dev))
        loss = TH.loss_fn(params, batch, cfg, pcfg)
        grads = torch.autograd.grad(loss, leaves)
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    torch.cuda.synchronize()
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(gg, gc))
    run.check(abs(lg - lc) <= 1e-5 * abs(lc) and worst <= 1e-4,
              f"tiny model f32, card vs cpu: loss {lg:.7f} vs {lc:.7f}, "
              f"worst grad leaf rel err {worst:.3e} (tolerance 1e-4)")


def drive(run, path, TH, GPTConfig, mods, fa, cost_model, torch):
    """Phase 4, one path: the training step through setup() and its step,
    with every count zeroed just before and read just after."""
    label, fields, batch, seq, tier, kernels, warm, timed_steps = path
    cfg = GPTConfig(**fields)
    pcfg = TH.ParallelConfig(remat=True, remat_policy="names", fused_ce=True,
                             param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16, moment_dtype=None)
    params, opt_state, step = TH.setup(cfg, pcfg, seed=0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for mod in mods:
        mod.reset_launch_counts()
    fa.reset_dispatch_counts()
    losses = []
    for _ in range(warm):
        params, opt_state, loss = step(params, opt_state, (ids, ids))
        losses.append(float(loss))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    timed = []
    for _ in range(timed_steps):
        params, opt_state, loss = step(params, opt_state, (ids, ids))
        timed.append(loss)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: n for mod in mods for name, n in mod.LAUNCHES.items()}
    dispatch = dict(fa.DISPATCH_COUNTS)
    losses += [float(x) for x in timed]

    steps = warm + timed_steps
    L = cfg.num_layers
    ms = start.elapsed_time(end) / timed_steps
    tok_s = batch * seq / (ms / 1e3)
    fpt = cost_model.gpt_flops_per_token(cfg, seq)
    mfu = cost_model.mfu(tok_s, fpt, "H100")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: h{cfg.hidden_size}, {L} layers, {cfg.num_heads} heads "
          f"of {cfg.hidden_size // cfg.num_heads}, vocab {cfg.vocab_size}, "
          f"B{batch} S{seq}; losses {[round(x, 4) for x in losses]}",
          flush=True)
    print(f"{label}: {ms:.2f} ms/step (device events), "
          f"{wall / timed_steps * 1e3:.2f} ms/step (host clock), "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} at {fpt:.4e} FLOP/token, "
          f"peak memory {peak_gb:.2f} GB", flush=True)
    ticks = ", ".join(f"{m}{{{v}}}: {n}" for (m, v), n in dispatch.items())
    print(f"{label}: launches {launches}, dispatch {ticks}", flush=True)
    run.check(all(math.isfinite(x) for x in losses),
              f"{label}: losses are finite")
    run.check(10.0 <= losses[0] <= 11.5,
              f"{label}: step-0 loss {losses[0]:.4f} near ln(50304) = 10.826")
    run.check(losses[-1] < losses[0], f"{label}: loss falls over the steps")
    run.check(launches == {n: L * steps if n in kernels else 0
                           for n in launches},
              f"{label}: {L} launches per step of each of {list(kernels)} "
              f"over {steps} steps, and no other attention kernel")
    # under "names" the recompute passes through dispatch again and gets
    # the saved outputs back without a launch: 2 ticks a layer, 1 launch
    run.check(set(dispatch) == {("attn.dispatch", tier)}
              and dispatch[("attn.dispatch", tier)] >= L * steps,
              f"{label}: every attention dispatched to {tier}, no fallback")
    run.check(0 < mfu < 1, f"{label}: MFU within (0, 1)")
    split = step_breakdown(TH, cfg, pcfg, params, opt_state, ids, torch)
    return {"launches": launches, "steps": steps, "ms_per_step": ms,
            "tokens_per_s": tok_s, "mfu": mfu, "peak_memory_gb": peak_gb,
            "step0_loss": losses[0], "last_loss": losses[-1], **split}


def step_breakdown(TH, cfg, pcfg, params, opt_state, ids, torch):
    """Where one step's device time goes: forward+backward against the
    optimizer (CUDA events), and device time by kernel (torch.profiler)
    over one whole step, against that step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    leaves = TH._leaves(params)

    def fwd_bwd():
        for p in leaves:
            p.requires_grad_(True)
        loss = TH.loss_fn(params, (ids, ids), cfg, pcfg)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        return grads

    grads = fwd_bwd()
    fb_ms = cuda_ms(fwd_bwd, reps=2)
    opt_ms = cuda_ms(lambda: TH.adamw_update(params, grads, opt_state),
                     reps=2)
    del grads
    step = TH.build_train_step(cfg, pcfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, (ids, ids))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"breakdown: forward+backward {fb_ms:.2f} ms, optimizer "
          f"{opt_ms:.2f} ms (device events); profiled step {wall_ms:.2f} ms "
          f"wall, {busy:.2f} ms kernel time, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}", flush=True)
    for key, ms, count in rows[:12]:
        print(f"  {ms:9.3f} ms {count:6d}x  {key[:100]}")
    return {"fwd_bwd_ms": fb_ms, "optimizer_ms": opt_ms,
            "profiled_step_ms": wall_ms, "kernel_ms": busy}


def time_kernels(mods, torch):
    """Phase 5: kernel, plain and library times of every kernel at its
    path's shape (bf16, causal). The library call is one
    scaled_dot_product_attention(is_causal=True) forward, and its backward
    (dq, dk and dv together) beside each backward kernel."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    t = {}
    for source in dict.fromkeys(k[1] for k in KERNELS):
        label = next(k[3] for k in KERNELS if k[1] == source)
        shape = attention_shape(label)
        q, k, v, do = path_inputs(gen, torch.bfloat16, torch, shape)
        calls = kernel_calls(mods, source, q, k, v, do,
                             1.0 / math.sqrt(shape[-1]), True)
        for name, (launch, plain) in calls.items():
            t[name] = cuda_ms(launch)
            t[f"plain {name}"] = cuda_ms(plain, reps=3)
        t[f"fwd {source}"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        t[f"bwd {source}"] = cuda_ms(lambda: torch.autograd.grad(
            out, (ql, kl, vl), do, retain_graph=True))
    return t


# The forward kernel that each autotune winner launches.
WINNER_KERNEL = {"simple": "simple_attention_fwd",
                 "causal_skip": "causal_attention_fwd",
                 "qblock": "qblock_attention_fwd"}


def check_autotune(run, mods, fa, at, torch):
    """Phase 6: the autotuner at each path's attention shape (bf16,
    causal), on the run's fresh table. Returns {path: {"winner",
    "timings_ms", "spread_ms"}}."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    tuned = {}
    for label in (p[0] for p in PATHS):
        b, h, s, d = attention_shape(label)
        bshd, dt = (b, s, h, d), torch.bfloat16
        tag = f"autotune {label} (B{b} S{s} H{h} D{d}, bf16 causal)"
        key = at._key(bshd, s, dt, True)
        run.check(at.lookup(bshd, s, dt, True) is None,
                  f"{tag}: no entry before the measurement")
        winner = at.measure(bshd, s, dt, True)
        ms = at._table[key]["timings_ms"]
        spread = at._table[key]["spread_ms"]
        tuned[label] = {"winner": winner, "timings_ms": ms,
                        "spread_ms": spread}
        kernels = {n: t for n, t in ms.items()
                   if t is not None and n != at.PLAIN}
        ranked = sorted(kernels, key=kernels.get)
        print(f"{tag}: forward+backward ms (median of 5 windows, spread) "
              + ", ".join(f"{n} {t} ({spread[n]})" for n, t in ms.items())
              + f"; winner {winner}, next kernel {ranked[1:2]}, plain "
              f"attention {'faster' if ms[at.PLAIN] < ms[winner] else 'slower'}"
              " than the winner", flush=True)
        run.check(winner == ranked[0],
                  f"{tag}: the winner is the fastest Hopper kernel")
        run.check(all(t is not None for n, t in ms.items()
                      if n != "library_flash")
                  and ms.get("library_flash", "absent") is None,
                  f"{tag}: every ported tier and plain attention timed, "
                  "library_flash None (no Hopper kernel)")
        with open(at._cache_path()) as f:
            disk = json.load(f).get(key, {}).get("winner")
        at._table = None
        again = at.lookup(bshd, s, dt, True)
        q = torch.empty(bshd, dtype=dt, device="cuda")
        decided = at.decide(q, q, True)
        run.check(disk == again == decided == winner,
                  f"{tag}: persisted {disk}, reloaded {again}, decided "
                  f"{decided}")
        q, k, v, _ = path_inputs(gen, dt, torch, (b, h, s, d))
        for mod in mods:
            mod.reset_launch_counts()
        fa.reset_dispatch_counts()
        out = fa.flash_attention_maybe(*(x.transpose(1, 2) for x in (q, k, v)),
                                       causal=True)
        torch.cuda.synchronize()
        launched = {n: c for mod in mods for n, c in mod.LAUNCHES.items() if c}
        want = {"blocked_flash_fwd" if winner.startswith("blocked_")
                else WINNER_KERNEL[winner]: 1}
        run.check(dict(fa.DISPATCH_COUNTS) == {("attn.dispatch", winner): 1}
                  and launched == want and out is not None,
                  f"{tag}: one flash_attention_maybe call dispatches "
                  f"{winner}, launches {launched}")
    return tuned


def main():
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on "
              "the card only", file=sys.stderr)
        return 1
    try:
        from paddle_tpu_torch.cost_model import cost_model
        from paddle_tpu_torch.models import gpt_hybrid as TH
        from paddle_tpu_torch.models.gpt import GPTConfig
        from paddle_tpu_torch.ops.hopper import _build
        from paddle_tpu_torch.ops.hopper import autotune as at
        from paddle_tpu_torch.ops.hopper import blocked_flash as bf
        from paddle_tpu_torch.ops.hopper import causal_attention as ca
        from paddle_tpu_torch.ops.hopper import flash_attention as fa
        from paddle_tpu_torch.ops.hopper import simple_attention as sa
        from paddle_tpu_torch.ops.hopper import simple_attention2 as sa2
    except ImportError as e:
        print(f"chip_smoke: run from the root of the repository ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    run = Run()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)} "
          f"(nvcc, sm_90a)", flush=True)
    for name, log in logs.items():
        regs = [int(w.split()[0]) for w in log.split("Used ")[1:]]
        spills = sum(int(w.split()[0]) for w in log.split(", ")
                     if w.endswith("spill stores"))
        print(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)}"
              f" registers a thread, {spills} bytes spilled")

    cache_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              ".cache")
    os.makedirs(cache_root, exist_ok=True)
    mods = (sa, ca, bf, sa2)
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        errs = check_kernels(run, mods, torch)
        check_small_model(run, TH, GPTConfig, torch)
        paths = {}
        for path in PATHS:
            paths[path[0]] = drive(run, path, TH, GPTConfig, mods, fa,
                                   cost_model, torch)
            torch.cuda.empty_cache()
        times = time_kernels(mods, torch)
        torch.cuda.synchronize()
        tuned = check_autotune(run, mods, fa, at, torch)

    kernels = []
    for kern in KERNELS:
        name, source, line, label, *_, library = kern
        launches = paths[label]["launches"][name]
        bound_ms, bound_by = bound(kern)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/hopper/csrc/"
                      f"{CUDA_SOURCE.get(source, source)}.cu",
            "replaces": f"paddle_tpu/ops/pallas/{source}.py:{line}",
            "launches": launches,
            "launches_per_step": launches / paths[label]["steps"],
            "max_abs_err": errs[name], "tolerance_rel": TOL["bfloat16"],
            "ms": times[name], "plain_ms": times[f"plain {name}"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": times[f"{library} {source}"],
        })
        print(f"{name}: {times[name]:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), roofline share {bound_ms / times[name]:.4f}, "
              f"plain {times[f'plain {name}']:.3f} ms, library "
              f"{times[f'{library} {source}']:.3f} ms")
    print(json.dumps({"paths": {
        label: {k: v for k, v in p.items() if k != "launches"}
        for label, p in paths.items()}}))
    print(json.dumps({"autotune": tuned}))
    if run.failures:
        print(f"chip_smoke: {len(run.failures)} check(s) failed",
              file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
