#!/usr/bin/env python3
"""Drives the PyTorch port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card: its name and power limit; builds every Hopper kernel of the
     port from the sources in this checkout (nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the card, at the
     training shape (B4 H16 S1024 D128 bf16, causal and not) and in f32;
  3. a small model on the card (kernels) against the same model on the CPU
     (plain path): the loss and gradients agree;
  4. the main path: the GPT-1.3B training step (h2048, 24 layers, 16 heads,
     vocab 50304, B4 S1024, bf16, remat "names", fused CE) through the
     port's setup() and step, with random weights from a seed. Every count
     is zeroed just before it and read just after: each step must launch
     the attention kernels 24 times forward and 24 times backward, with no
     dispatch fallback, a finite loss near ln(vocab) at step 0, and a loss
     that falls. Prints ms/step, tokens/s, MFU and peak memory;
  5. each kernel timed at the training shape beside its plain version, its
     bound on this card and one PyTorch library call that computes the same
     function (scaled_dot_product_attention, never used by the port).
Prints the card line, then one {"kernels": [...]} line, then as the last
line {"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12     # H100 SXM, dense bf16 tensor cores
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3
SHAPE = (4, 16, 1024, 128)   # B, H, S, D of the 1.3B step's attention
TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # max |err| / max |plain|
STEPS_WARM, STEPS_TIMED = 2, 6


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


def attention_bounds(b, h, s, d, itemsize, causal=True):
    """Least time (ms) of the forward and backward on this card: the larger
    of the operations over the bf16 peak and the bytes (each input read
    once, each output written once) over HBM. Causal work counts the pairs
    (i, j <= i) only; the forward does 2 products, the backward 5."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    tensor = b * h * s * d * itemsize
    out = {}
    for name, products, tensors in (("fwd", 2, 4), ("bwd", 5, 7)):
        ops_ms = products * 2 * pairs * d / PEAK_BF16_FLOPS * 1e3
        bytes_ms = tensors * tensor / PEAK_HBM_BYTES * 1e3
        out[name] = (max(ops_ms, bytes_ms),
                     "operations" if ops_ms > bytes_ms else "bytes")
    return out


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


def path_inputs(gen, dtype, torch):
    """q, k, v as the main path hands them to the kernels (views into one
    [B, S, 3*H*D] qkv activation, [B, H, S, D] by strides) and a dO."""
    b, h, s, d = SHAPE
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dtype)
    q, k, v = (x.reshape(b, s, h, d).transpose(1, 2)
               for x in qkv.split(h * d, dim=-1))
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
    return q, k, v, do.transpose(1, 2)


def check_kernels(run, sa, torch):
    """Phase 2: each kernel against its plain version on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for dtype, causal in ((torch.bfloat16, True), (torch.bfloat16, False),
                          (torch.float32, True)):
        q, k, v, do = path_inputs(gen, dtype, torch)
        scale = 1.0 / math.sqrt(SHAPE[-1])
        tol = TOL[str(dtype).split(".")[-1]]
        o = sa.simple_attention_fwd_cuda(q, k, v, scale, causal)
        grads = sa.simple_attention_bwd_cuda(q, k, v, do, scale, causal)
        torch.cuda.synchronize()
        want_o = sa.simple_attention_reference(q, k, v, scale, causal)
        want_g = sa.simple_attention_bwd_reference(q, k, v, do, scale, causal)
        torch.cuda.synchronize()
        tag = f"{str(dtype).split('.')[-1]} causal={causal}"
        fa, fr = max_err(o, want_o)
        run.check(fr <= tol, f"simple_attention_fwd {tag}: max abs err {fa:.3e}"
                  f" rel {fr:.3e} (tolerance rel {tol})")
        ba, br = 0.0, 0.0
        for name, g, w in zip(("dq", "dk", "dv"), grads, want_g):
            a, r = max_err(g, w)
            ba, br = max(ba, a), max(br, r)
            run.check(r <= tol, f"simple_attention_bwd {tag} {name}: max abs "
                      f"err {a:.3e} rel {r:.3e} (tolerance rel {tol})")
        if dtype == torch.bfloat16 and causal:
            errs = {"fwd": (fa, tol), "bwd": (ba, tol)}
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


def main_path(run, TH, GPTConfig, sa, fa, cost_model, torch):
    """Phase 4: the GPT-1.3B training step through setup() and its step."""
    cfg = GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                    num_heads=16, max_seq_len=1024)
    pcfg = TH.ParallelConfig(remat=True, remat_policy="names", fused_ce=True,
                             param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16, moment_dtype=None)
    batch, seq = 4, 1024
    params, opt_state, step = TH.setup(cfg, pcfg, seed=0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    sa.reset_launch_counts()
    fa.reset_dispatch_counts()
    losses = []
    for _ in range(STEPS_WARM):
        params, opt_state, loss = step(params, opt_state, (ids, ids))
        losses.append(float(loss))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    timed = []
    for _ in range(STEPS_TIMED):
        params, opt_state, loss = step(params, opt_state, (ids, ids))
        timed.append(loss)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sa.LAUNCHES)
    dispatch = dict(fa.DISPATCH_COUNTS)
    losses += [float(x) for x in timed]

    steps = STEPS_WARM + STEPS_TIMED
    L = cfg.num_layers
    ms = start.elapsed_time(end) / STEPS_TIMED
    tok_s = batch * seq / (ms / 1e3)
    fpt = cost_model.gpt_flops_per_token(cfg, seq)
    mfu = cost_model.mfu(tok_s, fpt, "H100")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"main path: losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"main path: {ms:.2f} ms/step (device events), "
          f"{wall / STEPS_TIMED * 1e3:.2f} ms/step (host clock), "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} at {fpt:.4e} FLOP/token, "
          f"peak memory {peak_gb:.2f} GB", flush=True)
    ticks = ", ".join(f"{m}{{{v}}}: {n}" for (m, v), n in dispatch.items())
    print(f"main path: launches {launches}, dispatch {ticks}", flush=True)
    run.check(all(math.isfinite(x) for x in losses), "losses are finite")
    run.check(10.0 <= losses[0] <= 11.5,
              f"step-0 loss {losses[0]:.4f} near ln(50304) = 10.826")
    run.check(losses[-1] < losses[0], "loss falls over the steps")
    run.check(launches == {"simple_attention_fwd": L * steps,
                           "simple_attention_bwd": L * steps},
              f"{L} forward and {L} backward kernel launches per step "
              f"over {steps} steps")
    # under "names" the recompute passes through dispatch again and gets
    # the saved output back without a launch: 2 ticks a layer, 1 launch
    run.check(set(dispatch) == {("attn.dispatch", "simple")}
              and dispatch[("attn.dispatch", "simple")] >= L * steps,
              "every attention dispatched to simple, no fallback")
    run.check(0 < mfu < 1, "MFU within (0, 1)")
    split = step_breakdown(TH, cfg, pcfg, params, opt_state, ids, torch)
    return {"launches": launches, "ms_per_step": ms, "tokens_per_s": tok_s,
            "mfu": mfu, "peak_memory_gb": peak_gb, **split}


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


def time_kernels(sa, torch):
    """Phase 5: kernel, plain and library times at the training shape."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = path_inputs(gen, torch.bfloat16, torch)
    scale = 1.0 / math.sqrt(SHAPE[-1])
    t = {
        "fwd": cuda_ms(lambda: sa.simple_attention_fwd_cuda(
            q, k, v, scale, True)),
        "bwd": cuda_ms(lambda: sa.simple_attention_bwd_cuda(
            q, k, v, do, scale, True)),
        "plain_fwd": cuda_ms(lambda: sa.simple_attention_reference(
            q, k, v, scale, True), reps=3),
        "plain_bwd": cuda_ms(lambda: sa.simple_attention_bwd_reference(
            q, k, v, do, scale, True), reps=3),
        "library_fwd": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
    }
    ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    t["library_bwd"] = cuda_ms(lambda: torch.autograd.grad(
        out, (ql, kl, vl), do, retain_graph=True))
    return t


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
        from paddle_tpu_torch.ops.hopper import flash_attention as fa
        from paddle_tpu_torch.ops.hopper import simple_attention as sa
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

    errs = check_kernels(run, sa, torch)
    check_small_model(run, TH, GPTConfig, torch)
    path = main_path(run, TH, GPTConfig, sa, fa, cost_model, torch)
    times = time_kernels(sa, torch)
    torch.cuda.synchronize()

    bounds = attention_bounds(*SHAPE, itemsize=2, causal=True)
    steps = STEPS_WARM + STEPS_TIMED
    kernels = []
    for part, line in (("fwd", 113), ("bwd", 130)):
        name = f"simple_attention_{part}"
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/hopper/csrc/simple_attention.cu",
            "replaces": f"paddle_tpu/ops/pallas/simple_attention.py:{line}",
            "launches": path["launches"][name],
            "launches_per_step": path["launches"][name] / steps,
            "max_abs_err": errs[part][0], "tolerance_rel": errs[part][1],
            "ms": times[part], "plain_ms": times[f"plain_{part}"],
            "bound_ms": bounds[part][0], "bound_by": bounds[part][1],
            "library_ms": times[f"library_{part}"],
        })
    for kern in kernels:
        print(f"{kern['name']}: {kern['ms']:.3f} ms, bound "
              f"{kern['bound_ms']:.4f} ms ({kern['bound_by']}), roofline "
              f"share {kern['bound_ms'] / kern['ms']:.4f}, plain "
              f"{kern['plain_ms']:.3f} ms, library {kern['library_ms']:.3f} ms")
    print(json.dumps({"step": {k: v for k, v in path.items()
                               if k != "launches"}}))
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
