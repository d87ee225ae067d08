"""GPT training step on one device: the port of ``paddle_tpu/models/gpt_hybrid.py``.

The reference compiles one SPMD program over a (dp, pp, tp) mesh; this port
runs its single-device case (dp=pp=tp=1) eagerly on one CUDA card:

- parameters are the reference's dict of stacked ``[L, ...]`` block leaves
  in the ``x @ W`` orientation, so ``params_from_jax`` is a plain copy;
- attention goes through ``ops/hopper/flash_attention.flash_attention_maybe``
  (the Hopper ``simple_attention`` kernel at the 1.3B shape,
  ``causal_attention`` at S=2048 and ``blocked_flash`` at S=4096 on the
  350M-class rungs), with the reference's plain einsum where dispatch
  returns None;
- remat is ``torch.utils.checkpoint`` per block; the ``"names"`` and
  ``"dots"`` policies are selective-checkpoint policies over aten ops and
  the attention op;
- the LM head and loss are ``ops/fused_ce.FusedLMCE`` or plain logits;
- AdamW is the reference's per-leaf update, written out in f32, applied in
  place (the reference donates params and state to its step).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..ops.fused_ce import fused_lm_ce
from ..ops.hopper.flash_attention import ATTENTION_OPS, flash_attention_maybe
from .gpt import GPTConfig


@dataclass
class ParallelConfig:
    """The reference's ParallelConfig, field for field. One device only:
    ``dp``/``pp``/``tp`` > 1, ``sp``, ``num_experts`` > 0 and
    ``collective_matmul`` raise NotImplementedError in ``setup`` and
    ``build_train_step``; ``microbatches``, ``pp_schedule`` and
    ``vpp_chunks`` only matter at pp > 1. ``zero1`` (shard the moments over
    dp) and ``scan_unroll`` (lax.scan unrolling) have no effect on one
    device in eager PyTorch."""
    dp: int = 1
    pp: int = 1
    tp: int = 1
    sp: bool = False
    num_experts: int = 0
    microbatches: int = 1
    pp_schedule: str = "gpipe"
    vpp_chunks: int = 1
    remat: bool = True
    # "full" recomputes the whole block; "dots" saves matmul outputs and
    # recomputes the elementwise rest; "names" saves remat_save_names
    remat_policy: str = "full"
    remat_save_names: tuple = ("attn_out", "ffn1", "qkv")
    gradient_merge_steps: int = 1
    collective_matmul: bool = False
    zero1: bool = True
    # Adam moment storage dtype; None inherits the param dtype
    moment_dtype: Any = None
    fused_ce: bool = True
    scan_unroll: int = 1
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16


def _validate(pcfg: ParallelConfig):
    multi = [f"{n}={getattr(pcfg, n)}" for n in ("dp", "pp", "tp")
             if getattr(pcfg, n) > 1]
    if pcfg.sp:
        multi.append("sp=True")
    if pcfg.num_experts > 0:
        multi.append(f"num_experts={pcfg.num_experts}")
    if pcfg.collective_matmul:
        multi.append("collective_matmul=True")
    if multi:
        raise NotImplementedError(
            "paddle_tpu_torch runs the single-device step only; "
            f"{', '.join(multi)} waits for the distributed slice (ROADMAP)")
    if pcfg.remat and pcfg.remat_policy not in ("full", "dots", "names"):
        raise ValueError(f"unknown remat_policy {pcfg.remat_policy!r}")


# ------------------------------ init ---------------------------------------
def init_params(cfg: GPTConfig, pcfg: ParallelConfig,
                generator: torch.Generator, device=None) -> Dict:
    """The reference's parameters and distributions (normal, std 0.02,
    residual projections scaled by 1/sqrt(2L)), drawn from ``generator``
    (which must live on ``device``). torch draws other numbers than
    jax.random from the same seed; ``params_from_jax`` brings the
    reference's own draws over."""
    dev = resolve_device(device)
    h = cfg.hidden_size
    m = h * cfg.ffn_mult
    L = cfg.num_layers
    dt = pcfg.param_dtype
    std = 0.02

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (x * scale).to(dt)

    def const(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    blocks = {
        "ln1_g": const((L, h), 1.0), "ln1_b": const((L, h), 0.0),
        "qkv_w": normal((L, h, 3 * h), std),
        "qkv_b": const((L, 3 * h), 0.0),
        "proj_w": normal((L, h, h), std / math.sqrt(2 * L)),
        "proj_b": const((L, h), 0.0),
        "ln2_g": const((L, h), 1.0), "ln2_b": const((L, h), 0.0),
        "fc1_w": normal((L, h, m), std),
        "fc1_b": const((L, m), 0.0),
        "fc2_w": normal((L, m, h), std / math.sqrt(2 * L)),
        "fc2_b": const((L, h), 0.0),
    }
    return {
        "wte": normal((cfg.vocab_size, h), std),
        "wpe": normal((cfg.max_seq_len, h), std),
        "blocks": blocks,
        "lnf_g": const((h,), 1.0), "lnf_b": const((h,), 0.0),
    }


def _to_torch(x, device):
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":      # ml_dtypes: torch cannot wrap it
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_jax(np_tree, device=None):
    """The reference's parameter (or moment) dict, as numpy arrays, to
    torch tensors with the same keys, shapes and dtypes."""
    dev = resolve_device(device)
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, dev) for k, v in np_tree.items()}
    return _to_torch(np_tree, dev)


def _leaves(params):
    out = []
    for k in sorted(params):
        v = params[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


# ---------------------------- forward --------------------------------------
def _layer_norm(x, g, b, eps=1e-5):
    """Stats in f32, cast back to x's dtype before the affine (which
    F.layer_norm would do in f32)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


def _attend(q, k, v, nh):
    b, s, h = q.shape
    d = h // nh
    q = q.reshape(b, s, nh, d)
    k = k.reshape(b, s, nh, d)
    v = v.reshape(b, s, nh, d)
    # the Hopper kernel on the card; plain attention where dispatch says None
    out = flash_attention_maybe(q, k, v, causal=True)
    if out is None:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) / math.sqrt(d)
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
        p = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out.reshape(b, s, h)


def _linear(x, w, b):
    """x @ w + b as one addmm: the op the remat policies count."""
    return torch.addmm(b, x.reshape(-1, x.shape[-1]), w) \
        .reshape(x.shape[:-1] + (w.shape[-1],))


def _block(x, lp, cfg):
    hres = x
    hx = _layer_norm(x, lp["ln1_g"], lp["ln1_b"])
    qkv = _linear(hx, lp["qkv_w"], lp["qkv_b"])                  # "qkv"
    h = cfg.hidden_size
    attn = _attend(qkv[..., :h], qkv[..., h:2 * h], qkv[..., 2 * h:],
                   cfg.num_heads)                                 # "attn_out"
    x = hres + _linear(attn, lp["proj_w"], lp["proj_b"])         # "proj"
    hres = x
    hx = _layer_norm(x, lp["ln2_g"], lp["ln2_b"])
    ff = F.gelu(_linear(hx, lp["fc1_w"], lp["fc1_b"]),            # "ffn1"
                approximate="tanh")
    return hres + _linear(ff, lp["fc2_w"], lp["fc2_b"])          # "ffn2"


# The order in which _block issues its four addmm ops.
_LINEAR_NAMES = ("qkv", "proj", "ffn1", "ffn2")
_DOTS = (torch.ops.aten.addmm.default, torch.ops.aten.mm.default,
         torch.ops.aten.bmm.default)


def _policy_context(pcfg):
    """Selective-checkpoint contexts for one block call.

    "dots": save every matmul output (jax's dots_saveable), recompute the
    rest, the attention op included. "names": save the outputs named in
    remat_save_names, recognised by op: "attn_out" is any of the Hopper
    attention ops (all their outputs: o, and the lse that the
    causal_attention and blocked_flash backwards read), and
    "qkv"/"proj"/"ffn1"/"ffn2" are _block's addmm calls in order.
    Where attention takes the plain path (CPU), "attn_out" names no op and
    is recomputed; values are the same either way."""
    names = set(pcfg.remat_save_names)
    seen = {False: 0, True: 0}     # addmm calls so far, forward / recompute

    def policy(ctx, func, *args, **kwargs):
        if pcfg.remat_policy == "dots":
            save = func in _DOTS
        elif func in ATTENTION_OPS:
            save = "attn_out" in names
        elif func == torch.ops.aten.addmm.default:
            i = seen[ctx.is_recompute]
            seen[ctx.is_recompute] = i + 1
            save = _LINEAR_NAMES[i] in names
        else:
            save = False
        return (CheckpointPolicy.MUST_SAVE if save
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def _stack_apply(blocks, x, cfg, pcfg):
    """The layer loop (the reference's lax.scan), one checkpoint per block
    under remat. ``unbind`` hands out per-layer views whose gradients are
    stacked back once."""
    names = sorted(blocks)
    per_layer = zip(*(torch.unbind(blocks[n], 0) for n in names))
    for leaves in per_layer:
        lp = dict(zip(names, leaves))
        if not pcfg.remat:
            x = _block(x, lp, cfg)
        elif pcfg.remat_policy == "full":
            x = checkpoint(_block, x, lp, cfg, use_reentrant=False)
        else:
            x = checkpoint(_block, x, lp, cfg, use_reentrant=False,
                           context_fn=lambda: _policy_context(pcfg))
    return x


def forward_hidden(params, input_ids, cfg: GPTConfig, pcfg: ParallelConfig):
    cdt = pcfg.compute_dtype
    b, s = input_ids.shape
    x = F.embedding(input_ids, params["wte"]).to(cdt) + \
        params["wpe"][:s][None].to(cdt)
    blocks = {k: p.to(cdt) for k, p in params["blocks"].items()}
    x = _stack_apply(blocks, x, cfg, pcfg)
    return _layer_norm(x, params["lnf_g"].to(cdt), params["lnf_b"].to(cdt))


def forward(params, input_ids, cfg: GPTConfig, pcfg: ParallelConfig):
    x = forward_hidden(params, input_ids, cfg, pcfg)
    return torch.einsum("bsh,vh->bsv", x, params["wte"].to(pcfg.compute_dtype))


def _ce_from_hidden(h, wte, labels, pcfg):
    """Next-token CE from the final (post-LN) hidden states [b, s, hid]."""
    b, s, hid = h.shape
    if pcfg.fused_ce:
        # next-token targets with the final position masked out
        tgt = torch.cat([labels[:, 1:], labels.new_zeros((b, 1))], dim=1)
        mask = torch.ones(b, s, dtype=torch.float32, device=h.device)
        mask[:, -1] = 0.0
        return fused_lm_ce(h.reshape(b * s, hid), wte.to(h.dtype),
                           tgt.reshape(b * s), mask.reshape(b * s))
    logits = torch.einsum("bsh,vh->bsv", h, wte.to(h.dtype))
    logits = logits[:, :-1].float()
    tgt = labels[:, 1:]
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, tgt[..., None])[..., 0]
    return torch.mean(logz - picked)


def loss_fn(params, batch, cfg, pcfg):
    input_ids, labels = batch
    # forward_hidden already applies the final layer norm
    x = forward_hidden(params, input_ids, cfg, pcfg)
    return _ce_from_hidden(x, params["wte"], labels, pcfg)


# --------------------------- optimizer -------------------------------------
def _adamw_leaf(p, m, v, g, step, lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """The per-leaf AdamW update math (f32 compute, storage dtypes kept).
    Returns (p', m', v')."""
    gf = g.float()
    pf = p.float()
    m_new = b1 * m.float() + (1 - b1) * gf
    v_new = b2 * v.float() + (1 - b2) * gf * gf
    sf = torch.tensor(float(step), dtype=torch.float32)
    c1 = (1 - torch.tensor(b1, dtype=torch.float32) ** sf).item()
    c2 = (1 - torch.tensor(b2, dtype=torch.float32) ** sf).item()
    upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps) + wd * pf
    return ((pf - lr * upd).to(p.dtype), m_new.to(m.dtype),
            v_new.to(v.dtype))


def adamw_init(params, pcfg):
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=pcfg.moment_dtype or tree.dtype,
                           device=tree.device)
    return {"m": zeros(params), "v": zeros(params), "step": 0}


@torch.no_grad()
def adamw_update(params, grads, opt_state, lr=3e-4, b1=0.9, b2=0.95,
                 eps=1e-8, wd=0.1):
    """One AdamW step over every leaf, written into params and opt_state in
    place (the reference donates both to its step). ``grads`` is a list in
    ``_leaves`` order."""
    step = opt_state["step"] + 1
    for p, g, m, v in zip(_leaves(params), grads, _leaves(opt_state["m"]),
                          _leaves(opt_state["v"])):
        p_new, m_new, v_new = _adamw_leaf(p, m, v, g, step, lr, b1, b2,
                                          eps, wd)
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
    opt_state["step"] = step
    return params, opt_state


# --------------------------- train step ------------------------------------
def build_train_step(cfg: GPTConfig, pcfg: ParallelConfig, lr=3e-4):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``.

    ``batch`` is (input_ids, labels), int64 [B, S] on the params' device.
    With ``gradient_merge_steps`` = k > 1 the batch is split into k chunks
    whose gradients are summed in the param dtype and averaged before one
    update; the loss is the mean of the chunks' losses."""
    _validate(pcfg)
    k = pcfg.gradient_merge_steps

    def grads_of(leaves, params, batch):
        loss = loss_fn(params, batch, cfg, pcfg)
        return loss, torch.autograd.grad(loss, leaves)

    def train_step(params, opt_state, batch):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if k > 1:
                b0 = batch[0].shape[0]
                if b0 % k:
                    raise ValueError(
                        f"global batch {b0} is not divisible by "
                        f"gradient_merge_steps={k}")
                acc = [torch.zeros_like(p) for p in leaves]
                lsum = 0.0
                for chunk in zip(*(x.chunk(k) for x in batch)):
                    loss, grads = grads_of(leaves, params, chunk)
                    acc = [a + g for a, g in zip(acc, grads)]
                    lsum = lsum + loss.detach()
                grads = [a / k for a in acc]
                loss = lsum / k
            else:
                loss, grads = grads_of(leaves, params, batch)
                loss = loss.detach()
        finally:
            for p in leaves:
                p.requires_grad_(False)
        adamw_update(params, grads, opt_state, lr=lr)
        return params, opt_state, loss

    return train_step


def setup(cfg: GPTConfig, pcfg: ParallelConfig, seed=0, device=None):
    """Returns (params, opt_state, train_step) on ``device`` (CUDA unless
    the caller says otherwise; raises when CUDA is missing)."""
    _validate(pcfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, pcfg, gen, dev)
    opt_state = adamw_init(params, pcfg)
    return params, opt_state, build_train_step(cfg, pcfg, lr=3e-4)
