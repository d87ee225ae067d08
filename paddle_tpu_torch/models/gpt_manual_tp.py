"""The manual tensor-parallel GPT block and the vocab-parallel head: the
port of the tp parts of ``paddle_tpu/models/gpt_manual_tp.py`` (reference:
Megatron's column/row-parallel matmuls with explicit psum, the
sequence-parallel variant with all_gather/psum_scatter, and Megatron's
parallel cross entropy, mp_ops.py _c_softmax_with_cross_entropy).

The reference writes this explicit form once, for its zero-bubble
pipelines. The port runs one process a GPU, so it is gpt_hybrid's tp
branch: each rank holds its shards and the collectives are the
differentiable ``distributed.collective`` Functions over the tp group.

Remat with collectives inside. A collective recomputed in backward is a
collective issued again, and every rank must issue it in the same order.
So nothing that communicates is ever inside a checkpoint: a block is a
sequence of runs of computation separated by its collectives (the
all-gathers and reduce-scatters, or the ring collective matmuls under
``collective_matmul``), and each run is checkpointed on its own under the
remat policy. A collective's output is the next run's input, which the
checkpoint keeps: under every policy the gathered LayerNorm outputs (non-cm)
or the ring matmuls' outputs and gathered operands (cm) are saved, never
recomputed. Inside a run, "full" recomputes everything, "dots" saves the
matmul outputs, and "names" saves the outputs of the run's one addmm
("qkv" or "ffn1"), its one mm ("proj" or "ffn2", before the reduction) and
the attention op ("attn_out"), and recomputes the LayerNorms, the GELU and
the residual adds.

``train_grads_zb_manual_tp`` is the zero-bubble pipelines (and 1F1B with
the ring collective matmuls) over this stage body, gpt_hybrid's pipeline
with the reference's vocab-parallel head. The manual expert-parallel
bodies come with the expert-parallel slice: they raise
``NotImplementedError`` naming it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..distributed import collective as C
from ..ops.hopper.flash_attention import ATTENTION_OPS
from .gpt import GPTConfig
from .gpt_hybrid import _DOTS, _attend, _layer_norm, _linear


# ------------------------- block (manual tp) -------------------------
def _remat_wrap(fn, pcfg, addmm_name=None, mm_name=None):
    """``fn`` (one run of computation between collectives) under the remat
    policy: itself without remat, else a non-reentrant checkpoint; under
    "names" the run's addmm output is saved when ``addmm_name`` is named,
    its mm output when ``mm_name`` is, the attention ops' when
    "attn_out" is."""
    if not pcfg.remat:
        return fn
    if pcfg.remat_policy == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False) \
            if torch.is_grad_enabled() else fn(*a)
    names = set(pcfg.remat_save_names)

    def policy(ctx, func, *args, **kwargs):
        if pcfg.remat_policy == "dots":
            save = func in _DOTS
        elif func in ATTENTION_OPS:
            save = "attn_out" in names
        elif func == torch.ops.aten.addmm.default:
            save = addmm_name in names
        elif func == torch.ops.aten.mm.default:
            save = mm_name in names
        else:
            save = False
        return (CheckpointPolicy.MUST_SAVE if save
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def context():
        return create_selective_checkpoint_contexts(policy)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                 context_fn=context) \
        if torch.is_grad_enabled() else fn(*a)


def _mm(x, w):
    """x @ w as one mm over the flattened rows (the op "names" counts)."""
    return torch.mm(x.reshape(-1, x.shape[-1]), w).reshape(
        x.shape[:-1] + (w.shape[-1],))


def _use_cm(pcfg):
    """The ring collective matmuls: ``collective_matmul`` with sequence
    parallelism (the reference's ``_use_cm``, at any tp: at tp = 1 the ring
    has no step to take)."""
    return bool(pcfg.collective_matmul) and pcfg.sp


def block_manual_tp(x, lp, cfg: GPTConfig, pcfg, tp_axis="tp"):
    """One transformer block with explicit tp collectives over ``tp_axis``
    (a mesh axis or a Group).

    Local parameter shapes (h hidden, hl = h / tp, m ffn, ml = m / tp):
    qkv_w [h, 3 hl] (this rank's q, k and v columns: the reference's
    [h, 3, hl] per-matrix shard, flattened), qkv_b [3 hl], proj_w [hl, h]
    (row-parallel), proj_b [h], fc1_w [h, ml], fc1_b [ml], fc2_w [ml, h],
    fc2_b [h], ln*_g/b [h] (replicated).

    Non-sp: x [b, s, h] the same on every rank in and out; the column
    input is pvary'd and each row output psum'd. sp: x [b, s / tp, h] this
    rank's slice of the sequence; all_gather before the column matmuls,
    psum_scatter after the row matmuls (Megatron-LM SP). sp +
    collective_matmul: those pairs are the ring collective matmuls.
    """
    g = C._axis_group(tp_axis)
    sp, cm = pcfg.sp, _use_cm(pcfg)
    nh_local = cfg.num_heads // g.nranks

    def gather(t):
        return C._AllGather.apply(t, g, 1) if sp else C._Pvary.apply(t, g)

    def reduce(part):
        return C._ReduceScatter.apply(part, g, 1) if sp \
            else C._Psum.apply(part, g)

    def attend(qkv):
        hl = qkv.shape[-1] // 3
        return _attend(qkv[..., :hl], qkv[..., hl:2 * hl], qkv[..., 2 * hl:],
                       nh_local)

    def residual_ln2(x, r, pb, lg, lb):
        x = x + r + pb
        return x, _layer_norm(x, lg, lb)

    def residual(x, r, b):
        return x + r + b

    run = _remat_wrap
    hx = run(_layer_norm, pcfg)(x, lp["ln1_g"], lp["ln1_b"])
    if cm:
        from ..parallel.collective_matmul import (sp_column_matmul_local,
                                                  sp_row_matmul_local)
        qkv = sp_column_matmul_local(hx, lp["qkv_w"], g)          # "qkv"
        attn = run(lambda q, b: attend(q + b), pcfg)(qkv, lp["qkv_b"])
        r = sp_row_matmul_local(attn, lp["proj_w"], g)            # "proj"
        x, hx = run(residual_ln2, pcfg)(x, r, lp["proj_b"], lp["ln2_g"],
                                        lp["ln2_b"])
        f1 = sp_column_matmul_local(hx, lp["fc1_w"], g)           # "ffn1"
        act = run(lambda f, b: F.gelu(f + b, approximate="tanh"),
                  pcfg)(f1, lp["fc1_b"])
        r = sp_row_matmul_local(act, lp["fc2_w"], g)              # "ffn2"
        return run(residual, pcfg)(x, r, lp["fc2_b"])

    def attention(hx, w, b, pw):
        return _mm(attend(_linear(hx, w, b)), pw)    # "qkv", "attn_out"

    def mlp(hx, w1, b1, w2):
        return _mm(F.gelu(_linear(hx, w1, b1), approximate="tanh"), w2)

    part = run(attention, pcfg, "qkv", "proj")(
        gather(hx), lp["qkv_w"], lp["qkv_b"], lp["proj_w"])
    x, hx = run(residual_ln2, pcfg)(x, reduce(part), lp["proj_b"],
                                    lp["ln2_g"], lp["ln2_b"])
    part = run(mlp, pcfg, "ffn1", "ffn2")(
        gather(hx), lp["fc1_w"], lp["fc1_b"], lp["fc2_w"])
    return run(residual, pcfg)(x, reduce(part), lp["fc2_b"])


def stack_apply_manual_tp(blocks, x, cfg, pcfg, tp_axis="tp"):
    """The layer loop over this rank's stacked [L, ...] shards (the manual-tp
    ``_stack_apply``); ``unbind`` hands out per-layer views whose gradients
    are stacked back once."""
    names = sorted(blocks)
    for leaves in zip(*(torch.unbind(blocks[n], 0) for n in names)):
        x = block_manual_tp(x, dict(zip(names, leaves)), cfg, pcfg, tp_axis)
    return x


# -------------------- vocab-parallel CE (manual) ---------------------
def ce_vocab_parallel(h, wte_local, labels, tp_axis="tp", valid_vocab=None):
    """Next-token CE with the vocab sharded over ``tp_axis`` (Megatron
    parallel_cross_entropy). ``h`` [b, s, hid] is the whole sequence, the
    same on every rank: its gradient here is this rank's vocab rows' share,
    so the caller sums them (``ops.pvary``, or ``ops.all_gather`` from the
    sequence slices). ``wte_local`` [Vp / tp, hid] is this rank's rows;
    ``labels`` [b, s] whole. Returns the mean CE over the b (s - 1)
    next-token positions, as gpt_hybrid's ``_ce_from_hidden``.

    ``valid_vocab``: the true vocab when the embedding was padded to a
    multiple of tp; the padded rows are masked to -inf, so they carry no
    probability and get no gradient."""
    from ..distributed.fleet.mp_layers import parallel_cross_entropy
    g = C._axis_group(tp_axis)
    vl = wte_local.shape[0]
    logits = torch.einsum("bsh,vh->bsv", h, wte_local.to(h.dtype))
    logits = logits[:, :-1].float()
    if valid_vocab is not None:
        rows = g.rank * vl + torch.arange(vl, device=logits.device)
        logits = logits.masked_fill(~(rows < valid_vocab)[None, None],
                                    -torch.inf)
    return parallel_cross_entropy(logits, labels[:, 1:], g).mean()


# ------------------------------ layouts ------------------------------
def _reshape_qkv(blocks):
    """[..., h, 3h] -> [..., h, 3, h] (and the bias [..., 3h] -> [..., 3, h]),
    so that a shard of the last dim takes a slice of each of q, k and v
    (a flat 3h / tp slice would straddle the q|k boundary). Row-major:
    W[..., i, k h + j] == W'[..., i, k, j], the split(qkv, 3, -1) that the
    single-device block computes."""
    b = dict(blocks)
    qw, qb = b["qkv_w"], b["qkv_b"]
    h3 = qw.shape[-1]
    b["qkv_w"] = qw.reshape(tuple(qw.shape[:-1]) + (3, h3 // 3))
    b["qkv_b"] = qb.reshape(tuple(qb.shape[:-1]) + (3, h3 // 3))
    return b


def _unreshape_qkv_grads(bgrads, like):
    g = dict(bgrads)
    g["qkv_w"] = g["qkv_w"].reshape(like["qkv_w"].shape)
    g["qkv_b"] = g["qkv_b"].reshape(like["qkv_b"].shape)
    return g


# ------------------------ zero-bubble pipelines ------------------------
def train_grads_zb_manual_tp(params, batch, cfg: GPTConfig, pcfg, mesh=None):
    """Loss and gradients (trees) of this rank's stage through the
    zero-bubble pipelines (and 1F1B with the ring collective matmuls) with
    the manual-tp stage body: the reference's embedding-outside,
    head-as-last-stage-seed structure, a rank at a time (gpt_hybrid's
    pipeline over the (dp, pp, tp) grid). The head is the vocab-parallel
    CE (``ce_vocab_parallel``; a vocab that tp does not divide is padded
    to a multiple of tp and its pad rows masked). ``mesh`` is accepted
    for the reference's signature; the groups are the grid's."""
    from .gpt_hybrid import _grid, _pp_loss_and_grads
    b, s = batch[0].shape
    if pcfg.sp and s % pcfg.tp:
        raise ValueError(f"sp requires seq len {s} % tp {pcfg.tp} == 0")
    if cfg.num_heads % pcfg.tp:
        raise ValueError(
            f"manual-tp stage needs num_heads {cfg.num_heads} % tp "
            f"{pcfg.tp} == 0 (heads are the column-parallel unit)")
    if pcfg.fused_ce:
        import warnings
        warnings.warn(
            "fused_ce is not available on the manual-tp pipeline "
            "route; using the vocab-parallel CE head (identical math, "
            "materializes [tokens, vocab/tp] logits per microbatch)",
            stacklevel=3)
    return _pp_loss_and_grads(params, batch, cfg, pcfg, _grid(pcfg),
                              vocab_parallel=True)


# ------------------- entries that a later slice brings -------------------
_EP = "the expert-parallel slice (ROADMAP queue 1, item 5d)"


def _ep(name):
    def entry(*args, **kwargs):
        raise NotImplementedError(f"{name} (the manual expert-parallel body) "
                                  f"comes with {_EP}")
    entry.__name__ = name
    entry.__doc__ = "The manual expert-parallel body; comes with " + _EP + "."
    return entry


moe_ffn_manual_ep = _ep("moe_ffn_manual_ep")
block_manual_ep = _ep("block_manual_ep")
stack_apply_manual_ep = _ep("stack_apply_manual_ep")
train_grads_zb_manual_ep = _ep("train_grads_zb_manual_ep")
