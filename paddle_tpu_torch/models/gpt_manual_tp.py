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
with the reference's vocab-parallel head.

The manual expert-parallel bodies (the reference's zero-bubble x MoE stage,
``moe_ffn_manual_ep``) are gpt_hybrid's ep branch at every (dp, pp, tp):
each dp rank holds E / dp experts, routes its own tokens and exchanges the
dispatched [E, T, h] tokens for its experts' [E / dp, dp T, h] with one
all-to-all over dp, and back with another. With experts beside tp the
expert's inner dim is split over tp (the reference's fc1_w P(pp, "dp",
None, "tp")): the exchanged tokens enter the column-parallel fc1 through a
pvary, fc2's partial outputs are psum'd over tp on the expert side, once,
before the bias and the reverse exchange, and under sp the tokens are the
whole sequence, gathered before the gate and split again after the
combine. The same rule as the tp collectives holds: each all-to-all sits
between two checkpointed runs, never inside one, so backward re-issues
none; a step issues 4 a layer a microbatch pass (2 forward, 2 backward).
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


def block_manual_tp(x, lp, cfg: GPTConfig, pcfg, tp_axis="tp", ep_axis=None):
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
    collective_matmul: those pairs are the ring collective matmuls. With
    experts the MLP is ``moe_ffn_manual_ep`` over ``ep_axis`` (the dp
    group) with the experts' inner dim split over tp.
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
        if pcfg.num_experts > 0:
            return x + moe_ffn_manual_ep(hx, lp, pcfg.num_experts, ep_axis,
                                         pcfg, g)
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
    if pcfg.num_experts > 0:
        return x + moe_ffn_manual_ep(hx, lp, pcfg.num_experts, ep_axis, pcfg,
                                     g)
    part = run(mlp, pcfg, "ffn1", "ffn2")(
        gather(hx), lp["fc1_w"], lp["fc1_b"], lp["fc2_w"])
    return run(residual, pcfg)(x, reduce(part), lp["fc2_b"])


def stack_apply_manual_tp(blocks, x, cfg, pcfg, tp_axis="tp",
                          ep_axis=None):
    """The layer loop over this rank's stacked [L, ...] shards (the manual-tp
    ``_stack_apply``); ``unbind`` hands out per-layer views whose gradients
    are stacked back once. With experts, ``ep_axis`` is the dp group they
    shard over."""
    names = sorted(blocks)
    for leaves in zip(*(torch.unbind(blocks[n], 0) for n in names)):
        x = block_manual_tp(x, dict(zip(names, leaves)), cfg, pcfg, tp_axis,
                            ep_axis)
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


# ------------------- manual-ep MoE stage (zb x MoE) -------------------
def _route(x, gate_w, e):
    """Top-1 routing of x's tokens: (dispatch [E, T, 1], gate [T], the
    dispatched tokens [E, T, h]); the reference's one-hot dispatch einsum
    written as a broadcast product (gpt_hybrid._moe_ffn)."""
    tokens = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(tokens.float() @ gate_w.float(), -1)
    gate = probs.max(-1).values.to(x.dtype)
    disp = F.one_hot(probs.argmax(-1), e).to(x.dtype).t()[:, :, None]
    return disp, gate, disp * tokens


def _experts(xin, w1, b1, w2):
    """The local experts over their tokens [E_l, T, h], before fc2's bias
    (a partial sum over tp when the inner dim is split)."""
    hmid = F.gelu(torch.einsum("eth,ehm->etm", xin, w1) + b1[:, None, :],
                  approximate="tanh")
    return torch.einsum("etm,emh->eth", hmid, w2)


def _combine(disp, hout, gate):
    return (disp * hout).sum(0) * gate[:, None]


def moe_ffn_manual_ep(x, lp, num_experts, ep_axis="dp", pcfg=None,
                      tp_axis=None):
    """GShard switch MoE with the experts sharded over ``ep_axis`` (a mesh
    axis or the dp Group) and explicit all-to-alls: the port of the
    reference's ``moe_ffn_manual_ep``, run under ``pcfg``'s remat policy
    (each computation between two collectives a checkpointed run).

    Local shapes: x [bl, s, h] (this rank's rows; under sp at tp > 1 its
    slice of the sequence); fc1_w [E_l, h, m_l], fc1_b [E_l, m_l], fc2_w
    [E_l, m_l, h], fc2_b [E_l, h] (E_l = E / ep ranks, m_l = m / tp);
    gate_w [h, E] replicated. ``tp_axis`` (with experts beside tp) is the
    group the inner dim splits over."""
    g_ep = C._axis_group(ep_axis)
    g_tp = C._axis_group(tp_axis) if tp_axis is not None else None
    if pcfg is None:
        from .gpt_hybrid import ParallelConfig
        pcfg = ParallelConfig(num_experts=num_experts, remat=False)
    run = _remat_wrap
    sp = bool(pcfg.sp) and g_tp is not None
    # under sp the whole sequence routes on every tp rank: its gradient
    # here is whole on each, so the gather's backward keeps this rank's
    # slice (no sum)
    full = C._GatherInvariant.apply(x, g_tp, 1) if sp else x
    disp, gate, xin = run(_route, pcfg)(full, lp["gate_w"], num_experts)
    # expert shards out, token shards in: [E_l, ep * T, h]
    xin = C._AllToAll.apply(xin, g_ep, 0, 1, True)
    if g_tp is not None:
        xin = C._Pvary.apply(xin, g_tp)
    hout = run(_experts, pcfg)(xin, lp["fc1_w"], lp["fc1_b"], lp["fc2_w"])
    if g_tp is not None:
        hout = C._Psum.apply(hout, g_tp)
    hout = hout + lp["fc2_b"][:, None, :]
    # token shards out, expert shards in: [E, T, h]
    hout = C._AllToAll.apply(hout, g_ep, 1, 0, True)
    out = run(_combine, pcfg)(disp, hout, gate).reshape(full.shape)
    return C._Split.apply(out, g_tp, 1) if sp else out


def block_manual_ep(x, lp, cfg: GPTConfig, pcfg, ep_axis="dp"):
    """The transformer block of the zero-bubble x MoE stage (tp = 1): local
    attention, then ``moe_ffn_manual_ep``. ``lp["qkv_w"]`` is the flat
    [h, 3 h] weight (or the reference's [h, 3, h] reshape of it)."""
    h = x.shape[-1]
    qw, qb = lp["qkv_w"], lp["qkv_b"]

    def attention(x, g1, b1, w, b, pw, pb, g2, b2):
        hx = _layer_norm(x, g1, b1)
        qkv = _linear(hx, w, b)                               # "qkv"
        a = _attend(qkv[..., :h], qkv[..., h:2 * h], qkv[..., 2 * h:],
                    cfg.num_heads)                            # "attn_out"
        x = x + _mm(a, pw) + pb                               # "proj"
        return x, _layer_norm(x, g2, b2)

    x, hx = _remat_wrap(attention, pcfg, "qkv", "proj")(
        x, lp["ln1_g"], lp["ln1_b"], qw.reshape(h, -1), qb.reshape(-1),
        lp["proj_w"], lp["proj_b"], lp["ln2_g"], lp["ln2_b"])
    return x + moe_ffn_manual_ep(hx, lp, pcfg.num_experts, ep_axis, pcfg)


def stack_apply_manual_ep(blocks, x, cfg, pcfg, ep_axis="dp"):
    """The layer loop of ``block_manual_ep`` over this rank's stacked
    [L, ...] leaves."""
    names = sorted(blocks)
    for leaves in zip(*(torch.unbind(blocks[n], 0) for n in names)):
        x = block_manual_ep(x, dict(zip(names, leaves)), cfg, pcfg, ep_axis)
    return x


def train_grads_zb_manual_ep(params, batch, cfg: GPTConfig, pcfg, mesh=None):
    """Loss and gradients (trees) of this rank's stage through the
    zero-bubble pipelines with the manual-ep stage body (tp = 1, experts
    over dp > 1): the reference's route, whose head is the plain CE
    (fused_ce and sp are ignored, with its warning). ``batch`` is this dp
    rank's rows; ``mesh`` is accepted for the reference's signature."""
    from dataclasses import replace
    from .gpt_hybrid import _grid, _pp_loss_and_grads
    assert pcfg.tp == 1 and pcfg.num_experts > 0 and pcfg.dp > 1
    if pcfg.num_experts % pcfg.dp:
        raise ValueError(
            f"manual-ep stage needs num_experts {pcfg.num_experts} % "
            f"dp {pcfg.dp} == 0 (experts shard over the dp axis)")
    if pcfg.fused_ce or pcfg.sp:
        import warnings
        warnings.warn(
            "the manual-ep zero-bubble route supports neither fused_ce "
            "(the head materializes [tokens, vocab] logits per "
            "microbatch) nor sp — both are ignored on this route",
            stacklevel=3)
    m = pcfg.microbatches
    b = batch[0].shape[0] * pcfg.dp
    if b % m or (b // m) % pcfg.dp:
        raise ValueError(
            f"manual-ep needs batch {b} divisible by microbatches {m} "
            f"and each microbatch's {b // m if b % m == 0 else '?'} "
            f"rows divisible by dp {pcfg.dp} (the batch shards over "
            "the manual dp axis)")
    pcfg = replace(pcfg, fused_ce=False, sp=False, collective_matmul=False)
    return _pp_loss_and_grads(params, batch, cfg, pcfg, _grid(pcfg))
