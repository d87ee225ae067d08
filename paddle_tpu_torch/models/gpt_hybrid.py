"""GPT training step: the port of ``paddle_tpu/models/gpt_hybrid.py``.

The reference compiles one SPMD program over a (dp, pp, tp) mesh; this port
runs its single-device case eagerly on one CUDA card, and its data-, tensor-
and pipeline-parallel cases over ``torch.distributed``, one process a GPU,
the ranks a (dp, pp, tp) grid with tp innermost (see "data parallel",
"tensor parallel", "pipeline parallel" and "expert parallel" below):

- parameters are the reference's dict of stacked ``[L, ...]`` block leaves
  in the ``x @ W`` orientation, so ``params_from_jax`` is a plain copy (at
  tp > 1, this rank's shards of them);
- attention goes through ``ops/hopper/flash_attention.flash_attention_maybe``
  (the Hopper ``simple_attention`` kernel at the 1.3B shape,
  ``causal_attention`` at S=2048 and ``blocked_flash`` at S=4096 on the
  350M-class rungs, ``qblock_attention`` at S=4096 with 64-wide heads, or
  the attention autotuner's measured winner), with the reference's plain
  einsum where dispatch returns None;
- ``num_experts`` > 0 makes each block's MLP the reference's GShard
  dense-dispatch switch MoE (``_moe_ffn``: top-1 routing, every expert
  run over the dispatched [E, T, H] tokens); with a process group, the
  experts shard over dp (``gpt_manual_tp.moe_ffn_manual_ep``: two
  all-to-alls a layer);
- remat is ``torch.utils.checkpoint`` per block; the ``"names"`` and
  ``"dots"`` policies are selective-checkpoint policies over aten ops and
  the attention op;
- the LM head and loss are ``ops/fused_ce.FusedLMCE`` or plain logits;
- AdamW is the reference's per-leaf update, written out in f32, applied in
  place (the reference donates params and state to its step);
- ``build_accum_steps`` is the reference's split gradient accumulation:
  ``grad_step`` adds one chunk's gradients into the accumulator in place,
  ``apply_step`` averages them, updates and zeroes the accumulator in place
  (the reference donates the accumulator to both programs).
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
    """The reference's ParallelConfig, field for field. ``dp`` x ``tp`` > 1
    needs a process group of dp x tp ranks
    (``distributed.init_parallel_env``); ``zero1`` shards the Adam moments
    over the dp ranks, ``tp`` shards the weights Megatron's way, ``sp``
    shards the activations between the blocks over the sequence, and
    ``collective_matmul`` (with ``sp``) makes the sequence-parallel matmuls
    ring collective matmuls. ``pp`` > 1 splits the layers into pp stages,
    a rank each, run as ``pp_schedule`` ("gpipe", "1f1b", "zbh1", "zbvpp")
    over ``microbatches`` microbatches; ``vpp_chunks`` > 1 (with "1f1b")
    gives each stage that many interleaved chunks (``_validate_pp_schedule``
    has the reference's rules). ``num_experts`` > 0 beside a process group
    shards the experts over dp (each dp rank holds E / dp of them).
    ``scan_unroll`` (lax.scan unrolling) has no effect in eager PyTorch."""
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
    """The reference's pipeline refusals (``_validate_pp_schedule``), its
    refusal of an expert dim that dp does not divide (which its
    ``param_specs`` shard over dp), and dp x pp x tp > 1 unless a process
    group of exactly that many ranks exists."""
    _validate_pp_schedule(pcfg)
    if pcfg.num_experts > 0 and pcfg.dp > 1 and pcfg.num_experts % pcfg.dp:
        raise ValueError(
            f"expert parallelism shards experts over dp: num_experts "
            f"{pcfg.num_experts} must divide by dp {pcfg.dp}")
    ranks = pcfg.dp * pcfg.pp * pcfg.tp
    if ranks > 1:
        from ..distributed.env import get_world_size, is_initialized
        if not is_initialized():
            raise RuntimeError(
                f"dp={pcfg.dp} x pp={pcfg.pp} x tp={pcfg.tp} runs one "
                f"process a GPU: start {ranks} ranks (python -m "
                "paddle_tpu_torch.distributed.launch) and call "
                "paddle_tpu_torch.distributed.init_parallel_env() first")
        if get_world_size() != ranks:
            raise ValueError(f"dp={pcfg.dp} x pp={pcfg.pp} x tp={pcfg.tp} "
                             f"but the process group has {get_world_size()} "
                             "ranks")
    if pcfg.remat and pcfg.remat_policy not in ("full", "dots", "names"):
        raise ValueError(f"unknown remat_policy {pcfg.remat_policy!r}")


def _validate_pp_schedule(pcfg):
    """The reference's pp-schedule validation, with its messages."""
    if pcfg.pp_schedule not in ("gpipe", "1f1b", "zbh1", "zbvpp"):
        raise ValueError(
            f"pp_schedule must be 'gpipe', '1f1b', 'zbh1' or 'zbvpp', "
            f"got {pcfg.pp_schedule!r}")
    if pcfg.vpp_chunks > 1 and (pcfg.pp <= 1
                                or pcfg.pp_schedule != "1f1b"):
        raise ValueError(
            "vpp_chunks > 1 requires pp > 1 with pp_schedule='1f1b' "
            "(the interleaved schedule generalizes the compiled 1F1B; "
            "'zbvpp' brings its own two V-placed chunks)")
    if pcfg.pp_schedule in ("zbh1", "zbvpp") and pcfg.num_experts > 0 \
            and pcfg.tp > 1:
        raise ValueError(
            f"pp_schedule={pcfg.pp_schedule!r} with BOTH tp>1 and "
            "expert-parallel MoE: the manual stage bodies exist per "
            "axis (manual-tp, manual-ep — models/gpt_manual_tp.py) but "
            "not combined. Use tp=1 for zb x MoE, or '1f1b' for the "
            "full tp x ep hybrid.")
    if pcfg.pp_schedule in ("zbh1", "zbvpp") and pcfg.num_experts > 0 \
            and pcfg.dp > 1 and pcfg.num_experts % pcfg.dp:
        raise ValueError(
            f"zb x MoE shards experts over dp: num_experts "
            f"{pcfg.num_experts} must divide by dp {pcfg.dp}")
    if pcfg.pp_schedule == "zbvpp" and pcfg.pp <= 1:
        raise ValueError("pp_schedule='zbvpp' requires pp > 1 (the "
                         "V placement spans a pipeline ring)")
    if pcfg.pp_schedule in ("zbh1", "zbvpp") and pcfg.tp > 1 \
            and pcfg.collective_matmul:
        raise ValueError(
            "collective_matmul does not compose with the zero-bubble "
            "schedules: the ring's tp ppermute lowers to ONE "
            "collective-permute spanning the whole mesh, and inside a "
            "cond-gated phase the idle pipeline stages never reach it "
            "(cross-matched data or rendezvous deadlock). Use "
            "pp_schedule='1f1b' for the ring under pp>1, or drop "
            "collective_matmul for zero-bubble.")
    if _cm_dropped(pcfg):
        import warnings
        warnings.warn(
            "collective_matmul requested but not routable at pp>1 "
            "(needs pp_schedule='1f1b', vpp_chunks=1, sp=True, tp>1, "
            "no MoE, fused_ce=False — the manual-tp route; with "
            "fused_ce=True the fused-CE memory win keeps the GSPMD "
            "route); running WITHOUT the ring overlap", stacklevel=3)


def _cm_dropped(pcfg):
    """collective_matmul at pp > 1 where the reference runs without the
    ring (it rides its manual-tp 1F1B route only)."""
    return pcfg.collective_matmul and pcfg.pp > 1 and not (
        pcfg.pp_schedule == "1f1b" and pcfg.vpp_chunks == 1
        and pcfg.sp and pcfg.tp > 1 and pcfg.num_experts == 0
        and not pcfg.fused_ce)


def _distributed() -> bool:
    from ..distributed.env import is_initialized
    return is_initialized()


def _ep(pcfg) -> bool:
    """Whether the experts shard over dp (the expert-parallel branch): with
    experts and a process group, at any dp (a group of one included)."""
    return pcfg.num_experts > 0 and _distributed()


# ------------------------------ init ---------------------------------------
def init_params(cfg: GPTConfig, pcfg: ParallelConfig,
                generator: torch.Generator, device=None) -> Dict:
    """The reference's parameters and distributions (normal, std 0.02,
    residual projections scaled by 1/sqrt(2L); with experts, the gate
    [L, h, E] and the FFN leaves stacked [L, E, ...]), drawn from ``generator``
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
    }
    if pcfg.num_experts > 0:
        e = pcfg.num_experts
        blocks.update({
            "gate_w": normal((L, h, e), std),
            "fc1_w": normal((L, e, h, m), std),
            "fc1_b": const((L, e, m), 0.0),
            "fc2_w": normal((L, e, m, h), std / math.sqrt(2 * L)),
            "fc2_b": const((L, e, h), 0.0),
        })
    else:
        blocks.update({
            "fc1_w": normal((L, h, m), std),
            "fc1_b": const((L, m), 0.0),
            "fc2_w": normal((L, m, h), std / math.sqrt(2 * L)),
            "fc2_b": const((L, h), 0.0),
        })
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


def params_from_jax(np_tree, device=None, tp_rank=0, tp=1, pp_rank=0, pp=1,
                    dp_rank=0, dp=1):
    """The reference's parameter (or moment) dict, as numpy arrays, to
    torch tensors with the same keys and dtypes; at ``pp`` > 1 its block
    leaves are the reference's stage-stacked ones ([pp, L / pp, ...], or
    [pp, v, Lc, ...] interleaved, or [pp, 2, Lc, ...] in the ZB-V
    placement) and this rank keeps stage ``pp_rank``'s entry; at ``tp`` > 1
    this rank's shards of them, as the reference's ``param_specs`` shards
    them (``tp_shard``); with experts at ``dp`` > 1, this rank's experts
    (``ep_shard``)."""
    dev = resolve_device(device)

    def convert(t, stage):
        if isinstance(t, dict):
            return {k: convert(v, stage) for k, v in t.items()}
        if stage:
            t = np.asarray(t)[pp_rank]
        return _to_torch(t, dev)
    tree = {k: convert(v, k == "blocks" and pp > 1)
            for k, v in np_tree.items()}
    tree = tp_shard(tree, tp_rank, tp) if tp > 1 else tree
    return ep_shard(tree, dp_rank, dp)


# --------------------------- pipeline layout -------------------------------
# The reference's shard_params stacks the block leaves by stage: [pp, L/pp]
# (layer l on stage l // (L/pp)); with vpp_chunks = v, [pp, v, Lc] (virtual
# stage sigma = j * pp + s, layers [sigma Lc, (sigma + 1) Lc), at [s, j]);
# under "zbvpp", [pp, 2, Lc] (the V placement: stage s holds virtual stages
# s and 2 pp - 1 - s). A rank holds its stage's entry.
def _stage_layers(pcfg, num_layers, pp_rank):
    """The global layer ids of stage ``pp_rank``'s block leaves, in their
    order (chunk-major where the leaves carry a chunk dim)."""
    L, pp, v = num_layers, pcfg.pp, pcfg.vpp_chunks
    if pcfg.pp_schedule == "zbvpp":
        ng = 2 * pp
        if L % ng:
            raise ValueError(
                f"num_layers {L} not divisible by 2*pp {ng} "
                "(pp_schedule='zbvpp' splits the model into 2*pp "
                "V-placed chunks)")
        lc = L // ng
        return [sg * lc + i for sg in (pp_rank, ng - 1 - pp_rank)
                for i in range(lc)]
    if L % (pp * v):
        raise ValueError(f"num_layers {L} not divisible by pp*vpp_chunks "
                         f"{pp}*{v}")
    lc = L // (pp * v)
    return [(j * pp + pp_rank) * lc + i for j in range(v) for i in range(lc)]


def _chunked(pcfg):
    """Whether a stage's block leaves carry a chunk dim."""
    return pcfg.pp_schedule == "zbvpp" or pcfg.vpp_chunks > 1


def pp_stage(tree, cfg, pcfg, pp_rank):
    """Stage ``pp_rank``'s share of a tree in the flat [L, ...] layout
    (``init_params``'): its block leaves in the reference's per-stage
    layout, the rest whole."""
    if pcfg.pp <= 1:
        return tree
    ids = _stage_layers(pcfg, cfg.num_layers, pp_rank)
    out = dict(tree)

    def take(x):
        x = x[ids]
        if _chunked(pcfg):
            v = 2 if pcfg.pp_schedule == "zbvpp" else pcfg.vpp_chunks
            x = x.reshape((v, len(ids) // v) + tuple(x.shape[1:]))
        return x.contiguous()
    out["blocks"] = {k: take(v) for k, v in tree["blocks"].items()}
    return out


def _stage_flat(x, pcfg):
    """A stage block leaf with its chunk dim (if any) folded into the
    layer dim."""
    return x.reshape((-1,) + tuple(x.shape[2:])) if _chunked(pcfg) else x


# --------------------------- tensor-parallel layout ------------------------
# The reference's param_specs shard the block weights Megatron's way over
# "tp": qkv_w/qkv_b and fc1_w/fc1_b by columns, proj_w and fc2_w by rows, the
# rest replicated; wte by vocab rows when tp divides the vocab, replicated
# otherwise. GSPMD shards qkv_w's flat last dim, which straddles q|k|v; here
# a rank holds its columns of each of q, k and v (the manual-tp layout,
# gpt_manual_tp._reshape_qkv), flattened back: [L, h, 3 h / tp].
_TP_COLUMNS = ("qkv_w", "qkv_b", "fc1_w", "fc1_b")
_TP_ROWS = ("proj_w", "fc2_w")


def _vocab_sharded(vocab, tp):
    return vocab % tp == 0


def _tp_slice(name, x, tp_rank, tp):
    """This rank's shard of one block leaf."""
    if name in ("qkv_w", "qkv_b"):
        h = x.shape[-1] // 3
        x = x.reshape(tuple(x.shape[:-1]) + (3, h))
        x = x.chunk(tp, -1)[tp_rank]
        return x.reshape(tuple(x.shape[:-2]) + (-1,))
    if name in _TP_COLUMNS:
        return x.chunk(tp, -1)[tp_rank]
    if name in _TP_ROWS:
        return x.chunk(tp, -2)[tp_rank]
    return x


def tp_shard(tree, tp_rank, tp):
    """This tp rank's shards of a parameter (or moment) tree in the
    reference's global layout."""
    out = dict(tree)
    out["blocks"] = {k: _tp_slice(k, v, tp_rank, tp).contiguous()
                     for k, v in tree["blocks"].items()}
    if _vocab_sharded(tree["wte"].shape[0], tp):
        out["wte"] = tree["wte"].chunk(tp, 0)[tp_rank].contiguous()
    return out


def _tp_gather_leaf(name, x, group, vocab_rows=None):
    """The global leaf from every tp rank's shard (eager all-gathers)."""
    from ..distributed import collective as C
    if group.nranks == 1:
        return x.clone()
    if name in ("qkv_w", "qkv_b"):
        hl = x.shape[-1] // 3
        full = C._gather_along(x.reshape(tuple(x.shape[:-1]) + (3, hl)),
                               group, x.dim())
        return full.reshape(tuple(x.shape[:-1]) + (-1,))
    if name in _TP_COLUMNS:
        return C._gather_along(x, group, x.dim() - 1)
    if name in _TP_ROWS:
        return C._gather_along(x, group, x.dim() - 2)
    if name == "wte" and vocab_rows is not None and x.shape[0] != vocab_rows:
        return C._gather_along(x, group, 0)
    return x.clone()


def _tp_gather(tree, group, vocab):
    out = {k: _tp_gather_leaf(k, v, group, vocab)
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = {k: _tp_gather_leaf(k, v, group)
                     for k, v in tree["blocks"].items()}
    return out


# --------------------------- expert-parallel layout ------------------------
# The reference's param_specs shard the expert dim of the MoE leaves over dp
# (EP = DP, fc1_w P(pp, "dp", None, "tp") and the like); the gate is
# replicated. A dp rank holds its E / dp experts: the leaves' E dim is the
# third from last for the weights ([..., E, h, m]) and the second from last
# for the biases ([..., E, m]), in every stage layout.
_EP_LEAVES = ("fc1_w", "fc1_b", "fc2_w", "fc2_b")


def _moe(tree):
    return "gate_w" in tree.get("blocks", {})


def _ep_dim(name, x):
    return x.dim() - (3 if name.endswith("_w") else 2)


def ep_shard(tree, dp_rank, dp):
    """This dp rank's experts of a parameter (or moment) tree (the tree
    itself without experts or at dp = 1)."""
    if dp <= 1 or not _moe(tree):
        return tree
    out = dict(tree)
    out["blocks"] = {
        k: v.chunk(dp, _ep_dim(k, v))[dp_rank].contiguous()
        if k in _EP_LEAVES else v for k, v in tree["blocks"].items()}
    return out


def _ep_gather(tree, group):
    """Every dp rank's experts concatenated back (eager all-gathers)."""
    from ..distributed import collective as C
    if group.nranks == 1 or not _moe(tree):
        return tree
    out = dict(tree)
    out["blocks"] = {
        k: C._gather_along(v, group, _ep_dim(k, v)) if k in _EP_LEAVES
        else v for k, v in tree["blocks"].items()}
    return out


#: leaves used on this rank's slice of the sequence only under sp: their
#: gradients are summed over tp (the reference gets this from GSPMD; the
#: fleet layers from register_sequence_parallel_allreduce_hooks)
_SP_BLOCK_LEAVES = ("ln1_g", "ln1_b", "ln2_g", "ln2_b", "proj_b", "fc2_b")
_SP_TOP_LEAVES = ("lnf_g", "lnf_b", "wpe")


def eager_params_from_jax(tree, device=None, stop_gradient=False):
    """A parameter dict as the port's eager Tensors on ``device``. Each leaf
    is a numpy array or a torch tensor (``stop_gradient`` applies; a torch
    tensor already on ``device`` is shared, not copied), or one of the
    reference's eager Tensors (its ``.numpy()`` and its stop_gradient are
    carried over)."""
    from ..core.tensor import Tensor
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: eager_params_from_jax(v, dev, stop_gradient)
                for k, v in tree.items()}
    if hasattr(tree, "stop_gradient") and hasattr(tree, "numpy"):
        stop_gradient, tree = tree.stop_gradient, tree.numpy()
    arr = tree.to(dev) if isinstance(tree, torch.Tensor) else _to_torch(tree,
                                                                        dev)
    return Tensor(arr, place=dev, stop_gradient=stop_gradient)


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


def _moe_ffn(x, lp, pcfg):
    """GShard-style dense-dispatch switch MoE: top-1 routing, each expert
    run over the [E, T, H] dispatched tokens, scaled by the gate
    probability. Issues no addmm (see _policy).

    The reference's dispatch and combine einsums ("te,th->eth",
    "te,eth->th") are written as broadcast products (and a sum over E):
    with a one-hot dispatch every output is one product, or one product
    plus exact zeros, so the values are the einsums'; torch would issue
    the first as a batched GEMM of T (E x 1) @ (1 x H) products."""
    b, s, h = x.shape
    e = pcfg.num_experts
    tokens = x.reshape(b * s, h)
    gate_logits = tokens.float() @ lp["gate_w"].float()
    probs = torch.softmax(gate_logits, -1)
    top = probs.argmax(-1)
    gate = probs.max(-1).values.to(x.dtype)
    disp = F.one_hot(top, e).to(x.dtype).t()[:, :, None]  # [E, T, 1]
    xin = disp * tokens                                   # dispatch
    hmid = F.gelu(torch.einsum("eth,ehm->etm", xin, lp["fc1_w"])
                  + lp["fc1_b"][:, None, :], approximate="tanh")
    hout = torch.einsum("etm,emh->eth", hmid, lp["fc2_w"]) \
        + lp["fc2_b"][:, None, :]
    combined = (disp * hout).sum(0) * gate[:, None]
    return combined.reshape(b, s, h)


def _block(x, lp, cfg, pcfg):
    hres = x
    hx = _layer_norm(x, lp["ln1_g"], lp["ln1_b"])
    qkv = _linear(hx, lp["qkv_w"], lp["qkv_b"])                  # "qkv"
    h = cfg.hidden_size
    attn = _attend(qkv[..., :h], qkv[..., h:2 * h], qkv[..., 2 * h:],
                   cfg.num_heads)                                 # "attn_out"
    x = hres + _linear(attn, lp["proj_w"], lp["proj_b"])         # "proj"
    hres = x
    hx = _layer_norm(x, lp["ln2_g"], lp["ln2_b"])
    if pcfg.num_experts > 0:
        return hres + _moe_ffn(hx, lp, pcfg)
    ff = F.gelu(_linear(hx, lp["fc1_w"], lp["fc1_b"]),            # "ffn1"
                approximate="tanh")
    return hres + _linear(ff, lp["fc2_w"], lp["fc2_b"])          # "ffn2"


# The order in which _block issues its addmm ops: four, or with experts the
# first two (_moe_ffn issues none; the reference names nothing inside it).
_LINEAR_NAMES = ("qkv", "proj", "ffn1", "ffn2")
_DOTS = (torch.ops.aten.addmm.default, torch.ops.aten.mm.default,
         torch.ops.aten.bmm.default)


def _policy_context(pcfg):
    """Selective-checkpoint contexts for one block call (``_policy``)."""
    return create_selective_checkpoint_contexts(_policy(pcfg))


def _policy(pcfg):
    """The selective-checkpoint policy of one block call.

    "dots": save every matmul output (jax's dots_saveable), recompute the
    rest, the attention op included. "names": save the outputs named in
    remat_save_names, recognised by op: "attn_out" is any of the Hopper
    attention ops (all their outputs: o, and the lse that the
    causal_attention and blocked_flash backwards read), and
    "qkv"/"proj"/"ffn1"/"ffn2" are _block's addmm calls in order (with
    experts only "qkv" and "proj"; the MoE FFN's products are saved under
    "dots" and never under "names", as in the reference).
    Where attention takes the plain path (CPU), "attn_out" names no op and
    is recomputed; values are the same either way."""
    names = set(pcfg.remat_save_names)
    linear_names = _LINEAR_NAMES[:2] if pcfg.num_experts > 0 \
        else _LINEAR_NAMES
    seen = {False: 0, True: 0}     # addmm calls so far, forward / recompute

    def policy(ctx, func, *args, **kwargs):
        if pcfg.remat_policy == "dots":
            save = func in _DOTS
        elif func in ATTENTION_OPS:
            save = "attn_out" in names
        elif func == torch.ops.aten.addmm.default:
            i = seen[ctx.is_recompute]
            seen[ctx.is_recompute] = i + 1
            save = linear_names[i] in names
        else:
            save = False
        return (CheckpointPolicy.MUST_SAVE if save
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def _stack_apply(blocks, x, cfg, pcfg):
    """The layer loop (the reference's lax.scan), one checkpoint per block
    under remat. ``unbind`` hands out per-layer views whose gradients are
    stacked back once."""
    names = sorted(blocks)
    per_layer = zip(*(torch.unbind(blocks[n], 0) for n in names))
    for leaves in per_layer:
        lp = dict(zip(names, leaves))
        if not pcfg.remat or not torch.is_grad_enabled():
            x = _block(x, lp, cfg, pcfg)
        elif pcfg.remat_policy == "full":
            x = checkpoint(_block, x, lp, cfg, pcfg, use_reentrant=False)
        else:
            x = checkpoint(_block, x, lp, cfg, pcfg, use_reentrant=False,
                           context_fn=lambda: _policy_context(pcfg))
    return x


def forward_hidden(params, input_ids, cfg: GPTConfig, pcfg: ParallelConfig):
    if pcfg.pp > 1:
        return forward_hidden_pp(params, input_ids, cfg, pcfg)
    cdt = pcfg.compute_dtype
    b, s = input_ids.shape
    x = F.embedding(input_ids, params["wte"]).to(cdt) + \
        params["wpe"][:s][None].to(cdt)
    blocks = {k: p.to(cdt) for k, p in params["blocks"].items()}
    if _ep(pcfg):
        from .gpt_manual_tp import stack_apply_manual_ep
        x = stack_apply_manual_ep(blocks, x, cfg, pcfg, _grid(pcfg).dp_group)
    else:
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
    if pcfg.pp > 1:
        return loss_fn_pp(params, batch, cfg, pcfg)
    if _distributed() and _grid(pcfg).tp_branch:
        return loss_fn_tp(params, batch, cfg, pcfg, _grid(pcfg).tp_group)
    input_ids, labels = batch
    # forward_hidden already applies the final layer norm
    x = forward_hidden(params, input_ids, cfg, pcfg)
    return _ce_from_hidden(x, params["wte"], labels, pcfg)


# --------------------------- tensor parallel -------------------------------
# The reference's tp and sp branches are GSPMD's: one global program, the
# weights sharded by param_specs, the activations constrained to
# P("dp", "tp", None) between blocks under sp. Here each rank of the tp group
# holds its shards and runs gpt_manual_tp's block (Megatron's explicit
# collectives, the differentiable distributed.collective Functions). The
# embedding is a masked lookup of this rank's vocab rows, psum'd (non-sp)
# or reduce-scattered onto the sequence (sp); with the vocab replicated
# (tp does not divide it) each rank looks up its own positions under sp.
# The LM head, under fused_ce, is FusedLMCE over this rank's share of the
# tokens (its slice of the sequence) with the whole wte (all-gathered from
# the vocab shards, whose gradient is reduce-scattered back): the losses'
# sums are psum'd and divided by the global count of next-token positions,
# the reference's mean. Its peak at Llama-7B width is the gathered wte
# (V x h, 0.26 GB in bf16) and one chunk of logits, never [T, V]. Without
# fused_ce, a vocab-sharded head is gpt_manual_tp.ce_vocab_parallel (the
# cross-rank max and sum). Under sp the leaves used on the sequence slice
# only (_SP_*_LEAVES, and a replicated wte) get their gradients summed over
# tp after the backward.
def _ce_sum(h, w, tgt, mask, fused):
    """The sum over the tokens of ``mask`` of the next-token CE of h @ w.T."""
    hid = h.shape[-1]
    if fused:
        m = mask.reshape(-1)
        return fused_lm_ce(h.reshape(-1, hid), w.to(h.dtype),
                           tgt.reshape(-1), m) * m.sum()
    logits = torch.einsum("bsh,vh->bsv", h, w.to(h.dtype)).float()
    ce = torch.logsumexp(logits, -1) - logits.gather(
        -1, tgt[..., None])[..., 0]
    return (ce * mask).sum()


def _ce_tp(h, wte, labels, pcfg, group, sharded):
    """The reference's ``_ce_from_hidden`` on a tp group: ``h`` is this
    rank's [b, s / tp, hid] (sp) or the whole [b, s, hid]."""
    from ..distributed import collective as C
    from .gpt_manual_tp import ce_vocab_parallel
    b, s = labels.shape
    n, r = group.nranks, group.rank
    if sharded and not pcfg.fused_ce:
        full = C._AllGather.apply(h, group, 1) if pcfg.sp \
            else C._Pvary.apply(h, group)
        return ce_vocab_parallel(full, wte, labels, group)
    if not pcfg.sp and s % n:
        # no even share of the tokens: every rank runs the whole head
        w = C._GatherInvariant.apply(wte, group, 0) if sharded else wte
        return _ce_from_hidden(h, w, labels, pcfg)
    if not pcfg.sp:
        h = C._Split.apply(h, group, 1)
    sl = s // n
    lo = r * sl
    if sharded:
        w = C._AllGather.apply(wte, group, 0)
    else:
        w = wte if pcfg.sp else C._Pvary.apply(wte, group)
    tgt = torch.cat([labels[:, 1:], labels.new_zeros((b, 1))], 1)
    pos = torch.arange(lo, lo + sl, device=h.device)
    mask = (pos < s - 1).to(torch.float32)[None].expand(b, sl)
    part = _ce_sum(h, w, tgt[:, lo:lo + sl], mask, pcfg.fused_ce)
    return C._Psum.apply(part.reshape(1), group)[0] / (b * (s - 1))


def loss_fn_tp(params, batch, cfg, pcfg, group):
    """``loss_fn`` on one rank of a tp group (a Group): ``params`` are this
    rank's shards (``tp_shard``), ``batch`` the tp group's whole batch."""
    from .gpt_manual_tp import stack_apply_manual_tp
    input_ids, labels = batch
    cdt = pcfg.compute_dtype
    x = _embed_tp(params, input_ids, cfg, pcfg, group)
    blocks = {k: p.to(cdt) for k, p in params["blocks"].items()}
    ep = _grid(pcfg).dp_group if _ep(pcfg) else None
    x = stack_apply_manual_tp(blocks, x, cfg, pcfg, group, ep)
    h = _layer_norm(x, params["lnf_g"].to(cdt), params["lnf_b"].to(cdt))
    return _ce_tp(h, params["wte"], labels, pcfg, group,
                  _vocab_sharded(cfg.vocab_size, group.nranks))


def _embed_tp(params, input_ids, cfg, pcfg, group):
    """The tp branch's embedding: a masked lookup of this rank's vocab rows
    psum'd (non-sp) or reduce-scattered onto the sequence (sp); with the
    vocab replicated, under sp, each rank looks up its own positions."""
    from ..distributed import collective as C
    cdt = pcfg.compute_dtype
    b, s = input_ids.shape
    n, r = group.nranks, group.rank
    if pcfg.sp and s % n:
        raise ValueError(f"sp requires seq len {s} % tp {n} == 0")
    sl = s // n if pcfg.sp else s
    lo = r * sl if pcfg.sp else 0
    wte = params["wte"]
    if _vocab_sharded(cfg.vocab_size, n):
        vl = wte.shape[0]
        loc = input_ids - r * vl
        x = F.embedding(loc.clamp(0, vl - 1), wte) * \
            ((loc >= 0) & (loc < vl))[..., None].to(wte.dtype)
        x = C._ReduceScatter.apply(x, group, 1) if pcfg.sp \
            else C._Psum.apply(x, group)
    else:
        x = F.embedding(input_ids[:, lo:lo + sl], wte)
    return x.to(cdt) + params["wpe"][lo:lo + sl][None].to(cdt)


def _leaf_names(params, prefix=""):
    out = []
    for k in sorted(params):
        v = params[k]
        out.extend(_leaf_names(v, prefix + k + ".") if isinstance(v, dict)
                   else [prefix + k])
    return out


def _sp_leaf_indices(params, cfg, tp):
    """The ``_leaves`` positions whose gradients sp leaves partial (an
    expert's fc2_b is added on the expert side, over every token)."""
    names = set(_SP_TOP_LEAVES) | {f"blocks.{n}" for n in _SP_BLOCK_LEAVES
                                   if not (_moe(params) and n == "fc2_b")}
    if not _vocab_sharded(cfg.vocab_size, tp):
        names.add("wte")
    return [i for i, n in enumerate(_leaf_names(params)) if n in names]


@torch.no_grad()
def _sum_sp_grads(grads, idx, group):
    """Sums the gradients at ``idx`` over the tp group, in one buffer."""
    from ..distributed import collective as C
    grads = list(grads)
    parts = [grads[i] for i in idx]
    flat = torch.cat([g.reshape(-1).float() for g in parts])
    C.all_reduce_flat(flat, C.ReduceOp.SUM, group)
    off = 0
    for i, g in zip(idx, parts):
        grads[i] = flat[off:off + g.numel()].view(g.shape).to(g.dtype)
        off += g.numel()
    return grads


# --------------------------- pipeline parallel -----------------------------
# The reference's pp branch runs the stage-stacked blocks inside shard_map
# over "pp": GPipe as a rotation differentiated by jax.grad, the other
# schedules as compiled tick loops (parallel/pipeline_1f1b.py). Here each
# rank of a pp group holds its stage (pp_stage) and runs the same schedules
# over torch.distributed point-to-point hops (parallel/pipeline*.py). The
# embedding runs on every rank outside the pipeline, and its backward takes
# the first stage's input cotangents (dx0, summed over pp); the head (final
# LayerNorm and CE) is the last stage's seed, its loss and gradients summed
# over pp; the tied wte adds both. The stage body is _stack_apply, or on the
# tp branch gpt_manual_tp's block over the tp group. Every rank of a tp
# group runs the same cells, so their tp collectives pair up.
def _stage_fn(cfg, pcfg, grid):
    ep = grid.dp_group if _ep(pcfg) else None
    if grid.tp_branch:
        from .gpt_manual_tp import stack_apply_manual_tp
        return lambda p, x: stack_apply_manual_tp(p, x, cfg, pcfg,
                                                  grid.tp_group, ep)
    if ep is not None:
        from .gpt_manual_tp import stack_apply_manual_ep
        return lambda p, x: stack_apply_manual_ep(p, x, cfg, pcfg, ep)
    return lambda p, x: _stack_apply(p, x, cfg, pcfg)


def _embed(params, input_ids, cfg, pcfg, grid):
    if grid.tp_branch:
        return _embed_tp(params, input_ids, cfg, pcfg, grid.tp_group)
    cdt = pcfg.compute_dtype
    s = input_ids.shape[1]
    return F.embedding(input_ids, params["wte"]).to(cdt) + \
        params["wpe"][:s][None].to(cdt)


def _head_loss(y, hp, labels, cfg, pcfg, grid, vocab_parallel=False):
    """The reference's head on the last stage's output: final LayerNorm and
    next-token CE (mean over ``labels``' tokens). ``vocab_parallel``: the
    manual-tp zero-bubble head (gpt_manual_tp.train_grads_zb_manual_tp)."""
    cdt = pcfg.compute_dtype
    h = _layer_norm(y, hp["lnf_g"].to(cdt), hp["lnf_b"].to(cdt))
    if vocab_parallel:
        from ..distributed import collective as C
        from .gpt_manual_tp import ce_vocab_parallel
        g = grid.tp_group
        if pcfg.sp:
            h = C._AllGather.apply(h, g, 1)
        else:
            h = C._Pvary.apply(h, g)
        V = cfg.vocab_size
        vpad = (-V) % g.nranks
        w = hp["wte"]
        if not _vocab_sharded(V, g.nranks):
            # the reference pads the head's rows to a multiple of tp and
            # masks the pad rows: this rank's rows of the padded wte
            w = F.pad(w, (0, 0, 0, vpad))
            vl = w.shape[0] // g.nranks
            w = w[g.rank * vl:(g.rank + 1) * vl]
        return ce_vocab_parallel(h, w, labels, g,
                                 valid_vocab=V if vpad else None)
    if grid.tp_branch:
        return _ce_tp(h, hp["wte"], labels, pcfg, grid.tp_group,
                      _vocab_sharded(cfg.vocab_size, grid.tp))
    return _ce_from_hidden(h, hp["wte"], labels, pcfg)


def _head_seed(lbl_mb, cfg, pcfg, grid, vocab_parallel=False):
    """The last virtual stage's seed of the schedules: ``last_grad(y, hp,
    mb) -> (loss, dy, head gradients)``, microbatch mb's head loss (over M
    of the batch: the sum over the microbatches is the batch's mean)."""
    m = len(lbl_mb)

    def last_grad(yv, hp, mb_idx):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in _leaves(hp)]
            yg = yv.detach().requires_grad_(True)
            hp_ = dict(zip(sorted(hp), leaves))
            lv = _head_loss(yg, hp_, lbl_mb[mb_idx], cfg, pcfg, grid,
                            vocab_parallel) / m
            gy, *gh = torch.autograd.grad(lv, [yg] + leaves)
        return lv.detach(), gy, dict(zip(sorted(hp), gh))
    return last_grad


def _graph_stage_fn(cfg, pcfg, grid):
    """The zero-bubble B's stage: it keeps its recomputed graph for W's
    second backward, so it runs without the per-block checkpoints, which
    allow one backward only."""
    return _stage_fn(cfg, ParallelConfig(**{**pcfg.__dict__,
                                            "remat": False}), grid)


def _head_params(params):
    return {"wte": params["wte"], "lnf_g": params["lnf_g"],
            "lnf_b": params["lnf_b"]}


def _pp_grads(params, x, dx0, hg, bgrads, cfg, pcfg, grid,
              vocab_parallel=False):
    """The gradient tree from the pipeline's parts: the embedding's
    backward from dx0 (the same on every rank), the tied wte's two
    shares, the head's and the blocks' gradients."""
    from ..distributed import collective as C
    dwte, dwpe = torch.autograd.grad(x, [params["wte"], params["wpe"]],
                                     dx0.to(x.dtype))
    hwte = hg["wte"].float()
    if vocab_parallel and not pcfg.sp and \
            not _vocab_sharded(cfg.vocab_size, grid.tp):
        # the padded head's rows of a replicated wte: one share a tp rank
        hwte = hwte.contiguous()
        C.all_reduce_flat(hwte.view(-1), C.ReduceOp.SUM, grid.tp_group)
    return {"wte": dwte.float() + hwte,
            "wpe": dwpe.float(),
            "lnf_g": hg["lnf_g"], "lnf_b": hg["lnf_b"],
            "blocks": bgrads}


def _pp_loss_and_grads(params, batch, cfg, pcfg, grid, vocab_parallel=False):
    """(loss, gradient tree) of the global ``batch`` (this rank's dp rows)
    through this rank's stage of the pipeline: the reference's
    ``_train_grads_1f1b`` (and its GPipe loss_fn) a rank at a time."""
    from ..distributed import collective as C
    from ..parallel.pipeline import pipeline_apply, pipeline_microbatch
    from ..parallel import pipeline_1f1b as P1
    input_ids, labels = batch
    cdt = pcfg.compute_dtype
    m = pcfg.microbatches
    stage_fn = _stage_fn(cfg, pcfg, grid)
    with torch.enable_grad():
        x = _embed(params, input_ids, cfg, pcfg, grid)
    x_in = x.detach()
    mb = pipeline_microbatch(x_in, m)
    head_params = _head_params(params)
    blocks = {k: p.to(cdt) for k, p in params["blocks"].items()}
    if pcfg.pp_schedule == "gpipe":
        # forward by hops, backward by the reverse hops; every rank runs
        # the head on the broadcast outputs, so its head gradients are
        # already whole and only dx0 is summed over pp
        with torch.enable_grad():
            mbg = mb.detach().requires_grad_(True)
            out = pipeline_apply(stage_fn, blocks, mbg, grid.pp_group)
            y = out.reshape(x_in.shape)
            loss = _head_loss(y, head_params, labels, cfg, pcfg, grid)
            hl = _leaves(head_params)
            bl = _leaves(params["blocks"])
            g = torch.autograd.grad(loss, [mbg] + hl + bl,
                                    allow_unused=True)
        dx0 = g[0].reshape(-1).float()
        C.all_reduce_flat(dx0, C.ReduceOp.SUM, grid.pp_group)
        dx0 = dx0.view(x_in.shape).to(x_in.dtype)
        hg = dict(zip(sorted(head_params), g[1:1 + len(hl)]))
        bgrads = dict(zip(sorted(params["blocks"]), g[1 + len(hl):]))
        loss = loss.detach()
    else:
        args = (stage_fn, blocks, mb, _head_seed(
            pipeline_microbatch(labels, m), cfg, pcfg, grid, vocab_parallel),
            head_params, grid.pp_group)
        if pcfg.vpp_chunks > 1:
            loss, bgrads, hg, dx0 = P1.pipeline_train_interleaved(
                *args, num_chunks=pcfg.vpp_chunks)
        elif pcfg.pp_schedule == "1f1b":
            loss, bgrads, hg, dx0 = P1.pipeline_train_1f1b(*args)
        else:
            run = {"zbh1": P1.pipeline_train_zbh1,
                   "zbvpp": P1.pipeline_train_zbvpp}[pcfg.pp_schedule]
            loss, bgrads, hg, dx0 = run(
                *args, graph_stage_fn=_graph_stage_fn(cfg, pcfg, grid))
        dx0 = dx0.reshape(x_in.shape)
    return loss, _pp_grads(params, x, dx0, hg, bgrads, cfg, pcfg, grid,
                           vocab_parallel)


def schedule_value_and_grad(params, batch, cfg: GPTConfig,
                            pcfg: ParallelConfig, sched):
    """(the loss, its gradients in ``_leaves`` order) of the one-device
    ``params`` (pp = 1, tp = 1) through the host schedule ``sched``
    (``parallel.pp_schedule``), every stage in this process: the pipeline
    path's stage function, head seed and embedding backward, run by
    ``pipeline_1f1b.run_all_stages``. Virtual stage i (``sched``'s chain
    depth) holds layers [i L / (n v), (i + 1) L / (n v))."""
    from ..parallel import pipeline_1f1b as P1
    from ..parallel.pipeline import pipeline_microbatch
    grid = _grid(pcfg)
    if grid.pp > 1 or grid.tp > 1:
        raise ValueError("schedule_value_and_grad runs every stage in one "
                         "process: pp = 1 and tp = 1")
    tree = _detach(params)
    input_ids, labels = batch
    cdt = pcfg.compute_dtype
    m, L = sched.n_microbatches, cfg.num_layers
    per = L // (sched.n_stages * sched.n_chunks)
    with torch.enable_grad():
        x = _embed(tree, input_ids, cfg, pcfg, grid)
    bgrads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in tree["blocks"].items()}
    chunks, accs = {}, {}
    for s in range(sched.n_stages):
        for c in range(sched.n_chunks):
            sl = slice(sched.virtual_index(s, c) * per,
                       (sched.virtual_index(s, c) + 1) * per)
            chunks[(s, c)] = {k: p[sl].to(cdt)
                              for k, p in tree["blocks"].items()}
            accs[(s, c)] = {k: g[sl] for k, g in bgrads.items()}
    loss, _, hg, dx0 = P1.run_all_stages(
        sched, _stage_fn(cfg, pcfg, grid), chunks,
        pipeline_microbatch(x.detach(), m),
        _head_seed(pipeline_microbatch(labels, m), cfg, pcfg, grid),
        _head_params(tree), graph_stage_fn=_graph_stage_fn(cfg, pcfg, grid),
        grads=accs)
    grads = _pp_grads(tree, x, dx0.reshape(x.shape), hg, bgrads, cfg, pcfg,
                      grid)
    return loss, _leaves(grads)


def _train_grads_1f1b(params, batch, cfg, pcfg):
    """Loss and gradients (trees) of this rank's stage through the
    pipeline schedule: the reference's routing, where the zero-bubble
    schedules at tp > 1 take the manual-tp route
    (gpt_manual_tp.train_grads_zb_manual_tp) and, with experts at tp = 1
    and dp > 1, the manual-ep route (``train_grads_zb_manual_ep``)."""
    if pcfg.pp_schedule in ("zbh1", "zbvpp") and pcfg.tp == 1 \
            and pcfg.num_experts > 0 and pcfg.dp > 1:
        from .gpt_manual_tp import train_grads_zb_manual_ep
        return train_grads_zb_manual_ep(params, batch, cfg, pcfg)
    use_manual_tp = pcfg.tp > 1 and pcfg.num_experts == 0 and (
        pcfg.pp_schedule in ("zbh1", "zbvpp")
        or (pcfg.pp_schedule == "1f1b" and pcfg.vpp_chunks == 1
            and pcfg.collective_matmul and pcfg.sp and not pcfg.fused_ce))
    if use_manual_tp:
        from .gpt_manual_tp import train_grads_zb_manual_tp
        return train_grads_zb_manual_tp(params, batch, cfg, pcfg)
    if _cm_dropped(pcfg):
        pcfg = ParallelConfig(**{**pcfg.__dict__,
                                 "collective_matmul": False})
    return _pp_loss_and_grads(params, batch, cfg, pcfg, _grid(pcfg))


def _eval_blocks(blocks, cfg, pcfg, grid):
    """This rank's stage of the plain [pp, L/pp] layout from a stage in
    any layout (the reference's eval relayout of the interleaved and ZB-V
    stackings): the blocks all-gathered over pp and re-split."""
    from ..distributed import collective as C
    if not _chunked(pcfg):
        return blocks
    L, pp = cfg.num_layers, pcfg.pp
    lp = L // pp
    order = [i for r in range(pp) for i in _stage_layers(pcfg, L, r)]
    out = {}
    for k, x in blocks.items():
        flat = _stage_flat(x, pcfg)
        allx = C._gather_along(flat, grid.pp_group, 0)
        full = torch.empty_like(allx)
        full[order] = allx
        out[k] = full[grid.pp_rank * lp:(grid.pp_rank + 1) * lp]
    return out


def forward_hidden_pp(params, input_ids, cfg: GPTConfig,
                      pcfg: ParallelConfig):
    """``forward_hidden`` at pp > 1 on this rank's stage: the reference's
    GPipe forward (interleaved and ZB-V stages relaid out to the plain
    layout first), the final hidden states on every rank."""
    from ..parallel.pipeline import pipeline_apply, pipeline_microbatch
    grid = _grid(pcfg)
    cdt = pcfg.compute_dtype
    x = _embed(params, input_ids, cfg, pcfg, grid)
    blocks = {k: p.to(cdt) for k, p in _eval_blocks(
        params["blocks"], cfg, pcfg, grid).items()}
    mb = pipeline_microbatch(x, pcfg.microbatches)
    y = pipeline_apply(_stage_fn(cfg, pcfg, grid), blocks, mb,
                       grid.pp_group).reshape(x.shape)
    return _layer_norm(y, params["lnf_g"].to(cdt), params["lnf_b"].to(cdt))


def loss_fn_pp(params, batch, cfg, pcfg):
    """``loss_fn`` at pp > 1 (the GPipe forward and the head), the same on
    every rank."""
    input_ids, labels = batch
    h = forward_hidden_pp(params, input_ids, cfg, pcfg)
    grid = _grid(pcfg)
    if grid.tp_branch:
        return _ce_tp(h, params["wte"], labels, pcfg, grid.tp_group,
                      _vocab_sharded(cfg.vocab_size, grid.tp))
    return _ce_from_hidden(h, params["wte"], labels, pcfg)


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


#: elements per piece of the update: the f32 temporaries of _adamw_leaf
#: stay 2^26 elements (the reference's compiled update fuses them away)
_UPDATE_CHUNK = 1 << 26


def _adamw_pieces(p, m, v, g, step, lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """``_adamw_leaf`` over p, m, v and g, written into p, m and v in place
    in pieces of ``_UPDATE_CHUNK`` elements (whole when one of them is not
    contiguous)."""
    if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
        pn, mn, vn = _adamw_leaf(p, m, v, g, step, lr, b1, b2, eps, wd)
        p.copy_(pn)
        m.copy_(mn)
        v.copy_(vn)
        return
    p, m, v, g = p.view(-1), m.view(-1), v.view(-1), g.reshape(-1)
    for i in range(0, p.numel(), _UPDATE_CHUNK):
        sl = slice(i, i + _UPDATE_CHUNK)
        pn, mn, vn = _adamw_leaf(p[sl], m[sl], v[sl], g[sl], step, lr, b1,
                                 b2, eps, wd)
        p[sl].copy_(pn)
        m[sl].copy_(mn)
        v[sl].copy_(vn)


@torch.no_grad()
def adamw_update(params, grads, opt_state, lr=3e-4, b1=0.9, b2=0.95,
                 eps=1e-8, wd=0.1):
    """One AdamW step over every leaf, written into params and opt_state in
    place (the reference donates both to its step), each leaf in pieces
    (``_adamw_pieces``). ``grads`` is a list in ``_leaves`` order."""
    step = opt_state["step"] + 1
    for p, g, m, v in zip(_leaves(params), grads, _leaves(opt_state["m"]),
                          _leaves(opt_state["v"])):
        _adamw_pieces(p, m, v, g, step, lr, b1, b2, eps, wd)
    opt_state["step"] = step
    return params, opt_state


# --------------------------- train step ------------------------------------
def build_train_step(cfg: GPTConfig, pcfg: ParallelConfig, lr=3e-4):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``.

    ``batch`` is (input_ids, labels), int64 [B, S] on the params' device.
    With ``gradient_merge_steps`` = k > 1 the batch is split into k chunks
    whose gradients are summed in the param dtype and averaged before one
    update; the loss is the mean of the chunks' losses.

    With a process group initialized (at any world size, 1 included) this
    is the data-parallel step (``_dp_train_step``)."""
    _validate(pcfg)
    if _distributed():
        return _dp_train_step(cfg, pcfg, lr)
    k = pcfg.gradient_merge_steps

    def train_step(params, opt_state, batch):
        if k > 1:
            b0 = batch[0].shape[0]
            if b0 % k:
                raise ValueError(
                    f"global batch {b0} is not divisible by "
                    f"gradient_merge_steps={k}")
            acc = [torch.zeros_like(p) for p in _leaves(params)]
            lsum = 0.0
            for chunk in zip(*(x.chunk(k) for x in batch)):
                loss, grads = _value_and_grad(params, chunk, cfg, pcfg)
                acc = [a + g for a, g in zip(acc, grads)]
                lsum = lsum + loss
            grads = [a / k for a in acc]
            loss = lsum / k
        else:
            loss, grads = _value_and_grad(params, batch, cfg, pcfg)
        adamw_update(params, grads, opt_state, lr=lr)
        return params, opt_state, loss

    return train_step


def _value_and_grad(params, batch, cfg, pcfg):
    """(the loss, detached; its gradients in ``_leaves`` order)."""
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = loss_fn(params, batch, cfg, pcfg)
        return loss.detach(), torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)


def build_accum_steps(cfg: GPTConfig, pcfg: ParallelConfig, lr=3e-4):
    """The reference's split gradient accumulation, as two functions:

    ``grad_step(params, acc, batch) -> (acc, loss)`` runs one chunk's
    forward and backward and adds its gradients into ``acc`` (a tree like
    params, from ``init_grad_accum``) in place, in the accumulator's dtype;
    ``apply_step(params, opt_state, acc, k) -> (params, opt_state, acc)``
    divides the sum by k, runs ``adamw_update`` (in place) and zeroes
    ``acc`` in place. The reference donates ``acc`` to both programs and
    returns new trees; the port writes into the ones it is given.

    With a process group initialized, ``grad_step`` adds this rank's rows'
    gradients and ``apply_step`` reduces the sum once over dp before the
    update (``_dp_accum_steps``)."""
    _validate(pcfg)
    if _distributed():
        return _dp_accum_steps(cfg, pcfg, lr)

    @torch.no_grad()
    def add_into(acc, grads):
        for a, g in zip(_leaves(acc), grads):
            a.add_(g.to(a.dtype))

    def grad_step(params, acc, batch):
        loss, grads = _value_and_grad(params, batch, cfg, pcfg)
        add_into(acc, grads)
        return acc, loss

    def apply_step(params, opt_state, acc, k):
        acc_leaves = _leaves(acc)
        adamw_update(params, [a / k for a in acc_leaves], opt_state, lr=lr)
        for a in acc_leaves:
            a.zero_()
        return params, opt_state, acc

    return grad_step, apply_step


def init_grad_accum(params):
    """A zeroed gradient accumulator like the param tree, in the params'
    dtypes (as the reference's: bf16 accumulation over a few chunks is well
    within tolerance and halves the accumulator's memory)."""
    if isinstance(params, dict):
        return {k: init_grad_accum(v) for k, v in params.items()}
    return torch.zeros_like(params)


def setup(cfg: GPTConfig, pcfg: ParallelConfig, seed=0, device=None):
    """Returns (params, opt_state, train_step) on ``device`` (CUDA unless
    the caller says otherwise; raises when CUDA is missing). With a process
    group initialized, each rank keeps its stage (``pp_stage``) and its tp
    shards (``tp_shard``) of the parameters drawn from ``seed``, which are
    broadcast over dp and laid into flat buffers (``_bind_flat``), and the
    state and step are the distributed ones."""
    _validate(pcfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, pcfg, gen, dev)
    if _distributed():
        from ..distributed import collective as C
        grid = _grid(pcfg)
        params = pp_stage(params, cfg, pcfg, grid.pp_rank)
        if grid.tp > 1:
            params = tp_shard(params, grid.tp_rank, grid.tp)
        params = ep_shard(params, grid.dp_rank, grid.dp)
        for b in _bind_flat(params, grid.dp):
            if not b.local:
                C.broadcast(b.flat, src=grid.dp_group.ranks[0],
                            group=grid.dp_group)
        opt_state = dp_adamw_init(params, pcfg)
    else:
        opt_state = adamw_init(params, pcfg)
    return params, opt_state, build_train_step(cfg, pcfg, lr=3e-4)


# --------------------------- data parallel ---------------------------------
# The reference's dp step is one GSPMD program: replicated params, the batch
# sharded over dp, XLA's psum of the gradients, and with zero1 each moment
# sharded over dp on its first divisible dim (moment_specs). Here each rank
# is a process: it runs the forward and backward on its B/dp rows of the
# global batch, and the leaves of one dtype live in one flat buffer, padded
# to a multiple of dp, of which rank r owns [r * c, (r + 1) * c). Its
# gradient bucket is reduce-scattered (AVG) onto that slice, _adamw_leaf
# updates the slice of the parameters and of the moments (ZeRO-1: the
# moments are only the slice), and an all-gather rebuilds the parameters.
# Without zero1 the gradients are all-reduced and every rank updates the
# whole buffer with whole moments. The update is elementwise, so any
# partition of the elements gives the reference's numbers; the padding
# stays 0 (p = g = m = v = 0 gives a 0 step) and never reaches a parameter.
#
# Expert parallel: the expert leaves (_EP_LEAVES, with experts under a
# process group) are this dp rank's experts, different on every dp rank, so
# they live in buckets of their own ("<dtype>.ep", ``local``) that never
# enter the dp reductions: each rank updates its experts whole, with whole
# moments. Their gradients arrive through the backward all-to-all summed
# over every dp rank's local mean loss, dp times the gradient of the
# reference's mean over the global batch, and are divided by dp.
class _Bucket:
    """The leaves of one dtype, as views of one flat buffer, split over
    ``span`` ranks (dp, or 1 for the expert leaves: ``local``)."""

    def __init__(self, dtype, refs, flat, numel, chunk, local=False):
        self.dtype, self.refs, self.flat = dtype, refs, flat
        self.numel, self.chunk, self.local = numel, chunk, local

    @property
    def key(self):
        return str(self.dtype).replace("torch.", "") + \
            (".ep" if self.local else "")

    @property
    def span(self):
        return self.flat.numel() // self.chunk

    def owned(self, t, rank):
        if self.local:
            return t
        return t[rank * self.chunk:(rank + 1) * self.chunk]


def _leaf_refs(tree):
    """(dict, key) of every leaf, in ``_leaves`` order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaf_refs(v) if isinstance(v, dict) else [(tree, k)])
    return out


def _bind_flat(params, dp):
    """One ``_Bucket`` a dtype (in order of first appearance in
    ``_leaves``), and one a dtype for the expert leaves (``local``). Leaves
    that are not yet views of their bucket's buffer are copied into a new
    one and replaced in ``params`` by views of it."""
    experts = params["blocks"] if _moe(params) else {}
    groups = {}
    for d, k in _leaf_refs(params):
        local = d is experts and k in _EP_LEAVES
        groups.setdefault((d[k].dtype, local), []).append((d, k))
    buckets = []
    for (dtype, local), refs in groups.items():
        span = 1 if local else dp
        leaves = [d[k] for d, k in refs]
        numel = sum(x.numel() for x in leaves)
        chunk = -(-numel // span)
        base = leaves[0]._base
        offs = np.cumsum([0] + [x.numel() for x in leaves[:-1]])
        bound = (base is not None and base.numel() == chunk * span
                 and base.dim() == 1 and all(
                     x._base is base and x.storage_offset() == int(o)
                     and x.is_contiguous() for x, o in zip(leaves, offs)))
        if not bound:
            base = torch.zeros(chunk * span, dtype=dtype,
                               device=leaves[0].device)
            for (d, k), x, o in zip(refs, leaves, offs):
                o = int(o)
                view = base[o:o + x.numel()].view(x.shape)
                view.copy_(x)
                d[k] = view
        buckets.append(_Bucket(dtype, refs, base, numel, chunk, local))
    return buckets


class _Grid:
    """This rank's place in the (dp, pp, tp) grid of the job's ranks, tp
    innermost (the reference's build_mesh order): rank = (dp_rank * pp +
    pp_rank) * tp + tp_rank. A group spanning the job is the job's group; a
    group of this rank alone has no torch group (its collectives are the
    identity), and neither has the job before ``init_parallel_env``
    (``world`` None)."""

    def __init__(self, world, tp, tp_branch, pp=1):
        from ..distributed.env import Group, new_group
        world = world or Group(0, [0])
        n, rank = world.nranks, world.rank
        if n % (tp * pp):
            raise ValueError(f"pp={pp} x tp={tp} does not divide the job's "
                             f"{n} ranks")
        self.world, self.tp, self.pp = world, tp, pp
        self.dp = n // (tp * pp)
        self.dp_rank, rest = divmod(rank, pp * tp)
        self.pp_rank, self.tp_rank = divmod(rest, tp)
        self.tp_branch = tp_branch

        def at(d, p, j):
            return (d * pp + p) * tp + j

        def group(all_ranks):
            mine = next(r for r in all_ranks if rank in r)
            if len(mine) == n:
                return world
            if len(mine) == 1:
                return Group(rank, mine)
            made = [new_group(r) for r in all_ranks]
            return made[all_ranks.index(mine)]
        self.tp_group = group([[at(d, p, j) for j in range(tp)]
                               for d in range(self.dp) for p in range(pp)])
        self.dp_group = group([[at(d, p, j) for d in range(self.dp)]
                               for p in range(pp) for j in range(tp)])
        self.pp_group = group([[at(d, p, j) for p in range(pp)]
                               for d in range(self.dp) for j in range(tp)])


_GRIDS: Dict[Any, _Grid] = {}


def _grid(pcfg) -> _Grid:
    """The (dp, pp, tp) grid of the current process group (made once a
    group; every rank makes its torch groups in the same order). The tp
    branch runs at tp > 1, and at any tp under sp or collective_matmul."""
    from ..distributed.env import init_parallel_env, is_initialized
    world = init_parallel_env() if is_initialized() else None
    tp_branch = pcfg.tp > 1 or pcfg.sp or pcfg.collective_matmul
    key = (pcfg.tp, pcfg.pp, tp_branch)
    g = _GRIDS.get(key)
    if g is None or world is None or g.world is not world:
        g = _GRIDS[key] = _Grid(world, pcfg.tp, tp_branch, pcfg.pp)
    return g


def _dp(pcfg):
    g = _grid(pcfg)
    return g.dp, g.dp_rank


def dp_adamw_init(params, pcfg):
    """The data-parallel AdamW state: per dtype bucket, the moments of this
    rank's slice (``zero1``) or of the whole buffer, and the step."""
    dp, _ = _dp(pcfg)
    m, v = {}, {}
    for b in _bind_flat(params, dp):
        n = b.chunk if pcfg.zero1 else b.flat.numel()
        mdt = pcfg.moment_dtype or b.dtype
        m[b.key] = torch.zeros(n, dtype=mdt, device=b.flat.device)
        v[b.key] = torch.zeros(n, dtype=mdt, device=b.flat.device)
    return {"m": m, "v": v, "step": 0}


def _flat_state(params, opt_state, pcfg, buckets):
    """Turns a state in the reference's layout (moment trees like params,
    as ``adamw_init`` or ``params_from_jax`` give) into this rank's flat
    one, in place."""
    keys = {b.key for b in buckets}
    if set(opt_state["m"]) == keys and all(
            isinstance(opt_state["m"][k], torch.Tensor) for k in keys):
        return
    dp, rank = _dp(pcfg)
    for name in ("m", "v"):
        refs = dict(zip(map(id, _leaves(params)), _leaves(opt_state[name])))
        flat = {}
        for b in buckets:
            parts = [refs[id(d[k])].reshape(-1) for d, k in b.refs]
            full = torch.cat(parts + [parts[0].new_zeros(
                b.flat.numel() - b.numel)])
            flat[b.key] = (b.owned(full, rank) if pcfg.zero1
                           else full).clone()
        opt_state[name] = flat


def _local_rows(batch, dp, rank):
    b0 = batch[0].shape[0]
    if b0 % dp:
        raise ValueError(f"global batch {b0} is not divisible by dp={dp}")
    n = b0 // dp
    return tuple(x[rank * n:(rank + 1) * n] for x in batch)


def _detach(tree):
    """Detached views of the parameter tree's leaves, asking for their
    gradients."""
    return {k: _detach(v) if isinstance(v, dict)
            else v.detach().requires_grad_(True) for k, v in tree.items()}


def _detached_value_and_grad(params, batch, cfg, pcfg):
    """(loss, gradients in ``_leaves`` order) of ``batch`` with respect to
    detached views of the parameters (the buffers' views stay untouched by
    autograd). On the tp branch: this rank's shards' gradients, the sp
    leaves' summed over tp."""
    tree = _detach(params)
    grid = _grid(pcfg)
    if grid.pp > 1:
        loss, grads = _train_grads_1f1b(tree, batch, cfg, pcfg)
        grads = _leaves(grads)
        if pcfg.sp:
            grads = _sum_sp_grads(grads,
                                  _sp_leaf_indices(tree, cfg, grid.tp),
                                  grid.tp_group)
        return loss.detach(), grads
    if not grid.tp_branch:
        loss = loss_fn(tree, batch, cfg, pcfg)
        return loss.detach(), torch.autograd.grad(loss, _leaves(tree))
    loss = loss_fn_tp(tree, batch, cfg, pcfg, grid.tp_group)
    grads = torch.autograd.grad(loss, _leaves(tree))
    if pcfg.sp:
        grads = _sum_sp_grads(grads, _sp_leaf_indices(tree, cfg, grid.tp),
                              grid.tp_group)
    return loss.detach(), grads


def _flat_grads(buckets, grads, params):
    """The gradients as one padded flat tensor a bucket."""
    by_id = dict(zip(map(id, _leaves(params)), grads))
    out = []
    for b in buckets:
        parts = [by_id[id(d[k])].reshape(-1) for d, k in b.refs]
        pad = b.flat.numel() - b.numel
        out.append(torch.cat(parts + [parts[0].new_zeros(pad)] if pad
                             else parts))
    return out


@torch.no_grad()
def _dp_update(buckets, flat_grads, opt_state, pcfg, lr):
    """Reduce each bucket's gradient over dp (AVG), update this rank's
    slice (or, without zero1, the whole buffer) in place and rebuild the
    parameters with an all-gather. An expert bucket's gradient is divided
    by dp and its buffer updated whole, with no collective."""
    from ..distributed import collective as C
    grid = _grid(pcfg)
    rank, group = grid.dp_rank, grid.dp_group
    step = opt_state["step"] + 1
    for b, g in zip(buckets, flat_grads):
        if b.local:
            _adamw_pieces(b.flat, opt_state["m"][b.key],
                          opt_state["v"][b.key], g / grid.dp, step, lr)
            continue
        if pcfg.zero1:
            gs = torch.empty(b.chunk, dtype=g.dtype, device=g.device)
            C.reduce_scatter_flat(gs, g, C.ReduceOp.AVG, group)
            p = b.owned(b.flat, rank)
        else:
            C.all_reduce_flat(g, C.ReduceOp.AVG, group)
            gs, p = g, b.flat
        _adamw_pieces(p, opt_state["m"][b.key], opt_state["v"][b.key], gs,
                      step, lr)
        if pcfg.zero1:
            C.all_gather_flat(b.flat, p, group)
    opt_state["step"] = step


def _avg_loss(loss, pcfg):
    """The loss averaged over dp (the tp ranks hold the same loss)."""
    from ..distributed import collective as C
    out = loss.float().reshape(1).clone()
    C.all_reduce_flat(out, C.ReduceOp.AVG, _grid(pcfg).dp_group)
    return out[0]


def _dp_train_step(cfg, pcfg, lr):
    """``step(params, opt_state, batch)`` with ``batch`` the global batch:
    this rank computes on its B/dp rows (in ``gradient_merge_steps``
    chunks, reduced once); the loss returned is the mean over dp."""
    k = pcfg.gradient_merge_steps

    def train_step(params, opt_state, batch):
        dp, rank = _dp(pcfg)
        buckets = _bind_flat(params, dp)
        _flat_state(params, opt_state, pcfg, buckets)
        rows = _local_rows(batch, dp, rank)
        if rows[0].shape[0] % k:
            raise ValueError(
                f"the rank's batch {rows[0].shape[0]} is not divisible by "
                f"gradient_merge_steps={k}")
        acc, lsum = None, 0.0
        for chunk in zip(*(x.chunk(k) for x in rows)):
            loss, grads = _detached_value_and_grad(params, chunk, cfg, pcfg)
            flat = _flat_grads(buckets, grads, params)
            del grads
            acc = flat if acc is None else [a.add_(f)
                                            for a, f in zip(acc, flat)]
            lsum = lsum + loss
        if k > 1:
            acc = [a / k for a in acc]
        _dp_update(buckets, acc, opt_state, pcfg, lr)
        return params, opt_state, _avg_loss(lsum / k, pcfg)

    return train_step


def _dp_accum_steps(cfg, pcfg, lr):
    @torch.no_grad()
    def add_into(acc, grads):
        for a, g in zip(_leaves(acc), grads):
            a.add_(g.to(a.dtype))

    def grad_step(params, acc, batch):
        dp, rank = _dp(pcfg)
        loss, grads = _detached_value_and_grad(
            params, _local_rows(batch, dp, rank), cfg, pcfg)
        add_into(acc, grads)
        return acc, _avg_loss(loss, pcfg)

    def apply_step(params, opt_state, acc, k):
        dp, _ = _dp(pcfg)
        buckets = _bind_flat(params, dp)
        _flat_state(params, opt_state, pcfg, buckets)
        acc_leaves = _leaves(acc)
        flat = _flat_grads(buckets, [a / k for a in acc_leaves], params)
        _dp_update(buckets, flat, opt_state, pcfg, lr)
        for a in acc_leaves:
            a.zero_()
        return params, opt_state, acc

    return grad_step, apply_step


def _pp_gather(tree, grid):
    """The reference's stage-stacked block leaves ([pp, ...]) from every pp
    rank's stage, the rest as they are."""
    from ..distributed import collective as C
    if grid.pp <= 1:
        return tree
    out = dict(tree)
    out["blocks"] = {k: C._gather_along(x[None], grid.pp_group, 0)
                     for k, x in tree["blocks"].items()}
    return out


def gather_params(params, cfg, pcfg):
    """The parameters in the reference's global layout on every rank (the
    tp shards and the dp ranks' experts all-gathered, the pp stages stacked
    as the reference's ``shard_params`` stacks them; at tp = pp = 1 without
    experts a copy)."""
    grid = _grid(pcfg)
    return _pp_gather(_ep_gather(_tp_gather(params, grid.tp_group,
                                            cfg.vocab_size), grid.dp_group),
                      grid)


def gather_opt_state(params, opt_state, pcfg, cfg=None):
    """The distributed AdamW state in the reference's layout on every rank:
    ``{"m": tree, "v": tree, "step": n}`` with trees like the reference's
    params (each moment all-gathered from the dp ranks' slices under zero1,
    and from the tp ranks' shards at tp > 1, which needs ``cfg``)."""
    from ..distributed import collective as C
    grid = _grid(pcfg)
    dp = grid.dp
    buckets = _bind_flat(params, dp)
    out = {"step": opt_state["step"]}
    for name in ("m", "v"):
        by_leaf = {}
        for b in buckets:
            part = opt_state[name][b.key]
            if pcfg.zero1 and not b.local:
                full = torch.empty(b.chunk * dp, dtype=part.dtype,
                                   device=part.device)
                C.all_gather_flat(full, part, grid.dp_group)
            else:
                full = part
            off = 0
            for d, k in b.refs:
                x = d[k]
                by_leaf[id(x)] = full[off:off + x.numel()].view(
                    x.shape).clone()
                off += x.numel()

        def tree_of(t):
            return {k: tree_of(v) if isinstance(v, dict) else by_leaf[id(v)]
                    for k, v in t.items()}
        out[name] = _ep_gather(tree_of(params), grid.dp_group)
        if grid.tp > 1:
            if cfg is None:
                raise ValueError("gather_opt_state at tp > 1 needs cfg")
            out[name] = _tp_gather(out[name], grid.tp_group, cfg.vocab_size)
        out[name] = _pp_gather(out[name], grid)
    return out


def opt_state_shards(params, opt_state, pcfg):
    """The moments for ``distributed.checkpoint.save_state_dict``: per
    bucket, this rank's slice of each (clipped to the unpadded length) as a
    ``ShardedTensor`` of the bucket's global flat shape, so that another
    dp world size can load them (``load_opt_state_shards``). At tp > 1
    each tp rank's buckets are entries of their own (``<dtype>.tp<r>``),
    and at pp > 1 each stage's (``<dtype>.pp<s>``), loaded at the same tp
    and pp. An expert bucket (``<dtype>.ep``) is this dp rank's piece of
    the dp ranks' buckets laid end to end, loaded at the same dp."""
    from ..core.tensor import Tensor
    from ..distributed.checkpoint import ShardedTensor
    grid = _grid(pcfg)
    dp, rank = grid.dp, grid.dp_rank
    suffix = (f".pp{grid.pp_rank}" if grid.pp > 1 else "") + \
        (f".tp{grid.tp_rank}" if grid.tp > 1 else "")
    out = {"step": opt_state["step"]}
    for name in ("m", "v"):
        out[name] = {}
        for b in _bind_flat(params, dp):
            t = opt_state[name][b.key]
            if b.local:
                out[name][b.key + suffix] = ShardedTensor(
                    Tensor._wrap(t), (b.numel * dp,), (rank * b.numel,))
                continue
            lo = rank * b.chunk if pcfg.zero1 else 0
            hi = min(lo + t.numel(), b.numel)
            out[name][b.key + suffix] = ShardedTensor(
                Tensor._wrap(t[:max(hi - lo, 0)]), (b.numel,), (lo,))
    return out


def load_opt_state_shards(params, opt_state, pcfg, path):
    """Fills this rank's moments (and the step) from a checkpoint that
    ``opt_state_shards`` wrote at any world size; the padding stays 0."""
    from ..distributed.checkpoint import load_state_dict
    target = opt_state_shards(params, opt_state, pcfg)
    load_state_dict(target, path)
    opt_state["step"] = target["step"]
    return opt_state
