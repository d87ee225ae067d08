"""Parallel-plan search over an analytically calibrated cost model: the
port of ``paddle_tpu/distributed/planner.py``.

Reference being re-designed: the auto-parallel static planner
(distributed/auto_parallel/static/planner_v2.py + completion.py) backed by
the measured op table (python/paddle/cost_model/static_op_benchmark.json).
Here, as in the port's source, the search space is the hybrid-parallel
config itself, (dp, tp, pp, sp, zero stage, remat, microbatches) over a
group of cards, and the objective is a roofline + ring-collective model
(``cost_model.CostModel``) calibrated against this repository's own
measured points on the card.

Use:
    spec = ModelSpec.gpt(n_params=1.3e9, layers=24, hidden=2048,
                         heads=16, seq=1024, vocab=50304)
    planner = Planner(chip="H100")
    plans = planner.plan(spec, n_chips=8, global_batch=64)
    best = plans[0]          # -> PlanCandidate(dp=8, zero=1, ...)

``Planner.calibrate(points)`` refits the MFU efficiency from measured
(ModelSpec, tokens/sec/card) pairs; the default is fit from the two
gpt_hybrid steps measured on an NVIDIA H100 80GB HBM3 at 700 W
(``chip_smoke.py``, PERF.md section 5): GPT-1.3B B4 S1024 at 16772.0
tokens/s and the 350M-class ``train_s2048`` (h1024, 8 heads, B4 S2048) at
31501.5 tokens/s.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..cost_model import GPU_SPECS, CostModel

#: per-card HBM (bytes), from the cost model's published specs
HBM_BYTES = {chip: spec["hbm_bytes"] for chip, spec in GPU_SPECS.items()}

@dataclass
class ModelSpec:
    n_params: float
    layers: int
    hidden: int
    heads: int
    seq: int
    vocab: int

    @classmethod
    def gpt(cls, n_params, layers, hidden, heads, seq, vocab):
        return cls(n_params, layers, hidden, heads, seq, vocab)

    @classmethod
    def from_config(cls, cfg):
        """From a models.gpt.GPTConfig-shaped object."""
        h, L, v = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
        ffn = getattr(cfg, "ffn_mult", 4)
        n = v * h + cfg.max_seq_len * h + L * (
            4 * h * h + 2 * ffn * h * h + 9 * h)
        return cls(float(n), L, h, cfg.num_heads, cfg.max_seq_len, v)


#: calibration points measured on an NVIDIA H100 80GB HBM3 at 700 W by
#: chip_smoke.py's gpt_hybrid paths (bf16, remat "names", fused CE; PERF.md
#: section 5); the full spec rides along so calibration charges the same
#: FLOP formula (attention included) the estimator uses
_H100_CALIBRATION = [
    # GPT-1.3B B4 S1024 (the flagship path): 16772.0 tokens/s
    (ModelSpec.gpt(1.3e9, 24, 2048, 16, 1024, 50304), 16_772.0),
    # 350M-class train_s2048 (h1024, 8 heads, B4 S2048): 31501.5 tokens/s
    (ModelSpec.gpt(0.35e9, 24, 1024, 8, 2048, 50304), 31_501.5),
]


@dataclass
class PlanCandidate:
    dp: int = 1
    tp: int = 1
    pp: int = 1
    sp: bool = False
    zero: int = 0              # 0..3 (sharding stage over dp)
    remat: bool = True
    microbatches: int = 1
    est_step_s: float = math.inf
    est_mem_bytes: float = math.inf
    breakdown: Dict[str, float] = field(default_factory=dict)

    @property
    def collective_matmul(self) -> bool:
        """Ring-overlap knob for the sp matmuls: recommended whenever
        the plan sequence-parallelizes over a real tp axis. At pp==1
        gpt_hybrid's tp branch runs the ring collective matmuls; at pp>1
        they ride the manual-tp 1F1B stage body (models/gpt_manual_tp.py).
        Consumed by to_parallel_config()."""
        return self.sp and self.tp > 1

    def to_parallel_config(self, zero_bubble: bool = False,
                           **overrides):
        """Materialize this plan as a hybrid-engine ParallelConfig
        (models/gpt_hybrid.py), carrying the collective_matmul knob and
        the zero/microbatch/remat choices. Extra kwargs override.

        zero_bubble=True upgrades the pipeline schedule to the compiled
        zero-bubble ZBH1; zero_bubble="zbvpp" selects the ZB-V schedule
        (matching Engine.prepare's contract); other strings raise.
        The upgrade applies under tp>1 too (the hybrid engine switches
        to the manual-tp stage body, models/gpt_manual_tp.py). Preconditions
        the manual-tp body adds beyond 1F1B, checked with clear errors
        at build/trace time: num_heads % tp == 0 (the candidate
        enumerator already guarantees this for planner-built plans) and
        — under sp — seq_len % tp == 0 (the planner cannot know the
        batch shape; pick 1f1b or pad the sequence if your seq length
        does not divide tp). The collective-matmul ring cannot ride the
        cond-gated zero-bubble phases (whole-mesh ppermute), so a
        zero-bubble choice drops it — see the conflict resolution
        below."""
        from ..models.gpt_hybrid import ParallelConfig
        if isinstance(zero_bubble, str) and \
                zero_bubble not in ("zbh1", "zbvpp"):
            raise ValueError(
                f"unrecognized zero_bubble schedule {zero_bubble!r}; "
                "expected True, 'zbh1' or 'zbvpp'")
        zb_sched = zero_bubble if isinstance(zero_bubble, str) else "zbh1"
        sched = "gpipe" if self.pp <= 1 else (
            zb_sched if zero_bubble else "1f1b")
        kw = dict(dp=self.dp, tp=self.tp, pp=self.pp, sp=self.sp,
                  microbatches=self.microbatches,
                  pp_schedule=sched,
                  remat=self.remat, zero1=self.zero >= 1,
                  collective_matmul=self.collective_matmul)
        kw.update(overrides)
        # Resolve knob conflicts AFTER overrides (the final schedule /
        # final fused_ce win; an explicit collective_matmul override is
        # honored as given):
        # - zero-bubble precludes the ring (its cond-gated phases
        #   cannot host the ring's whole-mesh ppermute — gpt_hybrid
        #   _validate_pp_schedule);
        # - at pp>1 the ring rides the manual-tp route, which has no
        #   fused-CE form: with fused_ce on (the default), the fused
        #   CE's memory win outranks the ring overlap, so the ring is
        #   dropped; pass fused_ce=False to take the ring instead.
        if "collective_matmul" not in overrides:
            fce = overrides.get("fused_ce", ParallelConfig.fused_ce)
            if kw["pp_schedule"] in ("zbh1", "zbvpp") or (
                    kw["collective_matmul"] and kw["pp"] > 1 and fce):
                kw["collective_matmul"] = False
        return ParallelConfig(**kw)

    def short(self) -> str:
        return (f"dp{self.dp}xtp{self.tp}xpp{self.pp}"
                f"{'+sp' if self.sp else ''}"
                f"{f'+zero{self.zero}' if self.zero else ''}"
                f"{'' if self.remat else '+noremat'}"
                f"{f'+mb{self.microbatches}' if self.pp > 1 else ''}"
                f"{'+cm' if self.collective_matmul else ''}")


from .auto_tuner import _divisors  # noqa: E402


def _spread(vals: List[int], k: int) -> List[int]:
    """Up to k values spanning the range (keep extremes + geometric
    middles) — no silent small-end truncation of the search space."""
    if len(vals) <= k:
        return vals
    idx = sorted({round(i * (len(vals) - 1) / (k - 1))
                  for i in range(k)})
    return [vals[i] for i in idx]


class Planner:
    #: usable fraction of HBM when judging feasibility — the bench
    #: runs within ~5% of HBM (B8 OOMs, B4 fits). Shared with the
    #: auto-tuner's prune_by_planner so the two rules cannot drift.
    hbm_feasible_frac = 0.95

    def __init__(self, chip: str = "H100", mfu: Optional[float] = None,
                 hbm_bytes: Optional[float] = None,
                 zero_stages: Sequence[int] = (0, 1, 2, 3)):
        """zero_stages limits the ZeRO dimension to what the target
        execution engine implements (the gpt_hybrid compiled engine
        implements stage 1; distributed/sharding.py's group-sharded
        eager path implements 1/2/3) — ranking a plan the target cannot
        execute would hand back an infeasible top-1."""
        self.cm = CostModel(chip)
        self.chip = chip
        self.hbm = hbm_bytes or HBM_BYTES[chip]
        self.zero_stages = tuple(zero_stages)
        self.mfu = mfu if mfu is not None else (
            self.calibrate(_H100_CALIBRATION) if chip == "H100"
            else 0.5)

    # ----------------------------------------------------- calibration
    def calibrate(self, points: Sequence[Tuple[ModelSpec, float]]
                  ) -> float:
        """Fit the achieved-MFU efficiency from measured
        (ModelSpec, tokens/sec/chip) pairs using the SAME FLOP formula
        the estimator charges (attention included — double-charging it
        would bias cross-seq ranking); sets and returns self.mfu."""
        effs = []
        for spec, tok_s in points:
            flops_needed = self.cm.train_flops(
                spec.n_params, spec.layers, spec.hidden, spec.seq,
                tok_s)
            effs.append(flops_needed / self.cm.spec["flops"])
        self.mfu = sum(effs) / len(effs)
        return self.mfu

    # ------------------------------------------------------- estimates
    def estimate(self, c: PlanCandidate, m: ModelSpec,
                 global_batch: int) -> PlanCandidate:
        """Fill est_step_s / est_mem_bytes / breakdown for one config."""
        spec = self.cm.spec
        tokens = float(global_batch) * m.seq
        tokens_dp = tokens / c.dp
        bd: Dict[str, float] = {}

        # ---- compute. The calibration points were measured WITH the
        # engine's remat-names policy, so mfu already absorbs its
        # recompute; remat=False removes roughly the re-run forward.
        flops = self.cm.train_flops(m.n_params, m.layers, m.hidden,
                                    m.seq, tokens)
        if not c.remat:
            flops *= 0.9            # names-policy recompute saved
        per_chip_flops = flops / (c.dp * c.tp * c.pp)
        # per-invocation token count: small microbatches leave the tensor
        # cores under-filled
        mb_tokens = tokens_dp / max(c.microbatches, 1)
        eff = mb_tokens / (mb_tokens + 512.0)
        bd["compute"] = per_chip_flops / (spec["flops"] * self.mfu * eff)

        # ---- TP activation collectives: per layer, fwd+bwd
        if c.tp > 1:
            act_bytes = 2.0 * tokens_dp * m.hidden
            kind = "reduce_scatter" if c.sp else "all_reduce"
            per_layer = self.cm.collective_cost(kind, act_bytes, c.tp)
            n_coll = 4 * m.layers / c.pp     # 2 fwd + 2 bwd per layer
            bd["tp_comm"] = n_coll * per_layer.time_s
            if c.sp:       # the matching all_gathers
                bd["tp_comm"] += n_coll * self.cm.collective_cost(
                    "all_gather", act_bytes, c.tp).time_s

        # ---- DP gradient + ZeRO parameter traffic
        if c.dp > 1:
            grad_bytes = 4.0 * m.n_params / (c.tp * c.pp)
            bd["dp_comm"] = self.cm.collective_cost(
                "all_reduce", grad_bytes, c.dp).time_s
            if c.zero >= 3:
                # params gathered fwd + bwd
                p_bytes = 2.0 * m.n_params / (c.tp * c.pp)
                bd["dp_comm"] += 2 * self.cm.collective_cost(
                    "all_gather", p_bytes, c.dp).time_s

        # ---- PP: activation hops (fwd + cotangent bwd per microbatch
        # per stage boundary) + the compiled-1F1B ramp bubble.
        # breakdown holds SECONDS only and sums exactly to est_step_s.
        if c.pp > 1:
            hop_bytes = 2.0 * mb_tokens * m.hidden
            bd["pp_comm"] = 2 * c.microbatches * self.cm.collective_cost(
                "ppermute", hop_bytes, c.pp).time_s * (c.pp - 1)
        step = sum(bd.values())
        if c.pp > 1:
            bubble = 2.0 * (c.pp - 1) / max(c.microbatches, 1)
            bd["pp_bubble"] = step * bubble
            step *= (1 + bubble)

        # ---- memory: bf16 weights, f32 Adam moments, a tenth of the
        # gradients live at once, and the activations that remat keeps
        shards = c.tp * c.pp
        p_shard = m.n_params / shards
        mem = 2.0 * p_shard                        # bf16 weights
        opt_shard = c.dp if c.zero >= 1 else 1
        mem += 8.0 * p_shard / opt_shard           # f32 adam m+v
        # gradients are freed leaf by leaf by the update; the peak adds
        # about the largest leaf, not the full tree
        mem += 4.0 * p_shard * 0.1 / (c.dp if c.zero >= 2 else 1)
        if c.zero >= 3:
            mem -= 2.0 * p_shard * (1 - 1.0 / c.dp)  # params dp-sharded
        # activations: saved tensors per layer x tokens on this chip
        # (the remat "names" policy keeps 3: qkv, attn_out, ffn1)
        act_tokens = tokens_dp / (c.tp if c.sp else 1)
        if c.pp > 1:
            act_tokens /= c.microbatches
        act_factor = 3.0 if c.remat else 16.0
        layers_here = m.layers / c.pp
        act = 2.0 * act_tokens * m.hidden * layers_here * act_factor
        if c.pp > 1:
            act *= min(2 * c.pp - 1, c.microbatches)   # 1F1B in-flight
        mem += act

        c.est_step_s = step
        c.est_mem_bytes = mem
        c.breakdown = bd
        return c

    # ----------------------------------------------------------- search
    def refusal_reason(self, m: ModelSpec, n_chips: int,
                       global_batch: int, *, dp: int, tp: int, pp: int,
                       microbatches: int = 1,
                       zero: int = 0) -> Optional[str]:
        """Why a config lies outside candidates()' structural space
        (None = legal). The SINGLE home of the legality rules: both
        candidates() enumeration below and the auto-tuner's
        prune_by_planner answer from here, and the lockstep test
        (test_auto_tuner_telemetry) pins that every enumerated
        candidate passes."""
        if dp * tp * pp != n_chips:
            return "mesh_mismatch"
        if tp > 8:
            return "tp_gt_8"
        if m.heads % tp or m.hidden % tp:
            return "tp_indivisible"
        if m.layers % pp:
            return "pp_indivisible"
        if global_batch % dp:
            return "dp_indivisible"
        if pp == 1:
            if microbatches != 1:
                return "microbatches_without_pp"
        else:
            if microbatches < pp:
                return "microbatches_lt_pp"
            if (global_batch // dp) % microbatches:
                return "microbatches_indivisible"
        if zero > 0 and dp <= 1:
            return "zero_requires_dp"   # zero stages shard over dp
        return None

    def candidates(self, m: ModelSpec, n_chips: int,
                   global_batch: int) -> List[PlanCandidate]:
        out = []
        for tp in _divisors(n_chips):
            if tp > 8 or m.heads % tp != 0 or m.hidden % tp != 0:
                continue
            rest = n_chips // tp
            for pp in _divisors(rest):
                if m.layers % pp != 0:
                    continue
                dp = rest // pp
                if global_batch % dp != 0:
                    continue
                mbs = [mb for mb in _divisors(global_batch // dp)
                       if mb >= pp] if pp > 1 else [1]
                zeros = tuple(z for z in self.zero_stages
                              if z == 0 or dp > 1) or (0,)
                for mb in _spread(mbs, 8):
                    for sp in ({False, tp > 1} if tp > 1 else {False}):
                        for zero in zeros:
                            for remat in (True, False):
                                out.append(PlanCandidate(
                                    dp=dp, tp=tp, pp=pp, sp=sp,
                                    zero=zero, remat=remat,
                                    microbatches=mb))
        return out

    def plan(self, m: ModelSpec, n_chips: int, global_batch: int,
             top_k: int = 5) -> List[PlanCandidate]:
        """Ranked feasible plans (fastest first; memory-infeasible
        configs dropped)."""
        cands = [self.estimate(c, m, global_batch)
                 for c in self.candidates(m, n_chips, global_batch)]
        feasible = [c for c in cands
                    if c.est_mem_bytes <= self.hbm_feasible_frac * self.hbm]
        if not feasible:
            raise RuntimeError(
                f"planner: no feasible config for {m.n_params / 1e9:.1f}B "
                f"params on {n_chips}x{self.chip}")
        # near-equal step times (within 0.5% of the fastest) tie-break
        # toward lower memory — zero stages are free headroom at equal
        # speed; relative bucketing so fast/small workloads don't
        # degenerate to memory-only ranking
        t_min = min(c.est_step_s for c in feasible)
        bucket = max(t_min * 0.005, 1e-9)
        feasible.sort(key=lambda c: (round(c.est_step_s / bucket),
                                     c.est_mem_bytes))
        return feasible[:top_k]

    def throughput(self, c: PlanCandidate, m: ModelSpec,
                   global_batch: int, n_chips: int) -> float:
        """tokens/sec/chip implied by a plan estimate."""
        tokens = global_batch * m.seq
        return tokens / c.est_step_s / n_chips
