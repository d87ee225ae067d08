"""Pipeline-parallel schedule descriptors: the port of
``paddle_tpu/parallel/pp_schedule.py`` (pure Python, copied so that the
port imports nothing of the reference package): F-then-B, 1F1B,
interleaved virtual pipeline (VPP), zero-bubble ZBH1 and ZB-V.

A Schedule is per-stage ordered instruction lists over (kind, stage,
microbatch, chunk) cells, with a dependency simulator (``simulate``:
validity, makespan, bubble), the liveness count (``peak_activations``) and
a host executor (``run_schedule``) that runs every stage in one process
over torch autograd. The distributed executors of
``parallel/pipeline_1f1b.py`` walk one stage's list each, a rank a stage.

Zero-bubble: B is the input gradient (on the critical path) and W the
deferred weight gradient (fills bubbles), two autograd passes over one
recomputed stage forward.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Callable, Dict, List, Optional, Tuple

# One instruction cell. kind: F (forward), B (backward input-grad; in
# non-zero-bubble schedules also computes weight-grad), W (deferred
# weight-grad, zero-bubble only). chunk = virtual-stage index (VPP).
PipeOp = namedtuple("PipeOp", ["kind", "stage", "mb", "chunk"])
PipeOp.__new__.__defaults__ = (0,)


class Schedule:
    """Per-stage ordered op lists + cost model."""

    def __init__(self, name: str, n_stages: int, n_microbatches: int,
                 per_stage: List[List[PipeOp]], n_chunks: int = 1,
                 durations: Optional[Dict[str, float]] = None,
                 chunk_dirs: Optional[List[int]] = None):
        self.name = name
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.n_chunks = n_chunks
        self.per_stage = per_stage
        # chunk_dirs[c] = +1: chunk c traverses devices 0..n-1;
        # -1: reversed (the ZB-V placement: device s holds virtual
        # stages s and 2n-1-s). Default: all forward (round-robin VPP).
        self.chunk_dirs = chunk_dirs or [1] * n_chunks
        self._chain_list = self._build_chain()
        self._chain_pos = {sc: i for i, sc in
                           enumerate(self._chain_list)}
        # F=1; a fused backward (dgrad+wgrad) costs 2; split B and W cost
        # 1 each — the standard zero-bubble accounting.
        self.durations = durations or (
            {"F": 1.0, "B": 1.0, "W": 1.0} if self._has_w()
            else {"F": 1.0, "B": 2.0})

    def _has_w(self):
        return any(op.kind == "W" for ops in self.per_stage for op in ops)

    # -- dependency model ---------------------------------------------
    def _build_chain(self):
        """Virtual-stage order as (physical_stage, chunk) pairs,
        honoring per-chunk traversal direction. Built once (chunk_dirs
        is fixed at construction)."""
        order = []
        for c, d in enumerate(self.chunk_dirs):
            rng = range(self.n_stages) if d > 0 else \
                range(self.n_stages - 1, -1, -1)
            order += [(s_, c) for s_ in rng]
        return order

    def virtual_index(self, stage: int, chunk: int) -> int:
        """Depth of (stage, chunk) in the virtual-stage chain, honoring
        per-chunk traversal direction — the index callback authors use
        to pick the right weights (round-robin placements: chunk*n +
        stage; the ZB-V placement: stage for chunk 0, 2n-1-stage for
        chunk 1)."""
        return self._chain_pos[(stage, chunk)]

    def deps(self, op: PipeOp) -> List[PipeOp]:
        """Cross-stage + intra-cell dependencies of one cell."""
        chain = self._chain_list
        pos = self._chain_pos[(op.stage, op.chunk)]
        out = []
        if op.kind == "F":
            if pos > 0:
                ps, pc = chain[pos - 1]
                out.append(PipeOp("F", ps, op.mb, pc))
        elif op.kind == "B":
            out.append(PipeOp("F", op.stage, op.mb, op.chunk))
            if pos < len(chain) - 1:
                ns, nc = chain[pos + 1]
                out.append(PipeOp("B", ns, op.mb, nc))
        elif op.kind == "W":
            out.append(PipeOp("B", op.stage, op.mb, op.chunk))
        return out

    # -- validation / cost --------------------------------------------
    def simulate(self) -> Tuple[float, float]:
        """Event-driven execution respecting per-stage order + deps.

        Returns (makespan, bubble_fraction). Raises on deadlock (invalid
        schedule) or on ops missing from the schedule.
        """
        ptr = [0] * self.n_stages
        stage_free = [0.0] * self.n_stages
        done: Dict[PipeOp, float] = {}
        total = sum(len(ops) for ops in self.per_stage)
        n_done = 0
        while n_done < total:
            progressed = False
            for s in range(self.n_stages):
                while ptr[s] < len(self.per_stage[s]):
                    op = self.per_stage[s][ptr[s]]
                    if any(d not in done for d in self.deps(op)):
                        break
                    start = max([stage_free[s]] +
                                [done[d] for d in self.deps(op)])
                    end = start + self.durations[op.kind]
                    done[op] = end
                    stage_free[s] = end
                    ptr[s] += 1
                    n_done += 1
                    progressed = True
            if not progressed:
                stuck = [self.per_stage[s][ptr[s]]
                         for s in range(self.n_stages)
                         if ptr[s] < len(self.per_stage[s])]
                raise RuntimeError(
                    f"schedule {self.name!r} deadlocked at {stuck}")
        makespan = max(done.values())
        work = max(sum(self.durations[op.kind] for op in ops)
                   for ops in self.per_stage)
        return makespan, 1.0 - work / makespan

    def peak_activations(self) -> int:
        """Max number of live forward contexts on any stage (the memory
        axis on which 1F1B beats F-then-B). A context becomes live at F
        and is freed at the matching B — unless a deferred W cell exists
        for it (zero-bubble), which holds the context until W runs;
        that's ZB's known memory premium over 1F1B."""
        peak = 0
        for ops in self.per_stage:
            has_w = {(op.mb, op.chunk) for op in ops if op.kind == "W"}
            live = 0
            for op in ops:
                if op.kind == "F":
                    live += 1
                elif op.kind == "B" and (op.mb, op.chunk) not in has_w:
                    live -= 1
                elif op.kind == "W":
                    live -= 1
                peak = max(peak, live)
        return peak

    def __repr__(self):
        return (f"Schedule({self.name}, stages={self.n_stages}, "
                f"mb={self.n_microbatches}, chunks={self.n_chunks})")


# ---------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------

def schedule_fthenb(n_stages: int, n_microbatches: int) -> Schedule:
    """GPipe F-then-B (reference pipeline_scheduler_pass FThenB): all
    forwards, then all backwards. Peak activation memory = all M."""
    per_stage = []
    for s in range(n_stages):
        ops = [PipeOp("F", s, i) for i in range(n_microbatches)]
        ops += [PipeOp("B", s, i) for i in range(n_microbatches)]
        per_stage.append(ops)
    return Schedule("FThenB", n_stages, n_microbatches, per_stage)


def schedule_1f1b(n_stages: int, n_microbatches: int) -> Schedule:
    """1F1B (pipeline_parallel.py:547): warmup of (stages-1-s) forwards,
    steady-state alternation, cooldown. Peak live activations per stage
    <= stages, independent of M."""
    per_stage = []
    for s in range(n_stages):
        w = min(n_stages - 1 - s, n_microbatches)
        ops = [PipeOp("F", s, i) for i in range(w)]
        for i in range(n_microbatches - w):
            ops.append(PipeOp("F", s, w + i))
            ops.append(PipeOp("B", s, i))
        for i in range(n_microbatches - w, n_microbatches):
            ops.append(PipeOp("B", s, i))
        per_stage.append(ops)
    return Schedule("1F1B", n_stages, n_microbatches, per_stage)


def schedule_zbh1(n_stages: int, n_microbatches: int) -> Schedule:
    """Zero-bubble ZBH1 (pipeline_zero_bubble.py:62): 1F1B shape with
    backward split into B (critical path) and W (bubble filler). W for
    microbatch i is scheduled at the point 1F1B would have spent the
    second half of its fused backward, except during cooldown where W's
    are deferred to fill the tail bubble."""
    per_stage = []
    for s in range(n_stages):
        w = min(n_stages - 1 - s, n_microbatches)
        ops = [PipeOp("F", s, i) for i in range(w)]
        pending_w: List[PipeOp] = []
        for i in range(n_microbatches - w):
            ops.append(PipeOp("F", s, w + i))
            ops.append(PipeOp("B", s, i))
            # steady state: immediately retire the weight grad unless we
            # are in the first `s` steady slots, where deferring it lets
            # the B chain start earlier on downstream stages
            if i < s:
                pending_w.append(PipeOp("W", s, i))
            else:
                ops.append(PipeOp("W", s, i))
        for i in range(n_microbatches - w, n_microbatches):
            ops.append(PipeOp("B", s, i))
            pending_w.append(PipeOp("W", s, i))
        ops += pending_w
        per_stage.append(ops)
    return Schedule("ZBH1", n_stages, n_microbatches, per_stage)


def schedule_interleaved(n_stages: int, n_microbatches: int,
                         n_chunks: int) -> Schedule:
    """Interleaved VPP (pipeline_parallel.py:1143 /
    pipeline_vpp.py): each physical stage holds `n_chunks` virtual
    stages; microbatches stream through chunk 0 of all stages, then
    chunk 1, etc. Generated greedily against the dependency model with
    the Megatron policy (depth-first forwards in warmup, then 1F1B
    alternation), so the order is valid by construction."""
    if n_microbatches % n_stages != 0:
        raise ValueError("interleaved schedule needs microbatches % "
                         "stages == 0 (reference constraint)")
    total_f = n_microbatches * n_chunks
    # per-stage warmup length (Megatron formula)
    per_stage: List[List[PipeOp]] = []
    f_order = []  # global virtual-forward order per stage policy
    for k in range(total_f):
        grp, pos = divmod(k, n_stages * n_chunks)
        chunk, slot = divmod(pos, n_stages)
        f_order.append((grp * n_stages + slot, chunk))
    for s in range(n_stages):
        warmup = min((n_stages - s - 1) * 2 + (n_chunks - 1) * n_stages,
                     total_f)
        fs = [PipeOp("F", s, mb, c) for mb, c in f_order]
        bs = [PipeOp("B", s, mb, c) for mb, c in
              [(mb, n_chunks - 1 - c) for mb, c in f_order]]
        ops = fs[:warmup]
        fi, bi = warmup, 0
        while fi < total_f or bi < total_f:
            if fi < total_f:
                ops.append(fs[fi])
                fi += 1
            if bi < total_f:
                ops.append(bs[bi])
                bi += 1
        per_stage.append(ops)
    return Schedule(f"VPP{n_chunks}", n_stages, n_microbatches, per_stage,
                    n_chunks=n_chunks)


# ---------------------------------------------------------------------
# Host executor (eager Plan interpreter)
# ---------------------------------------------------------------------

def run_schedule(sched: Schedule, forward: Callable, backward: Callable,
                 weight_grad: Optional[Callable], microbatch_inputs,
                 loss_grads):
    """Execute a schedule's cells with real compute.

    forward(stage, chunk, x) -> (y, ctx)
    backward(stage, chunk, ctx, gy) -> gx          (input-grad only)
    weight_grad(stage, chunk, ctx, gy) -> None     (accumulates weight
        grads; required for zero-bubble schedules with W cells. For
        schedules without W cells pass None and fold weight grads into
        `backward`; mismatches in either direction raise.)
    microbatch_inputs: list of M inputs to the FIRST virtual stage
        (chain position 0 — (stage 0, chunk 0) for every placement)
    loss_grads: list of M output-cotangents seeded at the LAST virtual
        stage, or a callable ``loss_grads(mb, y) -> gy`` called at that
        microbatch's first B with its final output ``y`` (a loss head);
        the list form is seeded at the LAST virtual
        stage — (stage n-1, chunk v-1) for round-robin placements,
        (stage 0, chunk 1) under the ZB-V placement (chunk_dirs
        [1,-1]); `Schedule.virtual_index` maps (stage, chunk) to chain
        depth for callback authors

    Executes cells in a valid global order (round-robin over stages
    honoring per-stage order + readiness, like the simulator). Returns
    the list of final-stage outputs per microbatch.
    """
    if weight_grad is not None and not sched._has_w():
        raise ValueError(
            f"schedule {sched.name!r} has no W cells; with a split "
            "weight_grad callback the weight grads would silently never "
            "be computed — use a zero-bubble schedule or fold weight "
            "grads into `backward` and pass weight_grad=None")
    if weight_grad is None and sched._has_w():
        raise ValueError(
            f"schedule {sched.name!r} contains W cells; pass a "
            "weight_grad callback (zero-bubble splits backward into "
            "input-grad B and weight-grad W)")
    acts: Dict[Tuple[int, int, int], object] = {}   # F outputs
    ctxs: Dict[Tuple[int, int, int], object] = {}
    grads: Dict[Tuple[int, int, int], object] = {}  # B input-grads
    outs: Dict[int, object] = {}
    n = sched.n_stages
    # data routing follows the virtual-stage CHAIN (which encodes
    # chunk_dirs), not hard-coded stage-0/stage-(n-1) boundaries — so
    # reversed chunks (the ZB-V placement) route correctly too
    chain = sched._chain_list
    pos_of = sched._chain_pos
    last = len(chain) - 1
    done = set()
    ptr = [0] * n
    total = sum(len(ops) for ops in sched.per_stage)
    n_done = 0
    while n_done < total:
        progressed = False
        for s in range(n):
            while ptr[s] < len(sched.per_stage[s]):
                op = sched.per_stage[s][ptr[s]]
                if any(d not in done for d in sched.deps(op)):
                    break
                key = (op.stage, op.mb, op.chunk)
                pos = pos_of[(op.stage, op.chunk)]
                if op.kind == "F":
                    if pos == 0:
                        x = microbatch_inputs[op.mb]
                    else:
                        ps, pc = chain[pos - 1]
                        x = acts[(ps, op.mb, pc)]
                    y, ctx = forward(op.stage, op.chunk, x)
                    acts[key] = y
                    ctxs[key] = ctx
                    if pos == last:
                        outs[op.mb] = y
                elif op.kind == "B":
                    if pos == last:
                        gy = loss_grads(op.mb, outs[op.mb]) \
                            if callable(loss_grads) else loss_grads[op.mb]
                    else:
                        ns, nc = chain[pos + 1]
                        gy = grads[(ns, op.mb, nc)]
                    gx = backward(op.stage, op.chunk, ctxs[key], gy)
                    grads[key] = gx
                    if weight_grad is not None:
                        # stash gy for the W cell
                        ctxs[key] = (ctxs[key], gy)
                else:  # W
                    ctx, gy = ctxs[key]
                    weight_grad(op.stage, op.chunk, ctx, gy)
                done.add(op)
                ptr[s] += 1
                n_done += 1
                progressed = True
        if not progressed:
            raise RuntimeError(f"run_schedule deadlocked in {sched.name}")
    return [outs[i] for i in range(sched.n_microbatches)]


def schedule_zbvpp(n_stages: int, n_microbatches: int,
                   mem_limit: Optional[int] = None) -> Schedule:
    """ZB-V / ZBVPP (reference pipeline_zero_bubble.py:151): two model
    chunks per device in V placement — device s holds virtual stages s
    and 2n-1-s, so the pipeline turns around WITHOUT a hop (the chunk
    boundary is device-local) — with backward split into B (input-grad,
    critical path) and W (weight-grad, bubble filler).

    Generated by dependency-driven greedy list scheduling: each device
    appends its highest-priority READY cell (B before F — B is the
    critical path — and W only when neither is ready, i.e. W fills
    bubbles). With `mem_limit` set, pending W's retire first once the
    live-context count hits the limit (trading bubble back for memory;
    the paper's ZB-V reaches zero bubble at the 1F1B envelope with an
    ILP-derived schedule — this greedy generator is the descriptor-level
    mirror, not that optimum). Default: unbounded (ZB-inf behavior).
    Valid by construction; bubble measured by simulate() and asserted
    below the fused-backward 1F1B's in tests.
    """
    n, m = n_stages, n_microbatches
    cap = mem_limit if mem_limit is not None else 10 ** 9
    dirs = [1, -1]
    v = 2
    sched = Schedule("ZBVPP", n, m, [[] for _ in range(n)],
                     n_chunks=v, chunk_dirs=dirs,
                     durations={"F": 1.0, "B": 1.0, "W": 1.0})
    # pending per device: per-chunk F/B queues (mb order) + W pool
    fq = {(s, c): list(range(m)) for s in range(n) for c in range(v)}
    bq = {(s, c): list(range(m)) for s in range(n) for c in range(v)}
    wq = {s: [] for s in range(n)}
    done = set()
    total = n * v * m * 3
    force_f = False
    while len(done) < total:
        progressed = False
        for s in range(n):
            # candidates in priority order: B, F (chunk order by
            # virtual depth so warmup fills chunk 0 first), W
            cand = None
            live = sum(1 for op in sched.per_stage[s]
                       if op.kind == "F") - \
                sum(1 for op in sched.per_stage[s] if op.kind == "W")
            if live >= cap and wq[s]:
                ready_w = [w for w in wq[s]
                           if all(d in done for d in sched.deps(w))]
                if ready_w:
                    cand = ready_w[0]
                    wq[s].remove(cand)
            if cand is None:
                for c in sorted(range(v),
                                key=lambda c: -(c * n)):  # deeper first
                    if bq[(s, c)]:
                        op = PipeOp("B", s, bq[(s, c)][0], c)
                        if all(d in done for d in sched.deps(op)):
                            cand = op
                            bq[(s, c)].pop(0)
                            wq[s].append(PipeOp("W", s, op.mb, c))
                            break
            if cand is None and (live < cap or force_f):
                for c in range(v):
                    if fq[(s, c)]:
                        op = PipeOp("F", s, fq[(s, c)][0], c)
                        if all(d in done for d in sched.deps(op)):
                            cand = op
                            fq[(s, c)].pop(0)
                            break
            if cand is None and wq[s]:
                cand = wq[s].pop(0)
            if cand is not None:
                sched.per_stage[s].append(cand)
                done.add(cand)
                progressed = True
        if not progressed:
            if not force_f:
                # liveness fallback: permit F beyond the memory cap for
                # one sweep (a starved downstream B needs our F)
                force_f = True
                continue
            raise RuntimeError("zbvpp generator deadlocked")
        force_f = False
    return sched
