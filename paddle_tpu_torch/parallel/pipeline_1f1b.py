"""The pipeline schedules a rank at a time: the port of
``paddle_tpu/parallel/pipeline_1f1b.py`` (1F1B, interleaved VPP, zero-bubble
ZBH1 and ZB-V).

The reference compiles each schedule into one XLA program: a ``lax.scan``
over clock ticks in which every stage runs its (masked) cells and the
activations and cotangents hop stages by ``lax.ppermute``. Here each rank
of the pp group is one stage, and its host walks its own instruction list
of the same schedule (``compiled_*_schedule(...).per_stage[stage]``): the
lockstep grid where virtual stage sigma forwards microbatch t - sigma and
backwards t - 2(Ng - 1) + sigma at tick t. After the cells of a tick, the
activations and cotangents they produced travel to the neighbouring stages
(``distributed.collective.p2p_exchange``); both sides of a hop know from
the grid which messages it carries, so every rank posts the same sends and
receives. Cells of a tick that the grid leaves empty are not run at all
(the reference runs them masked).

Memory and recompute are the reference's: F runs the stage without
autograd and stashes its input; B recomputes the stage forward from that
input and back-propagates through it (stage-granular recompute), so at
most 2(N - 1 - s) + 1 stage inputs are live on stage s. Under the
zero-bubble schedules B computes the input gradient only and keeps the
recomputed graph; the deferred W back-propagates through the same graph a
second time, for the weight gradients, and frees it. ``run_all_stages``
runs the same cells for every stage in one process, in
``pp_schedule.run_schedule``'s order.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from .pp_schedule import PipeOp, Schedule


def _record_schedule_metrics(kind: str, builder, *dims):
    """The schedule's analytic cost (``Schedule.simulate``: bubble share,
    makespan in cells) and its geometry as observability gauges keyed by
    schedule kind, and one ``pipeline.traces`` tick a run."""
    from ..observability import metrics as _met
    if not _met._ENABLED:
        return
    try:
        makespan, bubble = builder(*dims).simulate()
        r = _met.REGISTRY
        r.gauge("pipeline.bubble_fraction", schedule=kind).set(bubble)
        r.gauge("pipeline.makespan_ticks", schedule=kind).set(makespan)
        r.gauge("pipeline.stages", schedule=kind).set(dims[0])
        r.gauge("pipeline.microbatches", schedule=kind).set(dims[1])
        r.counter("pipeline.traces", schedule=kind).inc()
    except Exception:
        pass        # cost accounting must never break a train step


def compiled_1f1b_schedule(n_stages: int, n_microbatches: int) -> Schedule:
    """The (stage, tick) -> op timeline ``pipeline_train_1f1b`` runs, as a
    pp_schedule.Schedule — so its dependency validity, makespan and
    peak-activation bound are checkable with the same machinery as the
    host schedules (the VERDICT 'schedule equivalence' artifact)."""
    n, m = n_stages, n_microbatches
    per_stage = []
    for s in range(n):
        ops = []
        for t in range(m + 2 * (n - 1)):
            mf = t - s
            if 0 <= mf < m:
                ops.append(PipeOp("F", s, mf))
            mb = t - 2 * (n - 1) + s
            if 0 <= mb < m:
                ops.append(PipeOp("B", s, mb))
        per_stage.append(ops)
    return Schedule("compiled-1F1B", n, m, per_stage)


def compiled_interleaved_schedule(n_stages: int, n_microbatches: int,
                                  n_chunks: int) -> Schedule:
    """The lockstep timeline `pipeline_train_interleaved` runs, as a
    checkable pp_schedule.Schedule (reference analog:
    PipelineParallelWithInterleave, pipeline_parallel.py:1143 /
    pipeline_vpp.py).

    Virtual stage of (chunk j, device s) is sigma = j*n + s: consecutive
    virtual stages sit on consecutive ring devices, with the chunk
    boundary riding the ring's (n-1 -> 0) wrap — so one hop
    a tick serves both intra- and inter-chunk activation transfer. At tick t, virtual stage sigma forwards microbatch t -
    sigma and backwards t - 2(Ng-1) + sigma (Ng = n*v virtual stages).
    """
    n, m, v = n_stages, n_microbatches, n_chunks
    ng = n * v
    per_stage = []
    for s in range(n):
        ops = []
        for t in range(m + 2 * (ng - 1)):
            for j in range(v):
                sigma = j * n + s
                mf = t - sigma
                if 0 <= mf < m:
                    ops.append(PipeOp("F", s, mf, j))
                mb = t - 2 * (ng - 1) + sigma
                if 0 <= mb < m:
                    ops.append(PipeOp("B", s, mb, j))
        per_stage.append(ops)
    return Schedule(f"compiled-VPP{v}", n, m, per_stage, n_chunks=v)


def _zb_w_recurrence(ng: int, m: int, sigma: int):
    """The (static) W-firing recurrence of virtual stage `sigma` in an
    ng-deep pipeline: at tick t, with nW W's already retired, fire iff
    pending B's exist AND (the stage's F lane is idle — cooldown/drain
    — OR the backlog exceeds sigma, the zero-bubble 'defer the first
    sigma weight-grads' policy, pp_schedule.py schedule_zbh1). Yields
    (t, fired) until all m W's retire. ZBH1 instantiates it with
    ng = n_stages, sigma = s; ZB-V with ng = 2n and the V-placement
    virtual depths."""
    nW, t = 0, 0
    while nW < m:
        nB = min(max(t - 2 * (ng - 1) + sigma + 1, 0), m)
        f_active = 0 <= t - sigma < m
        pending = nB - nW
        fired = pending > 0 and ((not f_active) or pending > sigma)
        if fired:
            nW += 1
        yield t, fired
        t += 1


def zbh1_extra_ticks(n_stages: int, n_microbatches: int) -> int:
    """Drain ticks past the 1F1B grid that the deferred W backlog
    needs (worst on the last stage, which has no F-idle cooldown)."""
    T = n_microbatches + 2 * (n_stages - 1)
    extra = 0
    for s in range(n_stages):
        last = max(t for t, f in _zb_w_recurrence(
            n_stages, n_microbatches, s) if f)
        extra = max(extra, last + 1 - T)
    return max(extra, 0)


def compiled_zbh1_schedule(n_stages: int, n_microbatches: int) -> Schedule:
    """The exact (stage, tick) -> phases timeline `pipeline_train_zbh1`
    runs, as a checkable Schedule (the VERDICT schedule-equivalence
    artifact). F/B ride the compiled-1F1B grid; B is input-grad ONLY
    (cost 2: stage-granular forward recompute + dx) and the deferred W
    (cost 2: recompute + dW) fires per the backlog recurrence. The
    fused compiled 1F1B's honest durations are {F:1, B:3} (recompute +
    dx + dW); zero-bubble pays one extra recompute unit per microbatch
    to move W off the critical path into cond-skipped idle ticks.

    Reference: pipeline_zero_bubble.py:62 (ZBH1's B/W split and
    W-fills-bubbles placement)."""
    n, m = n_stages, n_microbatches
    T = m + 2 * (n - 1) + zbh1_extra_ticks(n, m)
    per_stage = []
    for s in range(n):
        fires = dict(_zb_w_recurrence(n, m, s))
        ops = []
        nW = 0
        for t in range(T):
            mf = t - s
            if 0 <= mf < m:
                ops.append(PipeOp("F", s, mf))
            mb = t - 2 * (n - 1) + s
            if 0 <= mb < m:
                ops.append(PipeOp("B", s, mb))
            if fires.get(t, False):
                ops.append(PipeOp("W", s, nW))
                nW += 1
        per_stage.append(ops)
    return Schedule("compiled-ZBH1", n, m, per_stage,
                    durations={"F": 1.0, "B": 2.0, "W": 2.0})


def zbvpp_extra_ticks(n_stages: int, n_microbatches: int) -> int:
    """Drain ticks past the ZB-V grid (m + 2(2n-1) ticks) that the
    deferred W backlogs need, worst over both lanes of every device."""
    ng = 2 * n_stages
    T = n_microbatches + 2 * (ng - 1)
    extra = 0
    for sigma in range(ng):
        last = max(t for t, f in _zb_w_recurrence(
            ng, n_microbatches, sigma) if f)
        extra = max(extra, last + 1 - T)
    return max(extra, 0)


def compiled_zbvpp_schedule(n_stages: int,
                            n_microbatches: int) -> Schedule:
    """The exact (device, tick) -> phases timeline `pipeline_train_zbvpp`
    runs, as a checkable Schedule (chunk_dirs=[1,-1]: the ZB-V
    placement — device s holds virtual stages s and 2n-1-s, so both
    chunk turnarounds are device-local and the last virtual stage sits
    on DEVICE 0). F/B ride the lockstep grid of the 2n-deep virtual
    pipeline; B is input-grad only (cost 2: stage recompute + dx) and
    each virtual stage's deferred W (cost 2: recompute + dW) fires per
    the zero-bubble backlog recurrence with defer bound sigma.

    Reference: pipeline_zero_bubble.py:151 (ZBVPP's B/W split and V
    placement)."""
    n, m = n_stages, n_microbatches
    ng = 2 * n
    T = m + 2 * (ng - 1) + zbvpp_extra_ticks(n, m)
    per_stage = []
    for s in range(n):
        sig = {0: s, 1: ng - 1 - s}
        fires = {c: dict(_zb_w_recurrence(ng, m, sig[c]))
                 for c in (0, 1)}
        nw = {0: 0, 1: 0}
        ops = []
        for t in range(T):
            for c in (0, 1):
                mf = t - sig[c]
                if 0 <= mf < m:
                    ops.append(PipeOp("F", s, mf, c))
            # backward order lane1-then-lane0 mirrors the compiled
            # tick (lane0's cot at device n-1 is lane1's previous dx)
            for c in (1, 0):
                mb = t - 2 * (ng - 1) + sig[c]
                if 0 <= mb < m:
                    ops.append(PipeOp("B", s, mb, c))
            for c in (0, 1):
                if fires[c].get(t, False):
                    ops.append(PipeOp("W", s, nw[c], c))
                    nw[c] += 1
        per_stage.append(ops)
    return Schedule("compiled-ZBVPP", n, m, per_stage, n_chunks=2,
                    chunk_dirs=[1, -1],
                    durations={"F": 1.0, "B": 2.0, "W": 2.0})


# ---------------------------------------------------------------------
# The host executor of one stage
# ---------------------------------------------------------------------
def _grid_ticks(sched: Schedule, op: PipeOp) -> Optional[int]:
    """The tick of an F or B cell on the lockstep grid (None for W, which
    never communicates)."""
    ng = len(sched._chain_list)
    sigma = sched._chain_pos[(op.stage, op.chunk)]
    if op.kind == "F":
        return op.mb + sigma
    if op.kind == "B":
        return op.mb + 2 * (ng - 1) - sigma
    return None


def _tag(kind: str, mb: int, chunk: int) -> int:
    return (mb * 8 + chunk) * 2 + (kind == "B")


def _tree_map(fn, *trees):
    """``fn`` over the leaves (dict keys in sorted order, as
    ``_tree_leaves``)."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def _tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def _tree_unflatten(like, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), like)


def _zero_grads(chunk_params, grad_dtype):
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=grad_dtype,
                                           device=p.device), chunk_params)


def _add_grads(acc_tree, dps):
    for acc, d in zip(_tree_leaves(acc_tree), dps):
        if d is not None:
            acc.add_(d.to(acc.dtype))


def _backward_cell(fn, params, x, gy, split):
    """A B cell: recompute the stage ``fn`` from its stashed input ``x``
    and back-propagate ``gy``. Returns (dx, the parameter gradients, None)
    or, ``split`` (zero-bubble), (dx, None, the graph that W
    back-propagates through a second time)."""
    ps = [p.detach().requires_grad_(True) for p in _tree_leaves(params)]
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        y = fn(_tree_unflatten(params, ps), xg)
        if split:
            (dx,) = torch.autograd.grad(y, [xg], gy.to(y.dtype),
                                        retain_graph=True)
            return dx, None, (y, ps, gy)
        dx, *dps = torch.autograd.grad(y, [xg] + ps, gy.to(y.dtype),
                                       allow_unused=True)
    return dx, dps, None


def _weight_cell(kept):
    """A W cell: the weight gradients through B's kept graph."""
    y, ps, gy = kept
    return torch.autograd.grad(y, ps, gy.to(y.dtype), allow_unused=True)


class _HeadSum:
    """The head's loss and gradients summed over the microbatches."""

    def __init__(self, grad_dtype):
        self.dtype, self.loss, self.grads = grad_dtype, None, None

    def add(self, l_mb, hg):
        l_mb = l_mb.detach().to(self.dtype)
        self.loss = l_mb if self.loss is None else self.loss + l_mb
        if hg is not None:
            self.grads = _tree_map(
                lambda g: g.detach().to(self.dtype).clone(), hg) \
                if self.grads is None else _tree_map(
                    lambda a, g: a.add_(g.to(a.dtype)), self.grads, hg)


def run_stage(sched: Schedule, group, stage_fn: Callable, chunk_params,
              x_microbatches, last_stage_grad: Callable, head_params=None,
              grad_dtype=torch.float32, graph_stage_fn=None):
    """Runs stage ``group.rank``'s cells of ``sched`` (a lockstep grid:
    ``compiled_*_schedule``) on this rank.

    ``stage_fn(params, x) -> y`` is one virtual stage's forward;
    ``chunk_params[c]`` is the parameter tree of this rank's chunk c;
    ``x_microbatches`` [M, ...] the first virtual stage's inputs (read on
    the rank that holds it); ``last_stage_grad(y, head_params, mb) ->
    (loss, dy, head_grads)`` the head on the last virtual stage's output.
    ``graph_stage_fn`` (default ``stage_fn``): the stage forward whose graph
    a zero-bubble B keeps for its W, which back-propagates through it a
    second time; a selective checkpoint allows one backward only, so pass
    the stage without it (the stage is a recompute already).

    Returns (this rank's summed head loss or None, its chunks' parameter
    gradients [c] (trees in ``grad_dtype``), its summed head gradients or
    None, the input cotangents [M, ...] of the first virtual stage or None
    where this rank does not hold it)."""
    from ..distributed import collective as C
    n, m = sched.n_stages, sched.n_microbatches
    s = group.rank
    chain, pos_of = sched._chain_list, sched._chain_pos
    ng = len(chain)
    split = sched._has_w()
    ops = sched.per_stage[s]
    ticks = [t for t in map(lambda o: _grid_ticks(sched, o), ops)
             if t is not None]
    if ticks != sorted(ticks):
        raise ValueError(f"schedule {sched.name!r}: stage {s}'s cells are "
                         "not in the lockstep grid's tick order")
    example = x_microbatches[0]
    shape, dtype, device = tuple(example.shape), example.dtype, \
        example.device
    v = sched.n_chunks
    my_chunks = [c for c in range(v) if (s, c) in pos_of]

    grads = [_zero_grads(chunk_params[c], grad_dtype) for c in range(v)]
    head = _HeadSum(grad_dtype)
    dx0 = None
    inbox: Dict = {}       # ("F"|"B", mb, chunk) -> tensor
    stash: Dict = {}       # (mb, chunk) -> stage input
    wstash: Dict = {}      # (mb, chunk) -> (y, param leaves, gy)
    outbox: Dict[int, list] = {}

    def send(t, kind, mb, to):
        """Routes a cell's output to virtual stage ``to`` = (stage,
        chunk): kept here when ``to`` is on this rank, else posted at the
        end of the tick."""
        if to[0] == s:
            inbox[(kind, mb, to[1])] = t
        else:
            outbox.setdefault(t_now[0], []).append(
                (t.contiguous(), to[0], _tag(kind, mb, to[1])))

    def exchange(t):
        """The hop after tick t: this rank's sends of the tick, and the
        receives that its cells of tick t + 1 need."""
        sends = outbox.pop(t, [])
        recvs, keys = [], []
        for c in my_chunks:
            sigma = pos_of[(s, c)]
            mb = t + 1 - sigma
            if sigma > 0 and 0 <= mb < m and chain[sigma - 1][0] != s:
                recvs.append((shape, dtype, device, chain[sigma - 1][0],
                              _tag("F", mb, c)))
                keys.append(("F", mb, c))
            mb = t + 1 - 2 * (ng - 1) + sigma
            if sigma < ng - 1 and 0 <= mb < m and \
                    chain[sigma + 1][0] != s:
                recvs.append((shape, dtype, device, chain[sigma + 1][0],
                              _tag("B", mb, c)))
                keys.append(("B", mb, c))
        if not sends and not recvs:
            return
        order = sorted(range(len(recvs)), key=lambda i: (recvs[i][3],
                                                          recvs[i][4]))
        sends = sorted(sends, key=lambda x: (x[1], x[2]))
        got = C.p2p_exchange(sends, [recvs[i] for i in order], group)
        for i, g in zip(order, got):
            inbox[keys[i]] = g

    t_now = [0]
    for op in ops:
        t = _grid_ticks(sched, op)
        if t is not None:
            while t_now[0] < t:
                exchange(t_now[0])
                t_now[0] += 1
        c, mb = op.chunk, op.mb
        sigma = pos_of[(s, c)]
        if op.kind == "F":
            x = x_microbatches[mb] if sigma == 0 \
                else inbox.pop(("F", mb, c))
            stash[(mb, c)] = x
            with torch.no_grad():
                y = stage_fn(chunk_params[c], x)
            if sigma == ng - 1:
                l_mb, dy, hg = last_stage_grad(y, head_params, mb)
                head.add(l_mb, hg)
                inbox[("B", mb, c)] = dy.to(dtype)
            else:
                send(y.to(dtype), "F", mb, chain[sigma + 1])
        elif op.kind == "B":
            fn = (graph_stage_fn or stage_fn) if split else stage_fn
            dx, dps, kept = _backward_cell(fn, chunk_params[c],
                                           stash.pop((mb, c)),
                                           inbox.pop(("B", mb, c)), split)
            if split:
                wstash[(mb, c)] = kept
            else:
                _add_grads(grads[c], dps)
            dx = dx.to(dtype)
            if sigma == 0:
                if dx0 is None:
                    dx0 = torch.zeros((m,) + shape, dtype=dtype,
                                      device=device)
                dx0[mb] = dx
            else:
                send(dx, "B", mb, chain[sigma - 1])
        else:                                                   # W
            _add_grads(grads[c], _weight_cell(wstash.pop((mb, c))))
    last = max(ticks) if ticks else -1
    while t_now[0] <= last + 1:
        exchange(t_now[0])
        t_now[0] += 1
    if inbox or stash or wstash or outbox:
        raise RuntimeError(f"schedule {sched.name!r}: stage {s} ended with "
                           "cells' data left over")
    return head.loss, grads, head.grads, dx0


def run_all_stages(sched: Schedule, stage_fn: Callable, chunk_params,
                   x_microbatches, last_stage_grad: Callable,
                   head_params=None, grad_dtype=torch.float32,
                   graph_stage_fn=None, grads=None):
    """Every stage of ``sched`` in this process, in
    ``pp_schedule.run_schedule``'s order, with ``run_stage``'s cells: F
    without autograd, B recomputing the stage (input gradient only under
    a zero-bubble schedule, whose W then takes the weight gradients).

    ``chunk_params[(stage, chunk)]`` is that virtual stage's parameter
    tree; ``grads`` (default zeros in ``grad_dtype``) trees like it that
    the gradients are summed into; the rest is ``run_stage``'s contract.
    Returns (the summed loss, ``grads``, the summed head gradients, the
    first virtual stage's input cotangents [M, ...])."""
    from .pp_schedule import run_schedule
    split = sched._has_w()
    if grads is None:
        grads = {k: _zero_grads(t, grad_dtype)
                 for k, t in chunk_params.items()}
    head = _HeadSum(grad_dtype)
    dx0 = torch.zeros_like(x_microbatches)

    def forward(stage, chunk, x):
        # the first virtual stage's inputs come as (microbatch, input)
        mb, x = x if isinstance(x, tuple) else (None, x)
        with torch.no_grad():
            y = stage_fn(chunk_params[(stage, chunk)], x)
        return y, {"x": x, "mb": mb}

    def backward(stage, chunk, ctx, gy):
        fn = (graph_stage_fn or stage_fn) if split else stage_fn
        dx, dps, ctx["kept"] = _backward_cell(
            fn, chunk_params[(stage, chunk)], ctx.pop("x"), gy, split)
        if not split:
            _add_grads(grads[(stage, chunk)], dps)
        if ctx["mb"] is not None:
            dx0[ctx["mb"]] = dx
        return dx

    def weight_grad(stage, chunk, ctx, gy):
        _add_grads(grads[(stage, chunk)], _weight_cell(ctx.pop("kept")))

    def loss_grads(mb, y):
        l_mb, dy, hg = last_stage_grad(y, head_params, mb)
        head.add(l_mb, hg)
        return dy.to(y.dtype)

    run_schedule(sched, forward, backward, weight_grad if split else None,
                 list(enumerate(x_microbatches)), loss_grads)
    return head.loss, grads, head.grads, dx0


def _pipeline_epilogue(group, loss, head, dx0, probe_head, x_microbatches,
                       grad_dtype):
    """The reference's final psums over the pp group: the loss and the head
    gradients live on the head stage, dx0 on the first virtual stage's;
    one flat sum (zeros elsewhere) replicates them on every rank."""
    from ..distributed import collective as C
    dev = x_microbatches.device
    parts = [loss.reshape(1) if loss is not None else
             torch.zeros(1, dtype=grad_dtype, device=dev)]
    hl = _tree_leaves(probe_head) if probe_head is not None else []
    if hl:
        got = _tree_leaves(head) if head is not None else None
        parts += [g.reshape(-1).to(grad_dtype) if got is not None else
                  torch.zeros(p.numel(), dtype=grad_dtype, device=dev)
                  for g, p in zip(got or hl, hl)]
    parts.append(dx0.reshape(-1).to(grad_dtype) if dx0 is not None else
                 torch.zeros(x_microbatches.numel(), dtype=grad_dtype,
                             device=dev))
    flat = torch.cat([p.to(dev) for p in parts])
    C.all_reduce_flat(flat, C.ReduceOp.SUM, group)
    loss = flat[0]
    off = 1
    out = []
    for p in hl:
        out.append(flat[off:off + p.numel()].view(p.shape))
        off += p.numel()
    head = _tree_unflatten(probe_head, out) if hl else None
    dx0 = flat[off:].view(x_microbatches.shape).to(x_microbatches.dtype)
    return loss, head, dx0


def pipeline_train_chunks(sched: Schedule, stage_fn: Callable, chunk_params,
                          x_microbatches, last_stage_grad: Callable,
                          head_params=None, group=None,
                          grad_dtype=torch.float32, graph_stage_fn=None):
    """``run_stage`` of this rank's stage of ``sched`` on the pp ``group``,
    then the epilogue: returns (the summed loss, this rank's chunks'
    parameter gradients [c], the summed head gradients, dx0 [M, ...]), the
    loss, head gradients and dx0 the same on every rank."""
    group = _pp_group(group)
    if group.nranks != sched.n_stages:
        raise ValueError(f"a {sched.n_stages}-stage schedule on a pp group "
                         f"of {group.nranks} ranks")
    loss, grads, head, dx0 = run_stage(
        sched, group, stage_fn, chunk_params, x_microbatches,
        last_stage_grad, head_params, grad_dtype, graph_stage_fn)
    loss, head, dx0 = _pipeline_epilogue(group, loss, head, dx0,
                                         head_params, x_microbatches,
                                         grad_dtype)
    return loss, grads, head, dx0


def _pp_group(group):
    """``group``, or this process alone (world 1) for None."""
    from ..distributed.env import Group
    return group or Group(0, [0])


def _pipeline_train(sched, stage_fn, stage_params, x_microbatches,
                    last_stage_grad, head_params, group, grad_dtype,
                    chunked, graph_stage_fn=None):
    """One of the pipeline_train_* entries. ``chunked``: stage_params
    leaves carry a leading chunk dim."""
    chunks = [_tree_map(lambda p, j=j: p[j], stage_params)
              for j in range(sched.n_chunks)] if chunked else [stage_params]
    loss, grads, head, dx0 = pipeline_train_chunks(
        sched, stage_fn, chunks, x_microbatches, last_stage_grad,
        head_params, group, grad_dtype, graph_stage_fn)
    grads = _tree_map(lambda *g: torch.stack(g), *grads) if chunked \
        else grads[0]
    return loss, grads, head, dx0


def pipeline_train_1f1b(stage_fn: Callable, stage_params, x_microbatches,
                        last_stage_grad: Callable, head_params=None,
                        group=None, grad_dtype=torch.float32):
    """1F1B on the pp ``group`` (a rank a stage): the reference's contract,
    a rank at a time.

    ``stage_fn(params, x) -> y`` this rank's stage; ``stage_params`` its
    parameter tree; ``x_microbatches`` [M, ...] the stage-0 inputs (the
    same on every rank; read on stage 0); ``last_stage_grad(y,
    head_params, mb_idx) -> (loss, dy, head_grads)`` the head and loss on
    the last stage's output (head_grads a tree like ``head_params``, or
    None). Returns (the summed loss, this stage's parameter gradients in
    ``grad_dtype``, the summed head gradients, dx0 [M, ...] the input
    cotangents at stage 0), the loss, head gradients and dx0 the same on
    every rank."""
    n, m = _pp_group(group).nranks, x_microbatches.shape[0]
    _record_schedule_metrics("1f1b", compiled_1f1b_schedule, n, m)
    return _pipeline_train(compiled_1f1b_schedule(n, m), stage_fn,
                           stage_params, x_microbatches, last_stage_grad,
                           head_params, group, grad_dtype, False)


def pipeline_train_interleaved(stage_fn: Callable, stage_params,
                               x_microbatches, last_stage_grad: Callable,
                               head_params=None, group=None, num_chunks=2,
                               grad_dtype=torch.float32):
    """Interleaved VPP: this rank holds ``num_chunks`` virtual stages (its
    parameter leaves carry a leading [v] dim: chunk j is virtual stage
    j * n + s); otherwise ``pipeline_train_1f1b``'s contract. The chunk
    boundary rides the ring's (n - 1 -> 0) wrap."""
    n, m = _pp_group(group).nranks, x_microbatches.shape[0]
    _record_schedule_metrics(f"vpp{num_chunks}",
                             compiled_interleaved_schedule, n, m,
                             num_chunks)
    return _pipeline_train(
        compiled_interleaved_schedule(n, m, num_chunks), stage_fn,
        stage_params, x_microbatches, last_stage_grad, head_params, group,
        grad_dtype, True)


def pipeline_train_zbh1(stage_fn: Callable, stage_params, x_microbatches,
                        last_stage_grad: Callable, head_params=None,
                        group=None, grad_dtype=torch.float32,
                        graph_stage_fn=None):
    """Zero-bubble ZBH1: ``pipeline_train_1f1b``'s contract, the backward
    split into B (the input gradient, on the 1F1B grid) and the deferred W
    (the weight gradient) retired by the backlog recurrence
    (``compiled_zbh1_schedule``); ``graph_stage_fn`` as in ``run_stage``."""
    n, m = _pp_group(group).nranks, x_microbatches.shape[0]
    _record_schedule_metrics("zbh1", compiled_zbh1_schedule, n, m)
    return _pipeline_train(compiled_zbh1_schedule(n, m), stage_fn,
                           stage_params, x_microbatches, last_stage_grad,
                           head_params, group, grad_dtype, False,
                           graph_stage_fn)


def pipeline_train_zbvpp(stage_fn: Callable, stage_params, x_microbatches,
                         last_stage_grad: Callable, head_params=None,
                         group=None, grad_dtype=torch.float32,
                         graph_stage_fn=None):
    """Zero-bubble ZB-V: two chunks a rank in the V placement (leaves
    [2, ...]: [0] virtual stage s, [1] virtual stage 2n - 1 - s), the
    ZBH1 split of the backward; the head sits on stage 0. Both chunk
    turnarounds stay on one rank. ``graph_stage_fn`` as in
    ``run_stage``."""
    n, m = _pp_group(group).nranks, x_microbatches.shape[0]
    _record_schedule_metrics("zbvpp", compiled_zbvpp_schedule, n, m)
    return _pipeline_train(compiled_zbvpp_schedule(n, m), stage_fn,
                           stage_params, x_microbatches,
                           last_stage_grad, head_params, group, grad_dtype,
                           True, graph_stage_fn)
