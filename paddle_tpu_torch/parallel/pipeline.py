"""GPipe over a pp group: the port of ``paddle_tpu/parallel/pipeline.py``.

The reference stacks the stages' weights on a leading axis sharded over
"pp" and rotates the microbatches through them with ``lax.ppermute`` in one
``lax.scan``; ``jax.grad`` of that forward is the pipelined backward. Here
each rank of the pp group holds its stage and walks the same ticks: at tick
t stage s runs microbatch t - s, when there is one, on the activation that
just hopped in from stage s - 1. A tick with no microbatch on a stage is
not run, and a hop carries only the pairs (s, s + 1) whose sender ran the
tick before: the reference's masked cells and its ring's wrap hop
(n - 1 -> 0), which stage 0 discards, cost nothing here. The backward
(``_GPipe.backward``) walks the ticks in reverse: each cell
back-propagates through the graph its forward kept, and the cotangents hop
back over the same pairs.
"""
from __future__ import annotations

from typing import Callable

import torch


def stack_stage_params(params_per_stage):
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage dim
    (the reference's layout; a rank keeps its stage's entry)."""
    first = params_per_stage[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([t[k] for t in params_per_stage])
                for k in first}
    return torch.stack(list(params_per_stage), 0)


def _hop(t, n, m):
    """The pairs of the hop into tick t: stage i sends what it ran at tick
    t - 1 to stage i + 1."""
    return [(i, i + 1) for i in range(n - 1) if 0 <= t - 1 - i < m]


class _GPipe(torch.autograd.Function):
    """pipeline_apply's ticks on this rank; ``keep``: each cell keeps its
    graph (input, output) for the backward."""

    @staticmethod
    def forward(ctx, stage_fn, like, group, keep, x, *leaves):
        from ..distributed import collective as C
        from .pipeline_1f1b import _tree_unflatten
        n, s, m = group.nranks, group.rank, x.shape[0]
        ps = [p.detach().requires_grad_(keep and p.requires_grad)
              for p in leaves]
        params = _tree_unflatten(like, ps)
        cells, outs = [], []
        carry = torch.zeros_like(x[0])
        with torch.set_grad_enabled(keep):
            for t in range(m + n - 1):
                perm = _hop(t, n, m)
                if any(s in pair for pair in perm):
                    carry = C._permute(carry.detach(), group, perm)
                if 0 <= t - s < m:
                    h = (x[t] if s == 0 else carry).detach() \
                        .requires_grad_(keep)
                    carry = stage_fn(params, h)
                    if keep:
                        cells.append((h, carry))
                    if s == n - 1:
                        outs.append(carry.detach())
        ctx.group, ctx.cells, ctx.ps, ctx.m = group, cells, ps, m
        mine = torch.stack(outs) if s == n - 1 else \
            torch.zeros((m,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
        # every rank gets the last stage's outputs (the reference's psum)
        return mine if n == 1 else C._sum_over(mine, group)

    @staticmethod
    def backward(ctx, g):
        from ..distributed import collective as C
        group, cells, ps, m = ctx.group, ctx.cells, ctx.ps, ctx.m
        n, s = group.nranks, group.rank
        want = [p.requires_grad for p in ps]
        gps = [torch.zeros_like(p) if w else None for p, w in zip(ps, want)]
        gx = torch.zeros_like(g) if ctx.needs_input_grad[4] else None
        cot = torch.zeros_like(g[0])
        for t in reversed(range(m + n - 1)):
            if 0 <= t - s < m:
                h, y = cells.pop()
                gy = g[t - s] if s == n - 1 else cot
                grads = torch.autograd.grad(
                    y, [h] + [p for p, w in zip(ps, want) if w],
                    gy.to(y.dtype), allow_unused=True)
                cot = grads[0]
                for acc, d in zip((a for a in gps if a is not None),
                                  grads[1:]):
                    if d is not None:
                        acc.add_(d)
                if s == 0 and gx is not None:
                    gx[t] = cot
            perm = _hop(t, n, m)
            if any(s in pair for pair in perm):
                cot = C._permute(cot.detach(), group,
                                 [(j, i) for i, j in perm])
        return (None, None, None, None, gx, *gps)


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches,
                   group=None):
    """Runs a GPipe pipeline over the pp ``group`` (a rank a stage).

    ``stage_fn(params, x) -> y`` is the stage, the same signature on every
    rank, ``y`` shaped like ``x``; ``stage_params`` this rank's stage
    parameters; ``x_microbatches`` [M, ...] the microbatched input (the
    same on every rank; stage 0 reads it, and the others' gradients of it
    are zeros, as the reference's). Returns [M, ...]: the LAST stage's
    outputs, on every rank (summed over the group from the last stage's,
    zeros elsewhere). Differentiable: the backward runs the hops in
    reverse; every rank of the group must call it, as every rank of the
    reference's program does."""
    from ..distributed.env import Group
    from .pipeline_1f1b import _tree_leaves
    group = group or Group(0, [0])
    leaves = _tree_leaves(stage_params)
    keep = torch.is_grad_enabled() and (
        x_microbatches.requires_grad or any(p.requires_grad for p in leaves))
    return _GPipe.apply(stage_fn, stage_params, group, keep, x_microbatches,
                        *leaves)


def pipeline_microbatch(x, num_microbatches: int):
    """[B, ...] -> [M, B // M, ...]"""
    b = x.shape[0]
    if b % num_microbatches != 0:
        raise ValueError(
            f"batch {b} not divisible by microbatches {num_microbatches}")
    return x.reshape((num_microbatches, b // num_microbatches)
                     + tuple(x.shape[1:]))
