"""paddle.distributed.utils: the MoE exchange ops, the port of
``paddle_tpu/distributed/utils.py`` (reference:
distributed/utils/moe_utils.py global_scatter/global_gather over an NCCL
all-to-all).

The reference's multi-rank semantics, with ``n`` ranks of ``E`` experts each
and ``local_count``/``global_count`` of length ``n * E`` (entry ``j * E + i``
is expert ``i`` of rank ``j``):

- ``global_scatter(x, local_count, global_count)``: ``x``'s rows are in
  blocks by global expert (``local_count[j * E + i]`` rows for expert ``i``
  of rank ``j``, in that order); the block of rank ``j`` goes there, and this
  rank receives ``global_count[j * E + i]`` rows from rank ``j`` for its
  expert ``i``. The rows received are laid out expert-major: for each local
  expert ``i``, the rows from rank 0, then rank 1, ...
- ``global_gather`` is its inverse: rows in that expert-major layout go back
  to the ranks they came from, which receive them in their original order.

Both are one ``all_to_all_single`` and a permutation of the rows, and both
are differentiable: each one's backward is the other over the same counts
(the exchange is a permutation, so its adjoint is its inverse). Under gloo a
CUDA tensor goes through a host copy (``collective.HOST_STAGED``).

Without a process group, at world 1, the exchange sends every rank's rows to
itself: the output is ``x``'s first ``sum(local_count)`` rows, ``x`` itself
when the counts cover its rows. That is the reference's value there (its
eager form sorts the rows by expert id, which the row blocks already are in,
so it is the identity on ``x``).
"""
from __future__ import annotations

import torch

from ..core.dispatch import run_op

__all__ = ["global_scatter", "global_gather"]


def _counts(c):
    """A count tensor (or sequence) as a list of python ints."""
    if hasattr(c, "_data"):
        c = c._data
    if isinstance(c, torch.Tensor):
        return [int(v) for v in c.reshape(-1).tolist()]
    return [int(v) for v in c]


def _layout(local_count, global_count, nranks):
    """(rows sent to each rank, rows received from each rank, experts a
    rank) for one exchange."""
    if len(local_count) != len(global_count) or len(local_count) % nranks:
        raise ValueError(
            f"local_count ({len(local_count)}) and global_count "
            f"({len(global_count)}) need n_expert * world_size = "
            f"n_expert * {nranks} entries each")
    ne = len(local_count) // nranks
    send = [sum(local_count[j * ne:(j + 1) * ne]) for j in range(nranks)]
    recv = [sum(global_count[j * ne:(j + 1) * ne]) for j in range(nranks)]
    return send, recv, ne


def _exchange_rows(x, send, recv, group):
    """One all_to_all_single of ``x``'s rows: ``send[j]`` rows to rank j,
    ``recv[j]`` rows from it (group-rank order)."""
    from . import collective as C
    pg = C._pg(group)
    x = x.contiguous()
    if pg is C._LOCAL:
        return x[:send[0]].clone()
    C._collective_log("alltoall", x, group)
    a, staged = C._host_route("alltoall", pg, x)
    out = a.new_empty((sum(recv),) + tuple(a.shape[1:]))
    C._alltoall(out, a, pg, recv, send)
    return out.to(x.device) if staged else out


def _to_expert_major(rows, global_count, nranks, ne):
    """Blocks received rank-major ((rank j, expert i) for j, then i) to
    expert-major (i, then j)."""
    blocks = list(torch.split(rows, global_count))
    return torch.cat([blocks[j * ne + i] for i in range(ne)
                      for j in range(nranks)]) if blocks else rows


def _to_rank_major(rows, global_count, nranks, ne):
    """The inverse of ``_to_expert_major``."""
    sizes = [global_count[j * ne + i] for i in range(ne)
             for j in range(nranks)]
    blocks = list(torch.split(rows, sizes))
    by = {(i, j): blocks[i * nranks + j] for i in range(ne)
          for j in range(nranks)}
    return torch.cat([by[(i, j)] for j in range(nranks)
                      for i in range(ne)]) if blocks else rows


def _nranks(group):
    from . import collective as C
    return C._nranks(C._pg(group))


def _scatter(x, lc, gc, group):
    n = _nranks(group)
    send, recv, ne = _layout(lc, gc, n)
    if sum(send) > x.shape[0]:
        raise ValueError(f"local_count sends {sum(send)} rows of "
                         f"{x.shape[0]}")
    got = _exchange_rows(x[:sum(send)], send, recv, group)
    return _to_expert_major(got, gc, n, ne)


def _gather(x, lc, gc, group):
    n = _nranks(group)
    send, recv, ne = _layout(lc, gc, n)
    if sum(recv) > x.shape[0]:
        raise ValueError(f"global_count returns {sum(recv)} rows of "
                         f"{x.shape[0]}")
    rows = _to_rank_major(x[:sum(recv)], gc, n, ne)
    return _exchange_rows(rows, recv, send, group)


class _GlobalScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lc, gc, group):
        ctx.args, ctx.rows = (lc, gc, group), x.shape[0]
        return _scatter(x.detach(), lc, gc, group)

    @staticmethod
    def backward(ctx, g):
        back = _gather(g, *ctx.args)
        if back.shape[0] < ctx.rows:      # rows that were never sent
            back = torch.cat([back, back.new_zeros(
                (ctx.rows - back.shape[0],) + tuple(back.shape[1:]))])
        return back, None, None, None


class _GlobalGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lc, gc, group):
        ctx.args, ctx.rows = (lc, gc, group), x.shape[0]
        return _gather(x.detach(), lc, gc, group)

    @staticmethod
    def backward(ctx, g):
        back = _scatter(g, *ctx.args)
        if back.shape[0] < ctx.rows:
            back = torch.cat([back, back.new_zeros(
                (ctx.rows - back.shape[0],) + tuple(back.shape[1:]))])
        return back, None, None, None


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream=True):
    """Sends ``x``'s rows to the experts of every rank and receives this
    rank's experts' rows, expert-major (reference moe_utils.py
    global_scatter; see the module docstring). ``group`` is a Group (the
    job's by default)."""
    lc, gc = _counts(local_count), _counts(global_count)
    return run_op("global_scatter",
                  lambda a: _GlobalScatter.apply(a, lc, gc, group), x)


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream=True):
    """The inverse of ``global_scatter`` over the same counts (reference
    moe_utils.py global_gather)."""
    lc, gc = _counts(local_count), _counts(global_count)
    return run_op("global_gather",
                  lambda a: _GlobalGather.apply(a, lc, gc, group), x)
