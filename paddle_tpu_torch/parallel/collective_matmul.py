"""Collective matmul: the port of ``paddle_tpu/parallel/collective_matmul.py``
(reference: Megatron-SP's overlap of the sequence-parallel all-gather with
the GEMM that follows it, fleet/utils/sequence_parallel_utils.py:255, and
of the row-parallel GEMM with its reduce-scatter).

The gathered GEMM is split into one block a rank: ``n - 1`` steps of one
block matmul and one ring shift (``batch_isend_irecv`` to the next rank,
from the previous one, posted before the block's matmul and waited after
it, so the transfer overlaps the product), then the last block. The
reduce-scatter form passes a partial-sum tile around the ring, each rank
adding its block for the tile's destination, so only one output block is
ever held. Both are autograd Functions whose gradients are the transposed
rings: an all-gather-matmul's dx is a matmul-reduce-scatter of the output
gradient by w^T, and the other way round; dw is the gathered operand's
product with the output gradient.

``axis_name`` is a ``ProcessMesh`` axis of the current mesh or a Group.
The reference's ``_widen_vma``/``_zeros_like_vma`` are jax typing and have
no counterpart here.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed import collective as C


def _fwd_perm(n):
    return [(i, (i + 1) % n) for i in range(n)]


def _post_shift(x, group):
    """Posts the send of ``x`` to the next rank of the ring and the receive
    of the previous rank's into a new buffer, sends first on every rank.
    Returns (the buffer, a function that waits and returns it)."""
    C._collective_log("ppermute", x, group)
    n, me = group.nranks, group.rank
    pg = C._pg(group)
    a, staged = C._host_route("ppermute", pg, x.contiguous())
    buf = torch.empty_like(a)
    pgroup = None if pg is dist.group.WORLD else pg
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, a, group.ranks[(me + 1) % n], group=pgroup),
        dist.P2POp(dist.irecv, buf, group.ranks[(me - 1) % n],
                   group=pgroup)])

    def wait():
        for w in works:
            w.wait()
        return buf.to(x.device) if staged else buf
    return wait


def _ag_matmul(x, w, group, keep=False):
    """all_gather(x, dim 0) @ w over the ring; with ``keep`` also the
    gathered x."""
    n, idx = group.nranks, group.rank
    s = x.shape[0]
    out = x.new_empty((n * s,) + tuple(x.shape[1:-1]) + (w.shape[-1],),
                      dtype=torch.promote_types(x.dtype, w.dtype))
    full = x.new_empty((n * s,) + tuple(x.shape[1:])) if keep else None
    cur = x
    for i in range(n):
        src = (idx - i) % n            # the rank the resident block left
        wait = _post_shift(cur, group) if i < n - 1 else None
        torch.matmul(cur, w, out=out[src * s:(src + 1) * s])
        if keep:
            full[src * s:(src + 1) * s] = cur
        if wait is not None:
            cur = wait()
    return out, full


def _matmul_rs(x, w, group, keep_from=None):
    """reduce_scatter(x @ w, dim 0) over the ring: x [m, ..., k_shard] and
    w [k_shard, f] are this rank's; returns rank r's rows
    [r m / n, (r + 1) m / n) of the sum over ranks."""
    n, idx = group.nranks, group.rank
    m = x.shape[0]
    if m % n:
        raise ValueError(f"rows {m} not divisible by axis size {n}")
    s = m // n

    def block(dest):
        return torch.matmul(x[dest * s:(dest + 1) * s], w)
    # the tile made first is bound for rank idx + n - 1; each shift hands
    # it one rank on, where the next block is added
    acc = block((idx + n - 1) % n)
    for i in range(1, n):
        wait = _post_shift(acc, group)
        blk = block((idx + n - 1 - i) % n)
        acc = wait() + blk
    return acc


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group):
        out, full = _ag_matmul(x, w, group, keep=True)
        ctx.save_for_backward(full, w)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, g):
        full, w = ctx.saved_tensors
        g = g.contiguous()
        dx = _matmul_rs(g, w.t(), ctx.group)
        k, f = w.shape
        dw = torch.matmul(full.reshape(-1, k).t(), g.reshape(-1, f))
        return dx, dw.to(w.dtype), None


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return _matmul_rs(x, w, group)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, g_full = _ag_matmul(g.contiguous(), w.t(), ctx.group, keep=True)
        k, f = w.shape
        dw = torch.matmul(x.reshape(-1, k).t(), g_full.reshape(-1, f))
        return dx, dw.to(w.dtype), None


def all_gather_matmul(x, w, axis_name):
    """all_gather(x, axis) @ w without materialising the gather first:
    x [s, ..., k] is this rank's block of the first dim of [n s, ..., k];
    w [k, f] is resident. Returns [n s, ..., f]."""
    return _AllGatherMatmul.apply(x, w, C._axis_group(axis_name))


def matmul_reduce_scatter(x, w, axis_name):
    """reduce_scatter(x @ w, axis) along the first dim: x [m, ..., k_shard],
    w [k_shard, f] this rank's k-shards; returns [m / n, ..., f], this
    rank's rows of the sum over ranks."""
    return _MatmulReduceScatter.apply(x, w, C._axis_group(axis_name))


def sp_column_matmul_local(x_local, w_local, axis_name):
    """allgather(x, seq) @ W on one rank: x_local [B, S / n, K] (its
    sequence slice), w_local [K, F / n] (its columns) -> [B, S, F / n]."""
    xt = x_local.transpose(0, 1).contiguous()          # [S/n, B, K]
    return all_gather_matmul(xt, w_local, axis_name).transpose(0, 1)


def sp_row_matmul_local(x_local, w_local, axis_name):
    """reduce_scatter(x @ W, seq) on one rank: x_local [B, S, K / n] (its
    features), w_local [K / n, F] (its rows) -> [B, S / n, F]."""
    xt = x_local.transpose(0, 1).contiguous()          # [S, B, K/n]
    return matmul_reduce_scatter(xt, w_local, axis_name).transpose(0, 1)


def _mesh_group(mesh, axis_name):
    return mesh.get_group(axis_name) if mesh is not None \
        else C._axis_group(axis_name)


def sp_column_matmul(x, w, mesh, axis_name="mp"):
    """The global form: x [B, S, K] and w [K, F] whole on every rank; this
    rank computes with its sequence slice of x and its columns of w, and
    the result [B, S, F] is gathered whole on every rank."""
    g = _mesh_group(mesh, axis_name)
    out = sp_column_matmul_local(C._Split.apply(x, g, 1),
                                 C._Split.apply(w, g, 1), g)
    return C._GatherInvariant.apply(out, g, 2)


def sp_row_matmul(x, w, mesh, axis_name="mp"):
    """The global form: x [B, S, K] and w [K, F] whole on every rank; this
    rank computes with its K-slices, and the result [B, S, F] is gathered
    whole on every rank."""
    g = _mesh_group(mesh, axis_name)
    out = sp_row_matmul_local(C._Split.apply(x, g, 2),
                              C._Split.apply(w, g, 0), g)
    return C._GatherInvariant.apply(out, g, 1)
