"""Collectives: the port of ``paddle_tpu/distributed/collective.py``
(reference: the ProcessGroup collective surface,
phi/core/distributed/collective/process_group.h:48, and
python/paddle/distributed/communication/*).

Each rank holds its own tensor and the eager collectives reduce, gather and
scatter across the ranks' values over ``torch.distributed`` (NCCL on the
card, gloo on the CPU). ``src``/``dst`` are global ranks, as in the
reference. ``sync_op=False`` returns a ``_Task`` whose ``wait()`` waits for
the collective; ``sync_op=True`` waits before returning. At world 1 before
``init_parallel_env`` every collective is the identity (the reference's
value at world 1).

Gloo has no AVG: there it is a SUM divided by the group's size.

The reference's in-graph ``ops`` (lax collectives keyed by a mesh axis name)
are functions of torch tensors here, keyed by the group that a mesh axis of
the current ``ProcessMesh`` names; they return new tensors and are
differentiable, with lax's transposes as their gradients (the tensor- and
sequence-parallel layers build on them). Under gloo, collectives of CUDA
tensors other than the all-reduce and the broadcast run on a host copy,
counted in ``HOST_STAGED``.
"""
from __future__ import annotations

import collections
import sys
from typing import List, Optional

import torch
import torch.distributed as dist

from ..core.tensor import Tensor
from ..observability import metrics as _met
from .env import Group, get_rank, get_world_size, is_initialized


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
             "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT,
             "avg": dist.ReduceOp.AVG}


class _Task:
    """A collective's handle (ProcessGroup::Task): ``wait()`` waits for
    torch's ``Work`` (on the card: makes the current stream wait) and then
    runs what completes the op (an AVG's division over gloo, the copy of a
    gathered list into Tensors)."""

    def __init__(self, work=None, then=None):
        self._work = work
        self._then = then

    def wait(self, timeout=None):
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._then is not None:
            then, self._then = self._then, None
            then()
        return True

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def _finish(work, then, sync_op):
    task = _Task(work, then)
    if sync_op:
        task.wait()
    return task


# ---------------------------------------------------------------------------
# collective deferral (DataParallel.no_sync / gradient accumulation)
# ---------------------------------------------------------------------------
# While a deferral context is open, framework-fired gradient-sync
# collectives (the DataParallel reducer's buckets, the sharding stages'
# gradient reductions, fused_allreduce_gradients) are RECORDED instead of
# executed, deduped by key, and replayed once on context exit against the
# then-current (accumulated) gradients — the reference no_sync contract.
_defer_stack: list = []


class _DeferredCalls:
    def __init__(self):
        self.calls = {}            # key -> fn (last registration wins)
        self.skipped = 0

    def add(self, key, fn):
        if key in self.calls:
            self.skipped += 1
        self.calls[key] = fn

    def flush(self):
        for fn in self.calls.values():
            fn()
        self.calls.clear()


def deferral_active():
    return bool(_defer_stack)


def defer_or_run(key, fn):
    """Run fn now, unless a deferral context is open — then record it
    (deduped by key; replayed once at context exit)."""
    if _defer_stack:
        _defer_stack[-1].add(key, fn)
        return None
    return fn()


class defer_collectives:
    """Context manager deferring grad-sync collectives until exit."""

    def __enter__(self):
        _defer_stack.append(_DeferredCalls())
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = _defer_stack.pop()
        if exc_type is None:
            rec.flush()
        return False


def _collective_log(op, tensor, group, n_tensors=1):
    if _met._ENABLED:
        _met.REGISTRY.counter("collective.calls", op=op).inc()
        a = _arr(tensor) if tensor is not None else None
        if isinstance(a, torch.Tensor):
            _met.REGISTRY.counter("collective.bytes", op=op).inc(
                a.numel() * a.element_size() * n_tensors)
    from ..core.flags import get_flag
    if get_flag("FLAGS_collective_debug"):
        shape = list(tensor.shape) if hasattr(tensor, "shape") else "?"
        gid = getattr(group, "id", "world") if group is not None \
            else "world"
        print(f"[collective] {op} group={gid} shape={shape}",
              file=sys.stderr)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
_LOCAL = object()        # world 1 before init_parallel_env: the identity


def _pg(group: Optional[Group]):
    """torch's process group of ``group``, or ``_LOCAL`` for world 1 before
    ``init_parallel_env`` and for a one-rank group without a torch group. A
    group this process is not in raises."""
    if group is None:
        if is_initialized():
            return dist.group.WORLD
        if get_world_size() != 1:
            raise RuntimeError("collectives over a world of "
                               f"{get_world_size()} need init_parallel_env()")
        return _LOCAL
    if group.process_group is None:
        # world 1 before init_parallel_env, or a group of this rank alone
        # made without a torch group (its collectives are the identity)
        if group.nranks == 1 and group.rank == 0:
            return _LOCAL
        raise ValueError(f"this process (rank {get_rank()}) is not a member "
                         f"of {group}")
    return group.process_group


def _arr(t):
    return t._data if isinstance(t, Tensor) else t


def _buf(t):
    """The storage a collective writes into: the tensor's own array,
    detached from autograd (the Tensor sees the write)."""
    a = _arr(t)
    if isinstance(t, Tensor):
        t._version += 1
    return a.detach()


def _nranks(pg):
    return 1 if pg is _LOCAL else dist.get_world_size(pg)


def _gloo(pg):
    return pg is not _LOCAL and dist.get_backend(pg) == "gloo"


def _torch_op(op, pg):
    """(torch's op, the divisor to apply afterwards): AVG over gloo is a
    SUM divided by the group size."""
    op = getattr(op, "value", op)
    op = str(op).lower().split(".")[-1]
    op = {"product": "prod"}.get(op, op)
    if op not in _TORCH_OP:
        raise ValueError(f"unknown reduce op {op!r}")
    if op == "avg" and _gloo(pg):
        return dist.ReduceOp.SUM, _nranks(pg)
    return _TORCH_OP[op], 1


def _divide(buf, n):
    if n == 1:
        return None

    def then():
        if buf.is_floating_point() or buf.is_complex():
            buf.div_(n)
        else:
            buf.floor_divide_(n)
    return then


def _wrap_like(t, arr):
    return Tensor._wrap(arr) if isinstance(t, Tensor) or t is None else arr


# ---------------------------------------------------------------------------
# eager collectives
# ---------------------------------------------------------------------------
def all_reduce(tensor, op=ReduceOp.SUM, group: Optional[Group] = None,
               sync_op=True):
    _collective_log("all_reduce", tensor, group)
    if deferral_active():
        # deduped by tensor identity: callers syncing a tensor that is
        # REPLACED each microbatch (param grads) defer at their own level,
        # keyed by the stable owner (the reducer, the sharding stages and
        # fused_allreduce_gradients do)
        _defer_stack[-1].add(("all_reduce", id(tensor), id(group)),
                             lambda: all_reduce(tensor, op, group, True))
        return _Task()
    pg = _pg(group)
    if pg is _LOCAL:
        return _Task()
    buf = _buf(tensor)
    top, div = _torch_op(op, pg)
    work = dist.all_reduce(buf, op=top, group=pg, async_op=True)
    return _finish(work, _divide(buf, div), sync_op)


def all_gather(tensor_list: List, tensor, group: Optional[Group] = None,
               sync_op=True):
    """Fill ``tensor_list`` with every rank's ``tensor``, in rank order."""
    _collective_log("all_gather", tensor, group)
    pg = _pg(group)
    a = _arr(tensor).detach()
    n = _nranks(pg)
    outs = [torch.empty_like(a) for _ in range(n)]
    if pg is _LOCAL:
        outs[0].copy_(a)
        work = None
    else:
        work = dist.all_gather(outs, a.contiguous(), group=pg,
                               async_op=True)

    def then():
        tensor_list.clear()
        tensor_list.extend(_wrap_like(tensor, o) for o in outs)
    return _finish(work, then, sync_op)


def all_gather_object(object_list, obj, group=None):
    pg = _pg(group)
    n = _nranks(pg)
    out = [None] * n
    if pg is _LOCAL:
        out[0] = obj
    else:
        dist.all_gather_object(out, obj, group=pg)
    object_list.clear()
    object_list.extend(out)


def broadcast(tensor, src=0, group=None, sync_op=True):
    _collective_log("broadcast", tensor, group)
    pg = _pg(group)
    if pg is _LOCAL:
        return _Task()
    work = dist.broadcast(_buf(tensor), src=int(src), group=pg,
                          async_op=True)
    return _finish(work, None, sync_op)


def broadcast_object_list(object_list, src=0, group=None):
    pg = _pg(group)
    if pg is not _LOCAL:
        dist.broadcast_object_list(object_list, src=int(src),
                                   group=pg)
    return object_list


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    _collective_log("reduce", tensor, group)
    if deferral_active():
        _defer_stack[-1].add(("reduce", id(tensor), id(group)),
                             lambda: reduce(tensor, dst, op, group, True))
        return _Task()
    pg = _pg(group)
    if pg is _LOCAL:
        return _Task()
    buf = _buf(tensor)
    top, div = _torch_op(op, pg)
    work = dist.reduce(buf, dst=int(dst), op=top, group=pg,
                       async_op=True)
    me = get_rank()
    then = _divide(buf, div) if me == int(dst) else None
    return _finish(work, then, sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """``tensor`` receives the entry of ``tensor_list`` (given on ``src``)
    at this rank's place in the group."""
    _collective_log("scatter", tensor, group)
    pg = _pg(group)
    buf = _buf(tensor)
    if pg is _LOCAL:
        if tensor_list:
            buf.copy_(_arr(tensor_list[0]))
        return _Task()
    src = int(src)
    parts = [_arr(t).detach().contiguous() for t in tensor_list] \
        if get_rank() == src else None
    work = dist.scatter(buf, parts, src=src, group=pg, async_op=True)
    return _finish(work, None, sync_op)


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """``tensor`` receives the reduction over the ranks of their
    ``tensor_list`` entries at this rank's place in the group."""
    _collective_log("reduce_scatter", tensor, group)
    if deferral_active():
        _defer_stack[-1].add(("reduce_scatter", id(tensor), id(group)),
                             lambda: reduce_scatter(tensor, tensor_list,
                                                    op, group, True))
        return _Task()
    pg = _pg(group)
    buf = _buf(tensor)
    if pg is _LOCAL:
        buf.copy_(_arr(tensor_list[0]))
        return _Task()
    top, div = _torch_op(op, pg)
    parts = [_arr(t).detach().contiguous() for t in tensor_list]
    work = dist.reduce_scatter(buf, parts, op=top, group=pg, async_op=True)
    return _finish(work, _divide(buf, div), sync_op)


def alltoall(in_tensor_list, out_tensor_list, group=None, sync_op=True):
    """Rank r's ``in_tensor_list[j]`` lands in rank j's
    ``out_tensor_list[r]``."""
    _collective_log("alltoall", in_tensor_list[0] if in_tensor_list
                    else None, group, n_tensors=len(in_tensor_list))
    pg = _pg(group)
    ins = [_arr(t).detach().contiguous() for t in in_tensor_list]
    outs = [torch.empty_like(a) for a in ins]
    if pg is _LOCAL:
        outs = [a.clone() for a in ins]
        work = None
    else:
        work = dist.all_to_all(outs, ins, group=pg, async_op=True)
    like = in_tensor_list[0] if in_tensor_list else None

    def then():
        out_tensor_list.clear()
        out_tensor_list.extend(_wrap_like(like, o) for o in outs)
    return _finish(work, then, sync_op)


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    _collective_log("alltoall_single", in_tensor, group)
    pg = _pg(group)
    src = _arr(in_tensor).detach().contiguous()
    if out_tensor is None:
        out_tensor = Tensor._wrap(torch.empty_like(src))
    buf = _buf(out_tensor)
    if pg is _LOCAL:
        buf.copy_(src)
        return _Task()
    work = dist.all_to_all_single(buf, src, out_split_sizes, in_split_sizes,
                                  group=pg, async_op=True)
    return _finish(work, None, sync_op)


def send(tensor, dst=0, group=None, sync_op=True):
    _collective_log("send", tensor, group)
    pg = _pg(group)
    if pg is _LOCAL:
        raise ValueError("send at world 1 has no peer")
    a, _ = _host_route("send", pg, _arr(tensor).detach().contiguous())
    work = dist.isend(a, dst=int(dst), group=pg)
    return _finish(work, None, sync_op)


def _recv_into(tensor, op, pg):
    """(the buffer to hand the backend, what copies it into ``tensor``
    once the receive completed: the host route's copy back, or None)."""
    buf = _buf(tensor)
    a, staged = _host_route(op, pg, buf)
    if not staged:
        return a, None
    return a, lambda: buf.copy_(a)


def recv(tensor, src=0, group=None, sync_op=True):
    _collective_log("recv", tensor, group)
    pg = _pg(group)
    if pg is _LOCAL:
        raise ValueError("recv at world 1 has no peer")
    a, then = _recv_into(tensor, "recv", pg)
    work = dist.irecv(a, src=int(src), group=pg)
    return _finish(work, then, sync_op)


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """One send or receive of ``batch_isend_irecv``: ``op`` is ``isend`` or
    ``irecv`` (this module's or torch's); ``tag`` tells apart two messages
    between the same pair of ranks (gloo matches on it; NCCL matches in
    order)."""

    def __init__(self, op, tensor, peer, group=None, tag=0):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group
        self.tag = tag


def batch_isend_irecv(p2p_op_list):
    """Posts every send and receive of the list and returns one task each.
    Under gloo, CUDA tensors go through a host copy (``HOST_STAGED``
    "send"/"recv"); a receive's task copies it back in ``wait()``."""
    ops, thens = [], []
    for p in p2p_op_list:
        name = getattr(p.op, "__name__", "")
        sending = name in ("isend", "send")
        pg = _pg(p.group)
        if sending:
            _collective_log("send", p.tensor, p.group)
            a, _ = _host_route("send", pg, _arr(p.tensor).detach()
                               .contiguous())
            then = None
        else:
            _collective_log("recv", p.tensor, p.group)
            a, then = _recv_into(p.tensor, "recv", pg)
        ops.append(dist.P2POp(dist.isend if sending else dist.irecv, a,
                              int(p.peer),
                              group=None if pg is dist.group.WORLD else pg,
                              tag=int(getattr(p, "tag", 0))))
        thens.append(then)
    works = dist.batch_isend_irecv(ops) if ops else []
    return [_Task(w, t) for w, t in zip(works, thens)]


#: the pipeline's hops: calls, bytes sent and received, and the host
#: clock around them (``p2p_exchange`` and ``ppermute``), by this process
P2P_STATS = collections.Counter()
#: the all-to-alls over a group of ranks (the MoE exchanges: ``ops.
#: all_to_all`` and ``utils.global_scatter``/``global_gather``): calls, bytes
#: sent, and the host clock around them, by this process
ALLTOALL_STATS = collections.Counter()


def _alltoall(out, a, group_pg, out_splits=None, in_splits=None):
    """``all_to_all_single`` of ``a`` into ``out``, counted in
    ``ALLTOALL_STATS``."""
    import time
    t0 = time.perf_counter()
    dist.all_to_all_single(out, a, out_splits, in_splits, group=group_pg)
    ALLTOALL_STATS["calls"] += 1
    ALLTOALL_STATS["bytes"] += a.numel() * a.element_size()
    ALLTOALL_STATS["seconds"] += time.perf_counter() - t0


def p2p_exchange(sends, recvs, group):
    """One pipeline hop between the ranks of ``group`` (the pp group):
    ``sends`` is [(tensor, group rank, tag)], ``recvs`` [(shape, dtype,
    device, group rank, tag)]. Posts every receive and send at once, waits
    for all of them and returns the received tensors in ``recvs``' order.
    Both sides of a pair must post the same messages: each side lists them
    in the same (tag) order, which NCCL matches in order and gloo by tag.
    """
    import time
    t0 = time.perf_counter()
    ops, outs = [], []
    for shape, dtype, device, peer, tag in recvs:
        buf = torch.empty(shape, dtype=dtype, device=device)
        outs.append(buf)
        ops.append(P2POp(irecv, buf, group.ranks[peer], group, tag))
        P2P_STATS["recv_bytes"] += buf.numel() * buf.element_size()
    for t, peer, tag in sends:
        ops.append(P2POp(isend, t, group.ranks[peer], group, tag))
        P2P_STATS["send_bytes"] += t.numel() * t.element_size()
    for task in batch_isend_irecv(ops):
        task.wait()
    P2P_STATS["calls"] += 1
    P2P_STATS["seconds"] += time.perf_counter() - t0
    return outs


def wait(tensor, group=None, use_calc_stream=True):
    a = _arr(tensor)
    if a.is_cuda:
        torch.cuda.current_stream(a.device).synchronize()
    return tensor


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """On ``dst``, ``gather_list`` receives every rank's ``tensor`` in rank
    order (reference communication/gather.py)."""
    _collective_log("gather", tensor, group)
    pg = _pg(group)
    a = _arr(tensor).detach().contiguous()
    n = _nranks(pg)
    me_dst = pg is _LOCAL or get_rank() == int(dst)
    outs = [torch.empty_like(a) for _ in range(n)] if me_dst else None
    if pg is _LOCAL:
        outs[0].copy_(a)
        work = None
    else:
        work = dist.gather(a, outs, dst=int(dst), group=pg,
                           async_op=True)

    def then():
        if gather_list is not None and me_dst:
            gather_list.clear()
            gather_list.extend(_wrap_like(tensor, o) for o in outs)
    return _finish(work, then, sync_op)


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    pg = _pg(group)
    if pg is _LOCAL:
        out_object_list.clear()
        out_object_list.append(in_object_list[0])
        return None
    out = [None]
    dist.scatter_object_list(out, in_object_list if get_rank() == int(src)
                             else None, src=int(src), group=pg)
    out_object_list.clear()
    out_object_list.append(out[0])
    return None


# ---------------------------------------------------------------------------
# differentiable collectives over a group (the reference's in-graph ops)
# ---------------------------------------------------------------------------
# Each rank holds its own tensor. The autograd Functions below carry lax's
# transposes, so that a rank's gradient is its part of the gradient of the
# one global function the reference computes: psum's backward is the
# identity (lax's pbroadcast), pvary is the identity with a psum backward
# (Megatron's f at a column-parallel input), all_gather <-> psum_scatter,
# all_to_all <-> the reverse all_to_all, ppermute <-> the inverse
# permutation. _GatherInvariant (all_gather with a slice backward, lax's
# all_gather_invariant) and _Split (a slice with an all_gather backward)
# move a tensor between sharded and replicated, whose gradient is the same
# on every rank.

#: collectives of CUDA tensors run on a host copy, by op. Under gloo the
#: port hands CUDA tensors only to the all-reduce and the broadcast (the
#: ops DataParallel over gloo runs on the card); its other collectives of
#: CUDA tensors go through the host (``_host_route``). NCCL never takes
#: this route.
HOST_STAGED = collections.Counter()
_GLOO_TAKES_CUDA = ("all_reduce", "broadcast")


def _host_route(op, pg, a):
    """(the tensor to hand the backend, whether it is a host copy)."""
    if a.is_cuda and _gloo(pg) and op not in _GLOO_TAKES_CUDA:
        HOST_STAGED[op] += 1
        if _met._ENABLED:
            _met.REGISTRY.counter("collective.host_staged", op=op).inc()
        return a.cpu(), True
    return a, False


def _sum_over(x, group, op=ReduceOp.SUM):
    """The reduction of every rank's ``x`` over ``group``, out of place."""
    _collective_log("all_reduce", x, group)
    pg = _pg(group)
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if pg is not _LOCAL:
        top, div = _torch_op(op, pg)
        dist.all_reduce(out, op=top, group=pg)
        then = _divide(out, div)
        if then is not None:
            then()
    return out


def _gather_along(x, group, dim):
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order."""
    _collective_log("all_gather", x, group)
    pg = _pg(group)
    if pg is _LOCAL:
        return x.detach().clone()
    n = _nranks(pg)
    a, staged = _host_route("all_gather", pg, x.detach().contiguous())
    a = a.reshape((-1,) + tuple(a.shape[1:]))
    buf = a.new_empty((n * a.shape[0],) + tuple(a.shape[1:]))
    _ALL_GATHER(buf, a, group=pg)
    out = torch.cat(buf.view((n,) + tuple(x.shape)).unbind(0), dim)
    return out.to(x.device) if staged else out


def _chunks(x, n, dim, what):
    if x.shape[dim] % n:
        raise ValueError(f"{what}: dim {dim} of size {x.shape[dim]} is not "
                         f"divisible by the group's {n} ranks")
    return x.chunk(n, dim)


def _scatter_sum(x, group, dim):
    """This rank's chunk along ``dim`` of the sum of every rank's ``x``
    (lax.psum_scatter, tiled)."""
    _collective_log("reduce_scatter", x, group)
    pg = _pg(group)
    if pg is _LOCAL:
        return x.detach().clone()
    n = _nranks(pg)
    parts = torch.stack(_chunks(x.detach(), n, dim,
                                "psum_scatter")).contiguous()
    a, staged = _host_route("reduce_scatter", pg, parts)
    out = a.new_empty(a.shape[1:])
    _REDUCE_SCATTER(out, a.view((-1,) + tuple(a.shape[2:])),
                    op=dist.ReduceOp.SUM, group=pg)
    return out.to(x.device) if staged else out


def _own_chunk(x, group, dim):
    n, r = group.nranks, group.rank
    return _chunks(x, n, dim, "split")[r].contiguous()


def _exchange(x, group, split_axis, concat_axis, tiled=True):
    """lax.all_to_all: chunk j of ``split_axis`` goes to group rank j; the
    chunks received are concatenated along ``concat_axis`` (stacked there
    when not ``tiled``, where ``split_axis`` has one entry a rank)."""
    _collective_log("alltoall", x, group)
    pg = _pg(group)
    n = _nranks(pg)
    if tiled:
        parts = torch.stack(_chunks(x.detach(), n, split_axis,
                                    "all_to_all")).contiguous()
    else:
        if x.shape[split_axis] != n:
            raise ValueError(f"all_to_all(tiled=False): dim {split_axis} "
                             f"has {x.shape[split_axis]} entries for {n} "
                             "ranks")
        parts = x.detach().movedim(split_axis, 0).contiguous()
    if pg is _LOCAL:
        got = parts.clone()
    else:
        a, staged = _host_route("alltoall", pg, parts)
        got = torch.empty_like(a, memory_format=torch.contiguous_format)
        _alltoall(got, a, pg)
        got = got.to(x.device) if staged else got
    if tiled:
        return torch.cat(got.unbind(0), concat_axis)
    return got.movedim(0, concat_axis).contiguous()


def _permute(x, group, perm):
    """lax.ppermute: group rank i sends ``x`` to group rank j for each
    (i, j) in ``perm``; a rank that receives nothing gets zeros. Every rank
    posts its sends and receives in ``perm``'s order."""
    _collective_log("ppermute", x, group)
    import time
    t0 = time.perf_counter()
    me = group.rank
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    pg = _pg(group)
    p2p = []
    staged = False
    if pg is not _LOCAL and any(i != j for i, j in perm):
        src, staged = _host_route("ppermute", pg, x.detach().contiguous())
        dst = torch.zeros_like(src) if staged else out
    for i, j in perm:
        if i == me and j == me:
            out.copy_(x)
        elif i == me:
            p2p.append(dist.P2POp(dist.isend, src, group.ranks[j],
                                  group=None if pg is dist.group.WORLD
                                  else pg))
        elif j == me:
            p2p.append(dist.P2POp(dist.irecv, dst, group.ranks[i],
                                  group=None if pg is dist.group.WORLD
                                  else pg))
    for work in dist.batch_isend_irecv(p2p) if p2p else ():
        work.wait()
    if staged and any(j == me and i != me for i, j in perm):
        out.copy_(dst)
    if p2p:
        nbytes = x.numel() * x.element_size()
        P2P_STATS["calls"] += 1
        P2P_STATS["send_bytes"] += nbytes * sum(i == me != j
                                                for i, j in perm)
        P2P_STATS["recv_bytes"] += nbytes * sum(j == me != i
                                                for i, j in perm)
        P2P_STATS["seconds"] += time.perf_counter() - t0
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_along(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim), None, None


class _GatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_along(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter_sum(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_along(g, ctx.group, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_chunk(x.detach(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_along(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, tiled):
        ctx.args = (group, concat_axis, split_axis, tiled)
        return _exchange(x, group, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g, *ctx.args), None, None, None, None)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group = group
        ctx.inverse = [(j, i) for i, j in perm]
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, ctx.inverse), None, None


def _axis_group(axis_name):
    """The group that ``axis_name`` names: a Group is itself; a name is an
    axis of the current ``ProcessMesh``."""
    if isinstance(axis_name, Group):
        return axis_name
    from .mesh import get_mesh
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError(f"no ProcessMesh is set: axis {axis_name!r} names "
                           "no group (set_mesh first)")
    return mesh.get_group(axis_name)


class ops:
    """The reference's lax collectives keyed by a mesh axis name (or given
    a Group), over the group that the axis of the current ``ProcessMesh``
    names. Functions of torch tensors with lax's transposes as their
    gradients; each returns a new tensor (``pvary`` a view)."""

    @staticmethod
    def psum(x, axis_name):
        return _Psum.apply(x, _axis_group(axis_name))

    @staticmethod
    def pvary(x, axis_name):
        """The identity, with a psum over the axis as its gradient: a
        replicated value entering computation that differs by rank."""
        return _Pvary.apply(x, _axis_group(axis_name))

    @staticmethod
    def pmean(x, axis_name):
        g = _axis_group(axis_name)
        return _Psum.apply(x, g) / g.nranks

    @staticmethod
    def pmax(x, axis_name):
        """Not differentiable (lax.pmax has no AD rule)."""
        return _sum_over(x, _axis_group(axis_name), ReduceOp.MAX)

    @staticmethod
    def all_gather(x, axis_name, axis=0, tiled=True):
        g = _axis_group(axis_name)
        if not tiled:
            x = x.unsqueeze(axis)
        return _AllGather.apply(x, g, axis)

    @staticmethod
    def psum_scatter(x, axis_name, scatter_dimension=0, tiled=True):
        out = _ReduceScatter.apply(x, _axis_group(axis_name),
                                   scatter_dimension)
        return out if tiled else out.squeeze(scatter_dimension)

    reduce_scatter = psum_scatter

    @staticmethod
    def all_to_all(x, axis_name, split_axis, concat_axis, tiled=True):
        return _AllToAll.apply(x, _axis_group(axis_name), split_axis,
                               concat_axis, tiled)

    @staticmethod
    def ppermute(x, axis_name, perm):
        """Group rank i sends x to group rank j for each (i, j) in perm;
        a rank that receives nothing gets zeros."""
        return _Ppermute.apply(x, _axis_group(axis_name),
                               [(int(i), int(j)) for i, j in perm])

    @staticmethod
    def axis_index(axis_name):
        return _axis_group(axis_name).rank

    @staticmethod
    def axis_size(axis_name):
        return _axis_group(axis_name).nranks


# ---------------------------------------------------------------------------
# flat-buffer collectives of the data-parallel engines (torch tensors)
# ---------------------------------------------------------------------------
# torch >= 2.13 names them *_single (the *_tensor names warn there)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def reduce_scatter_flat(out: torch.Tensor, inp: torch.Tensor,
                        op=ReduceOp.AVG, group: Optional[Group] = None):
    """``out`` (n elements) receives the reduction over the ranks of their
    ``inp[r * n:(r + 1) * n]``, r this rank's place in ``group``."""
    _collective_log("reduce_scatter", out, group)
    pg = _pg(group)
    if pg is _LOCAL:
        out.copy_(inp)
        return
    top, div = _torch_op(op, pg)
    a, staged = _host_route("reduce_scatter", pg, inp)
    o = out.cpu() if staged else out
    _REDUCE_SCATTER(o, a, op=top, group=pg)
    then = _divide(o, div)
    if then is not None:
        then()
    if staged:
        out.copy_(o)


def all_gather_flat(out: torch.Tensor, inp: torch.Tensor,
                    group: Optional[Group] = None):
    """``out[r * n:(r + 1) * n]`` receives rank r's ``inp`` (n elements).
    ``inp`` may be that slice of ``out`` itself (NCCL's in-place form)."""
    _collective_log("all_gather", inp, group)
    pg = _pg(group)
    if pg is _LOCAL:
        if out.data_ptr() != inp.data_ptr():
            out.copy_(inp)
        return
    a, staged = _host_route("all_gather", pg, inp)
    if staged:
        o = out.cpu()
        _ALL_GATHER(o, a, group=pg)
        out.copy_(o)
        return
    if _gloo(pg) and out.untyped_storage().data_ptr() == \
            inp.untyped_storage().data_ptr():
        inp = inp.clone()
    _ALL_GATHER(out, inp, group=pg)


def all_reduce_flat(buf: torch.Tensor, op=ReduceOp.AVG,
                    group: Optional[Group] = None):
    """``buf`` in place: the reduction of every rank's ``buf``."""
    _collective_log("all_reduce", buf, group)
    pg = _pg(group)
    if pg is _LOCAL:
        return
    top, div = _torch_op(op, pg)
    dist.all_reduce(buf, op=top, group=pg)
    then = _divide(buf, div)
    if then is not None:
        then()
