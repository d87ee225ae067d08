"""paddle.geometric: the port of ``paddle_tpu/geometric.py`` (reference:
python/paddle/geometric over the phi segment kernels): segment reductions
and message passing as torch scatter-reductions (``index_add``,
``scatter_reduce``), and the host-side graph sampling and reindexing in
numpy. A segment count is max(id) + 1, read on the host, as in the
reference; an empty max/min segment holds the dtype's lowest/highest
value, as jax's segment_max/min give.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .core.dispatch import run_op
from .core.tensor import Tensor


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def _nseg(ids):
    ids = _t(ids)
    return int(ids._data.max()) + 1 if ids.size else 0


def _segment(d, i, n, how):
    """Reduce rows of d into n segments by ids i: sum, max or min."""
    i = i.long()
    shape = (n,) + tuple(d.shape[1:])
    if how == "sum":
        return torch.zeros(shape, dtype=d.dtype, device=d.device) \
            .index_add(0, i, d)
    if d.is_floating_point():
        init = -math.inf if how == "max" else math.inf
    else:
        info = torch.iinfo(d.dtype)
        init = info.min if how == "max" else info.max
    idx = i.reshape((-1,) + (1,) * (d.ndim - 1)).expand_as(d)
    return torch.full(shape, init, dtype=d.dtype, device=d.device) \
        .scatter_reduce(0, idx, d, "amax" if how == "max" else "amin",
                        include_self=True)


def _segment_mean(d, i, n):
    s = _segment(d, i, n, "sum")
    cnt = _segment(torch.ones_like(d[..., :1]), i, n, "sum")
    return s / torch.clamp_min(cnt, 1)


def segment_sum(data, segment_ids, name=None):
    n = _nseg(segment_ids)
    return run_op("segment_sum", lambda d, i: _segment(d, i, n, "sum"),
                  _t(data), _t(segment_ids))


def segment_mean(data, segment_ids, name=None):
    n = _nseg(segment_ids)
    return run_op("segment_mean", lambda d, i: _segment_mean(d, i, n),
                  _t(data), _t(segment_ids))


def segment_max(data, segment_ids, name=None):
    n = _nseg(segment_ids)
    return run_op("segment_max", lambda d, i: _segment(d, i, n, "max"),
                  _t(data), _t(segment_ids))


def segment_min(data, segment_ids, name=None):
    n = _nseg(segment_ids)
    return run_op("segment_min", lambda d, i: _segment(d, i, n, "min"),
                  _t(data), _t(segment_ids))


def _reduce_messages(msgs, dst, n, reduce_op):
    if reduce_op == "mean":
        s = _segment(msgs, dst, n, "sum")
        cnt = _segment(torch.ones((msgs.shape[0], 1), dtype=msgs.dtype,
                                  device=msgs.device), dst, n, "sum")
        return s / torch.clamp_min(cnt, 1)
    how = {"sum": "sum", "add": "sum", "max": "max", "min": "min"}[reduce_op]
    return _segment(msgs, dst, n, how)


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """Gather x at src, scatter-reduce at dst (graph message passing)."""
    n = out_size or _nseg(dst_index)

    def f(a, src, dst):
        return _reduce_messages(a[src.long()], dst, n, reduce_op)
    return run_op("send_u_recv", f, _t(x), _t(src_index), _t(dst_index))


_COMBINE = {"add": lambda m, w: m + w, "sub": lambda m, w: m - w,
            "mul": lambda m, w: m * w, "div": lambda m, w: m / w}


def send_ue_recv(x, e, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    n = out_size or _nseg(dst_index)

    def f(a, ew, src, dst):
        msgs = _COMBINE[message_op](a[src.long()], ew)
        return _reduce_messages(msgs, dst, n, reduce_op)
    return run_op("send_ue_recv", f, _t(x), _t(e), _t(src_index),
                  _t(dst_index))


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """Per-edge message op(x[src], y[dst]) with no reduce (reference
    geometric/message_passing/send_recv.py:413)."""
    def f(a, b, src, dst):
        return _COMBINE[message_op](a[src.long()], b[dst.long()])
    return run_op("send_uv", f, _t(x), _t(y), _t(src_index), _t(dst_index))


# ------------------------------------------------------------------
# Graph sampling / reindex: host-side input-pipeline ops on a CSC
# graph (reference geometric/sampling/neighbors.py:30, reindex.py:32 —
# phi graph_sample_neighbors / reindex_graph kernels). On TPU the
# sampling stage lives in the host data pipeline, so these are numpy.
# ------------------------------------------------------------------

def _np1d(t):
    return np.asarray(t.numpy() if isinstance(t, Tensor) else t).reshape(-1)


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    if return_eids and eids is None:
        raise ValueError("`eids` should not be None if `return_eids` is "
                         "True.")
    r, cp, nodes = _np1d(row), _np1d(colptr), _np1d(input_nodes)
    ev = _np1d(eids) if eids is not None else None
    rng = np.random.default_rng()
    neigh, cnt, out_eids = [], [], []
    for n in nodes.tolist():
        lo, hi = int(cp[n]), int(cp[n + 1])
        deg = hi - lo
        if sample_size < 0 or deg <= sample_size:
            idx = np.arange(lo, hi)
        else:
            idx = lo + rng.choice(deg, size=sample_size, replace=False)
        neigh.append(r[idx])
        cnt.append(len(idx))
        if ev is not None:
            out_eids.append(ev[idx])
    out_n = Tensor(np.concatenate(neigh) if neigh
                   else np.empty(0, r.dtype))
    out_c = Tensor(np.asarray(cnt, np.int32))
    if return_eids:
        return out_n, out_c, Tensor(
            np.concatenate(out_eids) if out_eids else np.empty(0, r.dtype))
    return out_n, out_c


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size=-1, eids=None, return_eids=False,
                              name=None):
    if return_eids and eids is None:
        raise ValueError("`eids` should not be None if `return_eids` is "
                         "True.")
    r, cp, nodes = _np1d(row), _np1d(colptr), _np1d(input_nodes)
    w = _np1d(edge_weight).astype(np.float64)
    ev = _np1d(eids) if eids is not None else None
    rng = np.random.default_rng()
    neigh, cnt, out_eids = [], [], []
    for n in nodes.tolist():
        lo, hi = int(cp[n]), int(cp[n + 1])
        deg = hi - lo
        if deg == 0:
            cnt.append(0)
            continue
        if sample_size < 0 or deg <= sample_size:
            idx = np.arange(lo, hi)
        else:
            p = w[lo:hi] / w[lo:hi].sum()
            idx = lo + rng.choice(deg, size=sample_size, replace=False, p=p)
        neigh.append(r[idx])
        cnt.append(len(idx))
        if ev is not None:
            out_eids.append(ev[idx])
    out_n = Tensor(np.concatenate(neigh) if neigh
                   else np.empty(0, r.dtype))
    out_c = Tensor(np.asarray(cnt, np.int32))
    if return_eids:
        return out_n, out_c, Tensor(
            np.concatenate(out_eids) if out_eids else np.empty(0, r.dtype))
    return out_n, out_c


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    xs, ns, cs = _np1d(x), _np1d(neighbors), _np1d(count)
    remap = {int(v): i for i, v in enumerate(xs.tolist())}
    out_nodes = list(xs.tolist())
    src = np.empty(len(ns), xs.dtype)
    for i, v in enumerate(ns.tolist()):
        j = remap.get(int(v))
        if j is None:
            j = len(out_nodes)
            remap[int(v)] = j
            out_nodes.append(int(v))
        src[i] = j
    dst = np.repeat(np.arange(len(cs), dtype=xs.dtype), cs)
    return (Tensor(src), Tensor(dst),
            Tensor(np.asarray(out_nodes, xs.dtype)))


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """reindex over a list of per-edge-type neighbor/count tensors
    sharing one node renumbering (reference reindex.py:heter)."""
    xs = _np1d(x)
    remap = {int(v): i for i, v in enumerate(xs.tolist())}
    out_nodes = list(xs.tolist())
    srcs, dsts = [], []
    for ns_t, cs_t in zip(neighbors, count):
        ns, cs = _np1d(ns_t), _np1d(cs_t)
        src = np.empty(len(ns), xs.dtype)
        for i, v in enumerate(ns.tolist()):
            j = remap.get(int(v))
            if j is None:
                j = len(out_nodes)
                remap[int(v)] = j
                out_nodes.append(int(v))
            src[i] = j
        srcs.append(Tensor(src))
        dsts.append(Tensor(np.repeat(np.arange(len(cs), dtype=xs.dtype),
                                     cs)))
    return srcs, dsts, Tensor(np.asarray(out_nodes, xs.dtype))
