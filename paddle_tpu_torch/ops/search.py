"""Search / sort ops: the port of ``paddle_tpu/ops/search.py`` (reference:
python/paddle/tensor/search.py). Ops whose output shape depends on the
data (``unique``, ``histogram``, ...) run on the host, as in the
reference."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import run_op
from ..core.generator import generator_for, no_traced_form
from ..core.tensor import Tensor, _no_host_read


def _host(x):
    _no_host_read("numpy")
    return dtype_mod.to_numpy(x._data)


def _wrap_host(arr, like, dtype=None):
    t = dtype_mod.from_numpy(np.asarray(arr)).to(like._data.device)
    return Tensor._wrap(t if dtype is None else t.to(dtype))


def _arg_extreme(op_name, fn):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        d = dtype_mod.torch_dtype(dtype)

        def f(a):
            if axis is None:
                return fn(a.reshape(-1), 0).to(d)
            return fn(a, axis, keepdim=keepdim).to(d)
        return run_op(op_name, f, x, differentiable=False)
    op.__name__ = op_name
    return op


argmax = _arg_extreme("argmax", torch.argmax)
argmin = _arg_extreme("argmin", torch.argmin)


def argsort(x, axis=-1, descending=False, stable=True, name=None):
    return run_op("argsort",
                  lambda a: torch.argsort(a, dim=axis, descending=descending,
                                          stable=stable),
                  x, differentiable=False)


def sort(x, axis=-1, descending=False, stable=True, name=None):
    return run_op("sort",
                  lambda a: torch.sort(a, dim=axis, descending=descending,
                                       stable=stable).values, x)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    k = int(k.item()) if isinstance(k, Tensor) else int(k)

    def f(a):
        ax = a.dim() - 1 if axis is None else axis % a.dim()
        vals, idx = torch.topk(a, k, dim=ax, largest=largest, sorted=True)
        return vals, idx
    return run_op("topk", f, x)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def f(a):
        vals, idx = torch.kthvalue(a, k, dim=axis, keepdim=keepdim)
        return vals, idx
    return run_op("kthvalue", f, x)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value (the smallest among ties) and the first index
    where it occurs, as the reference computes them."""
    def f(a):
        ax = axis % a.dim()
        moved = torch.movedim(a, ax, -1)
        s = torch.sort(moved, dim=-1).values
        n = s.shape[-1]
        iota = torch.arange(n, device=a.device).expand(s.shape)
        starts = torch.ones_like(s, dtype=torch.bool)
        starts[..., 1:] = s[..., 1:] != s[..., :-1]
        start_idx = torch.cummax(torch.where(starts, iota, 0), -1).values
        best = torch.argmax(iota - start_idx, dim=-1)
        vals = torch.take_along_dim(s, best[..., None], dim=-1)[..., 0]
        idx = torch.argmax((moved == vals[..., None]).int(), dim=-1)
        if keepdim:
            vals = torch.movedim(vals[..., None], -1, ax)
            idx = torch.movedim(idx[..., None], -1, ax)
        return vals, idx
    return run_op("mode", f, x)


def nonzero(x, as_tuple=False):
    a = x._data.detach()
    if as_tuple:
        return tuple(Tensor._wrap(i.reshape(-1, 1))
                     for i in torch.nonzero(a, as_tuple=True))
    return Tensor._wrap(torch.nonzero(a))


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return run_op("searchsorted",
                  lambda seq, v: torch.searchsorted(
                      seq, v, out_int32=out_int32, right=right),
                  sorted_sequence, values, differentiable=False)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def _middle(a, axis, keepdim):
    """numpy's median: the mean of the two middle values of the sorted data
    (one for an odd count)."""
    if not (a.is_floating_point() or a.is_complex()):
        a = a.to(dtype_mod.get_default_dtype().torch)
    if axis is None:
        s = torch.sort(a.reshape(-1)).values
        n = s.shape[0]
        out = (s[(n - 1) // 2] + s[n // 2]) / 2
        return out.reshape([1] * a.dim()) if keepdim else out
    s = torch.sort(a, dim=axis).values
    n = s.shape[axis]
    out = (s.narrow(axis, (n - 1) // 2, 1) + s.narrow(axis, n // 2, 1)) / 2
    return out if keepdim else out.squeeze(axis)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    def f(a):
        if mode == "avg":
            return _middle(a, axis, keepdim)
        # min mode: the lower of the two middles
        if axis is None:
            s = torch.sort(a.reshape(-1)).values
            return s[(s.shape[0] - 1) // 2]
        s = torch.sort(a, dim=axis).values
        return s.select(axis, (s.shape[axis] - 1) // 2)
    return run_op("median", f, x)


def nanmedian(x, axis=None, keepdim=False, name=None):
    def f(a):
        if axis is None:
            out = torch.nanquantile(a.reshape(-1), 0.5)
            return out.reshape([1] * a.dim()) if keepdim else out
        return torch.nanquantile(a, 0.5, dim=axis, keepdim=keepdim)
    return run_op("nanmedian", f, x)


def _q(q, a):
    if isinstance(q, (int, float)):
        return float(q)
    qv = q._data if isinstance(q, Tensor) else torch.as_tensor(q)
    return qv.to(device=a.device, dtype=a.dtype)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return run_op("quantile",
                  lambda a: torch.quantile(a, _q(q, a), dim=axis,
                                           keepdim=keepdim,
                                           interpolation=interpolation), x)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return run_op("nanquantile",
                  lambda a: torch.nanquantile(a, _q(q, a), dim=axis,
                                              keepdim=keepdim), x)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    res = np.unique(_host(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not (return_index or return_inverse or return_counts):
        return _wrap_host(res, x, x._data.dtype)
    return tuple([_wrap_host(res[0], x, x._data.dtype)]
                 + [_wrap_host(r, x) for r in res[1:]])


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    arr = _host(x)
    if axis is None:
        arr = arr.reshape(-1)
        ax = 0
    else:
        ax = axis
    take = np.ones(arr.shape[ax], bool)
    sl = [np.s_[:]] * arr.ndim
    sl[ax] = np.s_[1:]
    sl2 = [np.s_[:]] * arr.ndim
    sl2[ax] = np.s_[:-1]
    neq = arr[tuple(sl)] != arr[tuple(sl2)]
    while neq.ndim > 1:
        neq = neq.any(axis=-1 if ax == 0 else 0)
    take[1:] = neq
    results = [_wrap_host(np.compress(take, arr, axis=ax), x, x._data.dtype)]
    if return_inverse:
        results.append(_wrap_host(np.cumsum(take) - 1, x, torch.int64))
    if return_counts:
        idx = np.nonzero(take)[0]
        results.append(_wrap_host(np.diff(np.append(idx, arr.shape[ax])), x,
                                  torch.int64))
    return results[0] if len(results) == 1 else tuple(results)


def index_of(x, value):
    """First flat index of ``value`` in ``x`` (list.index semantics over the
    flattened tensor); an int64 scalar Tensor, ValueError when absent."""
    hits = np.nonzero(_host(x).reshape(-1) == value)[0]
    if hits.size == 0:
        raise ValueError(f"{value!r} is not in tensor")
    return _wrap_host(np.int64(hits[0]), x)


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    arr = _host(input)
    lo, hi = (min, max) if (min != 0 or max != 0) else (arr.min(), arr.max())
    w = _host(weight) if weight is not None else None
    h, _ = np.histogram(arr, bins=bins, range=(lo, hi), weights=w,
                        density=density)
    return _wrap_host(h, input)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    w = _host(weights) if weights is not None else None
    h, edges = np.histogramdd(_host(x), bins=bins, range=ranges,
                              density=density, weights=w)
    return _wrap_host(h, x), [_wrap_host(e, x) for e in edges]


def bincount(x, weights=None, minlength=0, name=None):
    if weights is not None:
        return run_op("bincount",
                      lambda a, w: torch.bincount(a, w, minlength).to(w.dtype),
                      x, weights, differentiable=False)
    return run_op("bincount", lambda a: torch.bincount(a, minlength=minlength),
                  x, differentiable=False)


def top_p_sampling(x, ps, threshold=None, topp_seed=None, seed=-1, k=0,
                   mode="truncated", return_top=False, name=None):
    """Nucleus (top-p) sampling per row of probabilities (reference
    tensor/search.py:1362)."""
    dev = x._data.device
    gen = torch.Generator(device=dev).manual_seed(seed) if seed >= 0 \
        else generator_for(dev)
    no_traced_form(gen, "top_p_sampling")

    def f(probs_in, p):
        probs = probs_in.float().clamp_min(0.0)
        total = probs.sum(-1, keepdim=True)
        probs = torch.where(total > 0, probs / total.clamp_min(1e-38),
                            1.0 / probs.shape[-1])
        order = torch.argsort(-probs, dim=-1)
        sorted_p = torch.take_along_dim(probs, order, dim=-1)
        cum = torch.cumsum(sorted_p, -1)
        # keep tokens while the cumulative mass before them is < p
        keep = (cum - sorted_p) < p.reshape(-1, 1).float()
        keep[:, 0] = True
        masked = torch.where(keep, sorted_p, 0.0)
        masked = masked / masked.sum(-1, keepdim=True)
        draw = torch.multinomial(masked, 1, generator=gen)
        ids = torch.take_along_dim(order, draw, dim=-1)
        scores = torch.take_along_dim(probs, ids, dim=-1)
        return scores.to(probs_in.dtype), ids
    return run_op("top_p_sampling", f, x, ps, differentiable=False)
