"""Shape/layout manipulation ops: the port of
``paddle_tpu/ops/manipulation.py`` (reference: python/paddle/tensor/
manipulation.py). Every op computes out of place: a view that torch hands
back is never written, so inplace ops stay rebinds.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtype as dtype_mod
from ..core.dispatch import _as_array, rebind_inplace, run_op, run_op_inplace
from ..core.tensor import Tensor

_pyslice = slice  # captured before `def slice(...)` below shadows it


def _int(s):
    """A size as an int; a symbolic size (a torch.export trace with a
    dynamic dim) stays symbolic."""
    if isinstance(s, torch.SymInt):
        return s
    return int(s.item() if isinstance(s, Tensor) else s)


def _ints(seq):
    if isinstance(seq, Tensor):
        seq = seq.tolist()
    if isinstance(seq, (int, np.integer, torch.SymInt)):
        return _int(seq)
    return [_int(s) for s in seq]


def _int_arg(v):
    return int(v.item()) if isinstance(v, Tensor) else int(v)


def cast(x, dtype):
    d = dtype_mod.torch_dtype(dtype)
    if x._data.dtype == d:
        return x
    diff = (x._data.is_floating_point() or x._data.is_complex()) and \
        (d.is_floating_point or d.is_complex)
    return run_op("cast", lambda a: a.to(d), x, differentiable=diff)


def cast_(x, dtype):
    d = dtype_mod.torch_dtype(dtype)
    x._assign_array(x._data.detach().to(d))
    return x


def reshape(x, shape, name=None):
    shape = _ints(shape)
    return run_op("reshape", lambda a: torch.reshape(a, shape), x)


def reshape_(x, shape, name=None):
    shape = _ints(shape)
    return run_op_inplace("reshape_", lambda a: torch.reshape(a, shape), x)


view = reshape


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    nd = x.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0

    def f(a):
        if a.dim() == 0:
            return a.reshape(1)
        return a.reshape(a.shape[:s] + (-1,) + a.shape[e + 1:])
    return run_op("flatten", f, x)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return rebind_inplace(x, flatten(x, start_axis, stop_axis))


def transpose(x, perm, name=None):
    perm = _ints(perm)
    return run_op("transpose", lambda a: a.permute(perm), x)


def t(x, name=None):
    return run_op("t", lambda a: a.permute(*range(a.dim() - 1, -1, -1)), x)


def moveaxis(x, source, destination, name=None):
    return run_op("moveaxis",
                  lambda a: torch.movedim(a, _ints(source),
                                          _ints(destination)), x)


def swapaxes(x, axis1, axis2, name=None):
    return run_op("swapaxes",
                  lambda a: torch.swapaxes(a, int(axis1), int(axis2)), x)


def squeeze(x, axis=None, name=None):
    def f(a):
        if axis is None:
            return torch.squeeze(a)
        axes = _ints(axis if isinstance(axis, (list, tuple)) else [axis])
        axes = tuple(ax % a.dim() for ax in axes if a.shape[ax % a.dim()] == 1)
        return torch.squeeze(a, axes) if axes else a
    return run_op("squeeze", f, x)


def squeeze_(x, axis=None, name=None):
    return rebind_inplace(x, squeeze(x, axis))


def unsqueeze(x, axis, name=None):
    axes = _ints(axis if isinstance(axis, (list, tuple, Tensor)) else [axis])
    if isinstance(axes, int):
        axes = [axes]

    def f(a):
        for ax in axes:
            a = torch.unsqueeze(a, ax)
        return a
    return run_op("unsqueeze", f, x)


def unsqueeze_(x, axis, name=None):
    return rebind_inplace(x, unsqueeze(x, axis))


def concat(x, axis=0, name=None):
    axis = _int_arg(axis)
    return run_op("concat", lambda *xs: torch.cat(xs, axis), *list(x))


def stack(x, axis=0, name=None):
    return run_op("stack", lambda *xs: torch.stack(xs, axis), *list(x))


def hstack(x, name=None):
    return run_op("hstack", lambda *xs: torch.hstack(xs), *list(x))


def vstack(x, name=None):
    return run_op("vstack", lambda *xs: torch.vstack(xs), *list(x))


def dstack(x, name=None):
    return run_op("dstack", lambda *xs: torch.dstack(xs), *list(x))


def split(x, num_or_sections, axis=0, name=None):
    axis = _int_arg(axis)
    n = x.shape[axis % x.ndim]
    if isinstance(num_or_sections, int):
        sizes = [n // num_or_sections] * num_or_sections
    else:
        sizes = _ints(num_or_sections)
        total = sum(s for s in sizes if s > 0)
        sizes = [s if s > 0 else n - total for s in sizes]
    return list(run_op("split",
                       lambda a: tuple(torch.split(a, sizes, axis)), x))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def tensor_split(x, num_or_indices, axis=0, name=None):
    axis = int(axis)
    n = x.shape[axis % x.ndim]
    if isinstance(num_or_indices, int):
        k = num_or_indices
        base, rem = divmod(n, k)
        return split(x, [base + (1 if i < rem else 0) for i in range(k)],
                     axis)
    idx = [0] + _ints(num_or_indices) + [n]
    return split(x, [idx[i + 1] - idx[i] for i in range(len(idx) - 1)], axis)


def unbind(x, axis=0, name=None):
    return list(run_op("unbind", lambda a: tuple(torch.unbind(a, axis)), x))


unstack = unbind


def expand(x, shape, name=None):
    shape = _ints(shape)

    def f(a):
        tgt = list(shape)
        src = (1,) * (len(tgt) - a.dim()) + tuple(a.shape)
        tgt = [s if t_ == -1 else t_ for t_, s in zip(tgt, src)]
        return torch.broadcast_to(a.reshape(src), tgt)
    return run_op("expand", f, x)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_tensors(inputs, name=None):
    return list(run_op("broadcast_tensors",
                       lambda *xs: tuple(torch.broadcast_tensors(*xs)),
                       *list(inputs)))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def tile(x, repeat_times, name=None):
    reps = _ints(repeat_times)
    return run_op("tile", lambda a: torch.tile(a, tuple(reps)), x)


def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, Tensor):
        return run_op("repeat_interleave",
                      lambda a, r: torch.repeat_interleave(a, r, dim=axis),
                      x, repeats)
    return run_op("repeat_interleave",
                  lambda a: torch.repeat_interleave(a, int(repeats), dim=axis),
                  x)


def flip(x, axis, name=None):
    axes = _ints(axis if isinstance(axis, (list, tuple)) else [axis])
    return run_op("flip", lambda a: torch.flip(a, axes), x)


def rot90(x, k=1, axes=(0, 1), name=None):
    return run_op("rot90", lambda a: torch.rot90(a, k, list(axes)), x)


def roll(x, shifts, axis=None, name=None):
    sh = _ints(shifts) if isinstance(shifts, (list, tuple, Tensor)) \
        else int(shifts)
    ax = _ints(axis) if isinstance(axis, (list, tuple)) else axis
    if ax is None:
        return run_op("roll", lambda a: torch.roll(a, sh), x)
    return run_op("roll", lambda a: torch.roll(a, sh, ax), x)


def _take(a, i, axis):
    """numpy's take along one axis: the index's shape replaces the axis."""
    axis = axis % a.dim()
    out = torch.index_select(a, axis, i.reshape(-1).long())
    return out.reshape(a.shape[:axis] + i.shape + a.shape[axis + 1:])


def gather(x, index, axis=0, name=None):
    axis = _int_arg(axis)
    return run_op("gather", lambda a, i: _take(a, i, axis), x, index)


def gather_nd(x, index, name=None):
    return run_op("gather_nd",
                  lambda a, idx: a[tuple(idx.long().unbind(-1))], x, index)


def take(x, index, mode="raise", name=None):
    def f(a, i):
        flat = a.reshape(-1)
        n = flat.shape[0]
        i = i.long()
        i = i % n if mode == "wrap" else i.clamp(0, n - 1)
        return _take(flat, i, 0)
    return run_op("take", f, x, index)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return run_op("take_along_axis",
                  lambda a, i: torch.take_along_dim(a, i.long(), dim=axis),
                  arr, indices)


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    def f(a, idx, v):
        idx = idx.long()
        v = torch.broadcast_to(v, idx.shape).to(a.dtype)
        if reduce == "assign":
            return a.scatter(axis, idx, v)
        if reduce in ("add", "sum"):
            return a.scatter_add(axis, idx, v)
        red = {"mul": "prod", "multiply": "prod", "amax": "amax",
               "amin": "amin"}.get(reduce)
        if red is None:
            raise ValueError(f"unknown reduce {reduce}")
        return a.scatter_reduce(axis, idx, v, red, include_self=True)
    return run_op("put_along_axis", f, arr, indices, values)


def scatter(x, index, updates, overwrite=True, name=None):
    def f(a, idx, upd):
        idx = idx.reshape(-1).long()
        upd = upd.to(a.dtype)
        if overwrite:
            return a.index_copy(0, idx, upd)
        return a.index_fill(0, idx, 0).index_add(0, idx, upd)
    return run_op("scatter", f, x, index, updates)


def scatter_(x, index, updates, overwrite=True, name=None):
    return rebind_inplace(x, scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    return run_op("scatter_nd_add",
                  lambda a, idx, upd: a.index_put(
                      tuple(idx.long().unbind(-1)), upd.to(a.dtype),
                      accumulate=True),
                  x, index, updates)


def scatter_nd(index, updates, shape, name=None):
    def f(idx, upd):
        a = torch.zeros(_ints(shape), dtype=upd.dtype, device=upd.device)
        return a.index_put(tuple(idx.long().unbind(-1)), upd,
                           accumulate=True)
    return run_op("scatter_nd", f, index, updates)


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


def index_sample(x, index, name=None):
    return run_op("index_sample",
                  lambda a, idx: torch.take_along_dim(a, idx.long(), dim=1),
                  x, index)


def index_add(x, index, axis, value, name=None):
    return run_op("index_add",
                  lambda a, idx, v: torch.index_add(a, axis, idx.long(),
                                                    v.to(a.dtype)),
                  x, index, value)


def index_put(x, indices, value, accumulate=False, name=None):
    def f(a, v, *idxs):
        loc = tuple(i if i.dtype == torch.bool else i.long() for i in idxs)
        return a.index_put(loc, v.to(a.dtype), accumulate=accumulate)
    return run_op("index_put", f, x, value, *list(indices))


def index_fill(x, index, axis, value, name=None):
    return run_op("index_fill",
                  lambda a, idx: torch.index_fill(a, axis, idx.long(), value),
                  x, index)


def masked_select(x, mask, name=None):
    """Dynamic output shape, and no gradient, as in the reference."""
    return Tensor._wrap(torch.masked_select(x._data.detach(), mask._data))


def masked_fill(x, mask, value, name=None):
    if isinstance(value, Tensor):
        return run_op("masked_fill",
                      lambda a, m, vv: torch.where(m, vv.to(a.dtype), a),
                      x, mask, value)
    return run_op("masked_fill",
                  lambda a, m: torch.masked_fill(a, m, value), x, mask)


def masked_fill_(x, mask, value, name=None):
    return rebind_inplace(x, masked_fill(x, mask, value))


def masked_scatter(x, mask, value, name=None):
    """Dynamic, and no gradient, as in the reference."""
    a, m = x._data.detach(), mask._data
    v = value._data.detach().reshape(-1)[: int(m.sum())]
    return Tensor._wrap(a.masked_scatter(m, v.to(a.dtype)))


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        from .search import nonzero
        return nonzero(condition, as_tuple=True)
    from .math import _promote_binary
    x, y = _promote_binary(x, y)
    return run_op("where", lambda c, a, b: torch.where(c.bool(), a, b),
                  condition, x, y)


def where_(condition, x, y, name=None):
    return rebind_inplace(x, where(condition, x, y))


def numel(x, name=None):
    return Tensor._wrap(torch.tensor(x.size, dtype=torch.int64,
                                     device=x._data.device))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    size = index_num // nshards

    def f(a):
        lo, hi = shard_id * size, (shard_id + 1) * size
        inside = (a >= lo) & (a < hi)
        return torch.where(inside, a - lo, ignore_value)
    return run_op("shard_index", f, input, differentiable=False)


def slice(input, axes, starts, ends, name=None):
    axes, starts, ends = _ints(axes), _ints(starts), _ints(ends)

    def f(a):
        for ax, st, en in zip(axes, starts, ends):
            n = a.shape[ax]
            st2 = max(st + n, 0) if st < 0 else min(st, n)
            en2 = max(en + n, 0) if en < 0 else min(en, n)
            a = a.narrow(ax, st2, en2 - st2)
        return a
    return run_op("slice", f, input)


def strided_slice(x, axes, starts, ends, strides, name=None):
    axes, starts, ends, strides = map(_ints, (axes, starts, ends, strides))

    def f(a):
        for ax, st, en, sd in zip(axes, starts, ends, strides):
            # numpy's slice, negative steps included (torch has none)
            rows = range(a.shape[ax])[_pyslice(st, en, sd)]
            a = torch.index_select(a, ax, torch.tensor(list(rows),
                                                       dtype=torch.long,
                                                       device=a.device))
        return a
    return run_op("strided_slice", f, x)


def crop(x, shape=None, offsets=None, name=None):
    shape = _ints(shape)
    offsets = _ints(offsets) if offsets is not None else [0] * x.ndim

    def f(a):
        for i, s in enumerate(shape):
            size = a.shape[i] - offsets[i] if s == -1 else s
            a = a.narrow(i, offsets[i], size)
        return a
    return run_op("crop", f, x)


def _pad_index(n, lo, hi, mode, device):
    """Source rows of a dim of n rows padded by (lo, hi): numpy's 'edge',
    'reflect' and 'wrap'."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    period = 2 * (n - 1)
    i = i.abs() % period
    return torch.where(i >= n, period - i, i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    pad = _ints(pad)
    nd = x.ndim
    if len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # paddle F.pad semantics: pad applies to the last len(pad)//2
        # spatial dims in the (NCHW/NHWC) layout
        k = len(pad) // 2
        cfg = [(0, 0)] * nd
        dims = range(1, 1 + k) if data_format.endswith("C") \
            else range(nd - k, nd)
        for i, d in enumerate(dims):
            cfg[d] = (pad[2 * i], pad[2 * i + 1])
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode!r}")

    def f(a):
        if mode == "constant":
            flat = [p for lo_hi in reversed(cfg) for p in lo_hi]
            return F.pad(a, flat, mode="constant", value=value)
        for d, (lo, hi) in enumerate(cfg):
            if lo or hi:
                a = torch.index_select(
                    a, d, _pad_index(a.shape[d], lo, hi, mode, a.device))
        return a
    return run_op("pad", f, x)


def unfold(x, kernel_size, strides=1, paddings=0, dilations=1, name=None):
    def pair(v):
        return _ints(v) if isinstance(v, (list, tuple)) else [v] * 2
    ks, st, dl = pair(kernel_size), pair(strides), pair(dilations)
    pd = pair(paddings)
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]

    def f(a):
        # pd is [top, left, bottom, right]
        a = F.pad(a, [pd[1], pd[3], pd[0], pd[2]])
        return F.unfold(a, ks, dilation=dl, stride=st)
    return run_op("unfold", f, x)


def as_complex(x, name=None):
    return run_op("as_complex",
                  lambda a: torch.complex(a[..., 0], a[..., 1]), x)


def as_real(x, name=None):
    return run_op("as_real",
                  lambda a: torch.stack([a.real, a.imag], -1), x)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, Tensor):
        axes = axes.tolist()
    return run_op("tensordot", lambda a, b: torch.tensordot(a, b, axes), x, y)


def _atleast(name, fn):
    def op(*inputs, name=None):
        outs = [run_op(name, fn, x) for x in inputs]
        return outs[0] if len(outs) == 1 else outs
    op.__name__ = name
    return op


atleast_1d = _atleast("atleast_1d", torch.atleast_1d)
atleast_2d = _atleast("atleast_2d", torch.atleast_2d)
atleast_3d = _atleast("atleast_3d", torch.atleast_3d)


# ------------------------- __getitem__ / __setitem__ -----------------------
def _convert_index(item):
    """A python index spec (possibly holding Tensors or arrays) as
    (tensor inputs, rebuild(arrays) -> the torch index)."""
    if not isinstance(item, tuple):
        item = (item,)
    tensors = []
    spec = []
    for it in item:
        if isinstance(it, Tensor):
            spec.append(("T", len(tensors)))
            tensors.append(it)
        elif isinstance(it, np.ndarray):
            spec.append(("T", len(tensors)))
            tensors.append(Tensor._wrap(_as_array(it, "cpu")))
        else:
            spec.append(("S", it))

    def rebuild(arrays):
        out = []
        for kind, v in spec:
            if kind == "T":
                a = arrays[v]
                out.append(a if a.dtype == torch.bool else a.long())
            else:
                out.append(v)
        return tuple(out)
    return tensors, rebuild


def getitem(x, item):
    tensors, rebuild = _convert_index(item)
    return run_op("getitem", lambda a, *idx: a[rebuild(idx)], x, *tensors)


def setitem(x, item, value):
    tensors, rebuild = _convert_index(item)
    if isinstance(value, Tensor):
        def f(a, v, *idx):
            out = a.clone()
            out[rebuild(idx)] = v.to(a.dtype)
            return out
        out = run_op("setitem", f, x, value, *tensors)
    else:
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)

        def f(a, *idx):
            out = a.clone()
            out[rebuild(idx)] = value.to(a.device, a.dtype) \
                if isinstance(value, torch.Tensor) else value
            return out
        out = run_op("setitem", f, x, *tensors)
    return rebind_inplace(x, out)
