"""InferMeta: the port of ``paddle_tpu/core/infermeta.py``.

Shape and dtype inference (reference: paddle/phi/infermeta/{unary,binary,
ternary,multiary}.cc and MetaTensor, phi/core/meta_tensor.h). ``MetaTensor``
and the explicit meta functions carry over as the reference has them, with
the port's dtypes (``core.dtype.DType``, which compare equal to numpy
dtypes and names). Every other op's meta comes from running the op itself
on tensors without storage (``infer_via_eval_shape``): torch's meta device,
or ``FakeTensorMode`` where an op reads a value on the host and the meta
device refuses it. This stands where the reference uses
``jax.eval_shape``; an op whose output shape depends on its input's values
(``unique``, ``nonzero``, ``masked_select``) has no meta there either, and
raises here as it does there.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import dtype as dtype_mod


def _dt(dtype):
    return dtype_mod.convert_dtype(dtype)


def _promote(a, b):
    return dtype_mod.promote_types(a, b)


class MetaTensor:
    """Shape+dtype handle (phi/core/meta_tensor.h analog)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape: Sequence[int], dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = _dt(dtype)

    @classmethod
    def from_array(cls, a) -> "MetaTensor":
        return cls(a.shape, a.dtype)

    def numel(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def __repr__(self):
        return f"MetaTensor({list(self.shape)}, {self.dtype.name})"

    def __eq__(self, other):
        return (isinstance(other, MetaTensor) and self.shape == other.shape
                and self.dtype == other.dtype)


# ------------------------------------------------------------------ helpers

def broadcast_shape(a: Sequence[int], b: Sequence[int]) -> Tuple[int, ...]:
    """NumPy-style broadcast of two shapes (phi funcs.h GetBroadcastDims)."""
    ra, rb = list(a)[::-1], list(b)[::-1]
    out = []
    for i in range(max(len(ra), len(rb))):
        da = ra[i] if i < len(ra) else 1
        db = rb[i] if i < len(rb) else 1
        if da == db or da == 1 or db == 1:
            out.append(max(da, db))
        else:
            raise ValueError(f"cannot broadcast {tuple(a)} and {tuple(b)}")
    return tuple(out[::-1])


def _norm_axis(axis: int, ndim: int) -> int:
    if axis < -ndim or (ndim > 0 and axis >= ndim):
        raise ValueError(f"axis {axis} out of range for ndim {ndim}")
    return axis + ndim if axis < 0 else axis


# ---------------------------------------------------------------- unary ops

def unchanged_infermeta(x: MetaTensor) -> MetaTensor:
    """UnchangedInferMeta (phi/infermeta/unary.cc)."""
    return MetaTensor(x.shape, x.dtype)


def cast_infermeta(x: MetaTensor, dtype) -> MetaTensor:
    return MetaTensor(x.shape, dtype)


def real_to_complex_map(dt):
    return {"float32": _dt("complex64"), "float64": _dt("complex128")}.get(
        _dt(dt).name, _dt(dt))


def complex_to_real_map(dt):
    return {"complex64": _dt("float32"), "complex128": _dt("float64")}.get(
        _dt(dt).name, _dt(dt))


def reduce_infermeta(x: MetaTensor, axis=None, keepdim=False,
                     dtype=None) -> MetaTensor:
    """ReduceInferMeta / SumInferMeta."""
    dt = _dt(dtype) if dtype is not None else x.dtype
    if axis is None:
        shape = tuple([1] * len(x.shape)) if keepdim else ()
        return MetaTensor(shape, dt)
    axes = [axis] if isinstance(axis, int) else list(axis)
    axes = sorted(_norm_axis(a, len(x.shape)) for a in axes)
    out = []
    for i, s in enumerate(x.shape):
        if i in axes:
            if keepdim:
                out.append(1)
        else:
            out.append(s)
    return MetaTensor(out, dt)


def argminmax_infermeta(x: MetaTensor, axis=None, keepdim=False,
                        dtype=np.int64) -> MetaTensor:
    if axis is None:
        return MetaTensor((), _dt(dtype))
    m = reduce_infermeta(x, axis, keepdim)
    return MetaTensor(m.shape, _dt(dtype))


def reshape_infermeta(x: MetaTensor, shape: Sequence[int]) -> MetaTensor:
    """ReshapeInferMeta: supports one -1 and 0 ("copy input dim")."""
    shape = list(shape)
    for i, s in enumerate(shape):
        if s == 0:
            if i >= len(x.shape):
                raise ValueError("0-dim index out of range in reshape")
            shape[i] = x.shape[i]
    negs = [i for i, s in enumerate(shape) if s == -1]
    if len(negs) > 1:
        raise ValueError("only one -1 allowed in reshape target")
    if negs:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[negs[0]] = x.numel() // known
    if int(np.prod(shape) if shape else 1) != x.numel():
        raise ValueError(f"reshape {x.shape}->{shape}: numel mismatch")
    return MetaTensor(shape, x.dtype)


def transpose_infermeta(x: MetaTensor, perm: Sequence[int]) -> MetaTensor:
    perm = [_norm_axis(p, len(x.shape)) for p in perm]
    if sorted(perm) != list(range(len(x.shape))):
        raise ValueError(f"invalid perm {perm} for shape {x.shape}")
    return MetaTensor([x.shape[p] for p in perm], x.dtype)


def flatten_infermeta(x: MetaTensor, start_axis=0, stop_axis=-1) -> MetaTensor:
    nd = len(x.shape)
    if nd == 0:
        return MetaTensor((1,), x.dtype)
    a = _norm_axis(start_axis, nd)
    b = _norm_axis(stop_axis, nd)
    mid = int(np.prod(x.shape[a:b + 1])) if b >= a else 1
    return MetaTensor(x.shape[:a] + (mid,) + x.shape[b + 1:], x.dtype)


def squeeze_infermeta(x: MetaTensor, axis=None) -> MetaTensor:
    if axis is None:
        return MetaTensor([s for s in x.shape if s != 1], x.dtype)
    axes = [axis] if isinstance(axis, int) else list(axis)
    axes = {_norm_axis(a, len(x.shape)) for a in axes}
    out = [s for i, s in enumerate(x.shape) if not (i in axes and s == 1)]
    return MetaTensor(out, x.dtype)


def unsqueeze_infermeta(x: MetaTensor, axis) -> MetaTensor:
    axes = [axis] if isinstance(axis, int) else list(axis)
    out = list(x.shape)
    for a in sorted(_norm_axis(a, len(out) + 1) for a in axes):
        out.insert(a, 1)
    return MetaTensor(out, x.dtype)


def expand_infermeta(x: MetaTensor, shape: Sequence[int]) -> MetaTensor:
    out = list(shape)
    offset = len(out) - len(x.shape)
    for i, s in enumerate(out):
        if s == -1:
            j = i - offset
            if j < 0:
                raise ValueError("cannot infer -1 expand dim")
            out[i] = x.shape[j]
    broadcast_shape(x.shape, out)  # validates
    return MetaTensor(out, x.dtype)


def tile_infermeta(x: MetaTensor, repeat_times: Sequence[int]) -> MetaTensor:
    rt = list(repeat_times)
    shape = list(x.shape)
    if len(rt) < len(shape):
        rt = [1] * (len(shape) - len(rt)) + rt
    if len(shape) < len(rt):
        shape = [1] * (len(rt) - len(shape)) + shape
    return MetaTensor([s * r for s, r in zip(shape, rt)], x.dtype)


def pad_infermeta(x: MetaTensor, paddings: Sequence[int]) -> MetaTensor:
    """pad with [before0, after0, before1, after1, ...] (paddle order)."""
    out = list(x.shape)
    for i in range(len(paddings) // 2):
        out[i] += paddings[2 * i] + paddings[2 * i + 1]
    return MetaTensor(out, x.dtype)


def slice_infermeta(x: MetaTensor, axes, starts, ends) -> MetaTensor:
    out = list(x.shape)
    for ax, st, en in zip(axes, starts, ends):
        ax = _norm_axis(ax, len(out))
        n = out[ax]
        st = max(0, st + n if st < 0 else st)
        en = min(n, en + n if en < 0 else en)
        out[ax] = max(0, en - st)
    return MetaTensor(out, x.dtype)


# --------------------------------------------------------------- binary ops

def elementwise_infermeta(x: MetaTensor, y: MetaTensor) -> MetaTensor:
    """ElementwiseInferMeta: broadcast + dtype promotion."""
    shape = broadcast_shape(x.shape, y.shape)
    dt = _promote(x.dtype, y.dtype) \
        if x.dtype != y.dtype else x.dtype
    return MetaTensor(shape, dt)


def compare_infermeta(x: MetaTensor, y: MetaTensor) -> MetaTensor:
    return MetaTensor(broadcast_shape(x.shape, y.shape), np.bool_)


def matmul_infermeta(x: MetaTensor, y: MetaTensor, transpose_x=False,
                     transpose_y=False) -> MetaTensor:
    """MatmulInferMeta (phi/infermeta/binary.cc)."""
    xs, ys = list(x.shape), list(y.shape)
    vec_x = len(xs) == 1
    vec_y = len(ys) == 1
    if vec_x:
        xs = [1, xs[0]] if not transpose_x else [xs[0], 1]
    if vec_y:
        ys = [ys[0], 1] if not transpose_y else [1, ys[0]]
    if transpose_x:
        xs[-2], xs[-1] = xs[-1], xs[-2]
    if transpose_y:
        ys[-2], ys[-1] = ys[-1], ys[-2]
    if xs[-1] != ys[-2]:
        raise ValueError(f"matmul K mismatch: {x.shape} @ {y.shape}")
    batch = broadcast_shape(xs[:-2], ys[:-2])
    out = list(batch) + [xs[-2], ys[-1]]
    if vec_x:
        out.pop(-2)
    if vec_y:
        out.pop(-1)
    dt = _promote(x.dtype, y.dtype) \
        if x.dtype != y.dtype else x.dtype
    return MetaTensor(out, dt)


def embedding_infermeta(ids: MetaTensor, weight: MetaTensor) -> MetaTensor:
    return MetaTensor(ids.shape + (weight.shape[-1],), weight.dtype)


def gather_infermeta(x: MetaTensor, index: MetaTensor, axis=0) -> MetaTensor:
    ax = _norm_axis(axis, len(x.shape))
    out = list(x.shape)
    out[ax:ax + 1] = list(index.shape)
    return MetaTensor(out, x.dtype)


def index_select_infermeta(x: MetaTensor, index: MetaTensor,
                           axis=0) -> MetaTensor:
    ax = _norm_axis(axis, len(x.shape))
    out = list(x.shape)
    out[ax] = index.shape[0]
    return MetaTensor(out, x.dtype)


# -------------------------------------------------------------- multi-input

def concat_infermeta(xs: Sequence[MetaTensor], axis=0) -> MetaTensor:
    ax = _norm_axis(axis, len(xs[0].shape))
    out = list(xs[0].shape)
    out[ax] = sum(t.shape[ax] for t in xs)
    return MetaTensor(out, xs[0].dtype)


def stack_infermeta(xs: Sequence[MetaTensor], axis=0) -> MetaTensor:
    ax = _norm_axis(axis, len(xs[0].shape) + 1)
    out = list(xs[0].shape)
    out.insert(ax, len(xs))
    return MetaTensor(out, xs[0].dtype)


def split_infermeta(x: MetaTensor, num_or_sections, axis=0) \
        -> List[MetaTensor]:
    ax = _norm_axis(axis, len(x.shape))
    n = x.shape[ax]
    if isinstance(num_or_sections, int):
        if n % num_or_sections:
            raise ValueError(f"split: {n} not divisible by {num_or_sections}")
        sections = [n // num_or_sections] * num_or_sections
    else:
        sections = list(num_or_sections)
        rem = n - sum(s for s in sections if s > 0)
        sections = [rem if s in (-1,) else s for s in sections]
    outs = []
    for s in sections:
        shp = list(x.shape)
        shp[ax] = s
        outs.append(MetaTensor(shp, x.dtype))
    return outs


def where_infermeta(cond: MetaTensor, x: MetaTensor,
                    y: MetaTensor) -> MetaTensor:
    shape = broadcast_shape(broadcast_shape(cond.shape, x.shape), y.shape)
    return MetaTensor(shape, x.dtype)


def addmm_infermeta(input: MetaTensor, x: MetaTensor,
                    y: MetaTensor) -> MetaTensor:
    mm = matmul_infermeta(x, y)
    return MetaTensor(broadcast_shape(input.shape, mm.shape), mm.dtype)


# ----------------------------------------------------------------- nn ops

def _conv_out(in_size, k, stride, pad0, pad1, dilation):
    eff = (k - 1) * dilation + 1
    return (in_size + pad0 + pad1 - eff) // stride + 1


def conv2d_infermeta(x: MetaTensor, w: MetaTensor, stride=(1, 1),
                     padding=(0, 0), dilation=(1, 1),
                     data_format="NCHW") -> MetaTensor:
    """ConvInferMeta (phi/infermeta/binary.cc Conv variant), NCHW/NHWC."""
    def pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)
    s, d = pair(stride), pair(dilation)
    p = pair(padding) if not (isinstance(padding, (list, tuple))
                              and len(padding) == 4) else None
    if p is not None:
        pads = (p[0], p[0], p[1], p[1])
    else:
        pads = tuple(padding)
    co, kh, kw = w.shape[0], w.shape[2], w.shape[3]
    if data_format == "NCHW":
        n, h, wd = x.shape[0], x.shape[2], x.shape[3]
        oh = _conv_out(h, kh, s[0], pads[0], pads[1], d[0])
        ow = _conv_out(wd, kw, s[1], pads[2], pads[3], d[1])
        return MetaTensor((n, co, oh, ow), x.dtype)
    n, h, wd = x.shape[0], x.shape[1], x.shape[2]
    oh = _conv_out(h, kh, s[0], pads[0], pads[1], d[0])
    ow = _conv_out(wd, kw, s[1], pads[2], pads[3], d[1])
    return MetaTensor((n, oh, ow, co), x.dtype)


def pool2d_infermeta(x: MetaTensor, kernel_size, stride=None, padding=0,
                     ceil_mode=False, data_format="NCHW") -> MetaTensor:
    def pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)
    k = pair(kernel_size)
    s = pair(stride) if stride is not None else k
    p = pair(padding)
    rnd = math.ceil if ceil_mode else math.floor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        oh = int(rnd((h + 2 * p[0] - k[0]) / s[0])) + 1
        ow = int(rnd((w + 2 * p[1] - k[1]) / s[1])) + 1
        return MetaTensor((n, c, oh, ow), x.dtype)
    n, h, w, c = x.shape
    oh = int(rnd((h + 2 * p[0] - k[0]) / s[0])) + 1
    ow = int(rnd((w + 2 * p[1] - k[1]) / s[1])) + 1
    return MetaTensor((n, oh, ow, c), x.dtype)


def softmax_infermeta(x: MetaTensor, axis=-1) -> MetaTensor:
    _norm_axis(axis, len(x.shape))
    return MetaTensor(x.shape, x.dtype)


def cross_entropy_infermeta(logits: MetaTensor, label: MetaTensor,
                            reduction="mean") -> MetaTensor:
    if reduction in ("mean", "sum"):
        return MetaTensor((), logits.dtype)
    return MetaTensor(logits.shape[:-1], logits.dtype)


def layer_norm_infermeta(x: MetaTensor) -> MetaTensor:
    return MetaTensor(x.shape, x.dtype)


def one_hot_infermeta(x: MetaTensor, num_classes: int) -> MetaTensor:
    return MetaTensor(x.shape + (num_classes,),
                      dtype_mod.get_default_dtype())


# --------------------------------------------------------------- creation

def full_infermeta(shape: Sequence[int], dtype) -> MetaTensor:
    return MetaTensor(shape, dtype)


def arange_infermeta(start, end, step, dtype) -> MetaTensor:
    n = max(0, int(np.ceil((end - start) / step)))
    return MetaTensor((n,), dtype)


def tril_triu_infermeta(x: MetaTensor, diagonal=0) -> MetaTensor:
    return MetaTensor(x.shape, x.dtype)


def eye_infermeta(num_rows, num_columns=None, dtype=np.float32) -> MetaTensor:
    return MetaTensor((num_rows, num_columns or num_rows), dtype)


# ------------------------------------------------------------ the fallback

def _meta_of(out):
    from .tensor import Tensor
    if isinstance(out, Tensor):
        out = out._data
    return MetaTensor(tuple(out.shape), out.dtype)


def _run(kernel, metas, kwargs, make):
    from .tensor import Tensor
    torch_kernel = not getattr(kernel, "__module__", "").startswith(
        "paddle_tpu_torch")
    args = []
    for m in metas:
        if isinstance(m, MetaTensor):
            a = make(m)
            args.append(a if torch_kernel else Tensor._wrap(a))
        else:
            args.append(m)
    out = kernel(*args, **kwargs)
    if isinstance(out, (tuple, list)):
        return [_meta_of(o) for o in out]
    return _meta_of(out)


def infer_via_eval_shape(kernel, *metas, **kwargs):
    """Generic InferMeta: run the kernel itself on tensors that hold no
    data. ``kernel`` is an op of the port (taking Tensors) or a function
    of torch tensors. First on the meta device; where the op reads a
    value on the host, which the meta device refuses, under torch's
    ``FakeTensorMode``, which gives such reads a value only where the
    output's shape does not depend on it (so ``unique`` and ``nonzero``
    raise, as under ``jax.eval_shape``)."""
    def on_meta(m):
        return torch.empty(m.shape, dtype=m.dtype.torch, device="meta")
    try:
        return _run(kernel, metas, kwargs, on_meta)
    except (NotImplementedError, RuntimeError):
        pass
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return _run(kernel, metas, kwargs,
                    lambda m: torch.empty(m.shape, dtype=m.dtype.torch))


# Registry: op name -> explicit meta function (the static IR consults this
# first, then falls back to infer_via_eval_shape).
INFER_META = {
    "cast": cast_infermeta,
    "reshape": reshape_infermeta,
    "transpose": transpose_infermeta,
    "flatten": flatten_infermeta,
    "squeeze": squeeze_infermeta,
    "unsqueeze": unsqueeze_infermeta,
    "expand": expand_infermeta,
    "tile": tile_infermeta,
    "matmul": matmul_infermeta,
    "embedding": embedding_infermeta,
    "gather": gather_infermeta,
    "index_select": index_select_infermeta,
    "concat": concat_infermeta,
    "stack": stack_infermeta,
    "split": split_infermeta,
    "where": where_infermeta,
    "addmm": addmm_infermeta,
    "conv2d": conv2d_infermeta,
    "pool2d": pool2d_infermeta,
    "softmax": softmax_infermeta,
    "layer_norm": layer_norm_infermeta,
    "one_hot": one_hot_infermeta,
    "tril": tril_triu_infermeta,
    "triu": tril_triu_infermeta,
}
