"""Tensor creation ops: the port of ``paddle_tpu/ops/creation.py``
(reference: python/paddle/tensor/creation.py). New tensors land on the
current place (``set_device``), ``*_like`` ones beside their input."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtype as dtype_mod
from ..core.dispatch import run_op
from ..core.place import default_device
from ..core.tensor import Tensor


def _dt(dtype, default_float=True):
    d = dtype_mod.convert_dtype(dtype)
    if d is None and default_float:
        d = dtype_mod.get_default_dtype()
    return None if d is None else d.torch


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)


def _shape_tuple(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item() if isinstance(s, Tensor) else s) for s in shape)


def _v(x):
    return x.item() if isinstance(x, Tensor) else x


def zeros(shape, dtype=None, name=None):
    return Tensor._wrap(torch.zeros(_shape_tuple(shape), dtype=_dt(dtype),
                                    device=default_device()))


def ones(shape, dtype=None, name=None):
    return Tensor._wrap(torch.ones(_shape_tuple(shape), dtype=_dt(dtype),
                                   device=default_device()))


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _v(fill_value)
    d = _dt(dtype, default_float=False)
    if d is None:
        # paddle.full defaults to float32 for numeric fills, bool for bool
        d = torch.bool if isinstance(fill_value, bool) \
            else dtype_mod.get_default_dtype().torch
    return Tensor._wrap(torch.full(_shape_tuple(shape), fill_value, dtype=d,
                                   device=default_device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    return Tensor._wrap(torch.zeros_like(x._data, dtype=_dt(dtype, False)))


def ones_like(x, dtype=None, name=None):
    return Tensor._wrap(torch.ones_like(x._data, dtype=_dt(dtype, False)))


def full_like(x, fill_value, dtype=None, name=None):
    return Tensor._wrap(torch.full_like(x._data, _v(fill_value),
                                        dtype=_dt(dtype, False)))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _v(start), _v(end), _v(step)
    if end is None:
        start, end = 0, start
    d = _dt(dtype, default_float=False)
    if d is None:
        d = torch.int64 if all(isinstance(v, (int, np.integer))
                               for v in (start, end, step)) \
            else dtype_mod.get_default_dtype().torch
    return Tensor._wrap(torch.arange(start, end, step, dtype=d,
                                     device=default_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return Tensor._wrap(torch.linspace(_v(start), _v(stop), int(_v(num)),
                                       dtype=_dt(dtype),
                                       device=default_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return Tensor._wrap(torch.logspace(_v(start), _v(stop), int(_v(num)),
                                       base=_v(base), dtype=_dt(dtype),
                                       device=default_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = int(num_columns) if num_columns else n
    return Tensor._wrap(torch.eye(n, m, dtype=_dt(dtype),
                                  device=default_device()))


def _diag_index(n, offset, device):
    idx = torch.arange(n, device=device)
    return (idx, idx + offset) if offset >= 0 else (idx - offset, idx)


def diag(x, offset=0, padding_value=0, name=None):
    def f(a):
        if a.dim() == 1 and padding_value != 0:
            n = a.shape[0] + abs(offset)
            base = torch.full((n, n), padding_value, dtype=a.dtype,
                              device=a.device)
            r, c = _diag_index(a.shape[0], offset, a.device)
            return base.index_put((r, c), a)
        return torch.diag(a, offset)
    return run_op("diag", f, x)


def diagflat(x, offset=0, name=None):
    return run_op("diagflat", lambda a: torch.diagflat(a, offset), x)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return run_op("diag_embed",
                  lambda a: torch.diag_embed(a, offset, dim1, dim2), x)


def meshgrid(*args, **kwargs):
    tensors = args[0] if len(args) == 1 \
        and isinstance(args[0], (list, tuple)) else args
    outs = run_op("meshgrid",
                  lambda *xs: tuple(torch.meshgrid(*xs, indexing="ij")),
                  *tensors)
    return list(outs) if isinstance(outs, tuple) else [outs]


def tril(x, diagonal=0, name=None):
    return run_op("tril", lambda a: torch.tril(a, diagonal), x)


def triu(x, diagonal=0, name=None):
    return run_op("triu", lambda a: torch.triu(a, diagonal), x)


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = col if col is not None else row
    return Tensor._wrap(torch.tril_indices(row, col, offset,
                                           dtype=_dt(dtype),
                                           device=default_device()))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = col if col is not None else row
    return Tensor._wrap(torch.triu_indices(row, col, offset,
                                           dtype=_dt(dtype),
                                           device=default_device()))


def assign(x, output=None):
    src = x._data.detach() if isinstance(x, Tensor) else \
        Tensor(x)._data
    if output is None:
        return Tensor._wrap(src)
    output._assign_array(src.to(output._data.dtype))
    return output


def clone(x, name=None):
    return x.clone()


def complex(real, imag, name=None):
    return run_op("complex", torch.complex, real, imag)


def polar(abs, angle, name=None):
    return run_op("polar", torch.polar, abs, angle)


def one_hot(x, num_classes, name=None):
    return run_op("one_hot",
                  lambda a: F.one_hot(a.long(), num_classes).to(
                      dtype_mod.get_default_dtype().torch),
                  x, differentiable=False)


def create_tensor(dtype, name=None, persistable=False):
    """An empty typed Tensor placeholder (reference tensor/creation.py:265)."""
    return Tensor._wrap(torch.zeros((), dtype=_dt(dtype),
                                    device=default_device()))
