"""Comparison / logical / bitwise ops: the port of ``paddle_tpu/ops/logic.py``
(reference: python/paddle/tensor/logic.py)."""
from __future__ import annotations

import torch

from ..core.dispatch import run_op
from ..core.tensor import Tensor
from .math import _is_scalar, _promote_binary


def _cmp(op_name, f):
    def op(x, y, name=None):
        if isinstance(x, Tensor) and _is_scalar(y):
            return run_op(op_name, lambda a: f(a, y), x, differentiable=False)
        x, y = _promote_binary(x, y)
        return run_op(op_name, f, x, y, differentiable=False)
    op.__name__ = op_name
    return op


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)

logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)

bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)


def logical_not(x, name=None):
    return run_op("logical_not", torch.logical_not, x, differentiable=False)


def bitwise_not(x, name=None):
    return run_op("bitwise_not", torch.bitwise_not, x, differentiable=False)


def bitwise_left_shift(x, y, is_arithmetic=True, name=None):
    return _cmp("bitwise_left_shift", torch.bitwise_left_shift)(x, y)


def bitwise_right_shift(x, y, is_arithmetic=True, name=None):
    return _cmp("bitwise_right_shift", torch.bitwise_right_shift)(x, y)


def is_empty(x, name=None):
    return Tensor._wrap(torch.tensor(x.size == 0, device=x._data.device))


def is_tensor(x):
    return isinstance(x, Tensor)
