"""Op library + Tensor method patching: the port of
``paddle_tpu/ops/__init__.py``.

The method patch mirrors the reference's eager math-op patch
(fluid/pybind/eager_math_op_patch.cc + tensor_patch_methods.py): the dunders
and the methods of Tensor are bound here, so that the op implementations
live in one place.
"""
from __future__ import annotations

import torch

from . import creation, math, manipulation, logic, search, linalg, random

from ..core.tensor import Tensor


def _binary_dunder(fn, reverse=False):
    def method(self, other):
        if reverse:
            return fn(other, self)
        return fn(self, other)
    return method


def _patch_tensor_methods():
    T = Tensor
    # arithmetic
    T.__add__ = _binary_dunder(math.add)
    T.__radd__ = _binary_dunder(math.add, True)
    T.__sub__ = _binary_dunder(math.subtract)
    T.__rsub__ = _binary_dunder(math.subtract, True)
    T.__mul__ = _binary_dunder(math.multiply)
    T.__rmul__ = _binary_dunder(math.multiply, True)
    T.__truediv__ = _binary_dunder(math.divide)
    T.__rtruediv__ = _binary_dunder(math.divide, True)
    T.__floordiv__ = _binary_dunder(math.floor_divide)
    T.__rfloordiv__ = _binary_dunder(math.floor_divide, True)
    T.__mod__ = _binary_dunder(math.remainder)
    T.__rmod__ = _binary_dunder(math.remainder, True)
    T.__pow__ = _binary_dunder(math.pow)
    T.__rpow__ = lambda self, other: math.pow(
        creation.to_tensor(other, dtype=self.dtype, place=self.place), self)
    T.__neg__ = lambda self: math.neg(self)
    T.__abs__ = lambda self: math.abs(self)
    T.__matmul__ = _binary_dunder(linalg.matmul)
    T.__rmatmul__ = _binary_dunder(linalg.matmul, True)
    # comparison
    T.__eq__ = _binary_dunder(logic.equal)
    T.__ne__ = _binary_dunder(logic.not_equal)
    T.__lt__ = _binary_dunder(logic.less_than)
    T.__le__ = _binary_dunder(logic.less_equal)
    T.__gt__ = _binary_dunder(logic.greater_than)
    T.__ge__ = _binary_dunder(logic.greater_equal)
    # bitwise / logical
    T.__and__ = _binary_dunder(logic.bitwise_and)
    T.__or__ = _binary_dunder(logic.bitwise_or)
    T.__xor__ = _binary_dunder(logic.bitwise_xor)
    T.__invert__ = lambda self: logic.bitwise_not(self)
    T.__lshift__ = _binary_dunder(logic.bitwise_left_shift)
    T.__rshift__ = _binary_dunder(logic.bitwise_right_shift)
    # indexing
    T.__getitem__ = manipulation.getitem
    T.__setitem__ = manipulation.setitem

    methods = {
        # math
        "add": math.add, "add_": math.add_, "subtract": math.subtract,
        "subtract_": math.subtract_, "multiply": math.multiply,
        "multiply_": math.multiply_, "divide": math.divide,
        "divide_": math.divide_, "floor_divide": math.floor_divide,
        "remainder": math.remainder, "mod": math.mod, "pow": math.pow,
        "maximum": math.maximum, "minimum": math.minimum, "fmax": math.fmax,
        "fmin": math.fmin, "exp": math.exp, "exp_": math.exp_,
        "expm1": math.expm1, "log": math.log, "log2": math.log2,
        "log10": math.log10, "log1p": math.log1p, "sqrt": math.sqrt,
        "sqrt_": math.sqrt_, "rsqrt": math.rsqrt, "square": math.square,
        "abs": math.abs, "sign": math.sign, "floor": math.floor,
        "ceil": math.ceil, "round": math.round, "trunc": math.trunc,
        "frac": math.frac, "sin": math.sin, "cos": math.cos, "tan": math.tan,
        "asin": math.asin, "acos": math.acos, "atan": math.atan,
        "sinh": math.sinh, "cosh": math.cosh, "tanh": math.tanh,
        "asinh": math.asinh, "acosh": math.acosh, "atanh": math.atanh,
        "atan2": math.atan2, "reciprocal": math.reciprocal,
        "sigmoid": math.sigmoid, "erf": math.erf, "erfinv": math.erfinv,
        "lgamma": math.lgamma, "digamma": math.digamma, "neg": math.neg,
        "conj": math.conj, "angle": math.angle, "scale": math.scale,
        "scale_": math.scale_, "clip": math.clip, "clip_": math.clip_,
        "lerp": math.lerp, "nan_to_num": math.nan_to_num,
        "addmm": math.addmm, "inner": math.inner, "outer": math.outer,
        "kron": math.kron, "trace": math.trace, "diagonal": math.diagonal,
        "diff": math.diff, "cumsum": math.cumsum, "cumprod": math.cumprod,
        "cummax": math.cummax, "cummin": math.cummin,
        "logcumsumexp": math.logcumsumexp, "logsumexp": math.logsumexp,
        "sum": math.sum, "mean": math.mean, "prod": math.prod,
        "max": math.max, "min": math.min, "amax": math.amax,
        "amin": math.amin, "std": math.std, "var": math.var,
        "nansum": math.nansum, "nanmean": math.nanmean,
        "isnan": math.isnan, "isinf": math.isinf,
        "isfinite": math.isfinite, "isclose": math.isclose,
        "allclose": math.allclose, "equal_all": math.equal_all,
        "all": math.all, "any": math.any,
        "count_nonzero": math.count_nonzero, "zero_": math.zero_,
        "fill_": math.fill_, "real": math.real, "imag": math.imag,
        "stanh": math.stanh, "rad2deg": math.rad2deg,
        "deg2rad": math.deg2rad, "heaviside": math.heaviside,
        "hypot": math.hypot, "gcd": math.gcd, "lcm": math.lcm,
        # logic
        "equal": logic.equal, "not_equal": logic.not_equal,
        "greater_than": logic.greater_than,
        "greater_equal": logic.greater_equal, "less_than": logic.less_than,
        "less_equal": logic.less_equal, "logical_and": logic.logical_and,
        "logical_or": logic.logical_or, "logical_xor": logic.logical_xor,
        "logical_not": logic.logical_not, "bitwise_and": logic.bitwise_and,
        "bitwise_or": logic.bitwise_or, "bitwise_xor": logic.bitwise_xor,
        "bitwise_not": logic.bitwise_not, "is_empty": logic.is_empty,
        # manipulation
        "cast": manipulation.cast, "cast_": manipulation.cast_,
        "astype": manipulation.cast,
        "reshape": manipulation.reshape, "reshape_": manipulation.reshape_,
        "view": manipulation.view, "view_as": manipulation.view_as,
        "flatten": manipulation.flatten, "flatten_": manipulation.flatten_,
        "transpose": manipulation.transpose,
        "moveaxis": manipulation.moveaxis, "swapaxes": manipulation.swapaxes,
        "squeeze": manipulation.squeeze, "squeeze_": manipulation.squeeze_,
        "unsqueeze": manipulation.unsqueeze,
        "unsqueeze_": manipulation.unsqueeze_,
        "split": manipulation.split, "chunk": manipulation.chunk,
        "unbind": manipulation.unbind, "expand": manipulation.expand,
        "broadcast_to": manipulation.broadcast_to,
        "expand_as": manipulation.expand_as, "tile": manipulation.tile,
        "repeat_interleave": manipulation.repeat_interleave,
        "flip": manipulation.flip, "rot90": manipulation.rot90,
        "roll": manipulation.roll, "gather": manipulation.gather,
        "gather_nd": manipulation.gather_nd, "take": manipulation.take,
        "take_along_axis": manipulation.take_along_axis,
        "put_along_axis": manipulation.put_along_axis,
        "scatter": manipulation.scatter, "scatter_": manipulation.scatter_,
        "scatter_nd_add": manipulation.scatter_nd_add,
        "index_select": manipulation.index_select,
        "index_sample": manipulation.index_sample,
        "index_add": manipulation.index_add,
        "index_put": manipulation.index_put,
        "index_fill": manipulation.index_fill,
        "masked_select": manipulation.masked_select,
        "masked_fill": manipulation.masked_fill,
        "masked_fill_": manipulation.masked_fill_,
        "where": manipulation.where, "numel": manipulation.numel,
        "pad": manipulation.pad, "unfold": manipulation.unfold,
        "as_complex": manipulation.as_complex,
        "as_real": manipulation.as_real,
        "tensordot": manipulation.tensordot,
        "tril": creation.tril, "triu": creation.triu, "diag": creation.diag,
        "diag_embed": creation.diag_embed,
        "fill_diagonal_": None,
        # search
        "argmax": search.argmax, "argmin": search.argmin,
        "argsort": search.argsort, "sort": search.sort, "topk": search.topk,
        "kthvalue": search.kthvalue, "mode": search.mode,
        "nonzero": search.nonzero, "searchsorted": search.searchsorted,
        "bucketize": search.bucketize, "median": search.median,
        "nanmedian": search.nanmedian, "quantile": search.quantile,
        "unique": search.unique,
        "unique_consecutive": search.unique_consecutive,
        "histogram": search.histogram, "bincount": search.bincount,
        # linalg
        "matmul": linalg.matmul, "mm": linalg.mm, "bmm": linalg.bmm,
        "mv": linalg.mv, "dot": linalg.dot, "cross": linalg.cross,
        "norm": linalg.norm, "dist": linalg.dist,
        "cholesky": linalg.cholesky, "inverse": linalg.inverse,
        "pinv": linalg.pinv, "solve": linalg.solve,
        "matrix_power": linalg.matrix_power, "det": linalg.det,
        "qr": linalg.qr, "svd": linalg.svd, "eigh": linalg.eigh,
        "cov": linalg.cov, "corrcoef": linalg.corrcoef, "t": linalg.t,
        # random (inplace)
        "uniform_": random.uniform_, "normal_": random.normal_,
        "exponential_": random.exponential_, "bernoulli_": random.bernoulli_,
        "multinomial": random.multinomial,
    }
    for name, fn in methods.items():
        if fn is not None:
            setattr(T, name, fn)

    def fill_diagonal_(self, value, offset=0, wrap=False, name=None):
        a = self._data.detach()
        n = min(a.shape[-2], a.shape[-1])
        idx = torch.arange(n - (offset if offset > 0 else 0), device=a.device)
        r = idx + (-offset if offset < 0 else 0)
        c = idx + (offset if offset > 0 else 0)
        out = a.clone()
        out[..., r, c] = value
        self._assign_array(out)
        return self
    T.fill_diagonal_ = fill_diagonal_


_patch_tensor_methods()
