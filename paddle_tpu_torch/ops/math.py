"""Elementwise and reduction math ops: the port of ``paddle_tpu/ops/math.py``
(reference: python/paddle/tensor/math.py). Each op is one torch function
dispatched through ``run_op``, which handles AMP, autograd and NaN checks.

Promotion as in the reference: a python scalar keeps the tensor's dtype (a
float scalar lifts an integer tensor to the default float dtype), two
tensors promote through the dtype lattice.
"""
from __future__ import annotations

import builtins as _builtins

import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import _as_array, run_op, run_op_inplace
from ..core.tensor import Tensor
from .linalg import promoted


def _is_scalar(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _to_default_float(x):
    return Tensor._wrap(x._data.to(dtype_mod.get_default_dtype().torch),
                        x.stop_gradient)


def _as_tensor(v, like):
    """A non-scalar operand (array, list, bool) as a Tensor beside ``like``."""
    return Tensor._wrap(_as_array(v, like._data.device))


def _promote_binary(x, y):
    """Both operands as Tensors of one dtype (the reference's
    ``_promote_binary``, with casts recorded as ops)."""
    from .manipulation import cast
    if isinstance(x, Tensor) and not isinstance(y, Tensor):
        y = _scalar_tensor(y, x) if _is_scalar(y) else _as_tensor(y, x)
        if isinstance(y, Tensor) and y.dtype != x.dtype and _is_float(y) \
                and not _is_float(x):
            x = cast(x, y.dtype)
    elif isinstance(y, Tensor) and not isinstance(x, Tensor):
        x = _scalar_tensor(x, y) if _is_scalar(x) else _as_tensor(x, y)
        if x.dtype != y.dtype and _is_float(x) and not _is_float(y):
            y = cast(y, x.dtype)
    if x.dtype != y.dtype:
        d = dtype_mod.promote_types(x.dtype, y.dtype)
        x = cast(x, d) if x.dtype != d else x
        y = cast(y, d) if y.dtype != d else y
    return x, y


def _is_float(t):
    return t._data.is_floating_point() or t._data.is_complex()


def _scalar_tensor(s, like):
    dt = like._data.dtype
    if isinstance(s, float) and not (dt.is_floating_point or dt.is_complex):
        dt = dtype_mod.get_default_dtype().torch
    return Tensor._wrap(torch.full((), s, dtype=dt, device=like._data.device))


def _binop(op_name, f, scalar_ok=False):
    """A binary op. ``scalar_ok``: ``f`` takes a python scalar on either
    side (it is written with operators), so a scalar operand is passed as
    it is, with no tensor made for it."""
    def op(x, y, name=None):
        if scalar_ok and isinstance(x, Tensor) and _is_scalar(y):
            if isinstance(y, float) and not _is_float(x):
                x = _to_default_float(x)
            return run_op(op_name, lambda a: f(a, y), x)
        if scalar_ok and isinstance(y, Tensor) and _is_scalar(x):
            if isinstance(x, float) and not _is_float(y):
                y = _to_default_float(y)
            return run_op(op_name, lambda b: f(x, b), y)
        x, y = _promote_binary(x, y)
        return run_op(op_name, f, x, y)
    op.__name__ = op_name
    return op


add = _binop("add", lambda a, b: a + b, True)
subtract = _binop("subtract", lambda a, b: a - b, True)
multiply = _binop("multiply", lambda a, b: a * b, True)
divide = _binop("divide", lambda a, b: a / b, True)
def _no_grad(v):
    return v.detach() if isinstance(v, torch.Tensor) else v


# floor division is piecewise constant: its gradient is zero, as jax's is
# (torch defines none)
floor_divide = _binop("floor_divide",
                      lambda a, b: _no_grad(a) // _no_grad(b), True)
remainder = _binop("remainder", lambda a, b: a % b, True)
mod = remainder
floor_mod = remainder
fmod = _binop("fmod", torch.fmod)
maximum = _binop("maximum", torch.maximum)
minimum = _binop("minimum", torch.minimum)
# fmax/fmin as jnp's selects: a tie passes the gradient to ``y`` (torch's
# own split it between the two)
fmax = _binop("fmax", lambda a, b: torch.where(torch.isnan(b) | (a > b), a, b))
fmin = _binop("fmin", lambda a, b: torch.where(torch.isnan(b) | (a < b), a, b))
# at the origin torch's gradient is 0 where jax's is NaN: not mirrored
atan2 = _binop("atan2", torch.atan2)
hypot = _binop("hypot", lambda a, b: torch.sqrt(a * a + b * b))


def _heaviside(a, b):
    """``jnp.heaviside``'s where: piecewise constant in ``x`` (a zero
    gradient, as floor_divide's), ``y`` taken where ``x == 0``."""
    a = _no_grad(a)
    return torch.where(a < 0, 0.0, torch.where(a > 0, 1.0, b))


heaviside = _binop("heaviside", _heaviside)
gcd = _binop("gcd", torch.gcd)
lcm = _binop("lcm", torch.lcm)
nextafter = _binop("nextafter", torch.nextafter)
copysign = _binop("copysign", torch.copysign)
logaddexp = _binop("logaddexp", torch.logaddexp)


def pow(x, y, name=None):
    if _is_scalar(y):
        if isinstance(y, float) and not _is_float(x):
            x = _to_default_float(x)
        return run_op("pow", lambda a: torch.pow(a, y), x)
    return _binop("elementwise_pow", torch.pow)(x, y)


def _unary(op_name, f):
    def op(x, name=None):
        return run_op(op_name, f, x)
    op.__name__ = op_name
    return op


def _float_unary(op_name, f):
    """Unary op that lifts integer inputs to the default float dtype (paddle
    activation-op semantics)."""
    def op(x, name=None):
        if isinstance(x, Tensor) and not _is_float(x):
            x = _to_default_float(x)
        return run_op(op_name, f, x)
    op.__name__ = op_name
    return op


exp = _float_unary("exp", torch.exp)
expm1 = _float_unary("expm1", torch.expm1)
log = _float_unary("log", torch.log)
log2 = _float_unary("log2", torch.log2)
log10 = _float_unary("log10", torch.log10)
log1p = _float_unary("log1p", torch.log1p)
sqrt = _float_unary("sqrt", torch.sqrt)
rsqrt = _float_unary("rsqrt", torch.rsqrt)
square = _unary("square", torch.square)
def jax_abs(a):
    """``abs`` with jax's derivative at 0, 1 (torch's is 0); the same
    values: the ``+ 0.0`` turns the ``-0.0`` that the select keeps into 0."""
    if a.is_complex() or not a.is_floating_point():
        return torch.abs(a)
    return torch.where(a >= 0, a, -a) + 0.0


def jax_clip(a, lo=None, hi=None):
    """``jnp.clip``: ``minimum(maximum(a, lo), hi)``, so a value at a bound
    passes half its gradient, as jax splits a tie (torch's clamp passes
    all of it). Non-float tensors keep torch's clamp."""
    if not a.is_floating_point():
        return torch.clamp(a, lo, hi)
    if lo is not None:
        a = torch.maximum(a, torch.full((), lo, dtype=a.dtype,
                                        device=a.device))
    if hi is not None:
        a = torch.minimum(a, torch.full((), hi, dtype=a.dtype,
                                        device=a.device))
    return a


abs = _unary("abs", jax_abs)
sign = _unary("sign", torch.sign)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)
trunc = _unary("trunc", torch.trunc)
frac = _unary("frac", lambda a: a - torch.trunc(a))
sin = _float_unary("sin", torch.sin)
cos = _float_unary("cos", torch.cos)
tan = _float_unary("tan", torch.tan)
asin = _float_unary("asin", torch.asin)
acos = _float_unary("acos", torch.acos)
atan = _float_unary("atan", torch.atan)
sinh = _float_unary("sinh", torch.sinh)
cosh = _float_unary("cosh", torch.cosh)
tanh = _float_unary("tanh", torch.tanh)
asinh = _float_unary("asinh", torch.asinh)
acosh = _float_unary("acosh", torch.acosh)
atanh = _float_unary("atanh", torch.atanh)
reciprocal = _float_unary("reciprocal", lambda a: 1.0 / a)
sigmoid = _float_unary("sigmoid", torch.sigmoid)
logit = _float_unary("logit", lambda a: torch.log(a / (1 - a)))
erf = _float_unary("erf", torch.erf)
erfinv = _float_unary("erfinv", torch.erfinv)
lgamma = _float_unary("lgamma", torch.lgamma)
digamma = _float_unary("digamma", torch.digamma)
i0 = _float_unary("i0", torch.special.i0)
i1 = _float_unary("i1", torch.special.i1)
i0e = _float_unary("i0e", torch.special.i0e)
i1e = _float_unary("i1e", torch.special.i1e)
neg = _unary("neg", torch.neg)
conj = _unary("conj", lambda a: torch.conj(a).resolve_conj())
angle = _unary("angle", torch.angle)
deg2rad = _float_unary("deg2rad", torch.deg2rad)
rad2deg = _float_unary("rad2deg", torch.rad2deg)


def real(x, name=None):
    return run_op("real", lambda a: torch.real(a).clone(), x)


def imag(x, name=None):
    """Zeros of a real input's dtype, with a zero gradient, as ``jnp.imag``
    gives (torch refuses a real input)."""
    return run_op("imag", lambda a: torch.imag(a).clone() if a.is_complex()
                  else torch.zeros_like(_no_grad(a)), x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return run_op("stanh", lambda a: scale_b * torch.tanh(scale_a * a), x)


def multiplex(inputs, index, name=None):
    def f(idx, *xs):
        stacked = torch.stack(xs, 0)
        idx = idx.long().reshape(1, -1, *([1] * (stacked.dim() - 2)))
        return torch.take_along_dim(stacked, idx, dim=0)[0]
    return run_op("multiplex", f, index, *inputs)


def _scalars_for(a, *vals):
    """The reference casts scalar operands to the tensor's dtype."""
    if a.is_floating_point() or a.is_complex():
        return vals
    return tuple(int(v) for v in vals)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    s = scale.item() if isinstance(scale, Tensor) else scale

    def f(a):
        sv, bv = _scalars_for(a, s, bias)
        return a * sv + bv if bias_after_scale else (a + bv) * sv
    return run_op("scale", f, x)


def _clip_fn(lo, hi):
    if lo is None and hi is None:
        return lambda a: a
    return lambda a: jax_clip(a, lo, hi)


def clip(x, min=None, max=None, name=None):
    lo = min.item() if isinstance(min, Tensor) else min
    hi = max.item() if isinstance(max, Tensor) else max
    return run_op("clip", _clip_fn(lo, hi), x)


def clip_(x, min=None, max=None, name=None):
    lo = min.item() if isinstance(min, Tensor) else min
    hi = max.item() if isinstance(max, Tensor) else max
    return run_op_inplace("clip_", _clip_fn(lo, hi), x)


def lerp(x, y, weight, name=None):
    if isinstance(weight, Tensor):
        return run_op("lerp", lambda a, b, w: a + w * (b - a), x, y, weight)
    return run_op("lerp", lambda a, b: a + weight * (b - a), x, y)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return run_op("nan_to_num",
                  lambda a: torch.nan_to_num(a, nan=nan, posinf=posinf,
                                             neginf=neginf), x)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return run_op("addmm",
                  lambda i, a, b: beta * i + alpha * torch.matmul(
                      *promoted(a, b)),
                  input, x, y)


def inner(x, y, name=None):
    return run_op("inner", torch.inner, x, y)


def outer(x, y, name=None):
    return run_op("outer",
                  lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)), x, y)


def kron(x, y, name=None):
    return run_op("kron", torch.kron, x, y)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return run_op("trace",
                  lambda a: torch.diagonal(a, offset, axis1, axis2).sum(-1), x)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return run_op("diagonal",
                  lambda a: torch.diagonal(a, offset, axis1, axis2), x)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    ins = [x]
    has_p = prepend is not None
    has_a = append is not None
    if has_p:
        ins.append(prepend)
    if has_a:
        ins.append(append)

    def f(a, *rest):
        p = rest[0] if has_p else None
        ap = rest[int(has_p)] if has_a else None
        return torch.diff(a, n=n, dim=axis, prepend=p, append=ap)
    return run_op("diff", f, *ins)


def _flat_axis(a, axis):
    return (a.reshape(-1), 0) if axis is None else (a, axis)


def cumsum(x, axis=None, dtype=None, name=None):
    d = dtype_mod.torch_dtype(dtype)
    return run_op("cumsum",
                  lambda a: torch.cumsum(*_flat_axis(a, axis), dtype=d), x)


def cumprod(x, dim=None, dtype=None, name=None):
    d = dtype_mod.torch_dtype(dtype)
    return run_op("cumprod",
                  lambda a: torch.cumprod(*_flat_axis(a, dim), dtype=d), x)


def _cum_extreme(op_name, fn):
    def op(x, axis=None, dtype="int64", name=None):
        d = dtype_mod.torch_dtype(dtype)

        def f(a):
            vals, idx = fn(*_flat_axis(a, axis))
            return vals, idx.to(d)
        return run_op(op_name, f, x)
    op.__name__ = op_name
    return op


def _interleave(a, b, axis):
    """a[0], b[0], a[1], b[1], ... along ``axis`` (len(a) - len(b) in
    {0, 1})."""
    n = b.shape[axis]
    pairs = torch.stack([a.narrow(axis, 0, n), b], axis + 1)
    out = pairs.flatten(axis, axis + 1)
    if a.shape[axis] > n:
        out = torch.cat([out, a.narrow(axis, n, 1)], axis)
    return out


def _assoc_scan(fn, a, axis):
    """``jax.lax.associative_scan``'s recursion (odd/even halving) in torch:
    the same tree of ``fn`` calls, so ties split their gradient as the
    reference's cummax/cummin split them."""
    n = a.shape[axis]
    if n < 2:
        return a
    ev = a.narrow(axis, 0, n - 1 if n % 2 else n)
    odd_in = fn(_stride2(ev, axis, 0), _stride2(a, axis, 1))
    odd = _assoc_scan(fn, odd_in, axis)
    rest = _stride2(a, axis, 2)
    if n % 2 == 0:
        even = fn(odd.narrow(axis, 0, odd.shape[axis] - 1), rest)
    else:
        even = fn(odd, rest)
    even = torch.cat([a.narrow(axis, 0, 1), even], axis)
    return _interleave(even, odd, axis)


def _stride2(a, axis, start):
    idx = [slice(None)] * a.dim()
    idx[axis] = slice(start, None, 2)
    return a[tuple(idx)]


def _scan_extreme(torch_fn, combine):
    """Indices from torch's cummax/cummin, values from the reference's scan
    (the same values; its gradient splits ties)."""
    def fn(a, dim):
        vals, idx = torch_fn(a, dim)
        if a.is_floating_point() and a.dim():
            vals = _assoc_scan(combine, a, dim % a.dim())
        return vals, idx
    return fn


cummax = _cum_extreme("cummax", _scan_extreme(torch.cummax, torch.maximum))
cummin = _cum_extreme("cummin", _scan_extreme(torch.cummin, torch.minimum))


def logcumsumexp(x, axis=None, dtype=None, name=None):
    return run_op("logcumsumexp",
                  lambda a: torch.logcumsumexp(*_flat_axis(a, axis)), x)


# ------------------------------ reductions ---------------------------------
def _axis_arg(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(ax, a):
    return tuple(range(a.dim())) if ax is None else ax


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    d = dtype_mod.torch_dtype(dtype)

    def f(a):
        out_dtype = d
        if out_dtype is None and not (a.is_floating_point() or a.is_complex()):
            out_dtype = torch.int64
        return torch.sum(a, dim=_dims(ax, a), keepdim=keepdim,
                         dtype=out_dtype)
    return run_op("sum", f, x)


def mean(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    if isinstance(x, Tensor) and not _is_float(x):
        x = _to_default_float(x)
    return run_op("mean",
                  lambda a: torch.mean(a, dim=_dims(ax, a), keepdim=keepdim),
                  x)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    ax = _axis_arg(axis)
    d = dtype_mod.torch_dtype(dtype)

    def f(a):
        if d is not None:
            a = a.to(d)
        if ax is None:
            out = torch.prod(a)
            return out.reshape([1] * a.dim()) if keepdim else out
        dims = ax if isinstance(ax, tuple) else (ax,)
        for dim in sorted((i % a.dim() for i in dims), reverse=True):
            a = torch.prod(a, dim, keepdim=keepdim)
        return a
    return run_op("prod", f, x)


def max(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return run_op("max",
                  lambda a: torch.amax(a, dim=_dims(ax, a), keepdim=keepdim),
                  x)


def min(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return run_op("min",
                  lambda a: torch.amin(a, dim=_dims(ax, a), keepdim=keepdim),
                  x)


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return run_op("std",
                  lambda a: torch.std(a, dim=_dims(ax, a),
                                      correction=1 if unbiased else 0,
                                      keepdim=keepdim), x)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return run_op("var",
                  lambda a: torch.var(a, dim=_dims(ax, a),
                                      correction=1 if unbiased else 0,
                                      keepdim=keepdim), x)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    d = dtype_mod.torch_dtype(dtype)
    return run_op("nansum",
                  lambda a: torch.nansum(a, dim=_dims(ax, a), keepdim=keepdim,
                                         dtype=d), x)


def nanmean(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return run_op("nanmean",
                  lambda a: torch.nanmean(a, dim=_dims(ax, a),
                                          keepdim=keepdim), x)


def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return run_op("logsumexp",
                  lambda a: torch.logsumexp(a, dim=_dims(ax, a),
                                            keepdim=keepdim), x)


def all(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return run_op("all",
                  lambda a: torch.all(a, dim=_dims(ax, a), keepdim=keepdim),
                  x, differentiable=False)


def any(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return run_op("any",
                  lambda a: torch.any(a, dim=_dims(ax, a), keepdim=keepdim),
                  x, differentiable=False)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)

    def f(a):
        dims = _dims(ax, a)
        out = torch.count_nonzero(a, dim=dims)
        if keepdim:
            dims = dims if isinstance(dims, tuple) else (dims,)
            shape = [1 if (i in dims or i - a.dim() in dims) else s
                     for i, s in enumerate(a.shape)]
            out = out.reshape(shape)
        return out
    return run_op("count_nonzero", f, x, differentiable=False)


def isnan(x, name=None):
    return run_op("isnan", torch.isnan, x, differentiable=False)


def isinf(x, name=None):
    return run_op("isinf", torch.isinf, x, differentiable=False)


def isfinite(x, name=None):
    return run_op("isfinite", torch.isfinite, x, differentiable=False)


def isneginf(x, name=None):
    return run_op("isneginf", torch.isneginf, x, differentiable=False)


def isposinf(x, name=None):
    return run_op("isposinf", torch.isposinf, x, differentiable=False)


def isreal(x, name=None):
    return run_op("isreal", torch.isreal, x, differentiable=False)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return run_op("isclose",
                  lambda a, b: torch.isclose(a, b, rtol, atol, equal_nan),
                  x, y, differentiable=False)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return run_op("allclose",
                  lambda a, b: torch.isclose(a, b, rtol, atol,
                                             equal_nan).all(),
                  x, y, differentiable=False)


def equal_all(x, y, name=None):
    return run_op("equal_all",
                  lambda a, b: torch.tensor(
                      a.shape == b.shape and _builtins.bool((a == b).all()),
                      device=a.device),
                  x, y, differentiable=False)


# -------------------------- inplace variants --------------------------------
def _inplace_binop(op_name, f):
    def op(x, y, name=None):
        if _is_scalar(y):
            return run_op_inplace(op_name, lambda a: f(a, y), x)
        _, y2 = _promote_binary(x, y)
        return run_op_inplace(op_name, f, x, y2)
    op.__name__ = op_name
    return op


add_ = _inplace_binop("add_", lambda a, b: a + b)
subtract_ = _inplace_binop("subtract_", lambda a, b: a - b)
multiply_ = _inplace_binop("multiply_", lambda a, b: a * b)
divide_ = _inplace_binop("divide_", lambda a, b: a / b)


def scale_(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    def f(a):
        sv, bv = _scalars_for(a, scale, bias)
        return a * sv + bv if bias_after_scale else (a + bv) * sv
    return run_op_inplace("scale_", f, x)


def zero_(x):
    x._assign_array(torch.zeros_like(x._data.detach()))
    return x


def fill_(x, value):
    x._assign_array(torch.full_like(x._data.detach(), value))
    return x


def exp_(x, name=None):
    return run_op_inplace("exp_", torch.exp, x)


def sqrt_(x, name=None):
    return run_op_inplace("sqrt_", torch.sqrt, x)


def increment(x, value=1.0, name=None):
    return run_op_inplace("increment",
                          lambda a: a + _scalars_for(a, value)[0], x)
