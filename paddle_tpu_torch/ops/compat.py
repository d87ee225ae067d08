"""Top-level API parity ops: the port of ``paddle_tpu/ops/compat.py``.

The remaining ``paddle.*`` surface (reference: python/paddle/__init__.py
__all__ and python/paddle/tensor/{math,manipulation,creation}.py) that the
core op modules do not cover: construction, scatter and statistics ops,
framework helpers, the RNG state (the card's ``torch.Generator``s under
``get_cuda_rng_state``) and the random in-place fills. The generated
``<op>_`` variants are ``tensor_methods.build_inplace_variants``.
"""
from __future__ import annotations

import itertools as _it
import math

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import run_op
from ..core.generator import default_generator, generator_for
from ..core.tensor import Tensor


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


# ---------------------------------------------------------------------------
# construction / stacking
# ---------------------------------------------------------------------------

def block_diag(inputs, name=None):
    """Block-diagonal matrix from a list of 0/1/2-D tensors
    (ref: python/paddle/tensor/creation.py block_diag)."""
    def f(*ms):
        ms = [torch.atleast_2d(m) for m in ms]
        dt = ms[0].dtype
        for m in ms[1:]:
            dt = torch.promote_types(dt, m.dtype)
        return torch.block_diag(*[m.to(dt) for m in ms])
    return run_op("block_diag", f, *[_t(m) for m in inputs])


def cartesian_prod(x, name=None):
    """Cartesian product of 1-D tensors (ref: tensor/math.py
    cartesian_prod); one input gives it back flat."""
    xs = [_t(v) for v in x]
    if len(xs) == 1:
        return run_op("cartesian_prod", lambda v: v.reshape(-1), xs[0])
    return run_op("cartesian_prod", lambda *vs: torch.cartesian_prod(*vs),
                  *xs)


def combinations(x, r=2, with_replacement=False, name=None):
    """r-length combinations of a 1-D tensor (ref: tensor/math.py
    combinations)."""
    x = _t(x)
    gen = _it.combinations_with_replacement if with_replacement \
        else _it.combinations
    idx = np.array(list(gen(range(x.shape[0]), r)), dtype=np.int64)
    if idx.size == 0:
        idx = idx.reshape(0, r)
    return run_op("combinations",
                  lambda a: a[torch.as_tensor(idx, device=a.device)], x)


def vander(x, n=None, increasing=False, name=None):
    x = _t(x)
    m = x.shape[0] if n is None else int(n)

    def f(a):
        p = torch.arange(m, dtype=a.dtype, device=a.device)
        if not increasing:
            p = p.flip(0)
        return a[:, None] ** p[None, :]
    return run_op("vander", f, x)


def column_stack(x, name=None):
    return run_op("column_stack", lambda *vs: torch.column_stack(vs),
                  *[_t(v) for v in x])


def row_stack(x, name=None):
    return run_op("row_stack", lambda *vs: torch.vstack(vs),
                  *[_t(v) for v in x])


def _diff_sections(indices, total):
    """paddle h/v/dsplit take split *indices*; split() wants section sizes."""
    pts = [0] + [int(i) for i in indices] + [total]
    return [b - a for a, b in zip(pts[:-1], pts[1:])]


def _split_at(x, num_or_indices, axis):
    from .manipulation import split
    return split(x, num_or_indices if isinstance(num_or_indices, int)
                 else _diff_sections(num_or_indices, x.shape[axis]), axis)


def hsplit(x, num_or_indices, name=None):
    x = _t(x)
    return _split_at(x, num_or_indices, 0 if x.ndim == 1 else 1)


def vsplit(x, num_or_indices, name=None):
    return _split_at(_t(x), num_or_indices, 0)


def dsplit(x, num_or_indices, name=None):
    return _split_at(_t(x), num_or_indices, 2)


def unflatten(x, axis, shape, name=None):
    x = _t(x)
    axis = int(axis) % x.ndim
    shape = [int(s._data) if isinstance(s, Tensor) else int(s)
             for s in (shape.tolist() if isinstance(shape, Tensor) else shape)]
    known = int(np.prod([s for s in shape if s != -1]))
    shape = [x.shape[axis] // known if s == -1 else s for s in shape]

    def f(a):
        return a.reshape(a.shape[:axis] + tuple(shape) + a.shape[axis + 1:])
    return run_op("unflatten", f, x)


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        inputs = [inputs]
    return run_op("add_n", lambda *vs: sum(vs[1:], vs[0]),
                  *[_t(v) for v in inputs])


# ---------------------------------------------------------------------------
# scatter family: the slice of a copy is written, so autograd sees a new
# tensor and x is unchanged
# ---------------------------------------------------------------------------

def _written(a, idx, v):
    out = a.clone()
    out[idx] = v.to(a.dtype)
    return out


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    """Write ``value`` into the strided slice of x (ref:
    tensor/manipulation.py slice_scatter)."""
    x = _t(x)
    idx = [slice(None)] * x.ndim
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[int(ax)] = slice(int(st), int(en), int(sd))
    idx = tuple(idx)
    return run_op("slice_scatter", lambda a, v: _written(a, idx, v), x,
                  _t(value))


def select_scatter(x, values, axis, index, name=None):
    x = _t(x)
    idx = [slice(None)] * x.ndim
    idx[int(axis)] = int(index)
    idx = tuple(idx)
    return run_op("select_scatter", lambda a, v: _written(a, idx, v), x,
                  _t(values))


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    def f(a, v):
        n1, n2 = a.shape[axis1], a.shape[axis2]
        k = min(n1, n2 - offset) if offset >= 0 else min(n1 + offset, n2)
        ar = torch.arange(k, device=a.device)
        idx = [slice(None)] * a.ndim
        idx[axis1] = ar + (-offset if offset < 0 else 0)
        idx[axis2] = ar + (offset if offset >= 0 else 0)
        return _written(a, tuple(idx), v)
    return run_op("diagonal_scatter", f, _t(x), _t(y))


# ---------------------------------------------------------------------------
# math / statistics
# ---------------------------------------------------------------------------

def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return run_op("isin", lambda a, t: torch.isin(a, t, invert=invert),
                  _t(x), _t(test_x), differentiable=False)


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):
    def f(a):
        if min == 0 and max == 0:
            lo, hi = torch.min(a).float(), torch.max(a).float()
        else:
            lo = torch.tensor(float(min), device=a.device)
            hi = torch.tensor(float(max), device=a.device)
        same = lo == hi
        lo2 = torch.where(same, lo - 0.5, lo)
        hi2 = torch.where(same, hi + 0.5, hi)
        return torch.linspace(0.0, 1.0, bins + 1, device=a.device) \
            * (hi2 - lo2) + lo2
    return run_op("histogram_bin_edges", f, _t(input), differentiable=False)


def pdist(x, p=2.0, name=None):
    """Condensed pairwise distance of an (N, M) matrix (ref:
    tensor/linalg.py pdist)."""
    x = _t(x)
    iu = np.triu_indices(x.shape[0], 1)

    def f(a):
        d = a[:, None, :] - a[None, :, :]
        if p == 2.0:
            m = torch.sqrt(torch.sum(d * d, -1) + 1e-30)
        elif p == 0:
            m = torch.sum(d != 0, -1).to(a.dtype)
        elif math.isinf(p):
            m = torch.amax(d.abs(), -1)
        else:
            m = torch.sum(d.abs() ** p, -1) ** (1.0 / p)
        return m[torch.as_tensor(iu[0], device=a.device),
                 torch.as_tensor(iu[1], device=a.device)]
    return run_op("pdist", f, x)


def sinc(x, name=None):
    return run_op("sinc", torch.sinc, _t(x))


def sgn(x, name=None):
    def f(a):
        if a.is_complex():
            mag = a.abs()
            return torch.where(mag == 0, torch.zeros_like(a),
                               a / (mag + 1e-30))
        return torch.sign(a)
    return run_op("sgn", f, _t(x))


def signbit(x, name=None):
    return run_op("signbit", torch.signbit, _t(x), differentiable=False)


def frexp(x, name=None):
    return run_op("frexp", lambda a: tuple(torch.frexp(a)), _t(x),
                  differentiable=False)


def ldexp(x, y, name=None):
    def f(a, b):
        dt = a.dtype if a.is_floating_point() else torch.float32
        return a.to(dt) * (2.0 ** b.to(dt))
    return run_op("ldexp", f, _t(x), _t(y))


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return run_op("trapezoid",
                      lambda a, b: torch.trapezoid(a, b, dim=axis), _t(y),
                      _t(x))
    d = 1.0 if dx is None else dx
    return run_op("trapezoid", lambda a: torch.trapezoid(a, dx=d, dim=axis),
                  _t(y))


def _pairs(a, ax):
    n = a.shape[ax]
    return a.narrow(ax, 0, n - 1), a.narrow(ax, 1, n - 1)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        def f(a, b):
            ax = axis % a.ndim
            a0, a1 = _pairs(a, ax)
            if b.ndim == 1:
                shp = [1] * a.ndim
                shp[ax] = -1
                b = b.reshape(shp)
            b0, b1 = _pairs(b, ax % b.ndim if b.ndim == a.ndim else 0)
            return torch.cumsum((a0 + a1) * 0.5 * (b1 - b0), dim=ax)
        return run_op("cumulative_trapezoid", f, _t(y), _t(x))
    d = 1.0 if dx is None else dx

    def g(a):
        ax = axis % a.ndim
        a0, a1 = _pairs(a, ax)
        return torch.cumsum((a0 + a1) * 0.5 * d, dim=ax)
    return run_op("cumulative_trapezoid", g, _t(y))


def multigammaln(x, p, name=None):
    pp = int(p)

    def f(a):
        c = 0.25 * pp * (pp - 1) * np.log(np.pi)
        js = torch.arange(pp, dtype=a.dtype, device=a.device)
        return c + torch.sum(torch.lgamma(a[..., None] - js / 2.0), -1)
    return run_op("multigammaln", f, _t(x))


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    from ..core.place import default_device
    shape = (1,) if shape is None else tuple(int(s) for s in shape)
    dev = default_device()
    z = torch.randn(shape, generator=generator_for(dev), device=dev)
    return Tensor._wrap(torch.exp(z * std + mean))


# ---------------------------------------------------------------------------
# framework-level helpers
# ---------------------------------------------------------------------------

def rank(input, name=None):
    t = _t(input)
    return Tensor._wrap(torch.tensor(t.ndim, dtype=torch.int32,
                                     device=t._data.device))


def tolist(x):
    return _t(x).tolist()


def is_complex(x):
    return _t(x)._data.is_complex()


def is_integer(x):
    d = _t(x)._data
    return not (d.is_floating_point() or d.is_complex()
                or d.dtype == torch.bool)


def is_floating_point(x):
    return _t(x)._data.is_floating_point()


def check_shape(shape):
    """Validate a shape spec (ref: tensor/creation.py check_shape)."""
    if isinstance(shape, Tensor):
        return
    for s in shape:
        if not isinstance(s, (int, np.integer)) and not isinstance(s, Tensor):
            raise TypeError(f"shape entries must be ints, got {type(s)}")
        if isinstance(s, (int, np.integer)) and s < -1:
            raise ValueError(f"invalid dim {s} in shape")


def disable_signal_handler():
    """A no-op: the reference installs SIGSEGV and other handlers in C++;
    the port installs none to disable."""


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Tensor printing options (a Tensor prints through numpy)."""
    kw = {k: v for k, v in (("precision", precision),
                            ("threshold", threshold),
                            ("edgeitems", edgeitems),
                            ("linewidth", linewidth)) if v is not None}
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


def get_rng_state(device=None):
    return [default_generator().get_state()]


def set_rng_state(state_list, device=None):
    st = state_list[0] if isinstance(state_list, (list, tuple)) \
        else state_list
    default_generator().set_state(st)


def get_cuda_rng_state():
    """The state of the default generator's ``torch.Generator`` on each
    CUDA device (one ByteTensor each); empty without a CUDA device, as
    Paddle's is."""
    gen = default_generator()
    return [gen.device_state(torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state_list):
    """Restore what ``get_cuda_rng_state`` returned: the next draws on each
    card repeat the ones made after it."""
    gen = default_generator()
    for i, st in enumerate(state_list):
        gen.set_device_state(torch.device("cuda", i), st)


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """paddle.create_parameter (ref: tensor/creation.py create_parameter):
    a Parameter with its initializer applied eagerly."""
    from ..core.tensor import Parameter
    from ..nn import initializer as I
    init = default_initializer
    if init is None and attr is not None:
        init = getattr(attr, "initializer", None)
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    dt = dtype_mod.convert_dtype(dtype) or dtype_mod.float32
    p = Parameter(init([int(s) for s in shape], dt))
    p.stop_gradient = False
    if name:
        p.name = name
    return p


from ..batch import batch  # noqa: E402,F401  (paddle.batch)


class LazyGuard:
    """Context that flags deferred parameter initialization (ref:
    python/paddle/nn/initializer/lazy_init.py LazyGuard); parameters are
    made eagerly, so the guard only records the mode, as the
    reference's."""
    _active = False

    def __enter__(self):
        LazyGuard._active = True
        return self

    def __exit__(self, *exc):
        LazyGuard._active = False
        return False


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Estimate FLOPs of a Layer via forward hooks that count matmul-like
    work per leaf layer (ref: python/paddle/hapi/dynamic_flops.py)."""
    from .. import nn
    from .creation import zeros
    total = [0]

    def hook(layer, inputs, output):
        if isinstance(layer, nn.Linear):
            x = inputs[0]
            total[0] += 2 * int(np.prod(x.shape[:-1])) \
                * int(np.prod(layer.weight.shape))
        elif output is not None and getattr(layer, "weight", None) \
                is not None and hasattr(output, "shape"):
            total[0] += 2 * int(np.prod(output.shape[:2])) \
                * int(np.prod(layer.weight.shape))

    handles = [layer.register_forward_post_hook(hook)
               for layer in net.sublayers(include_self=True)
               if not layer.sublayers()]
    try:
        net(zeros(input_size))
    finally:
        for h in handles:
            h.remove()
    if total[0] == 0:
        n_params = sum(int(p.size) for _, p in net.named_parameters())
        total[0] = 2 * n_params * int(np.prod(input_size[:1]))
    return total[0]


# ---------------------------------------------------------------------------
# random in-place fills, drawn from the port's generator on x's device
# ---------------------------------------------------------------------------

def _rand_inplace(name, sample):
    def op(x, *args, **kw):
        kw.pop("name", None)
        a = x._data
        u = torch.rand(a.shape, generator=generator_for(a.device),
                       device=a.device)
        with torch.no_grad():
            x._assign_array(sample(u, *args, **kw).to(a.dtype))
        return x
    op.__name__ = name
    return op


def _normal_of(u):
    return math.sqrt(2.0) * torch.erfinv(2.0 * u.clamp(1e-7, 1 - 1e-7) - 1)


cauchy_ = _rand_inplace(
    "cauchy_", lambda u, loc=0, scale=1: loc + scale * torch.tan(
        math.pi * (u - 0.5)))
geometric_ = _rand_inplace(
    "geometric_", lambda u, probs=0.5: torch.floor(
        torch.log1p(-u) / math.log1p(-probs)) + 1)
log_normal_ = _rand_inplace(
    "log_normal_", lambda u, mean=1.0, std=2.0: torch.exp(
        _normal_of(u) * std + mean))
