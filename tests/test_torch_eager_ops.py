"""The eager op library of paddle_tpu_torch against the reference's, op by op.

Each case runs the same numpy inputs (made from a seed) through
``paddle_tpu.<op>`` and ``paddle_tpu_torch.<op>`` on the CPU and compares
every output and, for the inputs marked differentiable, the gradient of
``sum(out * w)`` (w fixed random weights, one per float output).

Tolerances: f32 rtol 1e-5 plus 1e-5 of the output's scale (the
transcendentals and reductions sum or round in another order); bf16 2e-2
of the scale. A case that needs another tolerance states it beside it.
Values are compared, not storage widths: the reference stores int64 and
float64 as 32 bits while jax's x64 mode is off, the port as asked.
"""
import zlib

import numpy as np
import pytest

import jax
import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

F32_TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    T.seed(2024)
    yield


# ------------------------------------------------------------------ inputs
def _rng(seed):
    return np.random.RandomState(seed)


def f(*shape, lo=None, hi=None):
    """A float32 input: normal, or uniform in [lo, hi)."""
    def make(r):
        if lo is None:
            return r.randn(*shape).astype(np.float32)
        return r.uniform(lo, hi, shape).astype(np.float32)
    return make


def i(*shape, lo=0, hi=5):
    return lambda r: r.randint(lo, hi, shape).astype(np.int64)


def b(*shape):
    return lambda r: r.rand(*shape) > 0.5


def const(arr):
    return lambda r: np.asarray(arr)


def spd(n):
    def make(r):
        a = r.randn(n, n).astype(np.float32)
        return (a @ a.T + n * np.eye(n)).astype(np.float32)
    return make


class Case:
    def __init__(self, id, fn, inputs, diff=(), tol=F32_TOL, dtype=None):
        self.id, self.fn, self.inputs, self.diff = id, fn, inputs, diff
        self.tol, self.dtype = tol, dtype

    def __repr__(self):
        return self.id


def _forward_backward(pd, case, xs):
    for k in case.diff:
        xs[k].stop_gradient = False
    out = case.fn(pd, *xs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    grads = []
    if case.diff:
        r = _rng(99)
        loss = None
        for o in outs:
            if not isinstance(o, pd.Tensor) or "float" not in str(o.dtype):
                continue
            w = pd.to_tensor(np.asarray(r.randn(*o.shape), np.float32))
            term = (o.astype("float32") * w).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        grads = [xs[k].grad for k in case.diff]
    return outs, grads


def _run(pd, case, arrays):
    """Outputs and the gradients of sum(out_i * w_i) with respect to the
    inputs in ``case.diff``. A differentiated reference case runs as one
    program through its ``jit.to_static`` (op by op it compiles a kernel
    an op shape, the backward's too), which runs op by op where its trace
    cannot follow the case; op by op too where the compiled backward
    refuses an op (ValueError) or a boolean mask needs concrete values."""
    if pd is P and case.diff:
        try:
            outs, grads = P.jit.to_static(
                lambda *ts: _forward_backward(P, case, list(ts)))(
                    *_inputs(P, case, arrays))
        except (ValueError, jax.errors.NonConcreteBooleanIndexError):
            outs, grads = _forward_backward(P, case,
                                            _inputs(P, case, arrays))
    else:
        outs, grads = _forward_backward(pd, case, _inputs(pd, case, arrays))
    vals = [o.astype("float32").numpy()
            if isinstance(o, pd.Tensor) and str(o.dtype) == "bfloat16"
            else (o.numpy() if isinstance(o, pd.Tensor) else np.asarray(o))
            for o in outs]
    return vals, [None if g is None else g.astype("float32").numpy()
                  for g in grads]


def _inputs(pd, case, arrays):
    xs = []
    for a in arrays:
        t = pd.to_tensor(a)
        if case.dtype is not None and np.issubdtype(a.dtype, np.floating):
            t = t.astype(case.dtype)
        xs.append(t)
    return xs


def _close(got, want, tol, what):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, \
        f"{what}: shape {got.shape} vs {want.shape}"
    if want.dtype == bool or got.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    got = got.astype(np.complex128 if np.iscomplexobj(want) else np.float64)
    want = want.astype(got.dtype)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               equal_nan=True, err_msg=what)


def _check(case):
    r = _rng(zlib.crc32(case.id.encode()))
    arrays = [mk(r) for mk in case.inputs]
    want_v, want_g = _run(P, case, arrays)
    got_v, got_g = _run(T, case, arrays)
    assert len(got_v) == len(want_v)
    for n, (g, w) in enumerate(zip(got_v, want_v)):
        _close(g, w, case.tol, f"{case.id} output {n}")
    for k, g, w in zip(case.diff, got_g, want_g):
        assert (g is None) == (w is None), f"{case.id} grad of input {k}"
        if w is not None:
            _close(g, w, case.tol, f"{case.id} grad of input {k}")


# ------------------------------------------------------------------ creation
CREATION = [
    Case("zeros", lambda p: p.zeros([2, 3]), []),
    Case("ones_int", lambda p: p.ones([2, 3], dtype="int32"), []),
    Case("full", lambda p: p.full([2, 2], 1.5), []),
    Case("full_bool", lambda p: p.full([3], True), []),
    Case("arange_int", lambda p: p.arange(7), []),
    Case("arange_float", lambda p: p.arange(0.5, 3.0, 0.25), []),
    Case("linspace", lambda p: p.linspace(-1.0, 2.0, 7), []),
    Case("logspace", lambda p: p.logspace(0.0, 2.0, 5), []),
    Case("eye", lambda p: p.eye(3, 4), []),
    Case("zeros_like", lambda p, x: p.zeros_like(x), [f(2, 3)]),
    Case("full_like", lambda p, x: p.full_like(x, 3.0), [f(2, 3)]),
    Case("diag_vec", lambda p, x: p.diag(x, offset=1), [f(4)], (0,)),
    Case("diag_pad", lambda p, x: p.diag(x, offset=-1, padding_value=2.0),
         [f(3)], (0,)),
    Case("diag_mat", lambda p, x: p.diag(x, offset=1), [f(4, 4)], (0,)),
    Case("diagflat", lambda p, x: p.diagflat(x), [f(2, 2)], (0,)),
    Case("diag_embed", lambda p, x: p.diag_embed(x, offset=1),
         [f(2, 3)], (0,)),
    Case("meshgrid", lambda p, x, y: p.meshgrid(x, y), [f(3), f(4)], (0, 1)),
    Case("tril", lambda p, x: p.tril(x, 1), [f(4, 5)], (0,)),
    Case("triu", lambda p, x: p.triu(x, -1), [f(4, 5)], (0,)),
    Case("tril_indices", lambda p: p.tril_indices(4, 5, 1), []),
    Case("triu_indices", lambda p: p.triu_indices(4, 3, -1), []),
    Case("one_hot", lambda p, x: p.one_hot(x, 6), [i(5, lo=0, hi=6)]),
    Case("assign", lambda p, x: p.assign(x), [f(3)]),
    Case("clone", lambda p, x: p.clone(x) * 2, [f(3)], (0,)),
]

# ---------------------------------------------------------------------- math
_UNARY = {
    "exp": f(3, 4), "expm1": f(3, 4), "log": f(3, 4, lo=0.1, hi=3),
    "log2": f(3, 4, lo=0.1, hi=3), "log10": f(3, 4, lo=0.1, hi=3),
    "log1p": f(3, 4, lo=0.1, hi=3), "sqrt": f(3, 4, lo=0.1, hi=3),
    "rsqrt": f(3, 4, lo=0.1, hi=3), "square": f(3, 4), "abs": f(3, 4),
    "sign": f(3, 4), "floor": f(3, 4), "ceil": f(3, 4), "round": f(3, 4),
    "trunc": f(3, 4), "frac": f(3, 4), "sin": f(3, 4), "cos": f(3, 4),
    "tan": f(3, 4, lo=-1, hi=1), "asin": f(3, 4, lo=-0.9, hi=0.9),
    "acos": f(3, 4, lo=-0.9, hi=0.9), "atan": f(3, 4), "sinh": f(3, 4),
    "cosh": f(3, 4), "tanh": f(3, 4), "asinh": f(3, 4),
    "acosh": f(3, 4, lo=1.1, hi=3), "atanh": f(3, 4, lo=-0.9, hi=0.9),
    "reciprocal": f(3, 4, lo=0.5, hi=2), "sigmoid": f(3, 4),
    "logit": f(3, 4, lo=0.1, hi=0.9), "erf": f(3, 4),
    "erfinv": f(3, 4, lo=-0.9, hi=0.9), "lgamma": f(3, 4, lo=0.5, hi=3),
    "digamma": f(3, 4, lo=0.5, hi=3), "i0": f(3, 4), "i1": f(3, 4),
    "i0e": f(3, 4), "i1e": f(3, 4), "neg": f(3, 4), "deg2rad": f(3, 4),
    "rad2deg": f(3, 4),
}
# no gradient is compared where it is zero almost everywhere or undefined
_NO_GRAD = {"sign", "floor", "ceil", "round", "trunc"}

MATH = [Case(name, (lambda n: lambda p, x: getattr(p, n)(x))(name), [mk],
             () if name in _NO_GRAD else (0,))
        for name, mk in _UNARY.items()]
MATH += [Case(f"{name}_int", (lambda n: lambda p, x: getattr(p, n)(x))(name),
              [i(3, 4, lo=1, hi=5)]) for name in ("exp", "sqrt", "tanh")]

_BINARY = {
    "add": (f(3, 4), f(4)), "subtract": (f(3, 4), f(3, 1)),
    "multiply": (f(3, 4), f(3, 4)), "divide": (f(3, 4), f(3, 4, lo=0.5, hi=2)),
    "floor_divide": (f(3, 4), f(3, 4, lo=0.5, hi=2)),
    "remainder": (f(3, 4), f(3, 4, lo=0.5, hi=2)),
    "fmod": (f(3, 4), f(3, 4, lo=0.5, hi=2)),
    "maximum": (f(3, 4), f(3, 4)), "minimum": (f(3, 4), f(3, 4)),
    "fmax": (f(3, 4), f(3, 4)), "fmin": (f(3, 4), f(3, 4)),
    "atan2": (f(3, 4), f(3, 4)), "hypot": (f(3, 4), f(3, 4)),
    "logaddexp": (f(3, 4), f(3, 4)), "copysign": (f(3, 4), f(3, 4)),
    "pow": (f(3, 4, lo=0.5, hi=2), f(3, 4)),
}
_BIN_NO_GRAD = {"floor_divide", "remainder", "fmod", "copysign"}
MATH += [Case(name, (lambda n: lambda p, x, y: getattr(p, n)(x, y))(name),
              list(mks), () if name in _BIN_NO_GRAD else (0, 1))
         for name, mks in _BINARY.items()]
MATH += [
    Case("add_int_int", lambda p, x, y: p.add(x, y), [i(3), i(3)]),
    Case("gcd", lambda p, x, y: p.gcd(x, y), [i(4, lo=1, hi=30),
                                               i(4, lo=1, hi=30)]),
    Case("lcm", lambda p, x, y: p.lcm(x, y), [i(4, lo=1, hi=12),
                                               i(4, lo=1, hi=12)]),
    Case("heaviside", lambda p, x, y: p.heaviside(x, y), [f(5), f(5)]),
    Case("promote_int_float", lambda p, x, y: x + y, [i(3), f(3)], (1,)),
    Case("dunder_scalars",
         lambda p, x: (x + 1, 2 - x, x * 3.0, 1.5 / (x * x + 1), x ** 2,
                       -x, 3 ** (x * 0.1), x // 2, x % 1.5, abs(x)),
         [f(3, 4)], (0,)),
    Case("int_scalar_lifts", lambda p, x: (x * 2.5, x / 2), [i(4)]),
    Case("dunder_matmul", lambda p, x, y: x @ y, [f(3, 4), f(4, 2)], (0, 1)),
    Case("pow_scalar", lambda p, x: p.pow(x, 3), [f(3, 4)], (0,)),
    Case("stanh", lambda p, x: p.stanh(x), [f(3, 4)], (0,)),
    Case("scale", lambda p, x: p.scale(x, 2.0, 0.5), [f(3, 4)], (0,)),
    Case("scale_before", lambda p, x: p.scale(x, 2.0, 0.5,
                                              bias_after_scale=False),
         [f(3, 4)], (0,)),
    Case("clip", lambda p, x: p.clip(x, -0.5, 0.7), [f(3, 4)], (0,)),
    Case("clip_min", lambda p, x: p.clip(x, min=0.1), [f(3, 4)], (0,)),
    Case("lerp", lambda p, x, y: p.lerp(x, y, 0.3), [f(3, 4), f(3, 4)],
         (0, 1)),
    Case("lerp_tensor", lambda p, x, y, w: p.lerp(x, y, w),
         [f(3, 4), f(3, 4), f(3, 4, lo=0, hi=1)], (0, 1, 2)),
    Case("nan_to_num", lambda p, x: p.nan_to_num(x / (x * 0.0), posinf=5.0),
         [f(3, 4)]),
    Case("addmm", lambda p, a, x, y: p.addmm(a, x, y, beta=0.5, alpha=2.0),
         [f(3, 2), f(3, 4), f(4, 2)], (0, 1, 2)),
    Case("inner", lambda p, x, y: p.inner(x, y), [f(3, 4), f(2, 4)], (0, 1)),
    Case("outer", lambda p, x, y: p.outer(x, y), [f(3), f(4)], (0, 1)),
    Case("kron", lambda p, x, y: p.kron(x, y), [f(2, 3), f(2, 2)], (0, 1)),
    Case("trace", lambda p, x: p.trace(x, offset=1), [f(4, 5)], (0,)),
    Case("diagonal", lambda p, x: p.diagonal(x, 0, 1, 2), [f(2, 3, 3)], (0,)),
    Case("diff", lambda p, x: p.diff(x, axis=1), [f(3, 5)], (0,)),
    Case("diff_prepend", lambda p, x, y: p.diff(x, prepend=y),
         [f(3, 5), f(3, 2)], (0, 1)),
    Case("cumsum", lambda p, x: p.cumsum(x, axis=1), [f(3, 5)], (0,)),
    Case("cumsum_flat", lambda p, x: p.cumsum(x), [f(3, 5)], (0,)),
    Case("cumprod", lambda p, x: p.cumprod(x, dim=0), [f(3, 5)], (0,)),
    Case("cummax", lambda p, x: p.cummax(x, axis=1), [f(3, 5)], (0,)),
    Case("cummin", lambda p, x: p.cummin(x, axis=0), [f(3, 5)], (0,)),
    Case("logcumsumexp", lambda p, x: p.logcumsumexp(x, axis=1), [f(3, 5)],
         (0,)),
    Case("multiplex", lambda p, a, c, idx: p.multiplex([a, c], idx),
         [f(4, 3), f(4, 3), i(4, 1, lo=0, hi=2)], (0, 1)),
    Case("sum_all", lambda p, x: p.sum(x), [f(3, 4, 5)], (0,)),
    Case("sum_axis", lambda p, x: p.sum(x, axis=1, keepdim=True),
         [f(3, 4, 5)], (0,)),
    Case("sum_axes", lambda p, x: p.sum(x, axis=[0, 2]), [f(3, 4, 5)], (0,)),
    Case("sum_int", lambda p, x: p.sum(x, axis=0), [i(3, 4)]),
    Case("mean", lambda p, x: p.mean(x, axis=-1), [f(3, 4, 5)], (0,)),
    Case("mean_all_keep", lambda p, x: p.mean(x, keepdim=True), [f(3, 4)],
         (0,)),
    Case("prod", lambda p, x: p.prod(x, axis=1), [f(3, 4, lo=0.5, hi=1.5)],
         (0,)),
    Case("prod_axes", lambda p, x: p.prod(x, axis=[0, 2], keepdim=True),
         [f(2, 3, 2, lo=0.5, hi=1.5)], (0,)),
    Case("prod_all", lambda p, x: p.prod(x), [f(3, 4, lo=0.5, hi=1.5)], (0,)),
    Case("max", lambda p, x: p.max(x, axis=1), [f(3, 5)], (0,)),
    Case("min_all", lambda p, x: p.min(x), [f(3, 5)], (0,)),
    Case("amax", lambda p, x: p.amax(x, axis=[0, 1], keepdim=True),
         [f(3, 5, 2)], (0,)),
    Case("std", lambda p, x: p.std(x, axis=1), [f(3, 6)], (0,)),
    Case("var_biased", lambda p, x: p.var(x, unbiased=False), [f(3, 6)],
         (0,)),
    Case("nansum", lambda p, x: p.nansum(x, axis=0), [f(3, 4)], (0,)),
    Case("nanmean", lambda p, x: p.nanmean(x, axis=1), [f(3, 4)], (0,)),
    Case("logsumexp", lambda p, x: p.logsumexp(x, axis=-1), [f(3, 6)], (0,)),
    Case("logsumexp_all", lambda p, x: p.logsumexp(x), [f(3, 6)], (0,)),
    Case("all_any", lambda p, x: (p.all(x, axis=1), p.any(x)), [b(3, 4)]),
    Case("count_nonzero", lambda p, x: p.count_nonzero(x, axis=1,
                                                       keepdim=True),
         [i(3, 4, lo=0, hi=2)]),
    Case("isnan_isinf_isfinite",
         lambda p, x: (p.isnan(x / x), p.isinf(1.0 / x), p.isfinite(x)),
         [const([0.0, 1.0, -2.0])]),
    Case("isclose", lambda p, x, y: p.isclose(x, x + y * 1e-7), [f(5), f(5)]),
    Case("allclose", lambda p, x, y: p.allclose(x, x + y), [f(5), f(5)]),
    Case("equal_all", lambda p, x: (p.equal_all(x, x), p.equal_all(x, x + 1)),
         [f(5)]),
    Case("bf16_add_exp_sum",
         lambda p, x, y: p.sum(p.exp(x * 0.5) + y, axis=1),
         [f(4, 8), f(4, 8)], (0, 1), tol=BF16_TOL, dtype="bfloat16"),
    Case("bf16_matmul", lambda p, x, y: p.matmul(x, y),
         [f(4, 8), f(8, 4)], (0, 1), tol=BF16_TOL, dtype="bfloat16"),
]

# -------------------------------------------------------------- manipulation
MANIPULATION = [
    Case("cast", lambda p, x: p.cast(x, "float64") * 2, [f(3)], (0,)),
    Case("cast_int", lambda p, x: x.astype("int32"), [f(3, lo=0, hi=9)]),
    Case("reshape", lambda p, x: p.reshape(x, [4, -1]), [f(2, 6)], (0,)),
    Case("flatten", lambda p, x: p.flatten(x, 1, 2), [f(2, 3, 4, 2)], (0,)),
    Case("transpose", lambda p, x: p.transpose(x, [2, 0, 1]), [f(2, 3, 4)],
         (0,)),
    Case("T_mT", lambda p, x: (x.T, x.mT), [f(2, 3, 4)], (0,)),
    Case("moveaxis", lambda p, x: p.moveaxis(x, 0, 2), [f(2, 3, 4)], (0,)),
    Case("swapaxes", lambda p, x: p.swapaxes(x, 0, 2), [f(2, 3, 4)], (0,)),
    Case("squeeze", lambda p, x: p.squeeze(x, [0, 2]), [f(1, 3, 1, 2)],
         (0,)),
    Case("squeeze_all", lambda p, x: p.squeeze(x), [f(1, 3, 1, 2)], (0,)),
    Case("unsqueeze", lambda p, x: p.unsqueeze(x, [0, -1]), [f(3, 2)], (0,)),
    Case("concat", lambda p, x, y: p.concat([x, y], axis=1),
         [f(2, 3), f(2, 2)], (0, 1)),
    Case("stack", lambda p, x, y: p.stack([x, y], axis=-1),
         [f(2, 3), f(2, 3)], (0, 1)),
    Case("hvdstack", lambda p, x, y: (p.hstack([x, y]), p.vstack([x, y]),
                                      p.dstack([x, y])),
         [f(2, 3), f(2, 3)], (0, 1)),
    Case("split", lambda p, x: p.split(x, 3, axis=1), [f(2, 6)], (0,)),
    Case("split_sections", lambda p, x: p.split(x, [1, -1, 2], axis=1),
         [f(2, 6)], (0,)),
    Case("chunk", lambda p, x: p.chunk(x, 2, axis=0), [f(4, 3)], (0,)),
    Case("tensor_split", lambda p, x: p.tensor_split(x, 3, axis=1),
         [f(2, 7)], (0,)),
    Case("unbind", lambda p, x: p.unbind(x, axis=1), [f(2, 3)], (0,)),
    Case("expand", lambda p, x: p.expand(x, [2, 3, 4]), [f(3, 1)], (0,)),
    Case("broadcast_to", lambda p, x: p.broadcast_to(x, [3, 4]), [f(4)],
         (0,)),
    Case("expand_as", lambda p, x, y: p.expand_as(x, y), [f(1, 4), f(3, 4)],
         (0,)),
    Case("broadcast_tensors", lambda p, x, y: p.broadcast_tensors([x, y]),
         [f(3, 1), f(1, 4)], (0, 1)),
    Case("tile", lambda p, x: p.tile(x, [2, 1, 3]), [f(2, 3)], (0,)),
    Case("repeat_interleave", lambda p, x: p.repeat_interleave(x, 2, axis=1),
         [f(2, 3)], (0,)),
    Case("repeat_interleave_tensor",
         lambda p, x, r: p.repeat_interleave(x, r, axis=0),
         [f(3, 2), const(np.array([1, 3, 2], np.int64))], (0,)),
    Case("flip", lambda p, x: p.flip(x, [0, 1]), [f(2, 3)], (0,)),
    Case("rot90", lambda p, x: p.rot90(x, 1, [0, 1]), [f(2, 3)], (0,)),
    Case("roll", lambda p, x: p.roll(x, [1, -1], [0, 1]), [f(3, 4)], (0,)),
    Case("roll_flat", lambda p, x: p.roll(x, 2), [f(3, 4)], (0,)),
    Case("gather", lambda p, x, idx: p.gather(x, idx, axis=1),
         [f(3, 5), const(np.array([4, 0, 2, 0], np.int64))], (0,)),
    Case("gather_nd", lambda p, x, idx: p.gather_nd(x, idx),
         [f(3, 4, 2), const(np.array([[0, 1], [2, 3], [0, 1]], np.int64))],
         (0,)),
    Case("take", lambda p, x, idx: p.take(x, idx),
         [f(3, 4), const(np.array([[0, 11], [5, 3]], np.int64))], (0,)),
    Case("take_along_axis", lambda p, x, idx: p.take_along_axis(x, idx, 1),
         [f(3, 5), i(3, 2, lo=0, hi=5)], (0,)),
    Case("put_along_axis",
         lambda p, x, idx, v: p.put_along_axis(x, idx, v, 1),
         [f(3, 5), const(np.array([[0], [3], [4]], np.int64)), f(3, 1)],
         (0, 2)),
    Case("put_along_axis_add",
         lambda p, x, idx, v: p.put_along_axis(x, idx, v, 1, reduce="add"),
         [f(3, 5), const(np.array([[0, 2], [3, 3], [4, 1]], np.int64)),
          f(3, 2)], (0, 2)),
    Case("put_along_axis_mul",
         lambda p, x, idx, v: p.put_along_axis(x, idx, v, 0,
                                               reduce="multiply"),
         [f(3, 2), const(np.array([[0, 2]], np.int64)), f(1, 2)]),
    Case("scatter", lambda p, x, idx, u: p.scatter(x, idx, u),
         [f(5, 3), const(np.array([3, 0], np.int64)), f(2, 3)], (0, 2)),
    Case("scatter_add", lambda p, x, idx, u: p.scatter(x, idx, u,
                                                      overwrite=False),
         [f(5, 3), const(np.array([3, 0, 3], np.int64)), f(3, 3)], (0, 2)),
    Case("scatter_nd_add", lambda p, x, idx, u: p.scatter_nd_add(x, idx, u),
         [f(4, 3), const(np.array([[1], [3], [1]], np.int64)), f(3, 3)],
         (0, 2)),
    Case("scatter_nd", lambda p, idx, u: p.scatter_nd(idx, u, [4, 3]),
         [const(np.array([[1], [3]], np.int64)), f(2, 3)], (1,)),
    Case("index_select", lambda p, x, idx: p.index_select(x, idx, axis=0),
         [f(4, 3), const(np.array([3, 1, 1], np.int64))], (0,)),
    Case("index_sample", lambda p, x, idx: p.index_sample(x, idx),
         [f(3, 5), i(3, 4, lo=0, hi=5)], (0,)),
    Case("index_add", lambda p, x, idx, v: p.index_add(x, idx, 1, v),
         [f(3, 5), const(np.array([4, 0], np.int64)), f(3, 2)], (0, 2)),
    Case("index_put", lambda p, x, r, c, v: p.index_put(x, (r, c), v),
         [f(3, 4), const(np.array([0, 2], np.int64)),
          const(np.array([1, 3], np.int64)), f(2)], (0, 3)),
    Case("index_put_acc",
         lambda p, x, r, v: p.index_put(x, (r,), v, accumulate=True),
         [f(3, 4), const(np.array([0, 0, 2], np.int64)), f(3, 4)], (0, 2)),
    Case("index_fill", lambda p, x, idx: p.index_fill(x, idx, 1, 2.5),
         [f(3, 4), const(np.array([0, 2], np.int64))], (0,)),
    Case("masked_select", lambda p, x, m: p.masked_select(x, m),
         [f(3, 4), b(3, 4)]),
    Case("masked_fill", lambda p, x, m: p.masked_fill(x, m, -1.0),
         [f(3, 4), b(3, 4)], (0,)),
    Case("masked_fill_tensor", lambda p, x, m, v: p.masked_fill(x, m, v),
         [f(3, 4), b(3, 4), f(1)], (0, 2)),
    Case("masked_scatter", lambda p, x, m, v: p.masked_scatter(x, m, v),
         [f(3, 4), b(3, 4), f(12)]),
    Case("where", lambda p, c, x, y: p.where(c, x, y),
         [b(3, 4), f(3, 4), f(3, 4)], (1, 2)),
    Case("where_scalar", lambda p, c, x: p.where(c, x, 0.5),
         [b(3, 4), f(3, 4)], (1,)),
    Case("numel", lambda p, x: p.numel(x), [f(3, 4)]),
    Case("shard_index", lambda p, x: p.shard_index(x, 20, 2, 1),
         [i(6, 1, lo=0, hi=20)]),
    Case("slice", lambda p, x: p.slice(x, [0, 1], [1, -3], [3, 10]),
         [f(4, 5)], (0,)),
    Case("strided_slice",
         lambda p, x: p.strided_slice(x, [0, 1], [0, 4], [4, 0], [2, -2]),
         [f(4, 5)], (0,)),
    Case("crop", lambda p, x: p.crop(x, [2, -1], [1, 2]), [f(4, 5)], (0,)),
    Case("pad_constant", lambda p, x: p.pad(x, [1, 0, 2, 1], value=0.5),
         [f(2, 3)], (0,)),
    Case("pad_reflect", lambda p, x: p.pad(x, [2, 1], mode="reflect"),
         [f(1, 2, 5)], (0,)),
    Case("pad_replicate", lambda p, x: p.pad(x, [1, 2, 2, 0],
                                             mode="replicate"),
         [f(1, 1, 3, 4)], (0,)),
    Case("pad_circular", lambda p, x: p.pad(x, [2, 1], mode="circular"),
         [f(1, 2, 5)], (0,)),
    Case("unfold", lambda p, x: p.unfold(x, [2, 3], strides=1, paddings=1),
         [f(1, 2, 4, 5)], (0,)),
    Case("as_real_as_complex", lambda p, x: p.as_real(p.as_complex(x)),
         [f(3, 2)], (0,)),
    Case("tensordot", lambda p, x, y: p.tensordot(x, y, axes=[[1], [0]]),
         [f(2, 3, 4), f(3, 5)], (0, 1)),
    Case("atleast", lambda p, x: (p.atleast_1d(x), p.atleast_2d(x),
                                  p.atleast_3d(x)), [f(3)], (0,)),
    Case("getitem_basic", lambda p, x: (x[0, 1], x[:, -1, ::2], x[..., 1:3],
                                        x[None, 1]),
         [f(2, 3, 4)], (0,)),
    Case("getitem_tensor", lambda p, x, idx: (x[idx, idx], x[:, idx]),
         [f(2, 3, 4), const(np.array([0, 1], np.int64))], (0,)),
    Case("getitem_mask", lambda p, x, m: x[m], [f(3, 4), b(3, 4)], (0,)),
    Case("getitem_embedding", lambda p, w, ids: w[ids],
         [f(10, 4), i(2, 3, lo=0, hi=10)], (0,)),
    Case("setitem", lambda p, x, v: _setitem(x, v), [f(3, 4), f(4)], (0, 1)),
]


def _setitem(x, v):
    y = x * 1.0
    y[1] = v
    y[0, 1:3] = 7.0
    y[2, -1] = v[0] * 2
    return y


# --------------------------------------------------------------------- logic
LOGIC = [
    Case(name, (lambda n: lambda p, x, y: getattr(p, n)(x, y))(name),
         [f(3, 4), f(3, 4)])
    for name in ("equal", "not_equal", "greater_than", "greater_equal",
                 "less_than", "less_equal")
] + [
    Case("compare_scalar", lambda p, x: (x > 0.5, x == 0.0, x <= 0.2),
         [f(3, 4)]),
    Case("logical", lambda p, x, y: (p.logical_and(x, y), p.logical_or(x, y),
                                     p.logical_xor(x, y), p.logical_not(x)),
         [b(5), b(5)]),
    Case("bitwise", lambda p, x, y: (p.bitwise_and(x, y), p.bitwise_or(x, y),
                                     p.bitwise_xor(x, y), p.bitwise_not(x),
                                     x & y, x | y, x ^ y, ~x),
         [i(5, lo=0, hi=16), i(5, lo=0, hi=16)]),
    Case("shifts", lambda p, x, y: (p.bitwise_left_shift(x, y),
                                    p.bitwise_right_shift(x, y)),
         [i(5, lo=0, hi=64), i(5, lo=0, hi=3)]),
    Case("is_empty", lambda p, x: p.is_empty(x), [f(0, 3)]),
]

# -------------------------------------------------------------------- search
SEARCH = [
    Case("argmax", lambda p, x: (p.argmax(x), p.argmax(x, axis=1,
                                                        keepdim=True)),
         [f(3, 5)]),
    Case("argmin", lambda p, x: p.argmin(x, axis=0), [f(3, 5)]),
    Case("argsort", lambda p, x: p.argsort(x, axis=1, descending=True),
         [f(3, 5)]),
    Case("sort", lambda p, x: p.sort(x, axis=0), [f(4, 3)], (0,)),
    Case("topk", lambda p, x: p.topk(x, 2, axis=1), [f(3, 5)], (0,)),
    Case("topk_smallest", lambda p, x: p.topk(x, 3, largest=False),
         [f(3, 5)], (0,)),
    Case("kthvalue", lambda p, x: p.kthvalue(x, 2, axis=1), [f(3, 5)], (0,)),
    Case("mode", lambda p, x: p.mode(x, axis=1), [i(4, 9, lo=0, hi=4)]),
    Case("mode_keepdim", lambda p, x: p.mode(x, axis=0, keepdim=True),
         [i(7, 3, lo=0, hi=3)]),
    Case("nonzero", lambda p, x: (p.nonzero(x), p.nonzero(x, as_tuple=True)),
         [i(3, 4, lo=0, hi=2)]),
    Case("searchsorted", lambda p, s, v: (p.searchsorted(s, v),
                                          p.searchsorted(s, v, right=True)),
         [const(np.array([0.0, 1.0, 1.0, 3.0], np.float32)),
          const(np.array([1.0, -1.0, 2.5, 4.0], np.float32))]),
    Case("bucketize", lambda p, x, s: p.bucketize(x, s),
         [f(5), const(np.array([-1.0, 0.0, 1.0], np.float32))]),
    Case("median_even", lambda p, x: p.median(x, axis=1), [f(3, 6)], (0,)),
    Case("median_odd_all", lambda p, x: p.median(x), [f(3, 5)], (0,)),
    Case("median_min", lambda p, x: p.median(x, axis=1, mode="min"),
         [f(3, 6)], (0,)),
    Case("nanmedian", lambda p, x: p.nanmedian(x, axis=1), [f(3, 6)], (0,)),
    Case("quantile", lambda p, x: p.quantile(x, 0.3, axis=1), [f(3, 6)],
         (0,)),
    Case("quantile_vec", lambda p, x: p.quantile(x, [0.1, 0.5], axis=0),
         [f(5, 3)], (0,)),
    Case("unique", lambda p, x: p.unique(x, return_index=True,
                                         return_inverse=True,
                                         return_counts=True),
         [i(10, lo=0, hi=5)]),
    Case("unique_consecutive",
         lambda p, x: p.unique_consecutive(x, return_inverse=True,
                                           return_counts=True),
         [const(np.array([1, 1, 2, 2, 3, 1, 1, 2], np.int64))]),
    Case("histogram", lambda p, x: p.histogram(x, bins=5, min=-2, max=2),
         [f(20)]),
    Case("bincount", lambda p, x: p.bincount(x), [i(10, lo=0, hi=6)]),
    Case("bincount_weights", lambda p, x, w: p.bincount(x, w),
         [i(10, lo=0, hi=6), f(10)]),
]

# -------------------------------------------------------------------- linalg
LINALG = [
    Case("matmul", lambda p, x, y: p.matmul(x, y), [f(2, 3, 4), f(4, 5)],
         (0, 1)),
    Case("matmul_transposed",
         lambda p, x, y: p.matmul(x, y, transpose_x=True, transpose_y=True),
         [f(4, 3), f(5, 4)], (0, 1)),
    Case("matmul_vec", lambda p, x, y: p.matmul(x, y), [f(3, 4), f(4)],
         (0, 1)),
    Case("mm_bmm_mv", lambda p, x, y, z, v: (p.mm(x, y), p.bmm(z, z),
                                             p.mv(x, v)),
         [f(3, 4), f(4, 2), f(2, 3, 3), f(4)], (0, 1, 2, 3)),
    Case("dot", lambda p, x, y: p.dot(x, y), [f(3, 4), f(3, 4)], (0, 1)),
    Case("cross", lambda p, x, y: p.cross(x, y), [f(4, 3), f(4, 3)], (0, 1)),
    Case("multi_dot", lambda p, x, y, z: p.multi_dot([x, y, z]),
         [f(3, 4), f(4, 5), f(5, 2)], (0, 1, 2)),
    Case("norm_fro", lambda p, x: p.norm(x), [f(3, 4)], (0,)),
    Case("norm_axis", lambda p, x: p.norm(x, p=1, axis=1), [f(3, 4)], (0,)),
    Case("norm_inf", lambda p, x: p.norm(x, p=float("inf")), [f(3, 4)], (0,)),
    Case("norm_p3", lambda p, x: p.norm(x, p=3), [f(3, 4)], (0,)),
    Case("norm_nuc", lambda p, x: p.norm(x, p="nuc", axis=[0, 1]),
         [f(3, 4)], (0,), tol=1e-4),
    Case("dist", lambda p, x, y: p.dist(x, y, p=2), [f(3, 4), f(3, 4)],
         (0, 1)),
    Case("cdist", lambda p, x, y: p.cdist(x, y), [f(3, 4), f(5, 4)], (0, 1)),
    Case("t", lambda p, x: p.t(x), [f(3, 4)], (0,)),
    # decompositions: f32 LAPACK routines of two libraries, 1e-4
    Case("cholesky", lambda p, x: p.cholesky(x), [spd(4)], (0,), tol=1e-4),
    Case("cholesky_solve",
         lambda p, b_, x: p.cholesky_solve(b_, p.cholesky(x)),
         [f(4, 2), spd(4)], (0, 1), tol=1e-4),
    Case("inverse", lambda p, x: p.inverse(x), [spd(4)], (0,), tol=1e-4),
    Case("solve", lambda p, x, y: p.solve(x, y), [spd(4), f(4, 2)], (0, 1),
         tol=1e-4),
    Case("solve_vec", lambda p, x, y: p.solve(x, y), [spd(4), f(4)], (0, 1),
         tol=1e-4),
    Case("det_slogdet", lambda p, x: (p.det(x), p.slogdet(x)), [spd(3)],
         (0,), tol=1e-4),
    Case("einsum", lambda p, x, y: p.einsum("bij,jk->bik", x, y),
         [f(2, 3, 4), f(4, 5)], (0, 1)),
]


def _lin(name):
    """A linalg op that the flat namespace does not export."""
    return lambda p, *xs, **kw: getattr(p.ops.linalg, name)(*xs, **kw)


LINALG += [
    Case("triangular_solve",
         lambda p, a, y: _lin("triangular_solve")(p, p.triu(a) + 4.0 *
                                                  p.eye(4), y),
         [f(4, 4), f(4, 2)], (0, 1), tol=1e-4),
    Case("triangular_solve_t",
         lambda p, a, y: _lin("triangular_solve")(
             p, p.tril(a) + 4.0 * p.eye(4), y, upper=False, transpose=True),
         [f(4, 4), f(4, 2)], (0, 1), tol=1e-4),
    Case("pinv", lambda p, x: _lin("pinv")(p, x), [f(4, 3)], (0,), tol=1e-4),
    Case("matrix_power", lambda p, x: _lin("matrix_power")(p, x, 3),
         [f(3, 3)], (0,), tol=1e-4),
    Case("eigvalsh", lambda p, x: _lin("eigvalsh")(p, x), [spd(4)], (0,),
         tol=1e-4),
    # sign-free invariants of the factors: the factor signs depend on LAPACK.
    # Values only: the reference's vjp of these three fails (its jnp results
    # are named tuples, its cotangents plain ones); the port's gradients are
    # held against finite differences below.
    Case("svd", lambda p, x: _svd_invariants(p, x), [f(4, 3)], tol=1e-4),
    Case("qr", lambda p, x: _qr_invariants(p, x), [f(4, 3)], tol=1e-4),
    Case("eigh", lambda p, x: _eigh_invariants(p, x), [spd(3)], tol=1e-4),
    Case("cov_corrcoef", lambda p, x: (_lin("cov")(p, x),
                                       _lin("corrcoef")(p, x)),
         [f(3, 6)], (0,), tol=1e-4),
    Case("matrix_exp", lambda p, x: _lin("matrix_exp")(p, x * 0.3),
         [f(3, 3)], (0,), tol=1e-4),
    Case("vector_norm", lambda p, x: _lin("vector_norm")(p, x, 3.0, axis=1),
         [f(3, 4)], (0,)),
    Case("matrix_rank", lambda p, x: _lin("matrix_rank")(p, x), [f(4, 3)]),
    Case("cond", lambda p, x: _lin("cond")(p, x), [spd(3)], tol=1e-4),
]


def _svd_invariants(p, x):
    u, s, vh = _lin("svd")(p, x)
    return s, p.matmul(u * s, vh)


def _qr_invariants(p, x):
    q, r = _lin("qr")(p, x)
    return p.matmul(q, r), p.abs(r), p.matmul(q.T, q)


def _eigh_invariants(p, x):
    w, v = _lin("eigh")(p, x)
    return w, v * v


ALL = CREATION + MATH + MANIPULATION + LOGIC + SEARCH + LINALG


@pytest.mark.parametrize("name", ["svd", "qr", "eigh"])
def test_decomposition_gradients_match_finite_differences(name):
    """The gradients the reference cannot take (see LINALG): torch's
    gradcheck of the port's op in float64."""
    import torch
    fn = {"svd": _svd_invariants, "qr": _qr_invariants,
          "eigh": _eigh_invariants}[name]
    r = _rng(5)
    a = spd(3)(r) if name == "eigh" else f(4, 3)(r)

    def pure(t):
        return tuple(o._data for o in fn(T, T.Tensor._wrap(t, False)))
    x = torch.tensor(a, dtype=torch.float64, requires_grad=True)
    if name == "eigh":
        # eigh reads one triangle: differentiate through a symmetric input
        assert torch.autograd.gradcheck(lambda t: pure((t + t.T) / 2), (x,))
    else:
        assert torch.autograd.gradcheck(pure, (x,))


@pytest.mark.parametrize("case", ALL, ids=repr)
def test_op_matches_reference(case):
    _check(case)


def test_case_ids_are_unique():
    ids = [c.id for c in ALL]
    assert len(ids) == len(set(ids))


# ------------------------------------------------------------------ inplace
INPLACE = [
    ("add_", lambda p, x, y: x.add_(y), [f(3), f(3)]),
    ("subtract_", lambda p, x, y: x.subtract_(y), [f(3), f(3)]),
    ("multiply_", lambda p, x, y: x.multiply_(y), [f(3), f(3)]),
    ("divide_", lambda p, x, y: x.divide_(y), [f(3), f(3, lo=1, hi=2)]),
    ("scale_", lambda p, x: x.scale_(2.0, 1.0), [f(3)]),
    ("clip_", lambda p, x: x.clip_(-0.2, 0.3), [f(3)]),
    ("exp_sqrt_", lambda p, x: x.exp_().sqrt_(), [f(3)]),
    ("zero_fill_", lambda p, x: (x.zero_(), x.fill_(2.5))[1], [f(3)]),
    ("reshape_squeeze_", lambda p, x: x.reshape_([1, 6]).squeeze_(0),
     [f(2, 3)]),
    ("unsqueeze_flatten_", lambda p, x: x.unsqueeze_(0).flatten_(), [f(2, 3)]),
    ("masked_fill_", lambda p, x, m: x.masked_fill_(m, 0.0), [f(3), b(3)]),
    ("generated_tanh_", lambda p, x: p.tanh_(x), [f(3)]),
    ("generated_pow_", lambda p, x: p.pow_(x, 2), [f(3)]),
    ("cast_", lambda p, x: p.cast_(x, "float16").astype("float32"), [f(3)]),
    ("increment", lambda p, x: p.increment(x, 2.0), [f(1)]),
]


@pytest.mark.parametrize("name,fn,inputs", INPLACE,
                         ids=[c[0] for c in INPLACE])
def test_inplace_op_matches_reference(name, fn, inputs):
    """The value, that the op returns its input, and the version bump."""
    r = _rng(7)
    arrays = [mk(r) for mk in inputs]
    got = {}
    for pd in (P, T):
        xs = [pd.to_tensor(a) for a in arrays]
        out = fn(pd, *xs)
        got[pd] = (out.numpy(), xs[0].numpy(), xs[0].inplace_version() > 0,
                   out is xs[0] or name == "cast_")
    (want_o, want_x, want_v, want_same), (o, x, v, same) = got[P], got[T]
    _close(o, want_o, 1e-3 if name == "cast_" else F32_TOL, name)
    _close(x, want_x, 1e-3 if name == "cast_" else F32_TOL, name)
    assert v and want_v and same and want_same


# -------------------------------------------------------------------- random
RANDOM = [
    ("rand", lambda p: p.rand([4000]), 0.5, 1 / 12),
    ("randn", lambda p: p.randn([4000]), 0.0, 1.0),
    ("standard_normal", lambda p: p.standard_normal([4000]), 0.0, 1.0),
    ("normal", lambda p: p.normal(2.0, 3.0, [4000]), 2.0, 9.0),
    ("uniform", lambda p: p.uniform([4000], min=-2.0, max=4.0), 1.0, 3.0),
    ("randint", lambda p: p.randint(0, 10, [4000]), 4.5, 8.25),
    ("randperm", lambda p: p.randperm(4000), 1999.5, (4000**2 - 1) / 12),
    ("bernoulli", lambda p: p.bernoulli(p.full([4000], 0.3)), 0.3, 0.21),
    ("poisson", lambda p: p.poisson(p.full([4000], 3.0)), 3.0, 3.0),
    ("multinomial",
     lambda p: p.multinomial(p.to_tensor([0.2, 0.3, 0.5]), 4000,
                             replacement=True), 1.3, 0.61),
    ("exponential_", lambda p: p.zeros([4000]).exponential_(2.0), 0.5, 0.25),
    ("normal_", lambda p: p.zeros([4000]).normal_(1.0, 2.0), 1.0, 4.0),
    ("rand_like", lambda p: p.rand_like(p.zeros([4000])), 0.5, 1 / 12),
    ("randn_like", lambda p: p.randn_like(p.zeros([4000])), 0.0, 1.0),
]


@pytest.mark.parametrize("name,fn,mean,var", RANDOM,
                         ids=[c[0] for c in RANDOM])
def test_random_op_is_seeded_and_has_its_moments(name, fn, mean, var):
    """Draws repeat under seed and differ without it; mean and variance are
    within 5 standard errors of the distribution's, as the reference's
    are. No value is compared with jax's: torch draws other numbers."""
    T.seed(11)
    a = fn(T).astype("float64").numpy()
    T.seed(11)
    again = fn(T).astype("float64").numpy()
    other = fn(T).astype("float64").numpy()
    np.testing.assert_array_equal(a, again)
    assert not np.array_equal(a, other)
    n = a.size
    for pd_name, x in (("port", a),
                       ("reference", fn(P).astype("float32").numpy())):
        x = x.astype(np.float64)
        assert abs(x.mean() - mean) < 5 * np.sqrt(var / n), (pd_name, x.mean())
        # the variance of a sample variance is about 2 var^2 / n for these
        assert abs(x.var() - var) < 5 * np.sqrt(2 * var**2 / n) + \
            5 * var / np.sqrt(n), (pd_name, x.var())


def test_random_dtypes_and_shapes_match_reference():
    for fn in (lambda p: p.rand([2, 3]), lambda p: p.randn([2, 3]),
               lambda p: p.randint(0, 5, [2, 3]),
               lambda p: p.uniform([2, 3], dtype="float32")):
        got, want = fn(T), fn(P)
        assert got.shape == want.shape
        assert got.dtype.name.rstrip("0123456789") == \
            want.dtype.name.rstrip("0123456789")


# ---------------------------------------------------- mixed-dtype products
MIXED_DTYPES = [("float32", "bfloat16"), ("bfloat16", "float32"),
                ("float16", "float32")]
MIXED = [
    ("linear", lambda p, x, w, b: p.nn.functional.linear(x, w)),
    ("linear_bias", lambda p, x, w, b: p.nn.functional.linear(x, w, b)),
    ("matmul", lambda p, x, w, b: p.matmul(x, w)),
    ("matmul_t", lambda p, x, w, b: p.matmul(x.T, w, transpose_x=True)),
    ("mm", lambda p, x, w, b: p.mm(x, w)),
    ("bmm", lambda p, x, w, b: p.bmm(x.unsqueeze(0), w.unsqueeze(0))),
    ("addmm", lambda p, x, w, b: p.addmm(b, x, w, beta=0.5, alpha=2.0)),
    ("einsum", lambda p, x, w, b: p.einsum("ij,jk->ik", x, w)),
]


@pytest.mark.parametrize("dx,dw", MIXED_DTYPES)
@pytest.mark.parametrize("name,fn", MIXED, ids=[c[0] for c in MIXED])
def test_mixed_dtype_products_promote(name, fn, dx, dw):
    """Products of two float dtypes promote as jnp's do (f32 x bf16 is f32)
    where torch's refuse them; the bias takes the weight's dtype. Values,
    dtype and the gradient of every input (in its own dtype)."""
    r = _rng(zlib.crc32(f"{name}{dx}{dw}".encode()))
    arrays = [r.randn(2, 4), r.randn(4, 3), r.randn(3)]
    outs = {}
    for pd in (P, T):
        xs = [pd.to_tensor(a.astype(np.float32)).astype(d)
              for a, d in zip(arrays, (dx, dw, dw))]
        for t in xs:
            t.stop_gradient = False
        out = fn(pd, *xs)
        (out.astype("float32") * pd.to_tensor(
            np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3))
         ).sum().backward()
        outs[pd] = (str(out.dtype), out.astype("float32").numpy(),
                    [None if t.grad is None else
                     (str(t.grad.dtype), t.grad.astype("float32").numpy())
                     for t in xs])
    (want_dt, want, want_g), (got_dt, got, got_g) = outs[P], outs[T]
    assert got_dt == want_dt == "float32"
    _close(got, want, F32_TOL, name)
    for k, (g, w) in enumerate(zip(got_g, want_g)):
        assert (g is None) == (w is None), k
        if w is not None:
            assert g[0] == w[0], (k, g[0], w[0])
            _close(g[1], w[1], BF16_TOL if "float32" not in w[0]
                   else F32_TOL, f"{name} grad {k}")


def test_imag_of_a_real_tensor_is_zeros_with_a_zero_gradient():
    x = np.array([0.5, 1.0, 2.0], np.float32)
    for dtype in ("float32", "float64"):
        got = T.imag(T.to_tensor(x.astype(dtype)))
        want = P.imag(P.to_tensor(x.astype(dtype)))
        assert got.numpy().dtype == want.numpy().dtype
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    for pkg in (T, P):
        t = pkg.to_tensor(x, stop_gradient=False)
        (pkg.imag(t) + t).sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), np.ones(3, np.float32))
