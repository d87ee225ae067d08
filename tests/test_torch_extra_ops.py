"""The ops this slice adds to the port's eager library, against the
reference on the CPU: ``ops/extra.py``, ``ops/vision_ops.py``, ``signal``,
``ops/compat.py``, ``geometric`` and ``ops/array.py``.

Each case runs the same numpy inputs (made from a seed) through
``paddle_tpu`` and ``paddle_tpu_torch`` and compares every output, and, for
the inputs marked differentiable, the gradient of ``sum(out * w)`` (w fixed
random weights, one per float output). Tolerances: f32 outputs rtol 1e-5
and atol 1e-6, the special functions rtol 1e-5; gradients within 1e-4 of
the reference gradient's scale. Values are compared, not storage widths
(the reference stores int64 as int32 while jax's x64 mode is off). The ops
that draw (``standard_gamma``, ``dirichlet``, ``top_p_sampling``,
``log_normal`` and the random fills) draw from torch's generators, so their
draws differ from jax's by design: they are held to their distribution and
support instead. ``gammainc``/``gammaincc`` are differentiated in both
arguments, and their derivative in ``a`` is also held to ``jax.grad`` in
float64 at 1e-5 relative, in both of its regimes.
"""
import importlib

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

OUT_RTOL, OUT_ATOL, GRAD_TOL = 1e-5, 1e-6, 1e-4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    T.seed(2024)
    yield


def _r(seed=0):
    return np.random.RandomState(seed)


def f32(*shape, lo=None, hi=None, seed=0):
    r = _r(seed)
    if lo is None:
        return r.randn(*shape).astype(np.float32)
    return r.uniform(lo, hi, shape).astype(np.float32)


def i64(*shape, hi=5, seed=0):
    return _r(seed).randint(0, hi, shape).astype(np.int64)


class Case:
    def __init__(self, id, fn, inputs, diff=(), rtol=OUT_RTOL,
                 atol=OUT_ATOL):
        self.id, self.fn, self.inputs, self.diff = id, fn, inputs, diff
        self.rtol, self.atol = rtol, atol

    def __repr__(self):
        return self.id


def _outs(out):
    if isinstance(out, (tuple, list)):
        return [o for o in out if o is not None]
    return [out]


def _forward_backward(pd, case, xs):
    for k in case.diff:
        xs[k].stop_gradient = False
    outs = _outs(case.fn(pd, *xs))
    grads = []
    if case.diff:
        r = _r(99)
        total = None
        for o in outs:
            if "float" in str(getattr(o, "dtype", "")):
                w = pd.to_tensor(np.asarray(r.randn(*o.shape), np.float32))
                term = (o.astype("float32") * w).sum()
                total = term if total is None else total + term
        total.backward()
        grads = [xs[k].grad for k in case.diff]
    return outs, grads


def _run(pd, case):
    """Outputs and the gradients of sum(out_i * w_i) with respect to the
    inputs in ``case.diff``. The reference's runs as one program through
    its ``jit.to_static`` (op by op it compiles a kernel an op shape), which
    runs op by op where its trace cannot follow the case; op by op too
    where the compiled backward refuses an op (the pools' reduce_window
    under JAX's linearization raises ValueError)."""
    xs = [pd.to_tensor(a) for a in case.inputs]
    if pd is P:
        try:
            outs, grads = P.jit.to_static(
                lambda *ts: _forward_backward(P, case, list(ts)))(*xs)
        except ValueError:
            outs, grads = _forward_backward(
                P, case, [pd.to_tensor(a) for a in case.inputs])
    else:
        outs, grads = _forward_backward(pd, case, xs)
    vals = [np.asarray(o.numpy()) if hasattr(o, "numpy") else np.asarray(o)
            for o in outs]
    return vals, [g.numpy() for g in grads]


def _check(case):
    (ref, ref_g), (got, got_g) = _run(P, case), _run(T, case)
    assert len(got) == len(ref), case.id
    for i, (g, w) in enumerate(zip(got, ref)):
        assert g.shape == w.shape, (case.id, i, g.shape, w.shape)
        if w.dtype == np.bool_ or g.dtype == np.bool_:
            np.testing.assert_array_equal(g, w, err_msg=f"{case.id} {i}")
        else:
            np.testing.assert_allclose(
                g.astype(np.float64), w.astype(np.float64), rtol=case.rtol,
                atol=case.atol, err_msg=f"{case.id} output {i}")
    for k, g, w in zip(case.diff, got_g, ref_g):
        scale = max(float(np.max(np.abs(w))), 1e-6)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=f"{case.id} grad of input {k}")


def X(pd):
    return pd.ops.extra


def V(pd):
    return importlib.import_module(pd.__name__ + ".ops.vision_ops")


POS = f32(3, 4, lo=0.5, hi=3.0)
PROB = f32(3, 4, lo=0.05, hi=0.95, seed=1)
IMG = f32(2, 3, 6, 6, seed=2)

EXTRA = [
    Case("p_norm", lambda pd, x: X(pd).p_norm(x, 3.0, 1), [f32(3, 4)], (0,)),
    Case("p_norm_inf_keepdim", lambda pd, x: X(pd).p_norm(
        x, float("inf"), 0, keepdim=True), [f32(3, 4)], (0,)),
    Case("p_norm_zero_vector", lambda pd, x: X(pd).p_norm(
        x, 0, asvector=True), [f32(3, 4)]),
    Case("frobenius_norm", lambda pd, x: X(pd).frobenius_norm(x, [0, 1]),
         [f32(3, 4)], (0,)),
    Case("squared_l2_norm", lambda pd, x: X(pd).squared_l2_norm(x),
         [f32(3, 4)], (0,)),
    Case("clip_by_norm", lambda pd, x: X(pd).clip_by_norm(x, 1.0),
         [f32(3, 4)], (0,)),
    Case("renorm", lambda pd, x: X(pd).renorm(x, 2.0, 0, 1.0), [f32(3, 4)],
         (0,)),
    Case("gammaln", lambda pd, x: X(pd).gammaln(x), [POS], (0,)),
    Case("polygamma_0", lambda pd, x: X(pd).polygamma(x, 0), [POS], (0,)),
    Case("polygamma_2", lambda pd, x: X(pd).polygamma(x, 2), [POS], (0,)),
    Case("gammaincc", lambda pd, a, x: X(pd).gammaincc(a, x),
         [POS, f32(3, 4, lo=0.1, hi=4.0, seed=3)], (0, 1)),
    Case("gammainc", lambda pd, a, x: X(pd).gammainc(a, x),
         [POS, f32(3, 4, lo=0.1, hi=4.0, seed=3)], (0, 1)),
    Case("logsigmoid", lambda pd, x: X(pd).logsigmoid(x), [f32(3, 4)],
         (0,)),
    Case("tanh_shrink", lambda pd, x: X(pd).tanh_shrink(x), [f32(3, 4)],
         (0,)),
    Case("swiglu_split", lambda pd, x: X(pd).swiglu(x), [f32(3, 4)], (0,)),
    Case("swiglu_pair", lambda pd, x, y: X(pd).swiglu(x, y),
         [f32(3, 4), f32(3, 4, seed=1)], (0, 1)),
    Case("fill", lambda pd, x: X(pd).fill(x, 2.5), [f32(3, 4)]),
    Case("fill_diagonal", lambda pd, x: X(pd).fill_diagonal(x, 9.0, 1),
         [f32(4, 5)], (0,)),
    Case("fill_diagonal_neg", lambda pd, x: X(pd).fill_diagonal(
        x, 9.0, -1), [f32(2, 4, 3)], (0,)),
    Case("fill_diagonal_wrap", lambda pd, x: X(pd).fill_diagonal(
        x, 7.0, 0, wrap=True), [f32(5, 3)]),
    Case("reverse", lambda pd, x: X(pd).reverse(x, [0, 1]), [f32(3, 4)],
         (0,)),
    Case("shape", lambda pd, x: X(pd).shape(x), [f32(3, 4, 2)]),
    Case("as_strided", lambda pd, x: X(pd).as_strided(x, [3, 2], [2, 3], 1),
         [f32(3, 4)], (0,)),
    Case("tensor_unfold", lambda pd, x: X(pd).tensor_unfold(x, 1, 3, 2),
         [f32(2, 7, 3)], (0,)),
    Case("view_dtype", lambda pd, x: X(pd).view_dtype(x, "int32"),
         [f32(3, 4)]),
    Case("view_shape", lambda pd, x: X(pd).view_shape(x, [4, 3]),
         [f32(3, 4)], (0,)),
    Case("split_with_num", lambda pd, x: X(pd).split_with_num(x, 2, 1),
         [f32(3, 4)], (0,)),
    Case("reduce_as", lambda pd, x, t: X(pd).reduce_as(x, t),
         [f32(2, 3, 4), f32(3, 1, seed=1)], (0,)),
    Case("bce_loss", lambda pd, p, y: X(pd).bce_loss(p, y),
         [PROB, (f32(3, 4, seed=2) > 0).astype(np.float32)], (0,)),
    Case("hinge_loss", lambda pd, x, y: X(pd).hinge_loss(x, y),
         [f32(3, 4), (f32(3, 4, seed=2) > 0).astype(np.float32)], (0,)),
    Case("kldiv_mean", lambda pd, x, y: X(pd).kldiv_loss(x, y),
         [f32(3, 4), PROB], (0,)),
    Case("kldiv_batchmean", lambda pd, x, y: X(pd).kldiv_loss(
        x, y, "batchmean"), [f32(3, 4), PROB], (0,)),
    Case("kldiv_none_log_target", lambda pd, x, y: X(pd).kldiv_loss(
        x, y, "none", True), [f32(3, 4), f32(3, 4, seed=4)], (0, 1)),
    Case("sigmoid_ce_logits", lambda pd, x, y: X(pd)
         .sigmoid_cross_entropy_with_logits(x, y, normalize=True),
         [f32(3, 4), (f32(3, 4, seed=2) > 0).astype(np.float32)], (0,)),
    Case("margin_cross_entropy", lambda pd, x, y: X(pd)
         .margin_cross_entropy(x, y, return_softmax=True),
         [f32(4, 6, lo=-0.9, hi=0.9), i64(4, hi=6)], (0,), rtol=1e-4),
    Case("fused_softmax_mask", lambda pd, x, m: X(pd).fused_softmax_mask(
        x, m), [f32(2, 2, 4, 4), f32(2, 1, 4, 4, seed=1)], (0,)),
    Case("fused_softmax_mask_triu", lambda pd, x: X(pd)
         .fused_softmax_mask_upper_triangle(x), [f32(2, 2, 4, 4)], (0,)),
    Case("edit_distance", lambda pd, h, r: X(pd).edit_distance(h, r),
         [i64(3, 5, hi=4), i64(3, 6, hi=4, seed=1)]),
    Case("edit_distance_lengths_normalized", lambda pd, h, r, hl, rl:
         X(pd).edit_distance(h, r, hl, rl, normalized=True),
         [i64(3, 5, hi=4), i64(3, 6, hi=4, seed=1),
          np.array([5, 3, 1]), np.array([6, 2, 4])]),
    Case("viterbi_decode", lambda pd, e, t, n: X(pd).viterbi_decode(e, t, n),
         [f32(2, 5, 3), f32(5, 5, seed=1), np.array([5, 3])]),
    Case("viterbi_decode_no_bos", lambda pd, e, t, n: X(pd).viterbi_decode(
        e, t, n, False), [f32(2, 5, 3), f32(3, 3, seed=1),
                          np.array([4, 5])]),
    Case("gather_tree", lambda pd, i, p: X(pd).gather_tree(i, p),
         [i64(4, 2, 3, hi=9), i64(4, 2, 3, hi=3, seed=1)]),
    Case("send_u_recv_sum", lambda pd, x, s, d: X(pd).send_u_recv(
        x, s, d, "SUM", 4), [f32(5, 3), np.array([0, 1, 2, 3, 4, 0]),
                             np.array([1, 1, 0, 3, 0, 1])], (0,)),
    Case("send_u_recv_mean", lambda pd, x, s, d: X(pd).send_u_recv(
        x, s, d, "MEAN"), [f32(5, 3), np.array([0, 1, 2, 3, 4, 0]),
                           np.array([1, 1, 0, 3, 0, 1])], (0,)),
    Case("send_u_recv_max_empty_rows", lambda pd, x, s, d: X(pd).send_u_recv(
        x, s, d, "MAX"), [f32(5, 3), np.array([0, 1, 2, 3, 4, 0]),
                          np.array([1, 1, 0, 3, 0, 1])], (0,)),
    Case("send_u_recv_min", lambda pd, x, s, d: X(pd).send_u_recv(
        x, s, d, "MIN"), [f32(5, 3), np.array([0, 1, 2, 3, 4, 0]),
                          np.array([1, 1, 0, 3, 0, 1])], (0,)),
    Case("segment_pool_sum", lambda pd, x, s: X(pd).segment_pool(x, s),
         [f32(6, 3), np.array([0, 0, 1, 1, 1, 3])], (0,)),
    Case("segment_pool_mean", lambda pd, x, s: X(pd).segment_pool(
        x, s, "MEAN"), [f32(6, 3), np.array([0, 0, 1, 1, 1, 3])], (0,)),
    Case("segment_pool_max", lambda pd, x, s: X(pd).segment_pool(
        x, s, "MAX"), [f32(6, 3), np.array([0, 0, 1, 1, 1, 2])], (0,)),
    Case("segment_pool_min", lambda pd, x, s: X(pd).segment_pool(
        x, s, "MIN"), [f32(6, 3), np.array([0, 0, 1, 1, 1, 2])], (0,)),
]

VISION = [
    Case("bilinear_interp", lambda pd, x: V(pd).bilinear_interp(x, 9, 4),
         [IMG], (0,)),
    Case("bilinear_interp_align", lambda pd, x: V(pd).bilinear_interp(
        x, 9, 4, align_corners=True), [IMG], (0,)),
    Case("nearest_interp", lambda pd, x: V(pd).nearest_interp(x, 9, 4),
         [IMG], (0,)),
    Case("bicubic_interp", lambda pd, x: V(pd).bicubic_interp(x, 9, 4),
         [IMG], (0,)),
    Case("linear_interp", lambda pd, x: V(pd).linear_interp(x, 9),
         [f32(2, 3, 6)], (0,)),
    Case("trilinear_interp", lambda pd, x: V(pd).trilinear_interp(
        x, 3, 5, 4), [f32(1, 2, 2, 3, 3)], (0,)),
    Case("affine_grid", lambda pd, t: V(pd).affine_grid(t, [2, 3, 4, 5]),
         [f32(2, 2, 3)], (0,)),
    Case("affine_grid_unaligned", lambda pd, t: V(pd).affine_grid(
        t, [2, 3, 4, 5], False), [f32(2, 2, 3)], (0,)),
] + [
    Case(f"grid_sample_{mode}_{pad}_{ac}", (
        lambda mode, pad, ac: lambda pd, x, g: V(pd).grid_sample(
            x, g, mode, pad, ac))(mode, pad, ac),
        [IMG, f32(2, 4, 5, 2, lo=-1.2, hi=1.2, seed=5)],
        (0, 1) if mode == "bilinear" else (0,))
    for mode in ("bilinear", "nearest")
    for pad in ("zeros", "border", "reflection")
    for ac in (True, False)
] + [
    Case(f"pad3d_{mode}", (lambda mode: lambda pd, x: V(pd).pad3d(
        x, [1, 2, 0, 1, 2, 1], mode, 0.5))(mode), [f32(1, 2, 3, 4, 4)],
        (0,))
    for mode in ("constant", "reflect", "replicate", "circular")
] + [
    Case("pad3d_ndhwc", lambda pd, x: V(pd).pad3d(
        x, [1, 0, 0, 1, 1, 1], data_format="NDHWC"), [f32(1, 3, 4, 4, 2)],
        (0,)),
    Case("pool2d_max_pad", lambda pd, x: V(pd).pool2d(x, 3, 2, 2),
         [IMG], (0,)),
    Case("pool2d_avg_exclusive", lambda pd, x: V(pd).pool2d(
        x, 3, 2, 1, "avg"), [IMG], (0,)),
    Case("pool2d_avg_inclusive", lambda pd, x: V(pd).pool2d(
        x, 2, 2, 1, "avg", exclusive=False), [IMG], (0,)),
    Case("pool2d_adaptive", lambda pd, x: V(pd).pool2d(
        x, [4, 3], pooling_type="avg", adaptive=True), [IMG], (0,)),
    Case("pool2d_adaptive_max", lambda pd, x: V(pd).pool2d(
        x, [4, 4], adaptive=True), [IMG], (0,)),
    Case("pool2d_global_nhwc", lambda pd, x: V(pd).pool2d(
        x, 2, global_pooling=True, data_format="NHWC"), [IMG], (0,)),
    Case("pool3d_max", lambda pd, x: V(pd).pool3d(x, 2, 2, 1),
         [f32(1, 2, 4, 4, 4)], (0,)),
    Case("pool3d_avg", lambda pd, x: V(pd).pool3d(
        x, 2, 1, 0, "avg"), [f32(1, 2, 4, 4, 4)], (0,)),
    Case("pool3d_global", lambda pd, x: V(pd).pool3d(
        x, 2, global_pooling=True), [f32(1, 2, 4, 4, 4)], (0,)),
    Case("max_pool2d_with_index", lambda pd, x: V(pd).max_pool2d_with_index(
        x, 2), [IMG], (0,)),
    Case("max_pool2d_with_index_pad", lambda pd, x: V(pd)
         .max_pool2d_with_index(x, 3, 2, 1), [IMG], (0,)),
    Case("unpool", lambda pd, x: V(pd).unpool(
        *V(pd).max_pool2d_with_index(x, 2), 2), [IMG], (0,)),
    Case("temporal_shift", lambda pd, x: V(pd).temporal_shift(x, 2),
         [f32(4, 8, 2, 2)], (0,)),
    Case("temporal_shift_nhwc", lambda pd, x: V(pd).temporal_shift(
        x, 2, 0.125, "NHWC"), [f32(4, 2, 2, 8)], (0,)),
    Case("shuffle_channel", lambda pd, x: V(pd).shuffle_channel(x, 3),
         [f32(2, 6, 2, 2)], (0,)),
]

SIGNAL = [
    Case("frame", lambda pd, x: pd.signal.frame(x, 4, 2), [f32(2, 10)],
         (0,)),
    Case("frame_axis0", lambda pd, x: pd.signal.frame(x, 3, 3, axis=0),
         [f32(10)], (0,)),
    Case("overlap_add", lambda pd, x: pd.signal.overlap_add(x, 2),
         [f32(2, 4, 3)], (0,)),
    Case("stft", lambda pd, x: pd.signal.stft(x, 8, 2).abs(), [f32(2, 32)],
         (0,), rtol=1e-4, atol=1e-5),
    Case("stft_window", lambda pd, x, w: pd.signal.stft(
        x, 8, 4, 6, w, center=False, normalized=True).abs(),
         [f32(32), f32(6, lo=0.1, hi=1.0)], (0, 1), rtol=1e-4, atol=1e-5),
    Case("istft_round_trip", lambda pd, x: pd.signal.istft(
        pd.signal.stft(x, 8, 2), 8, 2), [f32(2, 32)], (0,), rtol=1e-4,
         atol=1e-5),
]

COMPAT = [
    # values only: the reference's block_diag rewraps its inputs, so no
    # gradient reaches them there (the port's is differentiable)
    Case("block_diag", lambda pd, a, b: pd.block_diag([a, b]),
         [f32(2, 3), f32(1, 2, seed=1)]),
    Case("cartesian_prod", lambda pd, a, b: pd.cartesian_prod([a, b]),
         [f32(3), f32(2, seed=1)], (0, 1)),
    Case("combinations", lambda pd, a: pd.combinations(a, 2), [f32(4)],
         (0,)),
    Case("combinations_replacement", lambda pd, a: pd.combinations(
        a, 2, True), [f32(3)], (0,)),
    Case("vander", lambda pd, a: pd.vander(a, 4), [f32(3)], (0,)),
    Case("vander_increasing", lambda pd, a: pd.vander(a, increasing=True),
         [f32(3)], (0,)),
    Case("column_stack", lambda pd, a, b: pd.column_stack([a, b]),
         [f32(3), f32(3, 2, seed=1)], (0, 1)),
    Case("row_stack", lambda pd, a, b: pd.row_stack([a, b]),
         [f32(3), f32(2, 3, seed=1)], (0, 1)),
    Case("hsplit", lambda pd, a: pd.hsplit(a, [1, 3]), [f32(2, 4)], (0,)),
    Case("vsplit", lambda pd, a: pd.vsplit(a, 2), [f32(4, 2)], (0,)),
    Case("dsplit", lambda pd, a: pd.dsplit(a, [1]), [f32(2, 2, 3)], (0,)),
    Case("unflatten", lambda pd, a: pd.unflatten(a, 1, [2, -1]),
         [f32(3, 6)], (0,)),
    Case("add_n", lambda pd, a, b: pd.add_n([a, b, a]),
         [f32(3), f32(3, seed=1)], (0, 1)),
    Case("slice_scatter", lambda pd, a, v: pd.slice_scatter(
        a, v, [1], [0], [4], [2]), [f32(3, 4), f32(3, 2, seed=1)], (0, 1)),
    Case("select_scatter", lambda pd, a, v: pd.select_scatter(a, v, 0, 1),
         [f32(3, 4), f32(4, seed=1)], (0, 1)),
    Case("diagonal_scatter", lambda pd, a, v: pd.diagonal_scatter(a, v, 1),
         [f32(3, 4), f32(3, seed=1)], (0, 1)),
    Case("isin", lambda pd, a, t: pd.isin(a, t),
         [i64(3, 4, hi=6), np.array([1, 4])]),
    Case("histogram_bin_edges", lambda pd, a: pd.histogram_bin_edges(a, 5),
         [f32(10)]),
    Case("histogram_bin_edges_range", lambda pd, a: pd.histogram_bin_edges(
        a, 4, -1.0, 2.0), [f32(10)]),
    Case("pdist", lambda pd, a: pd.pdist(a), [f32(4, 3)], (0,)),
    Case("pdist_p1", lambda pd, a: pd.pdist(a, 1.0), [f32(4, 3)], (0,)),
    Case("sinc", lambda pd, a: pd.sinc(a), [f32(3, 4)], (0,)),
    Case("sgn", lambda pd, a: pd.sgn(a), [f32(3, 4)]),
    Case("signbit", lambda pd, a: pd.signbit(a), [f32(3, 4)]),
    Case("frexp", lambda pd, a: pd.frexp(a), [f32(3, 4)]),
    Case("ldexp", lambda pd, a, e: pd.ldexp(a, e),
         [f32(3, 4), i64(3, 4, hi=4)], (0,)),
    Case("trapezoid", lambda pd, y: pd.trapezoid(y, dx=0.5), [f32(3, 5)],
         (0,)),
    Case("trapezoid_x", lambda pd, y, x: pd.trapezoid(y, x),
         [f32(3, 5), np.sort(f32(5, seed=1))], (0,)),
    Case("cumulative_trapezoid", lambda pd, y: pd.cumulative_trapezoid(y),
         [f32(3, 5)], (0,)),
    Case("cumulative_trapezoid_x", lambda pd, y, x: pd.cumulative_trapezoid(
        y, x, axis=1), [f32(3, 5), np.sort(f32(5, seed=1))], (0,)),
    Case("multigammaln", lambda pd, a: pd.multigammaln(a, 3),
         [f32(3, 4, lo=2.0, hi=5.0)], (0,)),
    Case("rank", lambda pd, a: pd.rank(a), [f32(3, 4, 2)]),
    Case("renorm_inplace", lambda pd, a: pd.renorm_(a * 1.0, 2.0, 1, 1.5),
         [f32(3, 4)], (0,)),
    Case("sinc_inplace", lambda pd, a: pd.sinc_(a * 1.0), [f32(3, 4)],
         (0,)),
    Case("gammaln_inplace", lambda pd, a: pd.gammaln_(a * 1.0), [POS], (0,)),
]

GEOMETRIC = [
    Case(f"segment_{how}", (lambda how: lambda pd, x, s: getattr(
        pd.geometric, f"segment_{how}")(x, s))(how),
        [f32(6, 3), np.array([0, 0, 1, 1, 1, 3])], (0,))
    for how in ("sum", "mean", "max", "min")
] + [
    Case(f"geometric_send_u_recv_{op}", (lambda op: lambda pd, x, s, d:
                                         pd.geometric.send_u_recv(
                                             x, s, d, op))(op),
         [f32(5, 3), np.array([0, 1, 2, 3, 4, 0]),
          np.array([1, 1, 0, 3, 0, 1])], (0,))
    for op in ("sum", "mean", "max", "min")
] + [
    Case("send_ue_recv", lambda pd, x, e, s, d: pd.geometric.send_ue_recv(
        x, e, s, d, "mul", "sum"),
         [f32(5, 3), f32(6, 3, seed=1), np.array([0, 1, 2, 3, 4, 0]),
          np.array([1, 1, 0, 3, 0, 1])], (0, 1)),
    Case("send_uv", lambda pd, x, y, s, d: pd.geometric.send_uv(
        x, y, s, d, "sub"),
         [f32(5, 3), f32(5, 3, seed=1), np.array([0, 1, 2]),
          np.array([4, 3, 2])], (0, 1)),
    Case("sample_neighbors_all", lambda pd, r, c, n: pd.geometric
         .sample_neighbors(r, c, n),
         [np.array([1, 2, 0, 2, 0]), np.array([0, 2, 4, 5]),
          np.array([0, 2])]),
    Case("reindex_graph", lambda pd, x, n, c: pd.geometric.reindex_graph(
        x, n, c), [np.array([5, 9]), np.array([9, 7, 5, 8]),
                   np.array([3, 1])]),
]

CASES = EXTRA + VISION + SIGNAL + COMPAT + GEOMETRIC


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_matches_reference(case):
    _check(case)


@pytest.mark.parametrize("name", ["gammainc", "gammaincc"])
def test_gammainc_grad_in_a_matches_jax_f64(name):
    """d/da of P and Q at (a, x) pairs of both regimes of jax's
    igamma_grad_a: the series (x <= 1 or x <= a) and the continued
    fraction (x > 1 and x > a); 1e-5 relative in float64."""
    import jax
    import jax.numpy as jnp
    a = np.array([0.3, 0.8, 1.0, 4.0, 10.0, 0.5, 2.5, 3.0, 7.5, 2.0])
    x = np.array([0.2, 0.05, 0.5, 1.5, 9.0, 3.0, 6.0, 3.5, 12.0, 40.0])
    assert ((x > 1) & (x > a)).sum() == 5        # five of each regime
    ta = T.to_tensor(a, dtype="float64", stop_gradient=False)
    tx = T.to_tensor(x, dtype="float64", stop_gradient=False)
    getattr(T.ops.extra, name)(ta, tx).sum().backward()
    fn = getattr(jax.scipy.special, name)
    with jax.enable_x64(True):
        ja, jx = jax.grad(lambda p, q: fn(p, q).sum(), argnums=(0, 1))(
            jnp.asarray(a, jnp.float64), jnp.asarray(x, jnp.float64))
        ja, jx = np.asarray(ja), np.asarray(jx)
    assert ta.grad.numpy().dtype == np.float64
    np.testing.assert_allclose(ta.grad.numpy(), ja, rtol=1e-5, atol=0)
    np.testing.assert_allclose(tx.grad.numpy(), jx, rtol=1e-5, atol=0)


# ------------------------------------------------------------- draws
def test_standard_gamma_and_dirichlet_distributions():
    T.seed(7)
    alpha = np.full((20000,), 3.0, np.float32)
    g = T.ops.extra.standard_gamma(T.to_tensor(alpha)).numpy()
    assert (g > 0).all()
    assert abs(g.mean() - 3.0) < 0.1 and abs(g.var() - 3.0) < 0.3
    d = T.ops.extra.dirichlet(T.full([20000, 3], 2.0)).numpy()
    assert (d > 0).all()
    np.testing.assert_allclose(d.sum(-1), 1.0, rtol=1e-5)
    # Dirichlet(2, 2, 2): mean 1/3, var (1/3)(2/3)/7
    assert abs(d.mean() - 1 / 3) < 0.01
    assert abs(d[:, 0].var() - 2 / 63) < 0.005


def test_top_p_sampling_support():
    T.seed(3)
    probs = np.array([[0.5, 0.3, 0.15, 0.05]] * 4000, np.float32)
    v, ids = T.ops.extra.top_p_sampling(T.to_tensor(probs),
                                        T.full([4000], 0.7))
    ids = ids.numpy().reshape(-1)
    # the nucleus of p=0.7 is {0, 1}: nothing else is drawn, both are
    assert set(np.unique(ids)) == {0, 1}
    assert abs((ids == 0).mean() - 0.5 / 0.8) < 0.05
    np.testing.assert_allclose(v.numpy().reshape(-1), probs[0][ids])


def test_random_fills_and_log_normal_distributions():
    T.seed(11)
    ln = T.log_normal(0.0, 0.5, [20000]).numpy()
    assert abs(np.log(ln).mean()) < 0.02 and abs(np.log(ln).std() - 0.5) \
        < 0.02
    x = T.zeros([20000])
    assert T.geometric_(x, 0.25) is x
    g = x.numpy()
    assert g.min() >= 1 and abs(g.mean() - 4.0) < 0.15
    c = T.cauchy_(T.zeros([20000]), 1.0, 2.0).numpy()
    assert abs(np.median(c) - 1.0) < 0.1
    q = np.percentile(c, [25, 75])
    assert abs((q[1] - q[0]) / 2 - 2.0) < 0.15
    ln_ = T.log_normal_(T.zeros([20000]), 1.0, 0.25).numpy()
    assert abs(np.log(ln_).mean() - 1.0) < 0.02


def test_rng_state_round_trip():
    T.seed(5)
    st = T.get_rng_state()
    a = T.rand([4]).numpy()
    T.set_rng_state(st)
    np.testing.assert_array_equal(T.rand([4]).numpy(), a)
    # no card here: the CUDA state list is empty, as Paddle's is
    assert T.get_cuda_rng_state() == []
    T.set_cuda_rng_state([])


# -------------------------------------------------- AMP and optimizer ops
def _pair(arrays, dtype=None):
    out = {}
    for pd in (P, T):
        ts = [pd.to_tensor(a) for a in arrays]
        out[pd] = [t.astype(dtype) if dtype else t for t in ts]
    return out


def _np(t):
    return np.asarray(t.astype("float32").numpy())


def test_check_finite_and_unscale_and_update_loss_scaling():
    r = _r(1)
    for poison in (False, True):
        grads = [r.randn(3, 4).astype(np.float32) * 1024,
                 r.randn(5).astype(np.float32) * 1024]
        if poison:
            grads[1][2] = np.inf
        res = {}
        for pd in (P, T):
            gs = [pd.to_tensor(g) for g in grads]
            xs, found = pd.ops.extra.check_finite_and_unscale_(
                gs, pd.to_tensor(np.float32(1024.0)))
            assert xs[0] is gs[0]
            scale = pd.to_tensor(np.float32(1024.0))
            good = pd.to_tensor(np.int32(1999))
            bad = pd.to_tensor(np.int32(0))
            pd.ops.extra.update_loss_scaling_(gs, found, scale, good, bad)
            res[pd] = ([g.numpy() for g in gs], bool(found.numpy()[0]),
                       float(scale.numpy()), int(good.numpy()),
                       int(bad.numpy()))
        assert res[T][1] == res[P][1] == poison
        assert res[T][2:] == res[P][2:]
        for g, w in zip(res[T][0], res[P][0]):
            np.testing.assert_allclose(g, w, rtol=OUT_RTOL, atol=OUT_ATOL)


def test_found_inf_stays_a_device_tensor():
    g = T.to_tensor(np.array([1.0, np.nan], np.float32))
    _, found = T.ops.extra.check_finite_and_unscale_([g], T.to_tensor(2.0))
    assert isinstance(found, T.Tensor) and found.shape == [1]


@pytest.mark.parametrize("opt", ["sgd", "momentum", "momentum_nesterov_l2",
                                 "adamw", "adamw_master", "adam"])
def test_optimizer_ops_match_reference(opt):
    r = _r(2)
    p0, g0 = r.randn(3, 4).astype(np.float32), r.randn(3, 4).astype(
        np.float32)
    res = {}
    for pd in (P, T):
        X_ = pd.ops.extra
        master = opt == "adamw_master"
        p = pd.to_tensor(p0).astype("bfloat16" if master else "float32")
        g = pd.to_tensor(g0).astype(p.dtype)
        lr = pd.to_tensor(np.float32(0.1))
        state = []
        for _ in range(3):
            if opt == "sgd":
                X_.sgd_(p, lr, g)
            elif opt.startswith("momentum"):
                v = state[0] if state else pd.zeros([3, 4])
                state = [v]
                nest = opt != "momentum"
                X_.momentum_(p, g, v, lr, mu=0.9, use_nesterov=nest,
                             regularization_method="l2_decay" if nest
                             else "", regularization_coeff=0.01)
            else:
                if not state:
                    state = [pd.zeros([3, 4]), pd.zeros([3, 4]),
                             pd.to_tensor(np.float32(1.0)),
                             pd.to_tensor(np.float32(1.0)),
                             pd.to_tensor(p0) if master else None]
                m1, m2, b1, b2, mw = state
                if opt == "adam":
                    X_.adam_(p, g, lr, m1, m2, b1, b2)
                else:
                    X_.adamw_(p, g, lr, m1, m2, b1, b2, master_param=mw,
                              coeff=0.1, multi_precision=master)
        res[pd] = [_np(p)] + [_np(s) for s in state if s is not None]
    tol = 1e-2 if opt == "adamw_master" else OUT_RTOL
    for g, w in zip(res[T], res[P]):
        np.testing.assert_allclose(g, w, rtol=tol, atol=OUT_ATOL)
    if opt == "adamw_master":
        # the f32 master weights carry the step exactly
        np.testing.assert_allclose(res[T][-1], res[P][-1], rtol=OUT_RTOL,
                                   atol=OUT_ATOL)


def test_accuracy_check():
    a = f32(3, 4)
    for pd in (P, T):
        out = pd.ops.extra.accuracy_check(pd.to_tensor(a), pd.to_tensor(a))
        assert out.numpy().all()
        with pytest.raises(AssertionError, match="accuracy_check failed"):
            pd.ops.extra.accuracy_check(pd.to_tensor(a),
                                        pd.to_tensor(a + 1), "f")


# ---------------------------------------------- framework-level helpers
def test_framework_helpers_match_reference():
    a = f32(3, 4)
    flops = {}
    for pd in (P, T):
        t = pd.to_tensor(a)
        np.testing.assert_allclose(pd.tolist(t), a.tolist())
        assert not pd.is_complex(t) and pd.is_floating_point(t)
        assert pd.is_integer(pd.to_tensor([1, 2]))
        pd.check_shape([2, -1])
        with pytest.raises(ValueError):
            pd.check_shape([2, -3])
        with pytest.raises(TypeError):
            pd.check_shape([2.5])
        pd.disable_signal_handler()
        reader = pd.batch(lambda: iter(range(5)), 2)
        assert list(reader()) == [[0, 1], [2, 3], [4]]
        with pd.LazyGuard():
            pass
        p = pd.create_parameter([3, 2], "float32", is_bias=True)
        assert not p.stop_gradient and p.shape == [3, 2]
        np.testing.assert_array_equal(p.numpy(), 0)
        net = pd.nn.Sequential(pd.nn.Linear(4, 8), pd.nn.ReLU(),
                               pd.nn.Linear(8, 2))
        flops[pd] = pd.flops(net, [2, 4])
    assert flops[T] == flops[P]
    assert T.get_device() == "cpu:0"
    assert T.CustomPlace("cpu", 0).get_device().type == "cpu"
    assert T.IPUPlace().get_device().type == "cpu"
    with pytest.raises(ValueError):
        T.XPUPlace(0).get_device()


# --------------------------------------------------------- tensor arrays
def test_tensor_arrays_match_reference():
    xs = [f32(3, seed=s) for s in range(3)]
    got = {}
    for pd in (P, T):
        lst = pd.tensor.create_array("float32")
        sta = pd.tensor.create_array("float32", capacity=4,
                                     element_shape=[3])
        for j, x in enumerate(xs):
            i = pd.to_tensor([j])
            lst = pd.tensor.array_write(pd.to_tensor(x), i, lst)
            sta = pd.tensor.array_write(pd.to_tensor(x), i, sta)
        got[pd] = (int(pd.tensor.array_length(lst)),
                   int(pd.tensor.array_length(sta)),
                   [pd.tensor.array_read(sta, pd.to_tensor([j])).numpy()
                    for j in range(3)])
        with pytest.raises(IndexError):
            pd.tensor.array_write(pd.to_tensor(xs[0]), pd.to_tensor([5]),
                                  sta)
    assert got[T][:2] == got[P][:2] == (3, 3)
    for g, w in zip(got[T][2], got[P][2]):
        np.testing.assert_array_equal(g, w)
