"""paddle.nn of the port against the reference's, on the CPU.

Every ported functional and layer runs in both packages on the same inputs
(numpy, from a seed); its outputs and the gradient of a fixed random
weighting of them with respect to every floating input (and, for layers,
every parameter, carried across by ``state_dict``) agree: f32 within 1e-5
of each result's scale, bf16 within 2e-2 (the two frameworks round bf16 at
other points; torch keeps a bf16 layer_norm's statistics in f32). Also:
``state_dict`` keys, ``to``/``astype``/``bfloat16``, the forward hooks,
``MultiHeadAttention`` and ``TransformerEncoderLayer`` with and without a
mask, and ``scaled_dot_product_attention`` causal with Sq != Skv on the
CPU, which is bottom-right aligned there in both packages. Random
functionals (dropout, alpha_dropout, rrelu, gumbel_softmax) and the
initializers are held to determinism under ``seed`` and to their moments,
never to the reference's draws. The reference's side of a comparison runs
as one compiled program (its ``jit.to_static``), and its layers are built
with numpy draws (``_testing.numpy_initializers``), whose values the port
then loads.
"""
import numpy as np
import pytest

import jax  # (the conftest keeps it on the CPU)

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch._testing import numpy_initializers
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    T.seed(2024)
    yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30) if want.size else 1.0
    return float(np.abs(got - want).max() / scale) if want.size else 0.0


def _rs(seed=0):
    return np.random.RandomState(seed)


def _x(*shape, seed=0):
    return _rs(seed).randn(*shape).astype(np.float32)


def _forward_backward(pkg, fn, arrays, dtype, ts, layer=None):
    for t, a in zip(ts, arrays):
        if a.dtype.kind == "f":
            t.stop_gradient = False
    out = fn(pkg, *ts)
    outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
            if o is not None]
    loss = None
    for i, o in enumerate(outs):
        if not str(o.dtype).endswith(("float32", "bfloat16", "float16")):
            continue
        w = pkg.to_tensor(np.asarray(_rs(50 + i).randn(*o.shape), np.float32))
        term = (o.astype("float32") * w).sum()
        loss = term if loss is None else loss + term
    grads, pgrads = [], {}
    if loss is not None and not loss.stop_gradient:
        loss.backward()
        grads = [t.grad for t, a in zip(ts, arrays) if a.dtype.kind == "f"]
        if layer is not None:
            pgrads = {n: q.grad for n, q in layer.named_parameters()
                      if q.grad is not None}
    return outs, grads, pgrads


def _run(pkg, fn, arrays, dtype, layer=None):
    """Outputs, gradients of sum(out_i * w_i) with respect to the floating
    inputs (cast to ``dtype``), and ``layer``'s parameter gradients. The
    reference's runs as one program, through its ``jit.to_static`` (which
    threads ``layer``'s state): op by op it compiles a kernel an op shape,
    ~5 s for a transformer layer's forward and backward on a CPU."""
    ts = [pkg.to_tensor(a).astype(dtype) if a.dtype.kind == "f"
          else pkg.to_tensor(a) for a in arrays]
    if pkg is P:
        step = P.jit.to_static(
            lambda *xs: _forward_backward(P, fn, arrays, dtype, list(xs),
                                          layer),
            objs=[] if layer is None else [layer])
        outs, grads, pgrads = step(*ts)
    else:
        outs, grads, pgrads = _forward_backward(pkg, fn, arrays, dtype, ts,
                                                layer)
    return [o.numpy() for o in outs], \
        [None if g is None else g.numpy() for g in grads], \
        {n: g.numpy() for n, g in pgrads.items()}


def _compare(fn, arrays, dtype="float32"):
    ro, rg, _ = _run(P, fn, arrays, dtype)
    to, tg, _ = _run(T, fn, arrays, dtype)
    tol = TOL[dtype]
    assert len(ro) == len(to)
    for r, t in zip(ro, to):
        assert t.shape == r.shape
        assert _rel(t, r) <= tol
    assert len(rg) == len(tg)
    for r, t in zip(rg, tg):
        # an input the result does not depend on differentiably (a label
        # compared with ==): no gradient in torch, zeros in jax
        if t is None and r is not None:
            assert not np.any(r)
        elif r is not None:
            assert _rel(t, r) <= tol


def F(pkg):
    return pkg.nn.functional


# (id, fn(pkg, *tensors), inputs)
X = _x(3, 5, 6)
IMG = _x(2, 4, 8, 8)
ACTIVATIONS = [
    ("relu", lambda p, x: F(p).relu(x)),
    ("relu6", lambda p, x: F(p).relu6(x * 4)),
    ("leaky_relu", lambda p, x: F(p).leaky_relu(x, 0.2)),
    ("elu", lambda p, x: F(p).elu(x, 0.7)),
    ("selu", lambda p, x: F(p).selu(x)),
    ("celu", lambda p, x: F(p).celu(x, 1.3)),
    ("gelu", lambda p, x: F(p).gelu(x)),
    ("gelu_tanh", lambda p, x: F(p).gelu(x, approximate=True)),
    ("silu", lambda p, x: F(p).silu(x)),
    ("swish", lambda p, x: F(p).swish(x)),
    ("hardswish", lambda p, x: F(p).hardswish(x * 3)),
    ("hardsigmoid", lambda p, x: F(p).hardsigmoid(x * 3)),
    ("hardtanh", lambda p, x: F(p).hardtanh(x, -0.5, 0.7)),
    ("hardshrink", lambda p, x: F(p).hardshrink(x)),
    ("softshrink", lambda p, x: F(p).softshrink(x, 0.3)),
    ("tanhshrink", lambda p, x: F(p).tanhshrink(x)),
    ("mish", lambda p, x: F(p).mish(x)),
    ("softplus", lambda p, x: F(p).softplus(x * 10, beta=2.0)),
    ("softsign", lambda p, x: F(p).softsign(x)),
    ("sigmoid", lambda p, x: F(p).sigmoid(x)),
    ("tanh", lambda p, x: F(p).tanh(x)),
    ("log_sigmoid", lambda p, x: F(p).log_sigmoid(x)),
    ("maxout", lambda p, x: F(p).maxout(x, 3, axis=2)),
    ("softmax", lambda p, x: F(p).softmax(x, axis=1)),
    ("log_softmax", lambda p, x: F(p).log_softmax(x)),
    ("glu", lambda p, x: F(p).glu(x, axis=-1)),
    ("thresholded_relu", lambda p, x: F(p).thresholded_relu(x, 0.4)),
    ("prelu", lambda p, x, w: F(p).prelu(x, w)),
    ("rrelu_eval", lambda p, x: F(p).rrelu(x, training=False)),
]


@pytest.mark.parametrize("name,fn", ACTIVATIONS, ids=[a[0] for a in
                                                      ACTIVATIONS])
def test_activation(name, fn):
    arrays = [X] + ([np.array([0.1, 0.2, 0.3, 0.4, 0.5], np.float32)]
                    if name == "prelu" else [])
    _compare(fn, arrays)


COMMON = [
    ("linear", lambda p, x, w, b: F(p).linear(x, w, b),
     [_x(2, 3, 6), _x(6, 4, seed=1), _x(4, seed=2)]),
    ("linear_nobias", lambda p, x, w: F(p).linear(x, w),
     [_x(5, 6), _x(6, 4, seed=1)]),
    ("dropout_eval", lambda p, x: F(p).dropout(x, 0.3, training=False,
                                               mode="downscale_in_infer"),
     [X]),
    ("embedding", lambda p, ids, w: F(p).embedding(ids, w, padding_idx=2),
     [_rs().randint(0, 10, (3, 7)), _x(10, 4)]),
    ("one_hot", lambda p, ids: F(p).one_hot(ids, 6),
     [_rs().randint(0, 6, (4,))]),
    ("normalize", lambda p, x: F(p).normalize(x, p=2, axis=1), [X]),
    ("cosine_similarity", lambda p, a, b: F(p).cosine_similarity(a, b),
     [X, _x(3, 5, 6, seed=1)]),
    ("label_smooth", lambda p, x: F(p).label_smooth(x, epsilon=0.2), [X]),
    ("pad", lambda p, x: F(p).pad(x, [1, 2, 0, 3]), [IMG]),
    ("pad_reflect", lambda p, x: F(p).pad(x, [1, 2, 2, 1], mode="reflect"),
     [IMG]),
    ("interpolate_nearest", lambda p, x: F(p).interpolate(
        x, size=[12, 5], mode="nearest"), [IMG]),
    ("interpolate_bilinear", lambda p, x: F(p).interpolate(
        x, scale_factor=2, mode="bilinear"), [IMG]),
    ("interpolate_bilinear_align", lambda p, x: F(p).interpolate(
        x, size=[11, 13], mode="bilinear", align_corners=True), [IMG]),
    ("interpolate_bicubic", lambda p, x: F(p).interpolate(
        x, size=[13, 6], mode="bicubic"), [IMG]),
    ("interpolate_nhwc", lambda p, x: F(p).interpolate(
        x, size=[16, 16], mode="nearest", data_format="NHWC"), [IMG]),
    ("interpolate_linear_1d", lambda p, x: F(p).interpolate(
        x, size=[9], mode="linear", data_format="NCW"), [X]),
    ("pixel_shuffle", lambda p, x: F(p).pixel_shuffle(x, 2), [IMG]),
    ("pixel_unshuffle", lambda p, x: F(p).pixel_unshuffle(x, 2), [IMG]),
    ("channel_shuffle", lambda p, x: F(p).channel_shuffle(x, 2), [IMG]),
    ("unfold", lambda p, x: F(p).unfold(x, 3, strides=2, paddings=1),
     [IMG]),
    ("fold", lambda p, x: F(p).fold(x, [5, 5], 2, strides=1),
     [_x(2, 12, 16)]),
    ("sequence_mask", lambda p, n: F(p).sequence_mask(n, maxlen=6),
     [np.array([1, 4, 6], np.int64)]),
    ("bilinear", lambda p, a, b, w, bias: F(p).bilinear(a, b, w, bias),
     [_x(4, 3), _x(4, 5, seed=1), _x(2, 3, 5, seed=2), _x(2, seed=3)]),
]


@pytest.mark.parametrize("name,fn,arrays", COMMON, ids=[c[0] for c in
                                                        COMMON])
def test_common(name, fn, arrays):
    _compare(fn, arrays)


W2 = _x(6, 4, 3, 3, seed=1)
CONV = [
    ("conv1d", lambda p, x, w, b: F(p).conv1d(x, w, b, stride=2, padding=1),
     [_x(2, 3, 11), _x(5, 3, 3, seed=1), _x(5, seed=2)]),
    ("conv2d", lambda p, x, w: F(p).conv2d(x, w, padding=1, dilation=2),
     [IMG, W2]),
    ("conv2d_same_stride", lambda p, x, w: F(p).conv2d(
        x, w, stride=2, padding="SAME"), [IMG, W2]),
    ("conv2d_pairs", lambda p, x, w: F(p).conv2d(x, w, padding=[1, 0, 2, 1]),
     [IMG, W2]),
    ("conv2d_groups_nhwc", lambda p, x, w: F(p).conv2d(
        x, w, groups=2, padding=1, data_format="NHWC"),
     [_x(2, 8, 8, 4), _x(6, 2, 3, 3, seed=1)]),
    ("conv3d", lambda p, x, w: F(p).conv3d(x, w, padding=1),
     [_x(1, 2, 5, 5, 5), _x(3, 2, 3, 3, 3, seed=1)]),
    ("conv1d_transpose", lambda p, x, w: F(p).conv1d_transpose(
        x, w, stride=2, padding=1, output_padding=1),
     [_x(2, 3, 7), _x(3, 4, 3, seed=1)]),
    ("conv2d_transpose", lambda p, x, w, b: F(p).conv2d_transpose(
        x, w, b, stride=2, padding=1), [IMG, _x(4, 3, 3, 3, seed=1),
                                        _x(3, seed=2)]),
    ("conv2d_transpose_groups", lambda p, x, w: F(p).conv2d_transpose(
        x, w, stride=2, groups=2), [IMG, _x(4, 2, 3, 3, seed=1)]),
    ("conv2d_transpose_pairs", lambda p, x, w: F(p).conv2d_transpose(
        x, w, stride=2, padding=[1, 0, 0, 2]), [IMG, _x(4, 3, 3, 3, seed=1)]),
    ("conv3d_transpose", lambda p, x, w: F(p).conv3d_transpose(
        x, w, stride=2, padding=1), [_x(1, 2, 3, 3, 3),
                                     _x(2, 3, 3, 3, 3, seed=1)]),
]


@pytest.mark.parametrize("name,fn,arrays", CONV, ids=[c[0] for c in CONV])
def test_conv(name, fn, arrays):
    _compare(fn, arrays)


POOL_IMG = _x(2, 3, 9, 10)
POOL = [
    ("max_pool2d", lambda p, x: F(p).max_pool2d(x, 3, 2, padding=1)),
    ("max_pool2d_ceil", lambda p, x: F(p).max_pool2d(x, 2, 2,
                                                     ceil_mode=True)),
    ("max_pool2d_same", lambda p, x: F(p).max_pool2d(x, 3, 2,
                                                     padding="SAME")),
    ("max_pool2d_mask", lambda p, x: F(p).max_pool2d(x, 2, 2,
                                                     return_mask=True)),
    ("avg_pool2d", lambda p, x: F(p).avg_pool2d(x, 3, 2, padding=1)),
    ("avg_pool2d_inclusive", lambda p, x: F(p).avg_pool2d(
        x, 3, 2, padding=1, exclusive=False)),
    ("avg_pool2d_ceil", lambda p, x: F(p).avg_pool2d(x, 2, 2,
                                                     ceil_mode=True)),
    ("avg_pool2d_divisor", lambda p, x: F(p).avg_pool2d(
        x, 2, 2, divisor_override=3)),
    ("avg_pool2d_pairs", lambda p, x: F(p).avg_pool2d(
        x, 3, 1, padding=[1, 0, 0, 2])),
    ("max_pool1d", lambda p, x: F(p).max_pool1d(x[:, :, 0], 3, 2)),
    ("avg_pool1d", lambda p, x: F(p).avg_pool1d(x[:, :, 0], 3, 2,
                                                padding=1)),
    ("max_pool3d", lambda p, x: F(p).max_pool3d(x.unsqueeze(0), 2, 2)),
    ("avg_pool3d", lambda p, x: F(p).avg_pool3d(x.unsqueeze(0), 2, 2)),
    ("adaptive_avg_pool2d", lambda p, x: F(p).adaptive_avg_pool2d(x, 4)),
    ("adaptive_avg_pool2d_even", lambda p, x: F(p).adaptive_avg_pool2d(
        x, [3, 5])),
    ("adaptive_max_pool2d", lambda p, x: F(p).adaptive_max_pool2d(x, 4)),
    ("adaptive_avg_pool1d", lambda p, x: F(p).adaptive_avg_pool1d(
        x[:, :, 0], 4)),
    ("adaptive_max_pool1d", lambda p, x: F(p).adaptive_max_pool1d(
        x[:, :, 0], 3)),
    ("adaptive_avg_pool3d", lambda p, x: F(p).adaptive_avg_pool3d(
        x.unsqueeze(0), 2)),
    ("lp_pool2d", lambda p, x: F(p).lp_pool2d(x, 2, 3, 2)),
    ("lp_pool1d", lambda p, x: F(p).lp_pool1d(x[:, :, 0], 3, 2, 1)),
]


@pytest.mark.parametrize("name,fn", POOL, ids=[c[0] for c in POOL])
def test_pooling(name, fn):
    _compare(fn, [POOL_IMG])


def _bn(training, data_format="NCHW"):
    def fn(p, x, w, b):
        rm = p.to_tensor(np.linspace(-0.2, 0.2, 4).astype(np.float32))
        rv = p.to_tensor(np.linspace(0.5, 1.5, 4).astype(np.float32))
        out = F(p).batch_norm(x, rm, rv, w, b, training=training,
                              data_format=data_format)
        return out, rm, rv        # the running statistics as updated
    return fn


NORM = [
    ("batch_norm_train", _bn(True), [IMG, _x(4, seed=1), _x(4, seed=2)]),
    ("batch_norm_eval", _bn(False), [IMG, _x(4, seed=1), _x(4, seed=2)]),
    ("batch_norm_nhwc", _bn(True, "NHWC"),
     [_x(2, 5, 5, 4), _x(4, seed=1), _x(4, seed=2)]),
    ("layer_norm", lambda p, x, w, b: F(p).layer_norm(x, 6, w, b),
     [X, _x(6, seed=1), _x(6, seed=2)]),
    ("layer_norm_2d", lambda p, x: F(p).layer_norm(x, [5, 6]), [X]),
    ("rms_norm", lambda p, x, w: F(p).rms_norm(x, w), [X, _x(6, seed=1)]),
    ("instance_norm", lambda p, x, w, b: F(p).instance_norm(
        x, weight=w, bias=b), [IMG, _x(4, seed=1), _x(4, seed=2)]),
    ("group_norm", lambda p, x, w, b: F(p).group_norm(x, 2, weight=w,
                                                      bias=b),
     [IMG, _x(4, seed=1), _x(4, seed=2)]),
    ("group_norm_nhwc", lambda p, x: F(p).group_norm(
        x, 2, data_format="NHWC"), [_x(2, 5, 5, 4)]),
    ("local_response_norm", lambda p, x: F(p).local_response_norm(x, 3),
     [IMG]),
]


@pytest.mark.parametrize("name,fn,arrays", NORM, ids=[c[0] for c in NORM])
def test_norm(name, fn, arrays):
    _compare(fn, arrays)


LOGITS = _x(6, 5)
LABELS = np.array([0, 3, -100, 4, 1, 3], np.int64)
PROB = (_rs(1).rand(6, 5).astype(np.float32) * 0.9 + 0.05)
Y01 = (_rs(2).rand(6, 5) > 0.5).astype(np.float32)
CE_W = _rs(3).rand(5).astype(np.float32) + 0.5
SOFT = PROB / PROB.sum(-1, keepdims=True)
LOSS = [
    ("ce", lambda p, x, y: F(p).cross_entropy(x, y), [LOGITS, LABELS]),
    ("ce_n1_labels", lambda p, x, y: F(p).cross_entropy(x, y.unsqueeze(-1)),
     [LOGITS, LABELS]),
    ("ce_sum", lambda p, x, y: F(p).cross_entropy(x, y, reduction="sum"),
     [LOGITS, LABELS]),
    ("ce_none", lambda p, x, y: F(p).cross_entropy(x, y, reduction="none"),
     [LOGITS, LABELS]),
    ("ce_weight", lambda p, x, y, w: F(p).cross_entropy(x, y, weight=w),
     [LOGITS, LABELS, CE_W]),
    ("ce_smooth", lambda p, x, y: F(p).cross_entropy(
        x, y, label_smoothing=0.1), [LOGITS, LABELS]),
    ("ce_weight_smooth", lambda p, x, y, w: F(p).cross_entropy(
        x, y, weight=w, label_smoothing=0.1), [LOGITS, LABELS, CE_W]),
    ("ce_soft", lambda p, x, y: F(p).cross_entropy(x, y, soft_label=True),
     [LOGITS, SOFT]),
    ("ce_soft_weight", lambda p, x, y, w: F(p).cross_entropy(
        x, y, soft_label=True, weight=w), [LOGITS, SOFT, CE_W]),
    ("ce_axis1", lambda p, x, y: F(p).cross_entropy(x, y, axis=1),
     [_x(2, 5, 3), np.array([[0, 4, 2], [1, 1, 3]], np.int64)]),
    ("ce_probs", lambda p, x, y: F(p).cross_entropy(x, y, use_softmax=False),
     [SOFT, LABELS]),
    ("ce_all_ignored", lambda p, x, y: F(p).cross_entropy(x, y),
     [LOGITS, np.full(6, -100, np.int64)]),
    ("softmax_with_cross_entropy", lambda p, x, y:
     F(p).softmax_with_cross_entropy(x, y.unsqueeze(-1),
                                     return_softmax=True),
     [LOGITS, np.abs(LABELS) % 5]),
    ("nll", lambda p, x, y: F(p).nll_loss(F(p).log_softmax(x), y),
     [LOGITS, LABELS]),
    ("nll_weight", lambda p, x, y, w: F(p).nll_loss(
        F(p).log_softmax(x), y, weight=w), [LOGITS, LABELS, CE_W]),
    ("mse", lambda p, a, b: F(p).mse_loss(a, b), [LOGITS, PROB]),
    ("l1", lambda p, a, b: F(p).l1_loss(a, b, reduction="sum"),
     [LOGITS, PROB]),
    ("smooth_l1", lambda p, a, b: F(p).smooth_l1_loss(a, b, delta=0.5),
     [LOGITS, PROB]),
    ("huber", lambda p, a, b: F(p).huber_loss(a, b, delta=0.5),
     [LOGITS, PROB]),
    ("bce", lambda p, a, b: F(p).binary_cross_entropy(a, b), [PROB, Y01]),
    ("bce_logits", lambda p, a, b, w: F(p).binary_cross_entropy_with_logits(
        a, b, pos_weight=w), [LOGITS, Y01, CE_W]),
    ("kl_div", lambda p, a, b: F(p).kl_div(F(p).log_softmax(a), b,
                                           reduction="batchmean"),
     [LOGITS, SOFT]),
    ("margin_ranking", lambda p, a, b, y: F(p).margin_ranking_loss(
        a, b, y, margin=0.1), [LOGITS, PROB, np.sign(Y01 - 0.5)]),
    ("hinge_embedding", lambda p, a, y: F(p).hinge_embedding_loss(a, y),
     [LOGITS, np.sign(Y01 - 0.5)]),
    ("cosine_embedding", lambda p, a, b, y: F(p).cosine_embedding_loss(
        a, b, y, margin=0.1), [LOGITS, PROB,
                               np.array([1, -1, 1, 1, -1, 1], np.float32)]),
    ("triplet_margin", lambda p, a, b, c: F(p).triplet_margin_loss(
        a, b, c, swap=True), [LOGITS, PROB, _x(6, 5, seed=9)]),
    ("multi_label_soft_margin", lambda p, a, y:
     F(p).multi_label_soft_margin_loss(a, y), [LOGITS, Y01]),
    ("soft_margin", lambda p, a, y: F(p).soft_margin_loss(a, y),
     [LOGITS, np.sign(Y01 - 0.5)]),
    ("square_error_cost", lambda p, a, b: F(p).square_error_cost(a, b),
     [LOGITS, PROB]),
    ("log_loss", lambda p, a, b: F(p).log_loss(a, b), [PROB, Y01]),
    ("sigmoid_focal", lambda p, a, b: F(p).sigmoid_focal_loss(a, b),
     [LOGITS, Y01]),
    ("ctc", lambda p, lp, lab, il, ll: F(p).ctc_loss(lp, lab, il, ll),
     [_x(12, 2, 6), np.array([[1, 2, 2], [3, 1, 0]], np.int32),
      np.array([12, 10], np.int64), np.array([3, 2], np.int64)]),
    ("npair", lambda p, a, b, y: F(p).npair_loss(a, b, y),
     [LOGITS, PROB, np.array([0, 1, 0, 2, 1, 2], np.int64)]),
    ("dice", lambda p, a, y: F(p).dice_loss(F(p).softmax(a), y),
     [LOGITS, np.abs(LABELS[:, None]) % 5]),
]


@pytest.mark.parametrize("name,fn,arrays", LOSS, ids=[c[0] for c in LOSS])
def test_loss(name, fn, arrays):
    _compare(fn, arrays)


Q = _x(2, 6, 2, 8)
K = _x(2, 10, 2, 8, seed=1)
V = _x(2, 10, 2, 8, seed=2)
ATTENTION = [
    ("sdpa", lambda p, q, k, v: F(p).scaled_dot_product_attention(q, k, v),
     [Q, K, V]),
    ("sdpa_causal_cross", lambda p, q, k, v:
     F(p).scaled_dot_product_attention(q, k, v, is_causal=True), [Q, K, V]),
    ("sdpa_causal_self", lambda p, q: F(p).scaled_dot_product_attention(
        q, q, q, is_causal=True), [Q]),
    ("sdpa_bool_mask", lambda p, q, k, v, m:
     F(p).scaled_dot_product_attention(q, k, v, attn_mask=m),
     [Q, K, V, _rs(4).rand(2, 2, 6, 10) > 0.3]),
    ("sdpa_additive_mask", lambda p, q, k, v, m:
     F(p).scaled_dot_product_attention(q, k, v, attn_mask=m),
     [Q, K, V, _x(1, 2, 6, 10, seed=5)]),
    ("flash_attention", lambda p, q, k, v: F(p).flash_attention(
        q, k, v, causal=True), [Q, K, V]),
    ("flash_attn_unpadded", lambda p, q, k, v, cq, ck:
     F(p).flash_attn_unpadded(q, k, v, cq, ck, 4, 5, causal=True),
     [_x(7, 2, 8), _x(9, 2, 8, seed=1), _x(9, 2, 8, seed=2),
      np.array([0, 3, 7], np.int32), np.array([0, 4, 9], np.int32)]),
]


@pytest.mark.parametrize("name,fn,arrays", ATTENTION,
                         ids=[c[0] for c in ATTENTION])
def test_attention(name, fn, arrays):
    _compare(fn, arrays)


def test_sdpa_causal_cross_attention_is_bottom_right_on_the_cpu():
    """On the CPU (the plain path) the causal mask of Sq != Skv is
    bottom-right aligned, in both packages: the last query row sees every
    key, and with Sq < Skv the first row sees Skv - Sq + 1 of them."""
    q, k, v = (T.to_tensor(a) for a in (Q, K, V))
    out = F(T).scaled_dot_product_attention(q, k, v, is_causal=True)
    v_np = V.transpose(0, 2, 1, 3)
    logits = np.einsum("bqhd,bkhd->bhqk", Q, K) / np.sqrt(8)
    keep = np.tril(np.ones((6, 10), bool), 10 - 6)
    logits = np.where(keep, logits, -1e30)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bhkd->bqhd", p, v_np)
    assert _rel(out.numpy(), want) <= 1e-5


BF16 = [
    ("linear", COMMON[0][1], COMMON[0][2]),
    ("gelu_tanh", lambda p, x: F(p).gelu(x, approximate=True), [X]),
    ("softmax", lambda p, x: F(p).softmax(x), [X]),
    ("layer_norm", NORM[3][1], NORM[3][2]),
    ("embedding", COMMON[3][1], COMMON[3][2]),
    ("cross_entropy", LOSS[0][1], LOSS[0][2]),
    ("sdpa_causal", lambda p, q: F(p).scaled_dot_product_attention(
        q, q, q, is_causal=True), [Q]),
]


@pytest.mark.parametrize("name,fn,arrays", BF16, ids=[c[0] for c in BF16])
def test_bf16(name, fn, arrays):
    _compare(fn, arrays, "bfloat16")


# ------------------------------------------------------------------ layers
def _shifted(bn):
    """A BatchNorm with a bias and running statistics away from their
    initial values, so that its output and both buffers show them."""
    c = bn.bias.shape[0]
    bn.bias.set_value(np.linspace(-1, 1, c).astype(np.float32))
    bn._mean.set_value(np.linspace(0.5, -0.5, c).astype(np.float32))
    bn._variance.set_value(np.linspace(0.5, 2.0, c).astype(np.float32))
    return bn


def _layer_cases():
    return [
        ("Linear", lambda nn: nn.Linear(6, 4), [_x(3, 6)]),
        ("Embedding", lambda nn: nn.Embedding(10, 4, padding_idx=0),
         [_rs().randint(0, 10, (2, 5))]),
        ("Bilinear", lambda nn: nn.Bilinear(3, 5, 2),
         [_x(4, 3), _x(4, 5, seed=1)]),
        ("Conv1D", lambda nn: nn.Conv1D(3, 4, 3, padding=1), [_x(2, 3, 9)]),
        ("Conv2D", lambda nn: nn.Conv2D(4, 6, 3, stride=2), [IMG]),
        ("Conv3D", lambda nn: nn.Conv3D(2, 3, 2), [_x(1, 2, 4, 4, 4)]),
        ("Conv2DTranspose", lambda nn: nn.Conv2DTranspose(4, 3, 3, stride=2),
         [IMG]),
        ("Conv1DTranspose", lambda nn: nn.Conv1DTranspose(3, 2, 3),
         [_x(2, 3, 6)]),
        ("BatchNorm2D", lambda nn: nn.BatchNorm2D(4), [IMG]),
        ("BatchNorm1D", lambda nn: nn.BatchNorm1D(6), [_x(8, 6)]),
        # train mode with one value per channel (a batch of one at 1x1),
        # which torch's own batch_norm refuses
        ("BatchNorm2D_one_value", lambda nn: _shifted(nn.BatchNorm2D(4)),
         [_x(1, 4, 1, 1)]),
        ("BatchNorm1D_one_value", lambda nn: _shifted(nn.BatchNorm1D(6)),
         [_x(1, 6)]),
        ("LayerNorm", lambda nn: nn.LayerNorm(6), [X]),
        ("RMSNorm", lambda nn: nn.RMSNorm(6), [X]),
        ("GroupNorm", lambda nn: nn.GroupNorm(2, 4), [IMG]),
        ("InstanceNorm2D", lambda nn: nn.InstanceNorm2D(4), [IMG]),
        ("LocalResponseNorm", lambda nn: nn.LocalResponseNorm(3), [IMG]),
        ("PReLU", lambda nn: nn.PReLU(4, 0.1), [IMG]),
        ("GELU", lambda nn: nn.GELU(True), [X]),
        ("Softmax", lambda nn: nn.Softmax(1), [X]),
        ("Hardtanh", lambda nn: nn.Hardtanh(-0.3, 0.4), [X]),
        ("MaxPool2D", lambda nn: nn.MaxPool2D(2, 2), [IMG]),
        ("AvgPool2D", lambda nn: nn.AvgPool2D(3, 2, 1), [IMG]),
        ("AdaptiveAvgPool2D", lambda nn: nn.AdaptiveAvgPool2D(3), [IMG]),
        ("AdaptiveMaxPool1D", lambda nn: nn.AdaptiveMaxPool1D(2),
         [_x(2, 3, 7)]),
        ("Flatten", lambda nn: nn.Flatten(), [IMG]),
        ("Upsample", lambda nn: nn.Upsample(scale_factor=2), [IMG]),
        ("UpsamplingBilinear2D", lambda nn: nn.UpsamplingBilinear2D(
            size=[5, 7]), [IMG]),
        ("PixelShuffle", lambda nn: nn.PixelShuffle(2), [IMG]),
        ("Pad2D", lambda nn: nn.Pad2D([1, 0, 2, 1], mode="replicate"),
         [IMG]),
        ("ZeroPad2D", lambda nn: nn.ZeroPad2D([1, 0, 2, 1]), [IMG]),
        ("CosineSimilarity", lambda nn: nn.CosineSimilarity(),
         [X, _x(3, 5, 6, seed=1)]),
        ("Identity", lambda nn: nn.Identity(), [X]),
        ("Dropout_eval", lambda nn: nn.Dropout(0.4).eval(), [X]),
        ("Sequential", lambda nn: nn.Sequential(nn.Linear(6, 8), nn.ReLU(),
                                                nn.Linear(8, 3)), [X]),
        ("CrossEntropyLoss", lambda nn: nn.CrossEntropyLoss(),
         [LOGITS, LABELS]),
        ("MSELoss", lambda nn: nn.MSELoss(), [LOGITS, PROB]),
        ("BCEWithLogitsLoss", lambda nn: nn.BCEWithLogitsLoss(),
         [LOGITS, Y01]),
        ("KLDivLoss", lambda nn: nn.KLDivLoss("sum"), [LOGITS, SOFT]),
        ("SmoothL1Loss", lambda nn: nn.SmoothL1Loss(), [LOGITS, PROB]),
        ("NLLLoss", lambda nn: nn.NLLLoss(), [LOGITS, LABELS]),
        ("MultiHeadAttention", lambda nn: nn.MultiHeadAttention(16, 4),
         [_x(2, 6, 16)]),
        ("TransformerEncoderLayer", lambda nn: nn.TransformerEncoderLayer(
            16, 4, 32, dropout=0.0), [_x(2, 6, 16)]),
        ("TransformerEncoderLayer_pre_gelu", lambda nn:
         nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                    activation="gelu",
                                    normalize_before=True), [_x(2, 6, 16)]),
        ("TransformerDecoderLayer", lambda nn: nn.TransformerDecoderLayer(
            16, 4, 32, dropout=0.0), [_x(2, 6, 16), _x(2, 5, 16, seed=1)]),
        ("Transformer", lambda nn: nn.Transformer(
            16, 4, 1, 1, 32, dropout=0.0), [_x(2, 5, 16),
                                            _x(2, 6, 16, seed=1)]),
    ]


LAYERS = _layer_cases()


def _layer_pair(build):
    P.seed(11)
    with numpy_initializers(jax):
        ref = build(P.nn)
    port = build(T.nn)
    assert list(port.state_dict()) == list(ref.state_dict())
    port.set_state_dict({k: v.numpy() for k, v in ref.state_dict().items()})
    return ref, port


def _run_layer(pkg, layer, arrays, mask=None):
    def fn(p, *ts):
        if mask is None:
            return layer(*ts)
        m = p.to_tensor(mask)
        if isinstance(layer, p.nn.MultiHeadAttention):
            return layer(*ts, attn_mask=m)
        return layer(*ts, m)
    return _run(pkg, fn, arrays, "float32", layer)


def _compare_param_grads(tpg, rpg):
    """Each parameter's gradient within 1e-5 of its scale; the k
    projection's bias has a gradient that is zero in exact arithmetic
    (softmax is blind to a shift of a row's scores), so both packages'
    must be round-off: under 1e-5 of the layer's largest gradient."""
    assert set(tpg) == set(rpg)
    top = max((np.abs(g).max() for g in rpg.values()), default=0.0)
    for n in rpg:
        if n.endswith("k_proj.bias"):
            assert max(np.abs(tpg[n]).max(), np.abs(rpg[n]).max()) \
                <= 1e-5 * top, n
        else:
            assert _rel(tpg[n], rpg[n]) <= 1e-5, n


@pytest.mark.parametrize("name,build,arrays", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer(name, build, arrays):
    ref, port = _layer_pair(build)
    ro, rg, rpg = _run_layer(P, ref, arrays)
    to, tg, tpg = _run_layer(T, port, arrays)
    for r, t in zip(ro + rg, to + tg):
        assert _rel(t, r) <= 1e-5
    _compare_param_grads(tpg, rpg)
    # buffers the forward updated (BatchNorm's running statistics)
    for (n, r), (_, t) in zip(ref.state_dict().items(),
                              port.state_dict().items()):
        assert _rel(t.numpy(), r.numpy()) <= 1e-5, n


@pytest.mark.parametrize("mask_kind", ["bool", "additive"])
@pytest.mark.parametrize("layer", ["MultiHeadAttention",
                                   "TransformerEncoderLayer"])
def test_attention_layers_with_a_mask(layer, mask_kind):
    build = dict((c[0], c[1]) for c in LAYERS)[layer]
    x = _x(2, 6, 16, seed=4)
    mask = _rs(6).rand(2, 1, 6, 6) > 0.3 if mask_kind == "bool" \
        else _x(2, 1, 6, 6, seed=6)
    ref, port = _layer_pair(build)
    ro, rg, rpg = _run_layer(P, ref, [x], mask)
    to, tg, tpg = _run_layer(T, port, [x], mask)
    for r, t in zip(ro + rg, to + tg):
        assert _rel(t, r) <= 1e-5
    _compare_param_grads(tpg, rpg)


def test_decode_caches_wait_for_the_serving_slice():
    """The serving slice brought MultiHeadAttention's decode caches: the
    growing concat Cache and the fixed-capacity one of gen_cache(...,
    max_length=) give the reference's outputs over four decode steps
    (within 1e-5 of scale), and the fixed cache keeps its capacity."""
    ref, port = _layer_pair(lambda nn: nn.MultiHeadAttention(16, 4))
    x = _x(2, 4, 16, seed=8)
    for kw in ({}, {"max_length": 8}):
        outs = {}
        for pkg, mha in ((P, ref), (T, port)):
            mha.eval()
            t = pkg.to_tensor(x)
            cache = mha.gen_cache(t, **kw)
            got = []
            with pkg.no_grad():
                for i in range(4):
                    step = t[:, i:i + 1]
                    o, cache = mha(step, step, step, None, cache)
                    got.append(o.numpy())
            outs[pkg] = got
        for r, t in zip(outs[P], outs[T]):
            assert _rel(t, r) <= 1e-5
    assert cache.k.shape[1] == 8 and int(cache.length.numpy()[0]) == 4


# ------------------------------------------------- dtype, device and hooks
def test_astype_bfloat16_and_to_keep_trainable_leaves():
    lin = T.nn.Linear(6, 4)
    w = lin.weight
    x = T.to_tensor(_x(3, 6))
    lin(x).sum().backward()
    g = w.grad.numpy()
    lin.bfloat16()
    assert lin.weight is w and w.dtype == T.bfloat16
    assert w._data.is_leaf and w._data.requires_grad and not w.stop_gradient
    assert w.grad.dtype == T.bfloat16     # the gradient is cast along
    np.testing.assert_allclose(w.grad.numpy(), g, rtol=2 ** -8)
    lin.to(dtype="float32")
    assert w.dtype == T.float32 and w._data.is_leaf
    lin.astype("float16")
    assert lin.bias.dtype == T.float16
    lin.float()
    lin.to(device="cpu")
    w.clear_grad()
    lin(x).sum().backward()
    assert w.grad is not None and w.grad.shape == [6, 4]


def test_astype_matches_the_reference():
    ref, port = _layer_pair(lambda nn: nn.Sequential(nn.Linear(6, 4),
                                                     nn.LayerNorm(4)))
    ref.bfloat16()
    port.bfloat16()
    for (n, r), (_, t) in zip(ref.state_dict().items(),
                              port.state_dict().items()):
        assert t.dtype == T.bfloat16
        np.testing.assert_array_equal(t.numpy(), r.numpy(), err_msg=n)


def test_set_state_dict_reads_bfloat16_numpy_as_to_tensor_does():
    P.seed(2)
    ref = P.nn.Linear(4, 3).bfloat16()
    port = T.nn.Linear(4, 3).bfloat16()
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    assert str(state["weight"].dtype) == "bfloat16"
    missing, unexpected = port.set_state_dict(state)
    assert not missing and not unexpected
    np.testing.assert_array_equal(port.weight.numpy(),
                                  np.asarray(state["weight"], np.float32))
    assert port.set_state_dict({"nope": state["bias"]}) == (
        ["weight", "bias"], ["nope"])


def test_forward_hooks_match_the_reference():
    def run(pkg):
        lin = pkg.nn.Linear(6, 4)
        seen = []

        def pre(layer, inputs):
            seen.append("pre")
            return (inputs[0] * 2,)

        def post(layer, inputs, out):
            seen.append("post")
            return out + 1

        h1 = lin.register_forward_pre_hook(pre)
        h2 = lin.register_forward_post_hook(post)
        x = pkg.to_tensor(_x(3, 6))
        hooked = lin(x).numpy()
        h1.remove()
        h2.remove()
        plain = lin(x).numpy()
        return seen, hooked, plain, lin
    P.seed(4)
    rs, rh, rp, rl = run(P)
    T.seed(4)
    ts, th, tp, tl = run(T)
    assert ts == rs == ["pre", "post"]
    # same weights: load the reference's and run the port again
    tl.set_state_dict({k: v.numpy() for k, v in rl.state_dict().items()})
    np.testing.assert_allclose(
        tl(T.to_tensor(_x(3, 6) * 2)).numpy() + 1, rh, rtol=1e-5,
        atol=1e-6)


def test_layer_registries_match_the_reference():
    def build(nn):
        model = nn.Sequential(nn.Linear(4, 4), nn.BatchNorm1D(4))
        model.add_sublayer("extra", nn.LayerList([nn.Linear(4, 2)]))
        model.register_buffer("counter", (T if nn is T.nn else P)
                              .to_tensor(np.zeros(2, np.float32)),
                              persistable=False)
        return model
    ref, port = build(P.nn), build(T.nn)
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    assert [n for n, _ in port.named_buffers()] == \
        [n for n, _ in ref.named_buffers()]
    assert list(port.state_dict()) == list(ref.state_dict())
    assert len(port.sublayers()) == len(ref.sublayers())
    port.eval()
    assert not any(layer.training for layer in port.sublayers(True))


# ---------------------------------------------------------- random draws
@pytest.mark.parametrize("fn", [
    lambda x: F(T).dropout(x, 0.3),
    lambda x: F(T).dropout2d(x.reshape([4, 10, 5, 5]), 0.3),
    lambda x: F(T).alpha_dropout(x, 0.3),
    lambda x: F(T).rrelu(x),
    lambda x: F(T).gumbel_softmax(x, hard=True),
], ids=["dropout", "dropout2d", "alpha_dropout", "rrelu", "gumbel_softmax"])
def test_random_functionals_are_reproducible_under_seed(fn):
    x = T.to_tensor(_x(40, 25))
    T.seed(5)
    a = fn(x).numpy()
    b = fn(x).numpy()
    T.seed(5)
    c = fn(x).numpy()
    np.testing.assert_array_equal(a, c)
    assert not np.array_equal(a, b)


def test_dropout_moments():
    x = T.ones([400, 500])
    out = F(T).dropout(x, 0.3).numpy()
    kept = out != 0
    assert abs(kept.mean() - 0.7) < 0.01
    np.testing.assert_allclose(out[kept], 1 / 0.7, rtol=1e-6)
    np.testing.assert_array_equal(
        F(T).dropout(x, 0.3, training=False).numpy(), x.numpy())
    y = F(T).alpha_dropout(T.to_tensor(_x(400, 500)), 0.2).numpy()
    assert abs(y.mean()) < 0.02 and abs(y.std() - 1) < 0.02


@pytest.mark.parametrize("init,mean,std", [
    (lambda I: I.Normal(0.5, 2.0), 0.5, 2.0),
    (lambda I: I.TruncatedNormal(0.0, 1.0), 0.0, 0.8796),
    (lambda I: I.Uniform(-1.0, 3.0), 1.0, 4 / np.sqrt(12)),
    (lambda I: I.XavierNormal(), 0.0, np.sqrt(2 / (300 + 400))),
    (lambda I: I.XavierUniform(), 0.0, np.sqrt(2 / (300 + 400))),
    (lambda I: I.KaimingNormal(), 0.0, np.sqrt(2 / 300)),
    (lambda I: I.KaimingUniform(), 0.0, np.sqrt(2 / 300)),
], ids=["Normal", "TruncatedNormal", "Uniform", "XavierNormal",
        "XavierUniform", "KaimingNormal", "KaimingUniform"])
def test_initializer_moments_and_determinism(init, mean, std):
    I = T.nn.initializer
    T.seed(7)
    a = init(I)((300, 400), "float32").numpy()
    T.seed(7)
    b = init(I)((300, 400), "float32").numpy()
    np.testing.assert_array_equal(a, b)
    assert abs(a.mean() - mean) < 0.02 * max(std, 1)
    assert abs(a.std() - std) < 0.02 * std
    if isinstance(init(I), I.TruncatedNormal):
        assert np.abs(a).max() <= 2.0


@pytest.mark.parametrize("name", ["Constant", "Assign", "Orthogonal",
                                  "Dirac", "Bilinear"])
def test_deterministic_initializers_match_the_reference(name):
    def make(pkg):
        I = pkg.nn.initializer
        return {"Constant": lambda: I.Constant(0.25)((3, 4), "float32"),
                "Assign": lambda: I.Assign(np.arange(12.0))((3, 4),
                                                            "float32"),
                "Orthogonal": lambda: I.Orthogonal()((5, 3), "float32"),
                "Dirac": lambda: I.Dirac()((4, 4, 3, 3), "float32"),
                "Bilinear": lambda: I.Bilinear()((2, 2, 4, 4),
                                                 "float32")}[name]()
    got = make(T)
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    if name == "Orthogonal":       # random: orthonormal columns
        np.testing.assert_allclose(got.T @ got, np.eye(3), atol=1e-5)
        return
    np.testing.assert_array_equal(got, np.asarray(make(P), np.float32))


def test_layer_default_initializers_draw_from_the_port_generator():
    T.seed(9)
    a = T.nn.Linear(8, 4).weight.numpy()
    T.seed(9)
    b = T.nn.Linear(8, 4).weight.numpy()
    np.testing.assert_array_equal(a, b)
    limit = np.sqrt(6 / (8 + 4))
    assert np.abs(a).max() <= limit
    assert not T.nn.Linear(8, 4).bias.numpy().any()


# ---- BCE-with-logits and focal loss at a logit of exactly 0 ----------------
Z0 = np.array([100.0, -100.0, 0.0], np.float32)
Y0 = np.array([0.0, 1.0, 1.0], np.float32)


def _fd_grad(fn, z, eps=1e-3):
    """Central differences in f64 of fn(z) (numpy) at each z."""
    out = np.zeros_like(z, np.float64)
    for i in range(z.size):
        hi, lo = z.astype(np.float64), z.astype(np.float64)
        hi[i] += eps
        lo[i] -= eps
        out[i] = (fn(hi) - fn(lo)) / (2 * eps)
    return out


def _np_bce(z, y=Y0):
    return np.mean(np.logaddexp(0.0, z) - z * y)


def _np_focal(z, y=Y0, alpha=0.25, gamma=2.0):
    p = 1 / (1 + np.exp(-z))
    ce = np.logaddexp(0.0, z) - z * y
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    return np.sum(a_t * (1 - p_t) ** gamma * ce)


@pytest.mark.parametrize("name, call, oracle, dz2", [
    ("bce_logits", lambda F, z, y: F.binary_cross_entropy_with_logits(z, y),
     _np_bce, -1.0 / 6.0),
    ("sigmoid_focal", lambda F, z, y: F.sigmoid_focal_loss(z, y),
     _np_focal, -0.0746),
])
def test_logit_losses_are_smooth_at_zero(name, call, oracle, dz2):
    """The true gradient at z = 0 is sigmoid(0) - y's term, which finite
    differences give; the reference's kinks (max, abs) give another value
    there (ROADMAP, found in the reference), so only away from 0 is it
    held against the reference."""
    z = T.to_tensor(Z0, stop_gradient=False)
    loss = call(T.nn.functional, z, T.to_tensor(Y0))
    loss.backward()
    fd = _fd_grad(oracle, Z0)
    np.testing.assert_allclose(z.grad.numpy(), fd, rtol=1e-4, atol=1e-6)
    assert abs(float(z.grad.numpy()[2]) - dz2) < 1e-4
    # away from 0: the reference's value and gradient
    zs = np.array([1.5, -0.7, 0.3, -2.0], np.float32)
    ys = np.array([0.0, 1.0, 1.0, 0.0], np.float32)
    got = []
    for pkg in (T, P):
        zt = pkg.to_tensor(zs, stop_gradient=False)
        out = call(pkg.nn.functional, zt, pkg.to_tensor(ys))
        out.backward()
        got.append((float(out), zt.grad.numpy()))
    np.testing.assert_allclose(got[0][0], got[1][0], rtol=1e-6)
    np.testing.assert_allclose(got[0][1], got[1][1], rtol=1e-5, atol=1e-7)


def test_training_after_set_state_dict_leaves_the_loaded_dict_alone():
    """The optimizers write parameters in place; a parameter loaded from
    another Layer's state_dict owns its storage, so training it changes
    neither that dict nor its Layer, as with the reference's immutable
    arrays."""
    import paddle_tpu as P
    for pd in (P, T):
        pd.seed(0)
        src = pd.nn.Linear(4, 3)
        state = src.state_dict()
        snap = {k: v.numpy().copy() for k, v in state.items()}
        dst = pd.nn.Linear(4, 3)
        dst.set_state_dict(state)
        opt = pd.optimizer.AdamW(1e-1, parameters=dst.parameters())
        (dst(pd.ones([2, 4])) ** 2).sum().backward()
        opt.step()
        for k, v in src.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), snap[k])
            np.testing.assert_array_equal(state[k].numpy(), snap[k])
        assert not np.array_equal(dst.weight.numpy(), snap["weight"])
