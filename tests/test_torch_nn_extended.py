"""``nn.functional.extended``, ``nn.layer.extended``, ``nn.quant`` and the
tokenizer of the port against the reference on the CPU.

Each functional case runs the same numpy inputs (made from a seed) through
both packages and compares every output (f32 rtol 1e-5, atol 1e-6) and, for
the inputs marked differentiable, the gradient of ``sum(out * w)`` (within
1e-4 of its scale). The layers carry the reference's weights across
through their state_dicts. ``feature_alpha_dropout`` draws from torch's
generator (a different mask by design) and is held to what it keeps.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu.nn.quant  # noqa: F401  (a lazy submodule there)
import paddle_tpu_torch as T
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

OUT_RTOL, OUT_ATOL, GRAD_TOL = 1e-5, 1e-6, 1e-4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    T.seed(2024)
    yield


def f32(*shape, lo=None, hi=None, seed=0):
    r = np.random.RandomState(seed)
    if lo is None:
        return r.randn(*shape).astype(np.float32)
    return r.uniform(lo, hi, shape).astype(np.float32)


def i64(*shape, hi=5, seed=0):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(np.int64)


def _outs(out):
    if isinstance(out, (tuple, list)):
        return [o for o in out if o is not None]
    return [out]


def _forward_backward(pd, fn, diff, xs):
    for k in diff:
        xs[k].stop_gradient = False
    outs = _outs(fn(pd, *xs))
    grads = []
    if diff:
        r = np.random.RandomState(99)
        total = None
        for o in outs:
            if "float" in str(o.dtype):
                w = pd.to_tensor(np.asarray(r.randn(*o.shape), np.float32))
                term = (o * w).sum()
                total = term if total is None else total + term
        total.backward()
        grads = [xs[k].grad for k in diff]
    return outs, grads


def _run(pd, fn, inputs, diff):
    """Outputs and the gradients of sum(out_i * w_i) with respect to the
    inputs in ``diff``. The reference's runs as one program through its
    ``jit.to_static`` (op by op it compiles a kernel an op shape), which
    runs op by op where its trace cannot follow the function."""
    xs = [pd.to_tensor(a) for a in inputs]
    if pd is P:
        outs, grads = P.jit.to_static(
            lambda *ts: _forward_backward(P, fn, diff, list(ts)))(*xs)
    else:
        outs, grads = _forward_backward(pd, fn, diff, xs)
    return [o.numpy() for o in outs], [g.numpy() for g in grads]


def _close(got, want, what, grad=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if grad:
        scale = max(float(np.max(np.abs(want))), 1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=OUT_RTOL, atol=OUT_ATOL,
                                   err_msg=what)


def FE(pd):
    return pd.nn.functional


IMG = f32(2, 3, 6, 6, seed=2)
THETA = f32(2, 2, 3, lo=-0.8, hi=0.8, seed=3)
GRID = f32(2, 4, 5, 2, lo=-1.2, hi=1.2, seed=5)
# CSR of a 4x4 pattern per head: rows {0,1}, {1}, {0,2,3}, {3}
CSR_OFF = np.tile(np.array([0, 2, 3, 6, 7]), (1, 2, 1))
CSR_COL = np.tile(np.array([0, 1, 1, 0, 2, 3, 3]), (1, 2, 1))

CASES = [
    ("pairwise_distance", lambda pd, x, y: FE(pd).pairwise_distance(x, y),
     [f32(3, 4), f32(3, 4, seed=1)], (0, 1)),
    ("pairwise_distance_p1_keepdim", lambda pd, x, y: FE(pd)
     .pairwise_distance(x, y, 1.0, keepdim=True),
     [f32(3, 4), f32(3, 4, seed=1)], (0, 1)),
    ("poisson_nll_loss", lambda pd, x, y: FE(pd).poisson_nll_loss(x, y),
     [f32(3, 4), f32(3, 4, lo=0.0, hi=3.0, seed=1)], (0,)),
    ("poisson_nll_loss_full", lambda pd, x, y: FE(pd).poisson_nll_loss(
        x, y, log_input=False, full=True, reduction="none"),
     [f32(3, 4, lo=0.5, hi=2.0), f32(3, 4, lo=0.5, hi=3.0, seed=1)], (0,)),
    ("gaussian_nll_loss", lambda pd, x, y, v: FE(pd).gaussian_nll_loss(
        x, y, v, full=True), [f32(3, 4), f32(3, 4, seed=1),
                              f32(3, 4, lo=0.1, hi=2.0, seed=2)], (0, 2)),
    ("multi_margin_loss", lambda pd, x, y: FE(pd).multi_margin_loss(x, y),
     [f32(4, 5), i64(4, hi=5)], (0,)),
    ("multi_margin_loss_p2_weight", lambda pd, x, y, w: FE(pd)
     .multi_margin_loss(x, y, 2, 0.5, w, "sum"),
     [f32(4, 5), i64(4, hi=5), f32(5, lo=0.5, hi=1.5, seed=1)], (0,)),
    ("triplet_margin_with_distance_loss", lambda pd, a, p, n: FE(pd)
     .triplet_margin_with_distance_loss(a, p, n, swap=True),
     [f32(3, 4), f32(3, 4, seed=1), f32(3, 4, seed=2)], (0, 1, 2)),
    ("hsigmoid_loss", lambda pd, x, y, w, b: FE(pd).hsigmoid_loss(
        x, y, 6, w, b), [f32(4, 3), i64(4, hi=6), f32(5, 3, seed=1),
                         f32(5, 1, seed=2)], (0, 2, 3)),
    ("hsigmoid_loss_custom_path", lambda pd, x, y, w, t, c: FE(pd)
     .hsigmoid_loss(x, y, 4, w, None, t, c),
     [f32(2, 3), np.array([1, 3]), f32(3, 3, seed=1),
      np.array([[0, 1, -1], [0, 2, -1]] * 2)[:4],
      np.array([[1, 0, 0], [0, 1, 0]] * 2, np.float32)[:4]], (0, 2)),
    ("rnnt_loss", lambda pd, x, y, il, ll: FE(pd).rnnt_loss(x, y, il, ll),
     [f32(2, 4, 3, 5), np.array([[1, 2], [3, 1]]), np.array([4, 3]),
      np.array([2, 1])], (0,)),
    ("rnnt_loss_sum", lambda pd, x, y, il, ll: FE(pd).rnnt_loss(
        x, y, il, ll, blank=4, reduction="sum"),
     [f32(2, 4, 3, 5), np.array([[1, 2], [3, 1]]), np.array([4, 3]),
      np.array([2, 1])], (0,)),
    ("adaptive_log_softmax_with_loss", lambda pd, x, y, hw, t0, t1: FE(pd)
     .adaptive_log_softmax_with_loss(x, y, hw, [t0, t1], [4, 7, 10]),
     [f32(5, 3), np.array([0, 5, 9, 3, 6]), f32(3, 6, seed=1),
      f32(3, 3, seed=2), f32(3, 3, seed=3)], (0, 2, 3, 4)),
    ("zeropad2d", lambda pd, x: FE(pd).zeropad2d(x, [1, 2, 0, 1]), [IMG],
     (0,)),
    ("zeropad2d_nhwc", lambda pd, x: FE(pd).zeropad2d(
        x, [1, 0, 2, 1], "NHWC"), [IMG], (0,)),
    ("max_unpool2d", lambda pd, x: FE(pd).max_unpool2d(
        *pd.nn.functional.max_pool2d(x, 2, return_mask=True), 2), [IMG],
     (0,)),
    ("max_unpool1d", lambda pd, x: FE(pd).max_unpool1d(
        *pd.nn.functional.max_pool1d(x, 2, return_mask=True), 2),
     [f32(2, 3, 8)], (0,)),
    ("max_unpool3d", lambda pd, x: FE(pd).max_unpool3d(
        *pd.nn.functional.max_pool3d(x, 2, return_mask=True), 2),
     [f32(1, 2, 4, 4, 4)], (0,)),
    ("fractional_max_pool2d", lambda pd, x: FE(pd).fractional_max_pool2d(
        x, 4, random_u=0.3), [IMG], (0,)),
    ("fractional_max_pool3d_mask", lambda pd, x: FE(pd)
     .fractional_max_pool3d(x, [3, 2, 3], return_mask=True),
     [f32(1, 2, 5, 4, 6)], (0,)),
    ("affine_grid", lambda pd, t: FE(pd).affine_grid(t, [2, 3, 4, 5]),
     [THETA], (0,)),
    ("affine_grid_3d", lambda pd, t: FE(pd).affine_grid(
        t, [1, 2, 3, 4, 5], False), [f32(1, 3, 4, seed=3)], (0,)),
] + [
    (f"grid_sample_{mode}_{pad}", (lambda mode, pad: lambda pd, x, g: FE(pd)
                                   .grid_sample(x, g, mode, pad))(mode, pad),
     [IMG, GRID], (0, 1) if mode == "bilinear" else (0,))
    for mode in ("bilinear", "nearest")
    for pad in ("zeros", "border", "reflection")
] + [
    ("grid_sample_unaligned", lambda pd, x, g: FE(pd).grid_sample(
        x, g, padding_mode="reflection", align_corners=False), [IMG, GRID],
     (0, 1)),
    ("class_center_sample", lambda pd, y: FE(pd).class_center_sample(
        y, 10, 6), [np.array([1, 3, 3, 7])], ()),
    ("sparse_attention", lambda pd, q, k, v, o, c: FE(pd).sparse_attention(
        q, k, v, o, c), [f32(1, 2, 4, 8), f32(1, 2, 4, 8, seed=1),
                         f32(1, 2, 4, 8, seed=2), CSR_OFF, CSR_COL],
     (0, 1, 2)),
    ("gather_tree", lambda pd, i, p: FE(pd).gather_tree(i, p),
     [i64(4, 2, 3, hi=9), i64(4, 2, 3, hi=3, seed=1)], ()),
    ("temporal_shift", lambda pd, x: FE(pd).temporal_shift(x, 2),
     [f32(4, 8, 2, 2)], (0,)),
    ("margin_cross_entropy_mean", lambda pd, x, y: FE(pd)
     .margin_cross_entropy(x, y, reduction="mean"),
     [f32(4, 6, lo=-0.9, hi=0.9), i64(4, hi=6)], (0,)),
    ("flash_attn_qkvpacked", lambda pd, qkv: FE(pd).flash_attn_qkvpacked(
        qkv, causal=True), [f32(2, 8, 3, 2, 16)], (0,)),
    ("flash_attn_varlen_qkvpacked", lambda pd, qkv, cu: FE(pd)
     .flash_attn_varlen_qkvpacked(qkv, cu, cu, 5, 5, scale=0.25,
                                  causal=True),
     [f32(8, 3, 2, 16), np.array([0, 3, 8], np.int32)], (0,)),
    ("flashmask_attention", lambda pd, q, k, v, r: FE(pd)
     .flashmask_attention(q, k, v, r, causal=True),
     [f32(1, 6, 2, 8), f32(1, 6, 2, 8, seed=1), f32(1, 6, 2, 8, seed=2),
      np.array([[[[3, 6], [4, 6], [6, 6], [6, 6], [6, 6], [6, 6]]]])],
     (0, 1, 2)),
]


@pytest.mark.parametrize("name,fn,inputs,diff", CASES,
                         ids=[c[0] for c in CASES])
def test_functional_matches_reference(name, fn, inputs, diff):
    (ref, ref_g), (got, got_g) = _run(P, fn, inputs, diff), \
        _run(T, fn, inputs, diff)
    assert len(got) == len(ref)
    for i, (g, w) in enumerate(zip(got, ref)):
        _close(g, w, f"{name} output {i}")
    for k, g, w in zip(diff, got_g, ref_g):
        _close(g, w, f"{name} grad of input {k}", grad=True)


def test_feature_alpha_dropout_drops_whole_channels():
    x = T.to_tensor(f32(4, 8, 3, 3))
    out = T.nn.functional.feature_alpha_dropout(x, 0.5).numpy()
    xa = x.numpy()
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = 1.0 / np.sqrt((alpha_p ** 2 * 0.5 + 1) * 0.5)
    b = -a * alpha_p * 0.5
    kept = np.isclose(out, xa * a + b, atol=1e-6).all(axis=(2, 3))
    dropped = np.isclose(out, alpha_p * a + b, atol=1e-6).all(axis=(2, 3))
    assert (kept | dropped).all() and kept.any() and dropped.any()
    np.testing.assert_array_equal(
        T.nn.functional.feature_alpha_dropout(x, 0.5, False).numpy(), xa)


# ------------------------------------------------------------- the layers
def _carry(ref, port):
    sd = {k: v.numpy() for k, v in ref.state_dict().items()}
    assert set(sd) == set(port.state_dict())
    port.set_state_dict(sd)


LAYERS = [
    ("PairwiseDistance", lambda nn: nn.PairwiseDistance(), 2),
    ("PoissonNLLLoss", lambda nn: nn.PoissonNLLLoss(), 2),
    ("GaussianNLLLoss", lambda nn: nn.GaussianNLLLoss(), 3),
    ("MultiMarginLoss", lambda nn: nn.MultiMarginLoss(), "margin"),
    ("TripletMarginWithDistanceLoss",
     lambda nn: nn.TripletMarginWithDistanceLoss(), 3),
    ("HSigmoidLoss", lambda nn: nn.HSigmoidLoss(4, 6), "hsig"),
    ("RNNTLoss", lambda nn: nn.RNNTLoss(), "rnnt"),
    ("AdaptiveLogSoftmaxWithLoss",
     lambda nn: nn.AdaptiveLogSoftmaxWithLoss(4, 10, [4, 7]), "adaptive"),
    ("Softmax2D", lambda nn: nn.Softmax2D(), "img"),
    ("Unflatten", lambda nn: nn.Unflatten(1, [2, 3]), "flat"),
    ("ZeroPad1D", lambda nn: nn.ZeroPad1D([1, 2]), "seq"),
    ("ZeroPad3D", lambda nn: nn.ZeroPad3D(1), "vol"),
    ("FractionalMaxPool2D",
     lambda nn: nn.FractionalMaxPool2D(3, random_u=0.4), "img"),
    ("FractionalMaxPool3D",
     lambda nn: nn.FractionalMaxPool3D(2, random_u=0.4), "vol"),
    ("LPPool1D", lambda nn: nn.LPPool1D(2, 2), "seq"),
    ("LPPool2D", lambda nn: nn.LPPool2D(3, 2), "img"),
    ("MaxUnPool2D", lambda nn: nn.MaxUnPool2D(2), "unpool2"),
    ("MaxUnPool1D", lambda nn: nn.MaxUnPool1D(2), "unpool1"),
    ("MaxUnPool3D", lambda nn: nn.MaxUnPool3D(2), "unpool3"),
]

LAYER_INPUTS = {
    2: lambda: [f32(3, 4, lo=0.1, hi=2.0), f32(3, 4, lo=0.1, hi=2.0, seed=1)],
    3: lambda: [f32(3, 4, lo=0.1, hi=2.0), f32(3, 4, seed=1),
                f32(3, 4, lo=0.1, hi=2.0, seed=2)],
    "margin": lambda: [f32(4, 5), i64(4, hi=5)],
    "hsig": lambda: [f32(5, 4), i64(5, hi=6)],
    "rnnt": lambda: [f32(2, 4, 3, 5), np.array([[1, 2], [3, 1]]),
                     np.array([4, 3]), np.array([2, 1])],
    "adaptive": lambda: [f32(5, 4), np.array([0, 5, 9, 3, 6])],
    "img": lambda: [IMG],
    "flat": lambda: [f32(2, 6, 2)],
    "seq": lambda: [f32(2, 3, 8)],
    "vol": lambda: [f32(1, 2, 4, 4, 4)],
}


def _unpool_inputs(pd, n):
    pool = {1: pd.nn.functional.max_pool1d, 2: pd.nn.functional.max_pool2d,
            3: pd.nn.functional.max_pool3d}[n]
    x = pd.to_tensor({1: f32(2, 3, 8), 2: IMG, 3: f32(1, 2, 4, 4, 4)}[n])
    return list(pool(x, 2, return_mask=True))


@pytest.mark.parametrize("name,make,inputs", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_matches_reference(name, make, inputs):
    P.seed(5)
    ref, port = make(P.nn), make(T.nn)
    _carry(ref, port)
    got = {}
    for pd, layer in ((P, ref), (T, port)):
        if isinstance(inputs, str) and inputs.startswith("unpool"):
            xs = _unpool_inputs(pd, int(inputs[-1]))
        else:
            xs = [pd.to_tensor(a) for a in LAYER_INPUTS[inputs]()]
        params = [p for _, p in layer.named_parameters()]
        out = _outs(layer(*xs))
        if params:
            sum(o.sum() for o in out).backward()
        got[pd] = ([o.numpy() for o in out],
                   [p.grad.numpy() for p in params])
    for i, (g, w) in enumerate(zip(got[T][0], got[P][0])):
        _close(g, w, f"{name} output {i}")
    for i, (g, w) in enumerate(zip(got[T][1], got[P][1])):
        _close(g, w, f"{name} grad of parameter {i}", grad=True)


def test_adaptive_log_softmax_log_prob_and_predict():
    P.seed(6)
    ref = P.nn.AdaptiveLogSoftmaxWithLoss(4, 10, [4, 7], head_bias=True)
    port = T.nn.AdaptiveLogSoftmaxWithLoss(4, 10, [4, 7], head_bias=True)
    _carry(ref, port)
    x = f32(5, 4)
    _close(port.log_prob(T.to_tensor(x)).numpy(),
           ref.log_prob(P.to_tensor(x)).numpy(), "log_prob")
    np.testing.assert_array_equal(port.predict(T.to_tensor(x)).numpy(),
                                  ref.predict(P.to_tensor(x)).numpy())


def test_feature_alpha_dropout_layer_is_identity_in_eval():
    layer = T.nn.FeatureAlphaDropout(0.5)
    layer.eval()
    x = T.to_tensor(f32(2, 3, 4))
    np.testing.assert_array_equal(layer(x).numpy(), x.numpy())


def test_beam_search_dynamic_decode_matches_reference():
    P.seed(8)
    V_, E = 7, 6
    runs = {}
    emb_np = f32(V_, E, seed=1)
    proj_np = f32(E, V_, seed=2)
    for pd in (P, T):
        cell = pd.nn.GRUCell(E, E)
        if pd is P:
            ref_cell = cell
        else:
            _carry(ref_cell, cell)
        emb, proj = pd.to_tensor(emb_np), pd.to_tensor(proj_np)
        dec = pd.nn.BeamSearchDecoder(
            cell, start_token=0, end_token=1, beam_size=3,
            embedding_fn=lambda ids, emb=emb: emb[ids],
            output_fn=lambda h, proj=proj: pd.matmul(h, proj))
        init = pd.to_tensor(f32(2, E, seed=3))
        out, lp, lens = pd.nn.dynamic_decode(dec, init, max_step_num=5,
                                             return_length=True)
        runs[pd] = (out.numpy(), lp.numpy(), lens.numpy())
    np.testing.assert_array_equal(runs[T][0], runs[P][0])
    _close(runs[T][1], runs[P][1], "beam log-probabilities")
    np.testing.assert_array_equal(runs[T][2], runs[P][2])


# ---------------------------------------------------------------- nn.quant
def test_weight_quantize_dequantize_and_linear_match_reference():
    w, x, b = f32(16, 8), f32(4, 16, seed=1), f32(8, seed=2)
    got = {}
    for pd in (P, T):
        q, s = pd.nn.quant.weight_quantize(pd.to_tensor(w))
        deq = pd.nn.quant.weight_dequantize(q, s, out_dtype="float32")
        xt = pd.to_tensor(x, stop_gradient=False)
        out = pd.nn.quant.weight_only_linear(xt, q, pd.to_tensor(b), s)
        out.sum().backward()
        llm = pd.nn.quant.llm_int8_linear(pd.to_tensor(x), q,
                                          weight_scale=s)
        got[pd] = (q.numpy(), s.numpy(), deq.numpy(), out.numpy(),
                   xt.grad.numpy(), llm.numpy())
    assert got[T][0].dtype == np.int8
    np.testing.assert_array_equal(got[T][0], got[P][0])
    for i in range(1, 6):
        _close(got[T][i], got[P][i], f"quant output {i}")


def test_quantized_linear_layer():
    layer = T.nn.quant.QuantizedLinear(16, 8)
    assert layer.quant_weight.dtype == T.int8
    x = T.to_tensor(f32(4, 16))
    deq = T.nn.quant.weight_dequantize(layer.quant_weight,
                                       layer.weight_scale, out_dtype="float32")
    want = x.numpy() @ deq.numpy() + layer.bias.numpy()
    _close(layer(x).numpy(), want, "QuantizedLinear")


# ---------------------------------------------------------------- text
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "un", "##aff", "##able",
         "hello", "world", ",", "!", "the", "中", "文"]


def test_faster_tokenizer_and_viterbi_decoder_match_reference():
    texts = ["Hello, unaffable world!", "中文 the Café", "zzz"]
    got = {}
    for pd in (P, T):
        tok = pd.text.FasterTokenizer(VOCAB)
        ids, tt = tok(pd.text.StringTensor(texts), text_pair=["the", "a",
                                                              "world"],
                      max_seq_len=10, pad_to_max_seq_len=True)
        dec = pd.text.ViterbiDecoder(pd.to_tensor(f32(5, 5, seed=1)))
        score, path = dec(pd.to_tensor(f32(2, 4, 3)),
                          pd.to_tensor(np.array([4, 2])))
        got[pd] = (ids.numpy(), tt.numpy(), score.numpy(), path.numpy())
    assert got[T][0].dtype == np.int64
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[T][i], got[P][i])
    _close(got[T][2], got[P][2], "viterbi score")
