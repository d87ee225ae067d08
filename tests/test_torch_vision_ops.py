"""paddle_tpu_torch.vision.ops against paddle_tpu.vision.ops, on the CPU.

The same inputs, drawn from a numpy seed at a few boxes and channels, go
through every function of the reference's ``vision/ops.py`` and its port:

- index sets exactly: ``nms`` (with score ties, with categories, top_k,
  and the reference's quirk that category ids without scores stand in for
  the scores), ``generate_proposals``' boxes and counts,
  ``distribute_fpn_proposals``, ``matrix_nms``'s kept rows and indices;
- floats within 1e-5 of each output's largest value: ``box_coder``,
  ``prior_box``, ``yolo_box``, ``yolo_loss``, ``roi_align`` (``aligned``
  both ways, the default 2 x 2 grid and a set sampling ratio),
  ``roi_pool``, ``psroi_pool``, ``deform_conv2d`` (with and without a
  mask and a bias, ``groups`` 2, two deformable groups) and the layers;
- gradients: ``roi_align``'s and ``deform_conv2d``'s against ``jax.grad``
  of the reference's op, within 1e-5 of each gradient's largest value.

A bias without a mask makes the reference's ``deform_conv2d`` fail (its
stand-in mask does not reshape); the port adds the bias, and equals the
reference given a mask of ones.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu.core.tensor import Tensor as PTensor
from paddle_tpu_torch._testing import share_the_cores_fixture

TOL = 1e-5
PV, TV = P.vision.ops, T.vision.ops

_share_the_cores = share_the_cores_fixture()


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    yield


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _both(*arrays):
    """Each numpy array as a reference and a port tensor."""
    return ([P.to_tensor(a) for a in arrays], [T.to_tensor(a)
                                               for a in arrays])


def _np(out):
    if isinstance(out, (list, tuple)):
        return [_np(o) for o in out]
    return np.asarray(out.numpy())


def _jitted(fn, *arrays, **kw):
    """The reference's op compiled whole (``jax.jit``), as numpy: one XLA
    compile instead of one an eager primitive."""
    def raw(*a):
        out = fn(*(PTensor._wrap(x) for x in a), **kw)
        return tuple(o._data for o in out) if isinstance(out, tuple) \
            else out._data
    out = jax.jit(raw)(*(jnp.asarray(a) for a in arrays))
    return [np.asarray(o) for o in out] if isinstance(out, tuple) \
        else np.asarray(out)


def _boxes(rs, n, scale=20.0):
    xy = rs.rand(n, 2).astype(np.float32) * scale
    wh = rs.rand(n, 2).astype(np.float32) * scale / 2 + 0.5
    return np.concatenate([xy, xy + wh], 1)


# ------------------------------------------------------------------ boxes

@pytest.mark.parametrize("case", ["encode_list", "encode_tensor",
                                  "decode_axis0", "decode_axis1",
                                  "tuple_var_ignored", "unnormalized"])
def test_box_coder(case):
    rs = np.random.RandomState(0)
    prior = _boxes(rs, 6)
    var = [0.1, 0.1, 0.2, 0.2]
    kw = {}
    if case.startswith("encode") or case == "unnormalized":
        target = _boxes(rs, 4)
        code = "encode_center_size"
    else:
        target = rs.randn(4, 6, 4).astype(np.float32) * 0.3
        code = "decode_center_size"
    if case == "decode_axis1":
        target = rs.randn(6, 3, 4).astype(np.float32) * 0.3
        kw["axis"] = 1
    if case == "encode_tensor":
        var = np.tile(np.asarray(var, np.float32), (6, 1))
    if case == "decode_axis0":
        var = np.tile(np.asarray(var, np.float32), (6, 1))
    if case == "tuple_var_ignored":
        var = (0.1, 0.1, 0.2, 0.2)
    if case == "unnormalized":
        kw["box_normalized"] = False
    tp, tt = T.to_tensor(prior), T.to_tensor(target)
    if isinstance(var, np.ndarray):
        want = _jitted(lambda a, v, b: PV.box_coder(a, v, b, code, **kw),
                       prior, var, target)
        tv = T.to_tensor(var)
    else:
        want = _jitted(lambda a, b: PV.box_coder(a, var, b, code, **kw),
                       prior, target)
        tv = var
    got = _np(TV.box_coder(tp, tv, tt, code, **kw))
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("cfg", [
    dict(min_sizes=[4.0], aspect_ratios=(1.0, 2.0)),
    dict(min_sizes=[4.0, 8.0], max_sizes=[8.0, 16.0],
         aspect_ratios=(1.0, 2.0, 3.0), flip=True, clip=True,
         steps=(5.0, 4.0), offset=0.3)])
def test_prior_box(cfg):
    feat = np.zeros((1, 3, 5, 6), np.float32)
    img = np.zeros((1, 3, 20, 30), np.float32)
    (pf, pi), (tf, ti) = _both(feat, img)
    want = _np(PV.prior_box(pf, pi, **cfg))
    got = _np(TV.prior_box(tf, ti, **cfg))
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


def test_yolo_box_and_yolo_loss():
    rs = np.random.RandomState(1)
    anchors = [10, 13, 16, 30, 33, 23]
    x = rs.randn(2, 3 * (5 + 4), 4, 5).astype(np.float32)
    img = np.asarray([[64, 80], [40, 50]], np.int32)
    tx, ti = T.to_tensor(x), T.to_tensor(img)
    for clip in (True, False):
        want = _jitted(PV.yolo_box, x, img, anchors=anchors, class_num=4,
                       conf_thresh=0.4, downsample_ratio=16, clip_bbox=clip,
                       scale_x_y=1.2)
        got = _np(TV.yolo_box(tx, ti, anchors, 4, 0.4, 16, clip_bbox=clip,
                              scale_x_y=1.2))
        for g, w in zip(got, want):
            assert _rel(g, w) <= TOL
    gt = np.concatenate([rs.rand(2, 3, 2), rs.rand(2, 3, 2) * 0.5],
                        -1).astype(np.float32)
    gt[1, 2, 2:] = 0.0                            # an empty slot
    label = rs.randint(0, 4, (2, 3)).astype(np.int32)
    tg, tl = T.to_tensor(gt), T.to_tensor(label)
    want = _jitted(lambda a, b, c: PV.yolo_loss(a, b, c, anchors, [0, 1, 2],
                                                4, 0.7, 16), x, gt, label)
    got = _np(TV.yolo_loss(tx, tg, tl, anchors, [0, 1, 2], 4, 0.7, 16))
    assert _rel(got, want) <= TOL


# ---------------------------------------------------------------- RoI ops

def _roi_inputs(seed=2):
    rs = np.random.RandomState(seed)
    feat = rs.randn(3, 8, 10, 12).astype(np.float32)
    boxes = _boxes(rs, 7, 14.0)
    boxes[3] = [2.0, 3.0, 2.5, 3.2]               # smaller than a cell
    num = np.asarray([4, 0, 3], np.int32)         # an image without boxes
    return feat, boxes, num


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("ratio", [-1, 3])
def test_roi_align(aligned, ratio):
    feat, boxes, num = _roi_inputs()
    ta = [T.to_tensor(a) for a in (feat, boxes, num)]
    want = _jitted(lambda *a: PV.roi_align(*a, (3, 2), 0.8, ratio, aligned),
                   feat, boxes, num)
    got = _np(TV.roi_align(*ta, (3, 2), 0.8, ratio, aligned))
    assert _rel(got, want) <= TOL


def test_roi_align_gradient_against_jax_grad():
    feat, boxes, num = _roi_inputs(3)
    cot = np.random.RandomState(4).randn(7, 8, 2, 2).astype(np.float32)

    def ref(f):
        out = PV.roi_align(PTensor._wrap(f), P.to_tensor(boxes),
                           P.to_tensor(num), 2, 0.7, -1, True)
        return jnp.sum(out._data * cot)
    want = np.asarray(jax.jit(jax.grad(ref))(jnp.asarray(feat)))
    x = T.to_tensor(feat, stop_gradient=False)
    out = TV.roi_align(x, T.to_tensor(boxes), T.to_tensor(num), 2, 0.7)
    (out * T.to_tensor(cot)).sum().backward()
    assert _rel(x.grad.numpy(), want) <= TOL


def test_roi_pool_psroi_pool_and_the_layers():
    feat, boxes, num = _roi_inputs(5)
    ta = [T.to_tensor(a) for a in (feat, boxes, num)]
    for fn, args in (("roi_pool", ((2, 3), 0.8)), ("psroi_pool", (2, 0.8))):
        want = _jitted(lambda *a: getattr(PV, fn)(*a, *args), feat, boxes,
                       num)
        got = _np(getattr(TV, fn)(*ta, *args))
        assert _rel(got, want) <= TOL, fn
    for layer, args, kw in (("RoIPool", (2, 0.5), {}),
                            ("RoIAlign", (3, 0.5), {"aligned": False}),
                            ("PSRoIPool", (2, 0.5), {})):
        ref = getattr(PV, layer)(*args)
        want = _jitted(lambda *a: ref(*a, **kw), feat, boxes, num)
        got = _np(getattr(TV, layer)(*args)(*ta, **kw))
        assert _rel(got, want) <= TOL, layer


# -------------------------------------------------------------------- NMS

@pytest.mark.parametrize("case", ["boxes_only", "scores_with_ties",
                                  "categories", "top_k",
                                  "category_ids_without_scores"])
def test_nms_index_sets_are_the_references(case):
    rs = np.random.RandomState(6)
    boxes = _boxes(rs, 60, 12.0)
    scores = np.round(rs.rand(60), 1).astype(np.float32)   # many ties
    cats = rs.randint(0, 3, 60).astype(np.int64)
    kw = {"boxes_only": {},
          "scores_with_ties": {"scores": scores},
          "categories": {"scores": scores, "category_idxs": cats,
                         "categories": [0, 1, 2]},
          "top_k": {"scores": scores, "top_k": 7},
          "category_ids_without_scores": {"category_idxs": cats,
                                          "categories": [0, 1, 2]}}[case]
    pk = {k: P.to_tensor(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    tk = {k: T.to_tensor(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    want = _np(PV.nms(P.to_tensor(boxes), 0.3, **pk))
    got = _np(TV.nms(T.to_tensor(boxes), 0.3, **tk))
    assert got.dtype == want.dtype or got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms(gaussian):
    rs = np.random.RandomState(7)
    boxes = _boxes(rs, 12, 10.0)[None]
    scores = rs.rand(1, 3, 12).astype(np.float32)
    (pb, ps), (tb, ts) = _both(boxes, scores)
    kw = dict(score_threshold=0.1, post_threshold=0.2, nms_top_k=8,
              keep_top_k=10, use_gaussian=gaussian, return_index=True)
    want = _np(PV.matrix_nms(pb, ps, **kw))
    got = _np(TV.matrix_nms(tb, ts, **kw))
    assert _rel(got[0], want[0]) <= TOL
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


# ----------------------------------------------------- deformable conv

def _dcn_inputs(seed, n=2, cin=4, cout=6, h=6, w=7, dg=1, groups=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, cin, h, w).astype(np.float32)
    off = (rs.randn(n, 2 * dg * 9, h, w) * 0.8).astype(np.float32)
    mask = rs.rand(n, dg * 9, h, w).astype(np.float32)
    weight = rs.randn(cout, cin // groups, 3, 3).astype(np.float32)
    bias = rs.randn(cout).astype(np.float32)
    return x, off, mask, weight, bias


@pytest.mark.parametrize("case", [
    dict(mask=True, bias=True), dict(mask=True, bias=False),
    dict(mask=False, bias=False), dict(mask=True, bias=True, groups=2),
    dict(mask=True, bias=False, dg=2, stride=2)])
def test_deform_conv2d(case):
    dg, groups = case.get("dg", 1), case.get("groups", 1)
    x, off, mask, weight, bias = _dcn_inputs(8, dg=dg, groups=groups)
    if case.get("stride"):
        off = off[:, :, ::2, ::2]
        mask = mask[:, :, ::2, ::2]
    kw = dict(stride=case.get("stride", 1), padding=1,
              deformable_groups=dg, groups=groups)
    tx, to, tm, tw, tb = (T.to_tensor(a) for a in (x, off, mask, weight,
                                                   bias))
    want = _jitted(lambda xa, oa, ma, wa, ba: PV.deform_conv2d(
        xa, oa, wa, ba if case["bias"] else None,
        mask=ma if case["mask"] else None, **kw), x, off, mask, weight, bias)
    got = _np(TV.deform_conv2d(tx, to, tw, tb if case["bias"] else None,
                               mask=tm if case["mask"] else None, **kw))
    assert _rel(got, want) <= TOL


def test_deform_conv2d_gradients_against_jax_grad():
    x, off, mask, weight, bias = _dcn_inputs(9)
    cot = np.random.RandomState(10).randn(2, 6, 6, 7).astype(np.float32)

    def ref_ordered(xa, oa, ma, wa, ba):
        out = PV.deform_conv2d(PTensor._wrap(xa), PTensor._wrap(oa),
                               PTensor._wrap(wa), PTensor._wrap(ba),
                               padding=1, mask=PTensor._wrap(ma))
        return jnp.sum(out._data * cot)
    want = jax.jit(jax.grad(ref_ordered, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in (x, off, mask, weight, bias)))
    leaves = [T.to_tensor(a, stop_gradient=False)
              for a in (x, off, mask, weight, bias)]
    tx, to, tm, tw, tb = leaves
    out = TV.deform_conv2d(tx, to, tw, tb, padding=1, mask=tm)
    (out * T.to_tensor(cot)).sum().backward()
    for leaf, w in zip(leaves, want):
        assert _rel(leaf.grad.numpy(), np.asarray(w)) <= TOL


def test_deform_conv2d_bias_without_a_mask():
    x, off, mask, weight, bias = _dcn_inputs(11)
    tx, to, tw, tb = (T.to_tensor(a) for a in (x, off, weight, bias))
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(lambda *a: PV.deform_conv2d(
            *(PTensor._wrap(x) for x in a), padding=1)._data,
            x, off, weight, bias)
    want = _jitted(lambda xa, oa, wa, ba, ma: PV.deform_conv2d(
        xa, oa, wa, ba, padding=1, mask=ma), x, off, weight, bias,
        np.ones_like(mask))
    got = _np(TV.deform_conv2d(tx, to, tw, tb, padding=1))
    assert _rel(got, want) <= TOL


def test_deform_conv2d_layer_and_static_nn():
    x, off, mask, weight, bias = _dcn_inputs(12)
    tx, to, tm = (T.to_tensor(a) for a in (x, off, mask))
    ref = PV.DeformConv2D(4, 6, 3, padding=1)
    port = TV.DeformConv2D(4, 6, 3, padding=1)
    np.testing.assert_array_equal(port.weight.numpy(), ref.weight.numpy())
    want = _jitted(ref, x, off, mask)
    assert _rel(_np(port(tx, to, tm)), want) <= TOL
    assert TV.DeformConv2D(4, 6, 3, bias_attr=False).bias is None
    # static.nn over vision.ops: its own weight, the same function
    attr = T.ParamAttr(initializer=T.nn.initializer.Assign(weight))
    battr = T.ParamAttr(initializer=T.nn.initializer.Assign(bias))
    got = T.static.nn.deform_conv2d(tx, to, tm, 6, 3, padding=1,
                                    param_attr=attr, bias_attr=battr)
    direct = TV.deform_conv2d(tx, to, T.to_tensor(weight),
                              T.to_tensor(bias), padding=1, mask=tm)
    np.testing.assert_array_equal(got.numpy(), direct.numpy())
    assert got.shape == [2, 6, 6, 7]


# -------------------------------------------------------------- proposals

def test_distribute_fpn_proposals():
    rs = np.random.RandomState(13)
    xy = rs.rand(40, 2).astype(np.float32) * 300
    wh = np.exp(rs.rand(40, 2) * 6).astype(np.float32)
    rois = np.concatenate([xy, xy + wh], 1)
    for offset in (False, True):
        want = PV.distribute_fpn_proposals(P.to_tensor(rois), 2, 5, 4, 224,
                                           pixel_offset=offset,
                                           rois_num=P.to_tensor([40]))
        got = TV.distribute_fpn_proposals(T.to_tensor(rois), 2, 5, 4, 224,
                                          pixel_offset=offset,
                                          rois_num=T.to_tensor([40]))
        for g, w in zip(_np(got[0]), _np(want[0])):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
        np.testing.assert_array_equal(np.concatenate(_np(got[2])),
                                      np.concatenate(_np(want[2])))


def test_generate_proposals():
    rs = np.random.RandomState(14)
    a, h, w = 3, 6, 8
    scores = rs.rand(1, a, h, w).astype(np.float32)
    deltas = (rs.randn(1, 4 * a, h, w) * 0.2).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h) * 16.0, np.arange(w) * 16.0,
                         indexing="ij")
    sizes = np.asarray([16.0, 32.0, 64.0])
    anchors = np.stack([np.stack([xs - s / 2, ys - s / 2, xs + s / 2,
                                  ys + s / 2], -1) for s in sizes],
                       2).astype(np.float32)          # [H, W, A, 4]
    var = np.tile(np.asarray([0.1, 0.1, 0.2, 0.2], np.float32),
                  (h, w, a, 1))
    img = np.asarray([[80, 100]], np.float32)
    pa, ta = _both(scores, deltas, img, anchors, var)
    kw = dict(pre_nms_top_n=100, post_nms_top_n=20, nms_thresh=0.6,
              min_size=2.0, return_rois_num=True)
    want = _np(PV.generate_proposals(*pa, **kw))
    got = _np(TV.generate_proposals(*ta, **kw))
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], np.zeros(int(want[2].sum())))


def test_read_file_and_decode_jpeg(tmp_path):
    from PIL import Image
    rs = np.random.RandomState(15)
    path = tmp_path / "img.jpg"
    Image.fromarray(rs.randint(0, 256, (12, 10, 3)).astype(np.uint8)).save(
        path, quality=90)
    want = _np(PV.read_file(str(path)))
    got = _np(TV.read_file(str(path)))
    np.testing.assert_array_equal(got, want)
    for mode in ("unchanged", "gray", "rgb"):
        np.testing.assert_array_equal(
            _np(TV.decode_jpeg(T.to_tensor(got), mode)),
            _np(PV.decode_jpeg(P.to_tensor(want), mode)))
    assert TV.decode_jpeg(T.to_tensor(got), "gray").shape == [1, 12, 10]


def test_every_name_is_ported():
    assert sorted(TV.__all__) == sorted(PV.__all__)
    for name in PV.__all__:
        assert callable(getattr(TV, name)), name
