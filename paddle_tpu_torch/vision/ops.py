"""paddle.vision.ops: the port of ``paddle_tpu/vision/ops.py`` (reference:
python/paddle/vision/ops.py over phi's detection kernels).

Every op computes what the JAX package computes, its quirks kept (ROADMAP,
deliberate differences): ``roi_align`` samples a fixed 2 x 2 grid a cell
when ``sampling_ratio <= 0``; ``generate_proposals`` returns zero scores;
``nms`` returns the kept indices in score order, ties broken by a stable
sort's order.

The ops run on their tensors' device in torch ops. Two work on the host, as
the reference's do: ``distribute_fpn_proposals`` and ``generate_proposals``
(numpy; its NMS runs on the default device), and ``nms`` walks its greedy
pass on the host over one copy of the IoU-above-threshold matrix, which it
computes on the device (the reference's loop is n sequential steps). The
RoI ops gather the four corner values of each sample by (image, y, x)
index from one channels-last copy of the feature map: no per-box copy of
the map is made.
``deform_conv2d`` gathers its bilinear samples and then runs one GEMM, as
the reference does; its backward is autograd's through the gather.
"""
from __future__ import annotations

import io

import numpy as np
import torch

from ..core.dispatch import run_op
from ..core.tensor import Parameter, Tensor
from ..nn.layer.layers import Layer


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------

def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Encode/decode boxes against priors (reference box_coder op). A
    ``prior_box_var`` that is not a Tensor, array or list is ignored, as
    the reference ignores it."""
    def f(pb, pbv, tb):
        norm = 0.0 if box_normalized else 1.0
        pw = pb[:, 2] - pb[:, 0] + norm
        ph = pb[:, 3] - pb[:, 1] + norm
        px = pb[:, 0] + pw * 0.5
        py = pb[:, 1] + ph * 0.5
        if code_type == "encode_center_size":
            tw = tb[:, None, 2] - tb[:, None, 0] + norm
            th = tb[:, None, 3] - tb[:, None, 1] + norm
            tx = tb[:, None, 0] + tw * 0.5
            ty = tb[:, None, 1] + th * 0.5
            ox = (tx - px[None]) / pw[None]
            oy = (ty - py[None]) / ph[None]
            ow = torch.log(torch.abs(tw / pw[None]))
            oh = torch.log(torch.abs(th / ph[None]))
            out = torch.stack([ox, oy, ow, oh], -1)
            if pbv is not None:
                out = out / pbv[None]
            return out
        if pbv is not None:
            tb = tb * (pbv[None] if pbv.dim() == 2 else pbv)
        if axis == 0:
            px_, py_, pw_, ph_ = (px[None, :], py[None, :],
                                  pw[None, :], ph[None, :])
        else:
            px_, py_, pw_, ph_ = (px[:, None], py[:, None],
                                  pw[:, None], ph[:, None])
        ox = tb[..., 0] * pw_ + px_
        oy = tb[..., 1] * ph_ + py_
        ow = torch.exp(tb[..., 2]) * pw_
        oh = torch.exp(tb[..., 3]) * ph_
        return torch.stack([ox - ow * 0.5, oy - oh * 0.5,
                            ox + ow * 0.5 - norm, oy + oh * 0.5 - norm], -1)

    pb = _t(prior_box)
    if isinstance(prior_box_var, (Tensor, np.ndarray, list)):
        return run_op("box_coder", f, pb, _t(prior_box_var), _t(target_box))
    return run_op("box_coder", lambda a, b: f(a, None, b), pb,
                  _t(target_box))


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD prior boxes over the feature map grid (reference prior_box)."""
    feat = _t(input)
    img = _t(image)
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    step_w = steps[0] or iw / fw
    step_h = steps[1] or ih / fh
    ars = list(aspect_ratios)
    if flip:
        ars = ars + [1.0 / a for a in aspect_ratios if a != 1.0]
    boxes = []
    for s in min_sizes:
        boxes.append((s, s))
        if max_sizes:
            for ms in max_sizes:
                boxes.append((np.sqrt(s * ms), np.sqrt(s * ms)))
        for a in ars:
            if abs(a - 1.0) < 1e-6:
                continue
            boxes.append((s * np.sqrt(a), s / np.sqrt(a)))

    def f(fm, _img):
        dev, dt = fm.device, torch.float32
        cx = (torch.arange(fw, device=dev, dtype=dt) + offset) * step_w
        cy = (torch.arange(fh, device=dev, dtype=dt) + offset) * step_h
        cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
        out = [torch.stack([(cxg - float(bw) / 2) / iw,
                            (cyg - float(bh) / 2) / ih,
                            (cxg + float(bw) / 2) / iw,
                            (cyg + float(bh) / 2) / ih], -1)
               for bw, bh in boxes]
        b = torch.stack(out, 2)          # [H, W, P, 4]
        if clip:
            b = torch.clamp(b, 0.0, 1.0)
        var = torch.tensor(variance, dtype=b.dtype, device=dev).expand(
            b.shape).contiguous()
        return b, var
    return run_op("prior_box", f, feat, img, differentiable=False)


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5, name=None):
    """Decode a YOLOv3 head's output to boxes and scores (reference
    yolo_box)."""
    na = len(anchors) // 2
    anc = np.asarray(anchors, np.float32).reshape(na, 2)

    def f(xa, imgs):
        n, c, h, w = xa.shape
        xa = xa.reshape(n, na, -1, h, w)
        a = torch.as_tensor(anc, device=xa.device, dtype=xa.dtype)
        gy, gx = torch.meshgrid(torch.arange(h, dtype=xa.dtype,
                                             device=xa.device),
                                torch.arange(w, dtype=xa.dtype,
                                             device=xa.device),
                                indexing="ij")
        bx = (torch.sigmoid(xa[:, :, 0]) * scale_x_y
              - (scale_x_y - 1) / 2 + gx) / w
        by = (torch.sigmoid(xa[:, :, 1]) * scale_x_y
              - (scale_x_y - 1) / 2 + gy) / h
        in_w = downsample_ratio * w
        in_h = downsample_ratio * h
        bw = torch.exp(xa[:, :, 2]) * a[None, :, 0, None, None] / in_w
        bh = torch.exp(xa[:, :, 3]) * a[None, :, 1, None, None] / in_h
        obj = torch.sigmoid(xa[:, :, 4])
        cls = torch.sigmoid(xa[:, :, 5:5 + class_num])
        score = obj[:, :, None] * cls
        ih = imgs[:, 0].to(xa.dtype)[:, None, None, None]
        iw = imgs[:, 1].to(xa.dtype)[:, None, None, None]
        x0 = (bx - bw / 2) * iw
        y0 = (by - bh / 2) * ih
        x1 = (bx + bw / 2) * iw
        y1 = (by + bh / 2) * ih
        if clip_bbox:
            x0 = torch.clamp(x0, min=0)
            y0 = torch.clamp(y0, min=0)
            x1 = torch.minimum(x1, iw - 1)
            y1 = torch.minimum(y1, ih - 1)
        boxes = torch.stack([x0, y0, x1, y1], -1).reshape(n, -1, 4)
        mask = (obj.reshape(n, -1) > conf_thresh)[..., None]
        zero = torch.zeros((), dtype=xa.dtype, device=xa.device)
        boxes = torch.where(mask, boxes, zero)
        scores = score.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
        return boxes, torch.where(mask, scores, zero)
    return run_op("yolo_box", f, _t(x), _t(img_size), differentiable=False)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, scale_x_y=1.0, name=None):
    """YOLOv3 training loss, the reference's dense-assignment variant: each
    ground truth goes to its best anchor on its grid cell; objectness BCE
    everywhere else."""
    na = len(anchor_mask)
    anc = np.asarray(anchors, np.float32).reshape(-1, 2)
    anc_m = anc[np.asarray(anchor_mask)]

    def f(xa, gb, gl):
        n, c, h, w = xa.shape
        dev = xa.device
        xa = xa.reshape(n, na, 5 + class_num, h, w)
        in_w = downsample_ratio * w
        tx = torch.sigmoid(xa[:, :, 0])
        ty = torch.sigmoid(xa[:, :, 1])
        obj = xa[:, :, 4]
        gx = gb[..., 0] * w
        gy = gb[..., 1] * h
        gw = gb[..., 2]
        gh = gb[..., 3]
        valid = (gw > 0) & (gh > 0)
        aw = torch.as_tensor(anc_m[:, 0] / in_w, device=dev)
        ah = torch.as_tensor(anc_m[:, 1] / in_w, device=dev)
        inter = torch.minimum(gw[..., None], aw) * \
            torch.minimum(gh[..., None], ah)
        union = gw[..., None] * gh[..., None] + aw * ah - inter
        best = torch.argmax(inter / (union + 1e-9), -1)     # [N, B]
        ci = torch.clamp(gx.to(torch.int32), 0, w - 1).long()
        cj = torch.clamp(gy.to(torch.int32), 0, h - 1).long()
        bidx = torch.arange(n, device=dev)[:, None].expand_as(best)
        tobj = _scatter_max(
            torch.zeros((n, na, h, w), dtype=torch.float32, device=dev),
            (bidx, best, cj, ci), valid.float())
        obj_loss = torch.clamp(obj, min=0) - obj * tobj + \
            torch.log1p(torch.exp(-torch.abs(obj)))
        px = tx[bidx, best, cj, ci]
        py = ty[bidx, best, cj, ci]
        lx = (px - (gx - torch.floor(gx))) ** 2
        ly = (py - (gy - torch.floor(gy))) ** 2
        coord = torch.sum((lx + ly) * valid, -1)
        tcls = torch.nn.functional.one_hot(gl.long(), class_num).to(
            xa.dtype)
        pc = xa[:, :, 5:][bidx, best, :, cj, ci]
        cls_loss = torch.sum(torch.sum(
            torch.clamp(pc, min=0) - pc * tcls
            + torch.log1p(torch.exp(-torch.abs(pc))), -1) * valid, -1)
        return torch.sum(obj_loss, (1, 2, 3)) + coord + cls_loss
    return run_op("yolo_loss", f, _t(x), _t(gt_box), _t(gt_label))


def _scatter_max(base, index, values):
    """``base.at[index].max(values)``: duplicate indices take the max."""
    lin = sum(i.reshape(-1) * s for i, s in zip(index, base.stride()))
    return base.reshape(-1).scatter_reduce(
        0, lin, values.reshape(-1).to(base.dtype), "amax",
        include_self=True).reshape(base.shape)


# ---------------------------------------------------------------------------
# RoI ops
# ---------------------------------------------------------------------------

def _box_images(bn, nb):
    """The image index of each of the ``nb`` boxes, from boxes_num."""
    counts = bn.long()
    return torch.repeat_interleave(
        torch.arange(counts.shape[0], device=bn.device), counts,
        output_size=nb)


def _gather(fhwc, img, yy, xx):
    """``feat[img, :, yy, xx]`` for each box's row and column grids
    ([nb, H'] and [nb, W']) -> [nb, H', W', C], read from the map laid out
    channels-last (``fhwc``, [N, H, W, C]): each sample is one contiguous
    row of C values."""
    return fhwc[img[:, None, None], yy[:, :, None], xx[:, None, :]]


def _size(output_size):
    if isinstance(output_size, int):
        return output_size, output_size
    return tuple(output_size)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign (reference roi_align): bilinear samples over a fixed grid
    a cell (2 x 2 when ``sampling_ratio <= 0``), then their mean."""
    oh, ow = _size(output_size)
    sr = sampling_ratio if sampling_ratio > 0 else 2

    def f(feat, bxs, bn):
        n, c, h, w = feat.shape
        nb = bxs.shape[0]
        dev, dt = feat.device, bxs.dtype
        img = _box_images(bn, nb)
        off = 0.5 if aligned else 0.0
        x0 = bxs[:, 0] * spatial_scale - off
        y0 = bxs[:, 1] * spatial_scale - off
        x1 = bxs[:, 2] * spatial_scale - off
        y1 = bxs[:, 3] * spatial_scale - off
        bw = x1 - x0
        bh = y1 - y0
        if not aligned:
            bw = torch.clamp(bw, min=1.0)
            bh = torch.clamp(bh, min=1.0)
        gy = y0[:, None] + (torch.arange(oh * sr, device=dev, dtype=dt)
                            + 0.5)[None] * (bh[:, None] / (oh * sr))
        gx = x0[:, None] + (torch.arange(ow * sr, device=dev, dtype=dt)
                            + 0.5)[None] * (bw[:, None] / (ow * sr))
        yy0 = torch.clamp(torch.floor(gy), 0, h - 1)
        xx0 = torch.clamp(torch.floor(gx), 0, w - 1)
        yy1 = torch.clamp(yy0 + 1, 0, h - 1)
        xx1 = torch.clamp(xx0 + 1, 0, w - 1)
        ly = torch.clamp(gy - yy0, 0, 1)
        lx = torch.clamp(gx - xx0, 0, 1)
        y0i, y1i, x0i, x1i = (t.long() for t in (yy0, yy1, xx0, xx1))
        hy, hx = 1 - ly, 1 - lx
        feat = feat.permute(0, 2, 3, 1).contiguous()
        # the four corners' sum, accumulated in place: one corner's
        # samples are alive beside the sum at a time
        v = _gather(feat, img, y0i, x0i) * (hy[:, :, None, None]
                                            * hx[:, None, :, None])
        for yi, xi, wy, wx in ((y1i, x0i, ly, hx), (y0i, x1i, hy, lx),
                               (y1i, x1i, ly, lx)):
            v.addcmul_(_gather(feat, img, yi, xi),
                       wy[:, :, None, None] * wx[:, None, :, None])
        out = v.reshape(nb, oh, sr, ow, sr, c).mean((2, 4))
        return out.permute(0, 3, 1, 2).contiguous()
    return run_op("roi_align", f, _t(x), _t(boxes), _t(boxes_num))


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """RoIPool (reference roi_pool): the max over a dense grid of 4 x 4
    samples a cell."""
    oh, ow = _size(output_size)
    sr = 4

    def f(feat, bxs, bn):
        n, c, h, w = feat.shape
        nb = bxs.shape[0]
        dev, dt = feat.device, bxs.dtype
        img = _box_images(bn, nb)
        x0 = torch.round(bxs[:, 0] * spatial_scale)
        y0 = torch.round(bxs[:, 1] * spatial_scale)
        x1 = torch.round(bxs[:, 2] * spatial_scale)
        y1 = torch.round(bxs[:, 3] * spatial_scale)
        bw = torch.clamp(x1 - x0 + 1, min=1.0)
        bh = torch.clamp(y1 - y0 + 1, min=1.0)
        gy = y0[:, None] + (torch.arange(oh * sr, device=dev, dtype=dt)
                            + 0.5)[None] * (bh[:, None] / (oh * sr))
        gx = x0[:, None] + (torch.arange(ow * sr, device=dev, dtype=dt)
                            + 0.5)[None] * (bw[:, None] / (ow * sr))
        yy = torch.clamp(gy, 0, h - 1).to(torch.int32).long()
        xx = torch.clamp(gx, 0, w - 1).to(torch.int32).long()
        out = _gather(feat.permute(0, 2, 3, 1).contiguous(), img, yy, xx)
        out = out.reshape(nb, oh, sr, ow, sr, c).amax((2, 4))
        return out.permute(0, 3, 1, 2).contiguous()
    return run_op("roi_pool", f, _t(x), _t(boxes), _t(boxes_num))


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pool (reference psroi_pool): output cell
    (i, j) averages input channel group i * ow + j."""
    oh, ow = _size(output_size)
    sr = 4

    def f(feat, bxs, bn):
        n, c, h, w = feat.shape
        co = c // (oh * ow)
        nb = bxs.shape[0]
        dev, dt = feat.device, bxs.dtype
        img = _box_images(bn, nb)
        x0 = bxs[:, 0] * spatial_scale
        y0 = bxs[:, 1] * spatial_scale
        bw = torch.clamp((bxs[:, 2] - bxs[:, 0]) * spatial_scale, min=0.1)
        bh = torch.clamp((bxs[:, 3] - bxs[:, 1]) * spatial_scale, min=0.1)
        gy = y0[:, None] + (torch.arange(oh * sr, device=dev, dtype=dt)
                            + 0.5)[None] * (bh[:, None] / (oh * sr))
        gx = x0[:, None] + (torch.arange(ow * sr, device=dev, dtype=dt)
                            + 0.5)[None] * (bw[:, None] / (ow * sr))
        yy = torch.clamp(gy, 0, h - 1).to(torch.int32).long()
        xx = torch.clamp(gx, 0, w - 1).to(torch.int32).long()
        out = _gather(feat.permute(0, 2, 3, 1).contiguous(), img, yy, xx)
        out = out.reshape(nb, oh, sr, ow, sr, c).mean((2, 4))
        out = out.reshape(nb, oh, ow, oh * ow, co)
        cell = (torch.arange(oh, device=dev)[:, None] * ow
                + torch.arange(ow, device=dev)[None, :])   # [oh, ow]
        picked = torch.take_along_dim(
            out, cell[None, :, :, None, None], 3)[..., 0, :]
        return picked.permute(0, 3, 1, 2).contiguous()
    return run_op("psroi_pool", f, _t(x), _t(boxes), _t(boxes_num))


# ---------------------------------------------------------------------------
# NMS family
# ---------------------------------------------------------------------------

def _iou_matrix(b):
    x0, y0, x1, y1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    area = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    ix0 = torch.maximum(x0[:, None], x0[None, :])
    iy0 = torch.maximum(y0[:, None], y0[None, :])
    ix1 = torch.minimum(x1[:, None], x1[None, :])
    iy1 = torch.minimum(y1[:, None], y1[None, :])
    inter = torch.clamp(ix1 - ix0, min=0) * torch.clamp(iy1 - iy0, min=0)
    return inter / torch.clamp(area[:, None] + area[None, :] - inter,
                               min=1e-9)


def _greedy_keep(over):
    """The reference's suppression loop over the boolean matrix ``over``
    ([n, n], symmetric, rows in score order) on the host: box i is kept
    when no kept box before it overlaps it."""
    n = over.shape[0]
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            keep[i + 1:] &= ~over[i, i + 1:]
    return keep


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Hard NMS (reference nms op): the IoU-above-threshold matrix of the
    boxes in score order on their device, one copy of it to the host and
    the greedy pass there. Returns the kept indices in score order (a
    tie broken by a stable sort's order)."""
    b = _t(boxes)
    n = b.shape[0]
    args = [b] + ([_t(scores)] if scores is not None else []) \
        + ([_t(category_idxs)] if category_idxs is not None else [])

    def f(bx, *rest):
        # as the reference: without scores the first extra input (the
        # categories, if given) takes the scores' place
        sc = rest[0] if rest else torch.arange(
            n, 0, -1, device=bx.device).to(bx.dtype)
        order = torch.argsort(-sc, stable=True)
        iou = _iou_matrix(bx[order])
        if categories is not None and rest[1:]:
            cat = rest[1][order]
            iou = torch.where(cat[:, None] == cat[None, :], iou,
                              torch.zeros((), dtype=iou.dtype,
                                          device=iou.device))
        return order, iou > iou_threshold
    order, over = run_op("nms", f, *args, differentiable=False)
    keep = _greedy_keep(over._data.cpu().numpy())
    kept = np.nonzero(keep)[0]
    if top_k is not None:
        kept = kept[:top_k]
    idx = torch.as_tensor(kept, device=order._data.device)
    return Tensor._wrap(order._data[idx])


def matrix_nms(bboxes, scores, score_threshold, post_threshold,
               nms_top_k, keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2): decay-based soft suppression (reference
    matrix_nms op); the kept rows come back as the reference returns
    them."""
    def f(bx, sc):
        bb = bx if bx.dim() == 3 else bx[None]
        ss = sc if sc.dim() == 3 else sc[None]
        outs = []
        for b_i in range(bb.shape[0]):
            per_cls = []
            for c_i in range(ss.shape[1]):
                if c_i == background_label:
                    continue
                s = ss[b_i, c_i]
                order = torch.argsort(-s, stable=True)[:nms_top_k]
                s_o = s[order]
                b_o = bb[b_i][order]
                upper = torch.triu(_iou_matrix(b_o), 1)
                max_iou = torch.amax(upper, 0)
                one = torch.ones((), dtype=upper.dtype, device=upper.device)
                if use_gaussian:
                    decay = torch.exp(-(upper ** 2 - max_iou[None] ** 2)
                                      / gaussian_sigma)
                else:
                    decay = (1 - upper) / torch.clamp(1 - max_iou[None],
                                                      min=1e-9)
                decay = torch.amin(torch.where(upper > 0, decay, one), 0)
                s_new = s_o * decay
                keep = s_new > post_threshold
                entry = torch.cat([torch.full_like(s_new, c_i)[:, None],
                                   s_new[:, None], b_o], -1)
                per_cls.append(torch.where(keep[:, None], entry, -one))
            cat = torch.cat(per_cls, 0)
            outs.append(cat[torch.argsort(-cat[:, 1],
                                          stable=True)[:keep_top_k]])
        return torch.cat(outs, 0)
    out = run_op("matrix_nms", f, _t(bboxes), _t(scores),
                 differentiable=False)
    valid = out._data[:, 1] > 0
    kept = Tensor._wrap(out._data[valid])
    count = int(valid.sum())
    dev = out._data.device
    rois_num = Tensor._wrap(torch.tensor([count], dtype=torch.int32,
                                         device=dev))
    if return_index:
        idx = Tensor._wrap(torch.nonzero(valid)[:, 0].to(torch.int32))
        return (kept, idx, rois_num) if return_rois_num else (kept, idx)
    return (kept, rois_num) if return_rois_num else kept


# ---------------------------------------------------------------------------
# deformable convolution
# ---------------------------------------------------------------------------

def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1/v2 (reference deform_conv2d): the input's
    bilinear samples at each tap's offset position, gathered, then one
    GEMM. A bias without a mask adds the bias (the reference's reshape of
    its stand-in mask fails there unless the output is 1 x 1: ROADMAP,
    found in the reference)."""
    st, pd, dl = _pair(stride), _pair(padding), _pair(dilation)
    dg = deformable_groups

    def f(xa, off, w, *rest):
        n, cin, h, wdt = xa.shape
        cout, cin_g, kh, kw = w.shape
        dev, dt = xa.device, off.dtype
        oh = (h + 2 * pd[0] - dl[0] * (kh - 1) - 1) // st[0] + 1
        ow = (wdt + 2 * pd[1] - dl[1] * (kw - 1) - 1) // st[1] + 1
        ys = torch.arange(oh, device=dev, dtype=dt) * st[0] - pd[0]
        xs = torch.arange(ow, device=dev, dtype=dt) * st[1] - pd[1]
        ky = torch.arange(kh, device=dev, dtype=dt) * dl[0]
        kx = torch.arange(kw, device=dev, dtype=dt) * dl[1]
        # base position of each tap at each output: [1, 1, kh, kw, oh, ow]
        base_y = (ky[:, None, None, None] + ys[None, None, :, None])
        base_x = (kx[None, :, None, None] + xs[None, None, None, :])
        o = off.reshape(n, dg, kh * kw, 2, oh, ow)
        py = base_y[None, None] + o[:, :, :, 0].reshape(n, dg, kh, kw, oh,
                                                         ow)
        px = base_x[None, None] + o[:, :, :, 1].reshape(n, dg, kh, kw, oh,
                                                         ow)
        cg = cin // dg
        xg = xa.reshape(n, dg, cg, h, wdt)
        bi = torch.arange(n, device=dev)[:, None, None, None, None, None]
        gi = torch.arange(dg, device=dev)[None, :, None, None, None, None]
        y0 = torch.floor(py)
        x0 = torch.floor(px)
        wy = py - y0
        wx = px - x0
        cols = 0
        for yy, ww_y in ((y0, 1 - wy), (y0 + 1, wy)):
            for xx, ww_x in ((x0, 1 - wx), (x0 + 1, wx)):
                valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < wdt)
                yc = torch.clamp(yy, 0, h - 1).long()
                xc = torch.clamp(xx, 0, wdt - 1).long()
                g = xg[bi, gi, :, yc, xc]       # [n, dg, kh, kw, oh, ow, cg]
                cols = cols + g * (ww_y * ww_x * valid)[..., None]
        if rest and rest[0] is not None:
            cols = cols * rest[0].reshape(n, dg, kh, kw, oh, ow)[..., None]
        cols = cols.permute(0, 1, 6, 2, 3, 4, 5).reshape(
            n, cin * kh * kw, oh * ow)
        wmat = w.reshape(cout, cin_g * kh * kw)
        if groups == 1:
            out = torch.matmul(wmat, cols)
        else:
            cols_g = cols.reshape(n, groups, (cin // groups) * kh * kw, -1)
            out = torch.matmul(wmat.reshape(groups, cout // groups, -1),
                               cols_g).reshape(n, cout, -1)
        out = out.reshape(n, cout, oh, ow)
        if len(rest) > 1:
            out = out + rest[1].reshape(1, -1, 1, 1)
        return out

    args = [_t(x), _t(offset), _t(weight)]
    if mask is not None:
        args.append(_t(mask))
    if bias is not None:
        if mask is None:
            return run_op("deform_conv2d",
                          lambda a, o, w, bb: f(a, o, w, None, bb),
                          *args, _t(bias))
        args.append(_t(bias))
    return run_op("deform_conv2d", f, *args)


class DeformConv2D(Layer):
    """Layer over deform_conv2d (reference vision/ops.py DeformConv2D):
    its weight drawn as the reference draws it (uniform from
    ``RandomState(0)``), a zero bias."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        ks = _pair(kernel_size)
        rng = np.random.RandomState(0)
        bound = 1.0 / np.sqrt(in_channels * ks[0] * ks[1])
        self.weight = Parameter(rng.uniform(
            -bound, bound, (out_channels, in_channels // groups) + ks
        ).astype(np.float32))
        self.bias = None if bias_attr is False else Parameter(
            np.zeros(out_channels, np.float32))
        self._cfg = (stride, padding, dilation, deformable_groups, groups)

    def forward(self, x, offset, mask=None):
        s, p, d, dg, g = self._cfg
        return deform_conv2d(x, offset, self.weight, self.bias, s, p, d, dg,
                             g, mask)


# ---------------------------------------------------------------------------
# proposals (on the host, as the reference computes them)
# ---------------------------------------------------------------------------

def _host(x):
    return np.asarray(_t(x).numpy())


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """Assign RoIs to FPN levels by scale (reference
    distribute_fpn_proposals), in numpy on the host."""
    arr = _host(fpn_rois)
    off = 1.0 if pixel_offset else 0.0
    scale = np.sqrt(np.maximum(
        (arr[:, 2] - arr[:, 0] + off) * (arr[:, 3] - arr[:, 1] + off), 0))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    outs, idx_all = [], []
    for level in range(min_level, max_level + 1):
        sel = np.nonzero(lvl == level)[0]
        outs.append(Tensor(arr[sel].reshape(-1, 4)))
        idx_all.append(sel)
    restore_ind = Tensor(
        np.argsort(np.concatenate(idx_all)).astype(np.int32).reshape(-1, 1))
    if rois_num is not None:
        return outs, restore_ind, [Tensor(np.asarray([len(i)], np.int32))
                                   for i in idx_all]
    return outs, restore_ind


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False,
                       name=None):
    """RPN proposals (reference generate_proposals): decode the anchors,
    clip, drop the small, NMS. The decoding runs in numpy on the host, as
    the reference's does; its NMS runs on the default device. The scores
    it returns are zeros, as the reference's are."""
    sc, bd = _host(scores), _host(bbox_deltas)       # [N, A, H, W], 4A
    ims = _host(img_size)
    anc = _host(anchors).reshape(-1, 4)
    var = _host(variances).reshape(-1, 4)
    all_rois, all_nums = [], []
    for i in range(sc.shape[0]):
        s = sc[i].transpose(1, 2, 0).reshape(-1)
        d = bd[i].reshape(-1, 4, sc.shape[2], sc.shape[3]) \
            .transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-s)[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], anc[order % len(anc)], \
            var[order % len(var)]
        aw = a[:, 2] - a[:, 0]
        ah = a[:, 3] - a[:, 1]
        ax = a[:, 0] + aw / 2
        ay = a[:, 1] + ah / 2
        cx = v[:, 0] * d[:, 0] * aw + ax
        cy = v[:, 1] * d[:, 1] * ah + ay
        w = np.exp(np.minimum(v[:, 2] * d[:, 2], 10)) * aw
        h = np.exp(np.minimum(v[:, 3] * d[:, 3], 10)) * ah
        boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                         -1)
        ih, iw = ims[i]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, iw - 1)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ih - 1)
        keep = ((boxes[:, 2] - boxes[:, 0]) >= min_size) & \
               ((boxes[:, 3] - boxes[:, 1]) >= min_size)
        boxes, s = boxes[keep], s[keep]
        if len(boxes):
            kept = nms(Tensor(boxes.astype(np.float32)), nms_thresh,
                       Tensor(s.astype(np.float32)))
            boxes = boxes[np.asarray(kept.numpy())[:post_nms_top_n]]
        all_rois.append(boxes.astype(np.float32))
        all_nums.append(len(boxes))
    rois = Tensor(np.concatenate(all_rois, 0) if all_rois
                  else np.zeros((0, 4), np.float32))
    scores_out = Tensor(np.zeros(sum(all_nums), np.float32))
    if return_rois_num:
        return rois, scores_out, Tensor(np.asarray(all_nums, np.int32))
    return rois, scores_out


# ---------------------------------------------------------------------------
# image IO (on the host, as the reference's)
# ---------------------------------------------------------------------------

def read_file(filename, name=None):
    """The file's bytes as a uint8 tensor."""
    with open(filename, "rb") as fh:
        data = np.frombuffer(fh.read(), np.uint8)
    return Tensor(data.copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode a JPEG byte tensor to [C, H, W] uint8 with Pillow on the
    host (the reference decodes on the host too)."""
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("decode_jpeg requires Pillow") from e
    img = Image.open(io.BytesIO(bytes(_host(x).astype(np.uint8))))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return Tensor(np.ascontiguousarray(arr))


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._args = (output_size, spatial_scale)

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, *self._args)


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._args = (output_size, spatial_scale)

    def forward(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, *self._args, aligned=aligned)


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._args = (output_size, spatial_scale)

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, *self._args)


__all__ = [
    "yolo_loss", "yolo_box", "prior_box", "box_coder", "deform_conv2d",
    "DeformConv2D", "distribute_fpn_proposals", "generate_proposals",
    "read_file", "decode_jpeg", "roi_pool", "RoIPool", "psroi_pool",
    "PSRoIPool", "roi_align", "RoIAlign", "nms", "matrix_nms",
]
