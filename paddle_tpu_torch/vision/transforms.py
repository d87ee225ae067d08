"""Image transforms: the port of ``paddle_tpu/vision/transforms.py``
(numpy, HWC; reference: python/paddle/vision/transforms/transforms.py).

Every transform is the reference's numpy code but ``Resize``, which the
reference computes with ``jax.image.resize(..., "linear")``: here the same
function in numpy (``_linear_weights``). ``ToTensor`` builds a ``Tensor``
on the default place (the CPU inside a DataLoader worker).
"""
from __future__ import annotations

import numbers
import random

import numpy as np

from ..core.tensor import Tensor


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


class ToTensor(BaseTransform):
    """HWC uint8 [0,255] -> CHW float32 [0,1] Tensor."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        else:
            arr = arr.astype(np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return Tensor(arr)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW",
                 to_rgb=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = img.numpy() if isinstance(img, Tensor) else \
            np.asarray(img, np.float32)
        if self.data_format == "CHW":
            shape = (-1, 1, 1)
        else:
            shape = (1, 1, -1)
        out = (arr - self.mean.reshape(shape)) / self.std.reshape(shape)
        return Tensor(out) if isinstance(img, Tensor) else out


def _linear_weights(n_in, n_out):
    """[n_in, n_out] f32 weights of jax.image.resize's "linear" method along
    one axis (jax/_src/image/scale.py, compute_weight_mat): a triangle
    kernel at half-pixel centres, widened by n_in / n_out where the axis
    shrinks (antialiasing), each output's weights normalised to sum 1."""
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    dist = np.abs(sample[None, :] - np.arange(n_in)[:, None])
    w = np.maximum(0.0, 1.0 - dist / max(inv_scale, 1.0))
    return (w / w.sum(0, keepdims=True)).astype(np.float32)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = size if isinstance(size, (list, tuple)) \
            else (size, size)

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = self.size
        a = arr.astype(np.float32)
        # rows, then columns: out[i, j] = sum_y,x wh[y, i] ww[x, j] a[y, x]
        out = np.tensordot(_linear_weights(a.shape[0], h), a, ([0], [0]))
        out = np.moveaxis(np.tensordot(
            _linear_weights(a.shape[1], w), out, ([0], [1])), 0, 1)
        return out.astype(arr.dtype) if arr.dtype == np.uint8 else out


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False):
        self.size = size if isinstance(size, (list, tuple)) \
            else (size, size)
        self.padding = padding

    def _apply_image(self, img):
        arr = np.asarray(img)
        if self.padding:
            p = self.padding
            pads = [(p, p), (p, p)] + [(0, 0)] * (arr.ndim - 2)
            arr = np.pad(arr, pads)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = random.randint(0, max(h - th, 0))
        j = random.randint(0, max(w - tw, 0))
        return arr[i:i + th, j:j + tw]


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = size if isinstance(size, (list, tuple)) \
            else (size, size)

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return arr[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        arr = np.asarray(img)
        if random.random() < self.prob:
            return arr[:, ::-1].copy()
        return arr


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        arr = np.asarray(img)
        if random.random() < self.prob:
            return arr[::-1].copy()
        return arr


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = padding
        self.fill = fill

    def _apply_image(self, img):
        arr = np.asarray(img)
        p = self.padding
        if isinstance(p, numbers.Number):
            p = (p, p, p, p)
        if len(p) == 2:
            p = (p[0], p[1], p[0], p[1])
        pads = [(p[1], p[3]), (p[0], p[2])] + [(0, 0)] * (arr.ndim - 2)
        return np.pad(arr, pads, constant_values=self.fill)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr.transpose(self.order)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW"):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return np.asarray(img)[:, ::-1].copy()


def vflip(img):
    return np.asarray(img)[::-1].copy()


# ---------------------------------------------------------------------
# functional transforms (reference:
# python/paddle/vision/transforms/functional.py; numpy/HWC backend — the
# "cv2"/"pil" backends collapse to numpy here)
# ---------------------------------------------------------------------

def _np(img):
    if isinstance(img, Tensor):
        return img.numpy()
    return np.asarray(img)


def crop(img, top, left, height, width):
    return _np(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    a = _np(img)
    h, w = a.shape[:2]
    th, tw = output_size
    return crop(a, max((h - th) // 2, 0), max((w - tw) // 2, 0), th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    a = _np(img)
    if isinstance(padding, numbers.Number):
        pl = pr = pt = pb = int(padding)
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding
    cfg = [(pt, pb), (pl, pr)] + [(0, 0)] * (a.ndim - 2)
    if padding_mode == "constant":
        return np.pad(a, cfg, constant_values=fill)
    mode = {"edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    return np.pad(a, cfg, mode=mode)


def _affine_matrix(angle, translate, scale, shear, center):
    rot = np.deg2rad(angle)
    sx, sy = [np.deg2rad(s) for s in shear]
    cx, cy = center
    tx, ty = translate
    # M = T(center) T(translate) R(angle) Sh(shear) S(scale) T(-center)
    a = np.cos(rot - sy) / np.cos(sy)
    b = -np.cos(rot - sy) * np.tan(sx) / np.cos(sy) - np.sin(rot)
    c = np.sin(rot - sy) / np.cos(sy)
    d = -np.sin(rot - sy) * np.tan(sx) / np.cos(sy) + np.cos(rot)
    m = np.array([[a * scale, b * scale, 0],
                  [c * scale, d * scale, 0]], np.float64)
    m[0, 2] = cx + tx - m[0, 0] * cx - m[0, 1] * cy
    m[1, 2] = cy + ty - m[1, 0] * cx - m[1, 1] * cy
    return m


def _warp_affine(a, m, out_hw=None, fill=0.0):
    """Inverse-map affine warp with bilinear sampling (host-side numpy;
    input pipeline work like the reference's cv2 backend)."""
    h, w = a.shape[:2]
    oh, ow = out_hw if out_hw is not None else (h, w)
    minv = np.linalg.inv(np.vstack([m, [0, 0, 1]]))[:2]
    ys, xs = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
    src = minv @ np.stack([xs.ravel(), ys.ravel(),
                           np.ones(oh * ow)], 0)
    sx = src[0].reshape(oh, ow)
    sy = src[1].reshape(oh, ow)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    lx = sx - x0
    ly = sy - y0
    out = np.zeros((oh, ow) + a.shape[2:], np.float32)
    acc = a.astype(np.float32)
    for (yy, wy) in ((y0, 1 - ly), (y0 + 1, ly)):
        for (xx, wx) in ((x0, 1 - lx), (x0 + 1, lx)):
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            yc = np.clip(yy, 0, h - 1)
            xc = np.clip(xx, 0, w - 1)
            wgt = (wy * wx * valid)
            out += acc[yc, xc] * (wgt[..., None] if a.ndim == 3 else wgt)
    if fill is not None and not (np.isscalar(fill) and fill == 0):
        none = ~(((y0 >= -1) & (y0 < h)) & ((x0 >= -1) & (x0 < w)))
        out[none] = fill
    return out.astype(a.dtype) if a.dtype != np.uint8 else \
        np.clip(out, 0, 255).astype(np.uint8)


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    a = _np(img)
    h, w = a.shape[:2]
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    if isinstance(shear, numbers.Number):
        shear = (shear, 0.0)
    m = _affine_matrix(angle, translate, scale, shear, center)
    return _warp_affine(a, m, fill=fill)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    a = _np(img)
    h, w = a.shape[:2]
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    m = _affine_matrix(angle, (0, 0), 1.0, (0.0, 0.0), center)
    out_hw = None
    if expand:
        corners = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]]).T
        mapped = m @ corners
        ow = int(np.ceil(mapped[0].max() - mapped[0].min()))
        oh = int(np.ceil(mapped[1].max() - mapped[1].min()))
        m[0, 2] -= mapped[0].min()
        m[1, 2] -= mapped[1].min()
        out_hw = (oh, ow)
    return _warp_affine(a, m, out_hw, fill=fill)


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    a = _np(img)
    # solve 8-dof homography from 4 point pairs
    A = []
    B = []
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        A.append([sx, sy, 1, 0, 0, 0, -ex * sx, -ex * sy])
        A.append([0, 0, 0, sx, sy, 1, -ey * sx, -ey * sy])
        B += [ex, ey]
    coef = np.linalg.lstsq(np.asarray(A, np.float64),
                           np.asarray(B, np.float64), rcond=None)[0]
    hmat = np.concatenate([coef, [1.0]]).reshape(3, 3)
    h, w = a.shape[:2]
    hinv = np.linalg.inv(hmat)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pts = hinv @ np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)], 0)
    sx = (pts[0] / pts[2]).reshape(h, w)
    sy = (pts[1] / pts[2]).reshape(h, w)
    x0 = np.round(sx).astype(np.int64)
    y0 = np.round(sy).astype(np.int64)
    valid = (x0 >= 0) & (x0 < w) & (y0 >= 0) & (y0 < h)
    out = np.full_like(a, fill)
    out[valid] = a[np.clip(y0, 0, h - 1), np.clip(x0, 0, w - 1)][valid]
    return out


def adjust_brightness(img, brightness_factor):
    a = _np(img).astype(np.float32)
    out = a * brightness_factor
    return np.clip(out, 0, 255).astype(np.uint8) \
        if _np(img).dtype == np.uint8 else out


def adjust_contrast(img, contrast_factor):
    a = _np(img).astype(np.float32)
    mean = a.mean() if a.ndim == 2 else \
        (0.299 * a[..., 0] + 0.587 * a[..., 1]
         + 0.114 * a[..., 2]).mean()
    out = a * contrast_factor + mean * (1 - contrast_factor)
    return np.clip(out, 0, 255).astype(np.uint8) \
        if _np(img).dtype == np.uint8 else out


def adjust_saturation(img, saturation_factor):
    a = _np(img).astype(np.float32)
    gray = (0.299 * a[..., 0] + 0.587 * a[..., 1]
            + 0.114 * a[..., 2])[..., None]
    out = a * saturation_factor + gray * (1 - saturation_factor)
    return np.clip(out, 0, 255).astype(np.uint8) \
        if _np(img).dtype == np.uint8 else out


def adjust_hue(img, hue_factor):
    a = _np(img).astype(np.float32) / 255.0 \
        if _np(img).dtype == np.uint8 else _np(img).astype(np.float32)
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    mx = np.max(a[..., :3], -1)
    mn = np.min(a[..., :3], -1)
    d = mx - mn + 1e-8
    hch = np.where(mx == r, ((g - b) / d) % 6,
                   np.where(mx == g, (b - r) / d + 2, (r - g) / d + 4)) / 6
    s = np.where(mx > 0, d / (mx + 1e-8), 0)
    v = mx
    hch = (hch + hue_factor) % 1.0
    i = np.floor(hch * 6)
    f = hch * 6 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = (i.astype(np.int64) % 6)[..., None]
    rgb = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    if _np(img).dtype == np.uint8:
        return np.clip(rgb * 255, 0, 255).astype(np.uint8)
    return rgb


def to_grayscale(img, num_output_channels=1):
    a = _np(img).astype(np.float32)
    gray = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
    out = np.repeat(gray[..., None], num_output_channels, -1)
    return out.astype(np.uint8) if _np(img).dtype == np.uint8 else out


def erase(img, i, j, h, w, v, inplace=False):
    if isinstance(img, Tensor):
        a = img.numpy().copy()
        # CHW tensor layout: a per-channel value broadcasts along the
        # leading channel axis, so lift (C,) -> (C, 1, 1)
        val = np.asarray(v)
        if val.ndim == 1:
            val = val.reshape(-1, 1, 1)
        a[..., i:i + h, j:j + w] = val
        return Tensor(a)
    a = _np(img).copy()
    a[i:i + h, j:j + w] = v
    return a


# ---------------------------------------------------------------------
# class transforms built on the functionals
# ---------------------------------------------------------------------

class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def _apply_image(self, img):
        a = np.asarray(img)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = np.exp(random.uniform(np.log(self.ratio[0]),
                                       np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                top = random.randint(0, h - ch)
                left = random.randint(0, w - cw)
                patch = a[top:top + ch, left:left + cw]
                return resize(patch, self.size)
        return resize(center_crop(a, min(h, w)), self.size)


class BrightnessTransform(BaseTransform):
    def __init__(self, value):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img, random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.transforms = [BrightnessTransform(brightness),
                           ContrastTransform(contrast),
                           SaturationTransform(saturation),
                           HueTransform(hue)]

    def _apply_image(self, img):
        order = list(range(4))
        random.shuffle(order)
        for i in order:
            img = self.transforms[i](img)
        return img


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None):
        self.degrees = (-degrees, degrees) \
            if isinstance(degrees, numbers.Number) else tuple(degrees)
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        a = np.asarray(img)
        h, w = a.shape[:2]
        angle = random.uniform(*self.degrees)
        tr = (0, 0)
        if self.translate:
            tr = (random.uniform(-self.translate[0], self.translate[0]) * w,
                  random.uniform(-self.translate[1], self.translate[1]) * h)
        sc = random.uniform(*self.scale) if self.scale else 1.0
        sh = (0.0, 0.0)
        if self.shear:
            if isinstance(self.shear, numbers.Number):
                sh = (random.uniform(-self.shear, self.shear), 0.0)
            elif len(self.shear) == 2:
                sh = (random.uniform(self.shear[0], self.shear[1]), 0.0)
            else:
                sh = (random.uniform(self.shear[0], self.shear[1]),
                      random.uniform(self.shear[2], self.shear[3]))
        return affine(a, angle, tr, sc, sh, fill=self.fill,
                      center=self.center)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0):
        self.degrees = (-degrees, degrees) \
            if isinstance(degrees, numbers.Number) else tuple(degrees)
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        return rotate(img, random.uniform(*self.degrees),
                      expand=self.expand, center=self.center,
                      fill=self.fill)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0):
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        a = np.asarray(img)
        h, w = a.shape[:2]
        d = self.distortion_scale
        tl = (random.randint(0, int(d * w / 2)),
              random.randint(0, int(d * h / 2)))
        tr = (w - 1 - random.randint(0, int(d * w / 2)),
              random.randint(0, int(d * h / 2)))
        br = (w - 1 - random.randint(0, int(d * w / 2)),
              h - 1 - random.randint(0, int(d * h / 2)))
        bl = (random.randint(0, int(d * w / 2)),
              h - 1 - random.randint(0, int(d * h / 2)))
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        return perspective(a, start, [tl, tr, br, bl], fill=self.fill)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        a = img.numpy() if isinstance(img, Tensor) else np.asarray(img)
        if isinstance(img, Tensor):
            h, w = a.shape[-2:]
        else:
            h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = random.uniform(*self.ratio)
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w:
                i = random.randint(0, h - eh)
                j = random.randint(0, w - ew)
                return erase(img, i, j, eh, ew, self.value)
        return img
