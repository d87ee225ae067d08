"""Image helpers for dataset readers (reference:
python/paddle/dataset/image.py — cv2 there; the port's vision transforms
here)."""
from __future__ import annotations

import numpy as np


def simple_transform(im, resize_size, crop_size, is_train,
                     is_color=True, mean=None):
    """Resize-shorter-side + center/random crop + CHW float32
    (reference image.py simple_transform)."""
    from ..vision import transforms as T
    im = T.resize(im, resize_size)
    if is_train:
        h, w = im.shape[:2]
        i = np.random.randint(0, h - crop_size + 1)
        j = np.random.randint(0, w - crop_size + 1)
        im = T.crop(im, i, j, crop_size, crop_size)
        if np.random.rand() < 0.5:
            im = T.hflip(im)
    else:
        im = T.center_crop(im, crop_size)
    im = np.asarray(im, np.float32)
    if im.ndim == 3:
        im = im.transpose(2, 0, 1)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        im -= mean if mean.ndim == 1 else mean.reshape(-1, 1, 1)
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    from ..vision.datasets import DatasetFolder
    im = DatasetFolder._default_loader(filename)
    return simple_transform(np.asarray(im), resize_size, crop_size,
                            is_train, is_color, mean)
