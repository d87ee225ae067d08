"""VOC2012 segmentation readers (reference: python/paddle/dataset/voc2012.py).
Items: (image float32[3,H,W], seg-label int32[H,W])."""
from __future__ import annotations

import numpy as np

_SYNTH_N = 32


def _synth_reader(seed):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(_SYNTH_N):
            h = w = 128
            yield (rs.rand(3, h, w).astype(np.float32),
                   rs.randint(0, 21, (h, w)).astype(np.int32))

    return reader


def train():
    return _synth_reader(0)


def test():
    return _synth_reader(1)


def val():
    return _synth_reader(2)


def fetch():
    from .common import download
    download("https://dataset.bj.bcebos.com/voc2012%2FVOCtrainval_11-May-2012.tar",
             "voc2012", None)
