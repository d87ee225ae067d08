"""Flowers-102 readers (reference: python/paddle/dataset/flowers.py).
Items: (image float32[3,224,224], label int)."""
from __future__ import annotations

import numpy as np

_SYNTH_N = 64


def _synth_reader(seed, use_xmap=True):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(_SYNTH_N):
            yield (rs.rand(3, 224, 224).astype(np.float32),
                   int(rs.randint(102)))

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _synth_reader(0)


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _synth_reader(1)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _synth_reader(2)


def fetch():
    from .common import download
    download("https://dataset.bj.bcebos.com/flowers/102flowers.tgz",
             "flowers", None)
