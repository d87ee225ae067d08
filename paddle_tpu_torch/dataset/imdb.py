"""IMDB sentiment readers (reference: python/paddle/dataset/imdb.py).
Items: (word-id list, 0/1 label)."""
from __future__ import annotations

import numpy as np

_SYNTH_N = 256
_VOCAB = 5000


def word_dict():
    return {bytes(f"w{i}", "ascii"): i for i in range(_VOCAB)}


def _synth_reader(seed):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(_SYNTH_N):
            n = int(rs.randint(10, 200))
            yield rs.randint(0, _VOCAB, n).tolist(), int(rs.randint(2))

    return reader


def train(word_idx=None):
    return _synth_reader(0)


def test(word_idx=None):
    return _synth_reader(1)


def fetch():
    from .common import download
    download("https://dataset.bj.bcebos.com/imdb%2FaclImdb_v1.tar.gz",
             "imdb", None)
