"""PTB language-model readers (reference: python/paddle/dataset/imikolov.py).
Items: n-gram tuples of word ids."""
from __future__ import annotations

import numpy as np

_SYNTH_N = 512
_VOCAB = 2000


class DataType:
    NGRAM = 1
    SEQ = 2


def build_dict(min_word_freq=50):
    return {f"w{i}": i for i in range(_VOCAB)}


def _synth_reader(seed, n, data_type):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(_SYNTH_N):
            if data_type == DataType.NGRAM:
                yield tuple(rs.randint(0, _VOCAB, n).tolist())
            else:
                ln = int(rs.randint(5, 30))
                seq = rs.randint(0, _VOCAB, ln).tolist()
                yield seq[:-1], seq[1:]

    return reader


def train(word_idx=None, n=5, data_type=DataType.NGRAM):
    return _synth_reader(0, n, data_type)


def test(word_idx=None, n=5, data_type=DataType.NGRAM):
    return _synth_reader(1, n, data_type)


def fetch():
    from .common import download
    download("https://dataset.bj.bcebos.com/imikolov%2Fsimple-examples.tgz",
             "imikolov", None)
