"""WMT14 en-fr translation readers (reference:
python/paddle/dataset/wmt14.py). Items: (src ids, trg ids, trg-next ids)."""
from __future__ import annotations

import numpy as np

_SYNTH_N = 256


def _synth_reader(seed, dict_size):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(_SYNTH_N):
            ns, nt = int(rs.randint(5, 30)), int(rs.randint(5, 30))
            src = rs.randint(0, dict_size, ns).tolist()
            trg = rs.randint(0, dict_size, nt).tolist()
            yield src, trg, trg[1:] + [1]

    return reader


def train(dict_size):
    return _synth_reader(0, dict_size)


def test(dict_size):
    return _synth_reader(1, dict_size)


def get_dict(dict_size, reverse=True):
    src = {i: f"w{i}" for i in range(dict_size)}
    trg = {i: f"t{i}" for i in range(dict_size)}
    if not reverse:
        src = {v: k for k, v in src.items()}
        trg = {v: k for k, v in trg.items()}
    return src, trg


def fetch():
    from .common import download
    download("http://paddlemodels.bj.bcebos.com/wmt/wmt14.tgz", "wmt14",
             None)
