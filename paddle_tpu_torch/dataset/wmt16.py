"""WMT16 en-de translation readers (reference:
python/paddle/dataset/wmt16.py). Items: (src ids, trg ids, trg-next ids)."""
from __future__ import annotations

import numpy as np

_SYNTH_N = 256


def _synth_reader(seed, src_dict_size, trg_dict_size):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(_SYNTH_N):
            ns, nt = int(rs.randint(5, 30)), int(rs.randint(5, 30))
            src = rs.randint(0, src_dict_size, ns).tolist()
            trg = rs.randint(0, trg_dict_size, nt).tolist()
            yield src, trg, trg[1:] + [1]

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _synth_reader(0, src_dict_size, trg_dict_size)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _synth_reader(1, src_dict_size, trg_dict_size)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return _synth_reader(2, src_dict_size, trg_dict_size)


def get_dict(lang, dict_size, reverse=False):
    d = {f"{lang}{i}": i for i in range(dict_size)}
    return {v: k for k, v in d.items()} if reverse else d


def fetch():
    from .common import download
    download("http://paddlemodels.bj.bcebos.com/wmt/wmt16.tar.gz", "wmt16",
             None)
