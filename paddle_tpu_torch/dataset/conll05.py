"""CoNLL-2005 SRL readers (reference: python/paddle/dataset/conll05.py).
Items: 8 aligned id-sequences + label sequence."""
from __future__ import annotations

import numpy as np

_SYNTH_N = 128
_WORDS, _LABELS = 2000, 60


def get_dict():
    word_dict = {f"w{i}": i for i in range(_WORDS)}
    verb_dict = {f"v{i}": i for i in range(100)}
    label_dict = {f"l{i}": i for i in range(_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    from .common import DATA_HOME
    raise RuntimeError("emb file requires network egress; place it under "
                       f"{DATA_HOME}/conll05")


def _synth_reader(seed):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(_SYNTH_N):
            n = int(rs.randint(5, 40))
            seqs = [rs.randint(0, _WORDS, n).tolist() for _ in range(6)]
            verb = rs.randint(0, 100, n).tolist()
            mark = rs.randint(0, 2, n).tolist()
            labels = rs.randint(0, _LABELS, n).tolist()
            yield tuple(seqs) + (verb, mark, labels)

    return reader


def test():
    return _synth_reader(1)


def fetch():
    from .common import download
    download("https://dataset.bj.bcebos.com/conll05st%2Fconll05st-tests.tar.gz",
             "conll05", None)
