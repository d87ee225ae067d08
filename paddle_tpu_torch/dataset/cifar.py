"""CIFAR readers (reference: python/paddle/dataset/cifar.py).
Items: (image float32[3072] in [0,1], label int)."""
from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from .common import DATA_HOME

_SYNTH_N = 256


def _read_batch(batch):
    data = batch[b'data'].astype(np.float32) / 255.0
    labels = batch.get(b'labels', batch.get(b'fine_labels'))
    for d, l in zip(data, labels):
        yield d, int(l)


def reader_creator(filename, sub_name):
    def reader():
        with tarfile.open(filename, mode='r') as f:
            names = [n for n in f.getnames() if sub_name in n]
            names.sort()
            for name in names:
                batch = pickle.load(f.extractfile(name), encoding='bytes')
                for item in _read_batch(batch):
                    yield item

    return reader


def _synth_reader(seed, nclass):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(_SYNTH_N):
            yield (rs.rand(3072).astype(np.float32),
                   int(rs.randint(nclass)))

    return reader


def _make(split, nclass):
    name = "cifar-100-python.tar.gz" if nclass == 100 else \
        "cifar-10-python.tar.gz"
    path = os.path.join(DATA_HOME, "cifar", name)
    sub = {"train10": "data_batch", "test10": "test_batch",
           "train100": "train", "test100": "test"}[f"{split}{nclass}"]
    if os.path.exists(path):
        return reader_creator(path, sub)
    return _synth_reader(0 if split == "train" else 1, nclass)


def train10():
    return _make("train", 10)


def test10():
    return _make("test", 10)


def train100():
    return _make("train", 100)


def test100():
    return _make("test", 100)


def fetch():
    from .common import download
    download("https://dataset.bj.bcebos.com/cifar/cifar-10-python.tar.gz",
             "cifar", None)
