"""UCI housing readers (reference: python/paddle/dataset/uci_housing.py).
Items: (features float32[13], price float32[1])."""
from __future__ import annotations

import os

import numpy as np

from .common import DATA_HOME

feature_names = ['CRIM', 'ZN', 'INDUS', 'CHAS', 'NOX', 'RM', 'AGE', 'DIS',
                 'RAD', 'TAX', 'PTRATIO', 'B', 'LSTAT']

UCI_TRAIN_DATA = None
UCI_TEST_DATA = None


def feature_range(maximums, minimums):
    pass


def load_data(filename, feature_num=14, ratio=0.8):
    global UCI_TRAIN_DATA, UCI_TEST_DATA
    if UCI_TRAIN_DATA is not None and UCI_TEST_DATA is not None:
        return
    data = np.fromfile(filename, sep=' ')
    data = data.reshape(data.shape[0] // feature_num, feature_num)
    maximums, minimums, avgs = (data.max(axis=0), data.min(axis=0),
                                data.sum(axis=0) / data.shape[0])
    for i in range(feature_num - 1):
        data[:, i] = (data[:, i] - avgs[i]) / (maximums[i] - minimums[i])
    offset = int(data.shape[0] * ratio)
    UCI_TRAIN_DATA = data[:offset]
    UCI_TEST_DATA = data[offset:]


def _synth(seed, n=128):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 13).astype(np.float32)
    w = rs.randn(13).astype(np.float32)
    y = (x @ w + 0.1 * rs.randn(n)).astype(np.float32)
    return np.concatenate([x, y[:, None]], 1)


def _rows(split):
    path = os.path.join(DATA_HOME, "uci_housing", "housing.data")
    if os.path.exists(path):
        load_data(path)
        return UCI_TRAIN_DATA if split == "train" else UCI_TEST_DATA
    return _synth(0 if split == "train" else 1)


def train():
    def reader():
        for row in _rows("train"):
            yield row[:-1].astype(np.float32), row[-1:].astype(np.float32)

    return reader


def test():
    def reader():
        for row in _rows("test"):
            yield row[:-1].astype(np.float32), row[-1:].astype(np.float32)

    return reader


def fetch():
    from .common import download
    download("https://archive.ics.uci.edu/ml/machine-learning-databases/"
             "housing/housing.data", "uci_housing", None)
